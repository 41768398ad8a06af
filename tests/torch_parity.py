"""Helpers of the port's CLI parity tests: the JAX CLI in this process, the
port's CLI in one subprocess that imports no JAX, FASTA writing and random
references with reads cut from them."""

import contextlib
import io
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs each command line through the port's CLI in this one process: ->
# [stdout, exit code, the error an uncaught exception printed last]
RUNNER = """
import contextlib, io, json, sys
from metagraph_tpu_torch.cli import main
out = []
for args in json.load(open(sys.argv[1])):
    buf, code, err = io.StringIO(), 0, None
    try:
        with contextlib.redirect_stdout(buf), \\
                contextlib.redirect_stderr(io.StringIO()):
            main(args)
    except SystemExit as e:
        code = e.code or 0
    except Exception as e:
        code, err = 1, f"{type(e).__name__}: {e}"
    out.append([buf.getvalue(), code, err])
json.dump(out, open(sys.argv[2], "w"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "metagraph_tpu")]
assert not bad, bad
"""


def run_jax(args):
    """The JAX CLI on one command line: -> [stdout, exit code, error]."""
    from metagraph_tpu.cli.main import main as jax_main
    buf, code, err = io.StringIO(), 0, None
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jax_main(args)
    except SystemExit as e:
        code = e.code or 0
    except Exception as e:          # noqa: BLE001 (an uncaught CLI error)
        code, err = 1, f"{type(e).__name__}: {e}"
    return [buf.getvalue(), code, err]


def jax_cli(*args):
    """The JAX CLI on a command line that must succeed (builds, annotates,
    conversions)."""
    out, code, err = run_jax([str(a) for a in args])
    assert code == 0 and err is None, (args, code, err)
    return out


def run_port(tmp, lines):
    """The port's CLI on every command line (with --torch-device cpu), in
    one subprocess."""
    spec, res = tmp / "port_lines.json", tmp / "port_out.json"
    spec.write_text(json.dumps([[str(a) for a in line]
                                + ["--torch-device", "cpu"]
                                for line in lines]))
    env = dict(os.environ, PYTHONPATH=REPO)
    got = subprocess.run([sys.executable, "-c", RUNNER, str(spec), str(res)],
                         capture_output=True, env=env, cwd=str(tmp),
                         timeout=900)
    assert got.returncode == 0, got.stderr.decode()[-3000:]
    return json.loads(res.read_text())


def write_fasta(path, recs):
    with open(path, "w") as f:
        f.writelines(f">{h}\n{s}\n" for h, s in recs)


def references_and_reads(rng, n_refs=5, length=(120, 260), letters="ACGT",
                         n_reads=3, complement=True):
    """Random references over ``letters`` and reads cut from them: forward,
    reverse-complemented (DNA), with substitutions, with an N run, a read
    shorter than most k, an empty read.  -> (refs, reads)."""
    refs = ["".join(rng.choice(list(letters), size=int(rng.integers(*length))))
            for _ in range(n_refs)]
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i, s in enumerate(refs):
        for j in range(n_reads):
            a = int(rng.integers(0, len(s) - 80))
            r = s[a: a + int(rng.integers(50, 80))]
            if complement and j == 1:
                r = r[::-1].translate(comp)
            if j == 2:
                r = list(r)
                for p in range(5, len(r), 23):
                    r[p] = letters[(letters.index(r[p]) + 1) % len(letters)]
                r = "".join(r)
            reads.append(r)
        reads.append(s[10:40] + "N" * 5 + s[45:100])
    reads += [refs[0][:9], "", refs[1] + refs[2][:50]]
    return refs, reads
