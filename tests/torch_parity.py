"""Helpers of the port's CLI parity tests: the JAX CLI in this process, the
port's CLI in one subprocess that imports no JAX, FASTA writing, random
references with reads cut from them, and the comparison of two ``build``
outputs."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs each command line through the port's CLI in this one process: ->
# [stdout, exit code, the error an uncaught exception printed last] and,
# given a third argument, the stderr text
RUNNER = """
import contextlib, io, json, sys
from metagraph_tpu_torch.cli import main
with_stderr = len(sys.argv) > 3
out = []
for args in json.load(open(sys.argv[1])):
    buf, ebuf, code, err = io.StringIO(), io.StringIO(), 0, None
    try:
        with contextlib.redirect_stdout(buf), \\
                contextlib.redirect_stderr(ebuf):
            main(args)
    except SystemExit as e:
        code = e.code or 0
    except Exception as e:
        code, err = 1, f"{type(e).__name__}: {e}"
    out.append([buf.getvalue(), code, err]
               + ([ebuf.getvalue()] if with_stderr else []))
json.dump(out, open(sys.argv[2], "w"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "metagraph_tpu")]
assert not bad, bad
"""


def run_jax(args, stderr=False):
    """The JAX CLI on one command line: -> [stdout, exit code, error] and,
    if ``stderr``, the stderr text."""
    from metagraph_tpu.cli.main import main as jax_main
    buf, ebuf, code, err = io.StringIO(), io.StringIO(), 0, None
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(ebuf):
            jax_main(args)
    except SystemExit as e:
        code = e.code or 0
    except Exception as e:          # noqa: BLE001 (an uncaught CLI error)
        code, err = 1, f"{type(e).__name__}: {e}"
    return [buf.getvalue(), code, err] + ([ebuf.getvalue()] if stderr else [])


def jax_cli(*args):
    """The JAX CLI on a command line that must succeed (builds, annotates,
    conversions)."""
    out, code, err = run_jax([str(a) for a in args])
    assert code == 0 and err is None, (args, code, err)
    return out


def run_port(tmp, lines, stderr=False):
    """The port's CLI on every command line (with --torch-device cpu), in
    one subprocess; each result as ``run_jax``'s."""
    spec, res = tmp / "port_lines.json", tmp / "port_out.json"
    spec.write_text(json.dumps([[str(a) for a in line]
                                + ["--torch-device", "cpu"]
                                for line in lines]))
    env = dict(os.environ, PYTHONPATH=REPO)
    got = subprocess.run([sys.executable, "-c", RUNNER, str(spec), str(res)]
                         + (["stderr"] if stderr else []),
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


MMAP_FILES = (".W.npy", ".last.npy", ".valid.npy", ".meta.npz")


def graph_line(stderr):
    """The ``graph built:`` lines of a build's stderr."""
    return [ln for ln in stderr.splitlines() if ln.startswith("graph built")]


def _npz(path):
    import numpy as np
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


def same_build_files(tmp, a, b, mmap_layout):
    """The artifacts of builds ``a`` and ``b`` (names without .dbg.npz) in
    ``tmp``: the same files, keys, dtypes and arrays (the mmap layout's
    ``.weights.npy`` where either has one)."""
    import numpy as np
    if mmap_layout:
        assert not os.path.exists(tmp / f"{a}.dbg.npz")
        ext = MMAP_FILES + ((".weights.npy",) if any(
            os.path.exists(tmp / f"{x}.dbg.weights.npy") for x in (a, b))
            else ())
        pairs = [(tmp / f"{a}.dbg{e}", tmp / f"{b}.dbg{e}") for e in ext]
    else:
        pairs = [(tmp / f"{a}.dbg.npz", tmp / f"{b}.dbg.npz")]
    for pa, pb in pairs:
        if str(pa).endswith(".npy"):
            x, y = {"": np.load(pa)}, {"": np.load(pb)}
        else:
            x, y = _npz(pa), _npz(pb)
        assert sorted(x) == sorted(y), (pa, sorted(x), sorted(y))
        for f in x:
            assert x[f].dtype == y[f].dtype and x[f].shape == y[f].shape \
                and np.array_equal(x[f], y[f]), (pa, f)


def detour_references_and_reads(rng, n_refs=4, length=700, n_reads=24,
                                read_len=150, letters="ACGT"):
    """References for alignment: random ones and a copy of the first with
    a substitution every 97 characters (a detour of the graph at each);
    reads of ``read_len`` cut from them with 0-3 substitutions (and, for
    DNA, every third one reverse-complemented), one with a deletion, one
    random read that nothing matches, one with an N run.  -> (refs,
    reads)."""
    refs = ["".join(rng.choice(list(letters), size=length))
            for _ in range(n_refs)]
    var = list(refs[0])
    for p in range(100, length, 97):
        var[p] = letters[(letters.index(var[p]) + 1) % len(letters)]
    refs.append("".join(var))
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(n_reads):
        s = refs[i % len(refs)]
        a = int(rng.integers(0, len(s) - read_len))
        r = list(s[a: a + read_len])
        for p in rng.choice(read_len, int(rng.integers(0, 4)),
                            replace=False):
            r[p] = letters[(letters.index(r[p]) + 1
                            + int(rng.integers(len(letters) - 1)))
                           % len(letters)]
        r = "".join(r)
        if letters == "ACGT" and i % 3 == 1:
            r = r[::-1].translate(comp)
        reads.append(r)
    reads.append(refs[2][:70] + refs[2][73: read_len + 3])
    reads.append("".join(rng.choice(list(letters), size=read_len)))
    unknown = "N" if letters == "ACGT" else "X"
    reads.append(refs[1][:60] + unknown * 4 + refs[1][64: read_len])
    return refs, reads


def mosaic_references(rng, n_refs=70, n_blocks=24, block=(40, 70),
                      per_ref=4, mutate=0.0):
    """References that are mosaics of shared random blocks, so that paths
    branch at block boundaries into blocks that other references (labels)
    hold; ``mutate`` substitutes that share of each reference's
    characters.  -> list of str."""
    blocks = ["".join(rng.choice(list("ACGT"), int(rng.integers(*block))))
              for _ in range(n_blocks)]
    refs = []
    for _ in range(n_refs):
        s = list("".join(blocks[int(b)] for b in
                         rng.choice(n_blocks, per_ref, replace=False)))
        for p in np.flatnonzero(rng.random(len(s)) < mutate):
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        refs.append("".join(s))
    return refs


def reads_from(rng, refs, n, length=(50, 90), complement=True):
    """Reads cut from the references: substitutions, a 2 bp deletion in
    every fifth, every third reverse-complemented."""
    comp = str.maketrans("ACGT", "TGCA")
    out = []
    for i in range(n):
        r = refs[int(rng.integers(0, len(refs)))]
        a = int(rng.integers(0, max(len(r) - length[1], 1)))
        s = list(r[a: a + int(rng.integers(*length))])
        for p in rng.choice(len(s), int(rng.integers(0, 3)), replace=False):
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        if i % 5 == 4:
            del s[20: 22]
        s = "".join(s)
        if complement and i % 3 == 1:
            s = s[::-1].translate(comp)
        out.append(s)
    return out
