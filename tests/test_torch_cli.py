"""``python -m metagraph_tpu_torch query --device --torch-device cpu`` prints
the same bytes as ``python -m metagraph_tpu.cli query --device``, takes its
command lines and keeps its error contract, on column annotations (the
annotations that ``transform_anno`` writes: test_torch_cli_converted.py).

The JAX CLI builds and annotates a small random-ACGT index in tmp_path; its
query runs in this process (stdout captured), the port's in a subprocess
without JAX.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    from metagraph_tpu.cli.main import main as jax_main
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(41)
    refs = ["".join(rng.choice(list("ACGT"), size=int(n)))
            for n in rng.integers(200, 600, size=8)]
    refs[3] = refs[3] + refs[3][40:140]
    with open(tmp / "refs.fa", "w") as f:
        f.writelines(f">ref{i} sample\n{s}\n" for i, s in enumerate(refs))
    comp = str.maketrans("ACGT", "TGCA")
    queries = []
    for i, s in enumerate(refs):
        queries.append(s[i * 7: i * 7 + 150])
        queries.append(s[20:180][::-1].translate(comp))
        q = list(s[60:200])
        for p in range(0, len(q), 13):
            q[p] = "ACGTN"[int(rng.integers(5))]
        queries.append("".join(q))
    queries += ["N" * 50, "ACGTA", refs[0][:30] + "NNNN" + refs[1][:60]]
    with open(tmp / "q.fa", "w") as f:
        f.writelines(f">q{i}\n{s}\n" for i, s in enumerate(queries))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_main(["build", "-k", "19", "-o", str(tmp / "g"),
                  str(tmp / "refs.fa")])
        jax_main(["annotate", "-i", str(tmp / "g.dbg"), "--anno-header",
                  "--count-kmers", "-o", str(tmp / "a"),
                  str(tmp / "refs.fa")])
    return tmp


OPTION_SETS = [
    ["--query-mode", "labels"],
    ["--query-mode", "matches", "--num-top-labels", "2"],
    ["--query-mode", "counts", "--min-kmers-fraction-label", "0.3"],
    ["--query-mode", "signature", "--min-kmers-fraction-label", "0.5",
     "--min-kmers-fraction-graph", "0.2"],
    ["--query-mode", "matches", "--json", "--fwd-and-reverse"],
    ["--query-mode", "counts", "--json", "--batch-size", "400"],
    ["--query-mode", "labels", "--fwd-and-reverse"],
]


@pytest.mark.parametrize("opts", OPTION_SETS, ids=lambda o: " ".join(o))
def test_stdout_matches_jax_cli(index, opts):
    from metagraph_tpu.cli.main import main as jax_main
    args = ["query", "-i", str(index / "g.dbg"), "-a",
            str(index / "a.column.annodbg"), *opts]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_main(args + ["--device", str(index / "q.fa")])
    want = buf.getvalue().encode()
    env = dict(os.environ, PYTHONPATH=REPO)
    got = subprocess.run(
        [sys.executable, "-m", "metagraph_tpu_torch", *args, "--device",
         "--torch-device", "cpu", str(index / "q.fa")],
        capture_output=True, env=env, cwd=str(index), timeout=120)
    assert got.returncode == 0, got.stderr.decode()[-2000:]
    assert got.stdout == want
    assert want.count(b"\n") >= 27


def test_chip_smoke_rehearsal_and_refusal(tmp_path):
    """chip_smoke.py's control flow at a tiny size on the CPU (it exits 2
    without a result), and its refusal without a card, alone in a
    directory or not (exit 1, no result)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = os.path.join(REPO, "chip_smoke.py")
    out = subprocess.run([sys.executable, script, "--rehearse", "--out",
                          str(tmp_path / "out")], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 2, out.stderr[-3000:]
    assert "oracle: 61 sequences equal" in out.stdout
    assert "match=exact" in out.stdout and '"ok"' not in out.stdout
    lone = tmp_path / "lone"
    lone.mkdir()
    (lone / "chip_smoke.py").write_bytes(open(script, "rb").read())
    for path in (script, str(lone / "chip_smoke.py")):
        out = subprocess.run([sys.executable, path], capture_output=True,
                             text=True, env=env, cwd=str(lone), timeout=120)
        assert out.returncode == 1 and out.stdout == ""


def test_port_cli_refuses_out_of_scope(index, tmp_path):
    """``query --align`` and ``--batch-align`` on a hash graph, which the
    port refused before it aligned on graphs without a BOSS: the port
    prints the JAX CLI's 27 lines."""
    from metagraph_tpu.cli.main import main as jax_main
    from metagraph_tpu_torch.cli import main
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_main(["build", "--graph", "hash", "-k", "19", "-o",
                  str(tmp_path / "h"), str(index / "refs.fa")])
        jax_main(["annotate", "-i", str(tmp_path / "h.dbg"), "--anno-header",
                  "-o", str(tmp_path / "ha"), str(index / "refs.fa")])
    base = ["query", "-i", str(tmp_path / "h.dbg"), "-a",
            str(tmp_path / "ha.column.annodbg")]
    for extra in (["--align"], ["--align", "--batch-align"]):
        buf, got = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf):
            jax_main(base + extra + [str(index / "q.fa")])
        assert buf.getvalue().count("\n") == 27
        with contextlib.redirect_stdout(got), \
                contextlib.redirect_stderr(io.StringIO()):
            main(base + extra + ["--torch-device", "cpu",
                                 str(index / "q.fa")])
        assert got.getvalue() == buf.getvalue()


def _run_both(index, args, jax_args=None):
    """The JAX CLI in this process and the port in a subprocess on the same
    command line (the port's with ``--torch-device cpu``): -> ((JAX stdout,
    stderr, exit code), the port's)."""
    from metagraph_tpu.cli.main import main as jax_main
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            jax_main(jax_args or args)
        except SystemExit as e:
            code = e.code or 0
    env = dict(os.environ, PYTHONPATH=REPO)
    got = subprocess.run(
        [sys.executable, "-m", "metagraph_tpu_torch", *args,
         "--torch-device", "cpu"], capture_output=True, env=env,
        cwd=str(index), timeout=120)
    return ((out.getvalue().encode(), err.getvalue(), code),
            (got.stdout, got.stderr.decode(), got.returncode))


# C1: JAX command lines, in JAX's argument order (--device before the
# input), with its common flags
JAX_LINES = [
    ["-v", "--query-mode", "matches"],
    ["--mmap", "--query-mode", "counts"],
    ["-o", "x", "--parallel-each", "1", "-p", "1"],
    ["--align-match-score", "3", "--max-hull-forks", "2",
     "--query-mode", "signature"],
]


@pytest.mark.parametrize("opts", JAX_LINES, ids=lambda o: " ".join(o))
def test_jax_command_lines_run_on_the_port(index, opts):
    args = ["query", "-i", str(index / "g.dbg"), "-a",
            str(index / "a.column.annodbg"), *opts, "--device",
            str(index / "q.fa")]
    want, got = _run_both(index, args)
    assert got[2] == 0, got[1][-2000:]
    assert got[0] == want[0] and want[0].count(b"\n") >= 27
    if "-v" in opts:        # progress lines on stderr, as JAX's trace
        assert "[trace] Batch of" in got[1] and "[trace] query:" in got[1]


@pytest.mark.parametrize("missing", ("graph", "annotation", "input"))
def test_missing_file_error_contract(index, missing):
    """C2: a missing file prints the JAX CLI's [error] line and exits 1."""
    paths = {"graph": str(index / "g.dbg"),
             "annotation": str(index / "a.column.annodbg"),
             "input": str(index / "q.fa")}
    paths[missing] = str(index / "absent")
    args = ["query", "-i", paths["graph"], "-a", paths["annotation"],
            "--device", paths["input"]]
    want, got = _run_both(index, args)
    assert want[2] == got[2] == 1
    assert got[0] == want[0] == b""
    line = [ln for ln in got[1].splitlines() if ln.startswith("[error]")]
    assert line == [ln for ln in want[1].splitlines()
                    if ln.startswith("[error]")]
    assert line and "File not found: " in line[0] and "absent" in line[0]


def _closed_early(cmd, env, cwd):
    """Run ``cmd``, read one line of its stdout, close the pipe and wait:
    -> (exit code, stderr)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, cwd=cwd)
    first = proc.stdout.readline()
    proc.stdout.close()
    err = proc.stderr.read().decode()
    proc.wait(timeout=120)
    assert first
    return proc.returncode, err


def test_stdout_closed_early_exits_as_jax(index):
    """C2: a reader that closes stdout after one line: both CLIs exit 0
    and print no traceback."""
    with open(index / "q.fa") as f:
        body = f.read()
    big = index / "many.fa"
    with open(big, "w") as f:
        f.write(body * 400)        # far more than a pipe holds
    args = ["query", "-i", str(index / "g.dbg"), "-a",
            str(index / "a.column.annodbg"), "--device", str(big)]
    env = dict(os.environ, PYTHONPATH=REPO)
    want = _closed_early([sys.executable, "-m", "metagraph_tpu.cli", *args],
                         env, str(index))
    got = _closed_early([sys.executable, "-m", "metagraph_tpu_torch", *args,
                         "--torch-device", "cpu"], env, str(index))
    assert got == want
    assert got[0] == 0 and "Traceback" not in got[1]
