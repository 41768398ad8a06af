"""The port's ``query`` loads the graph, the annotation and a ``.seqs`` file
beside it before it refuses what it has not ported (``--align``,
``--batch-align``), as the JAX ``cmd_query`` loads them before it builds
its engine (metagraph_tpu/cli/main.py:799-815): a missing graph or
annotation prints the JAX CLI's ``[error] File not found: ...`` line and
exits 1 whatever else the command line asks (``-p``, ``--align``, a
``.seqs`` file); with its inputs present, ``-p``/``--parallel-each`` above
1 and a ``.seqs`` file that is no mapping give the JAX CLI's bytes and
exit code.

The JAX CLI builds and annotates a small random-ACGT index in tmp_path and
runs in this process; the port runs in a subprocess without JAX.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    from metagraph_tpu.cli.main import main as jax_main
    tmp = tmp_path_factory.mktemp("refusals")
    rng = np.random.default_rng(47)
    refs = ["".join(rng.choice(list("ACGT"), size=int(n)))
            for n in rng.integers(150, 300, size=4)]
    with open(tmp / "refs.fa", "w") as f:
        f.writelines(f">ref{i} sample\n{s}\n" for i, s in enumerate(refs))
    with open(tmp / "q.fa", "w") as f:
        f.writelines(f">q{i}\n{s[10:120]}\n" for i, s in enumerate(refs))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_main(["build", "-k", "15", "-o", str(tmp / "g"),
                  str(tmp / "refs.fa")])
        jax_main(["annotate", "-i", str(tmp / "g.dbg"), "--anno-header",
                  "-o", str(tmp / "a"), str(tmp / "refs.fa")])
    return tmp


def _run_both(cwd, args):
    """The JAX CLI in this process and the port in a subprocess on the same
    command line (the port's with ``--torch-device cpu``): -> ((JAX stdout,
    stderr, exit code), the port's)."""
    from metagraph_tpu.cli.main import main as jax_main
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            jax_main(args)
        except SystemExit as e:
            code = e.code or 0
    env = dict(os.environ, PYTHONPATH=REPO)
    got = subprocess.run(
        [sys.executable, "-m", "metagraph_tpu_torch", *args,
         "--torch-device", "cpu"], capture_output=True, env=env,
        cwd=str(cwd), timeout=120)
    return ((out.getvalue().encode(), err.getvalue(), code),
            (got.stdout, got.stderr.decode(), got.returncode))


@pytest.mark.parametrize("unported", ("-p 2", "--align", ".seqs"))
@pytest.mark.parametrize("missing", ("graph", "annotation"))
def test_missing_input_reported_before_refusal(index, tmp_path, missing,
                                               unported):
    """C4: a missing graph or annotation combined with an unported flag or
    a .seqs file: the JAX [error] line and exit code 1, no traceback."""
    graph, anno = str(index / "g.dbg"), str(tmp_path / "a.column.annodbg")
    if missing == "graph":
        graph = str(tmp_path / "absent.dbg")
        shutil.copyfile(index / "a.column.annodbg.npz", anno + ".npz")
    extra = []
    if unported == ".seqs":
        with open(tmp_path / "a.seqs", "w") as f:
            f.write("ref0 sample\n")
    else:
        extra = unported.split()
    args = ["query", "-i", graph, "-a", anno, *extra, "--device",
            str(index / "q.fa")]
    want, got = _run_both(tmp_path, args)
    assert want[2] == got[2] == 1
    assert got[0] == want[0] == b""
    line = [ln for ln in got[1].splitlines() if ln.startswith("[error]")]
    assert line == [ln for ln in want[1].splitlines()
                    if ln.startswith("[error]")]
    assert line and line[0].startswith("[error] File not found: ")
    assert ("absent" if missing == "graph" else "a.column.annodbg") \
        in line[0]
    assert "Traceback" not in got[1] and "NotImplementedError" not in got[1]


def _in_process(main, args):
    """-> (stdout, exit code, the uncaught error's type and message)."""
    out, code, err = io.StringIO(), 0, None
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            main(args)
        except SystemExit as e:
            code = e.code or 0
        except Exception as e:      # noqa: BLE001 (an uncaught CLI error)
            code, err = 1, f"{type(e).__name__}: {e}"
    return out.getvalue(), code, err


@pytest.mark.parametrize("unported", ("-p 2", "--parallel-each 3",
                                      "--align", "--batch-align", ".seqs"))
def test_present_inputs_then_refusal(index, tmp_path, unported):
    """With the graph and the annotation present, the port loads them and
    then refuses what it has not ported (--align, --batch-align), naming
    the ROADMAP item; -p 2, --parallel-each 3 and a .seqs file that holds
    no mapping (a text file) give the JAX CLI's stdout and exit code (the
    last: its ValueError from np.load, exit 1)."""
    from metagraph_tpu.cli.main import main as jax_main
    from metagraph_tpu_torch.cli import main
    anno = tmp_path / "a.column.annodbg"
    shutil.copyfile(index / "a.column.annodbg.npz", f"{anno}.npz")
    extra = []
    if unported == ".seqs":
        (tmp_path / "a.seqs").write_text("ref0 sample\n")
    else:
        extra = unported.split()
    args = ["query", "-i", str(index / "g.dbg"), "-a", str(anno), *extra,
            str(index / "q.fa")]
    if unported in ("--align", "--batch-align"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(args + ["--torch-device", "cpu"])
        return
    want = _in_process(jax_main, args[:-1] + ["--device", args[-1]])
    got = _in_process(main, args + ["--torch-device", "cpu"])
    assert got == want
    if unported == ".seqs":
        assert want[1] == 1 and want[2].startswith("ValueError")
    else:
        assert want[1] == 0 and want[0].count("\n") == 4
