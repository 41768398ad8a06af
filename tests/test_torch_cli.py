"""``python -m metagraph_tpu_torch query --device cpu`` prints the same bytes
as ``python -m metagraph_tpu.cli query --device``.

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
         "cpu", str(index / "q.fa")],
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


def test_port_cli_refuses_out_of_scope(index):
    from metagraph_tpu_torch.cli import main
    base = ["query", "-i", str(index / "g.dbg"), "-a",
            str(index / "a.column.annodbg"), "--device", "cpu"]
    for extra in (["--query-mode", "coords"], ["-p", "2"], ["--align"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(base + extra + [str(index / "q.fa")])
