"""``-p``/``--parallel-each`` on the port: up to N batches in flight on a
thread pool, their results yielded in submission order, so that
``python -m metagraph_tpu_torch query -p N`` prints the bytes of
``python -m metagraph_tpu.cli query -p N`` (and of the sequential run) on
the wire, codes and map routes and with a ``.seqs`` mapping; each batch's
host seconds stay its own; launch counters stay exact when threads launch.

The JAX CLI builds and annotates small random-ACGT indexes in tmp_path;
the port's command lines run in one subprocess without JAX.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = """
import contextlib, io, json, sys
from metagraph_tpu_torch.cli import main
out = []
for args in json.load(open(sys.argv[1])):
    buf, code = io.StringIO(), 0
    try:
        with contextlib.redirect_stdout(buf):
            main(args)
    except SystemExit as e:
        code = e.code or 0
    out.append([buf.getvalue(), code])
json.dump(out, open(sys.argv[2], "w"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "metagraph_tpu")]
assert not bad, bad
"""


@pytest.fixture(scope="module")
def par_index(tmp_path_factory):
    """Basic k = 15 (wire route) and k = 33 (codes route) graphs and a
    canonical k = 33 graph (map route) of eight references, with counts;
    the k = 15 graph also with coordinates and a .seqs mapping (two files,
    one label each); reads from both strands, with N runs."""
    from metagraph_tpu.cli.main import main as jax_main
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(53)
    refs = ["".join(rng.choice(list("ACGT"), size=int(n)))
            for n in rng.integers(150, 400, size=8)]
    for half in (0, 1):
        with open(tmp / f"refs{half}.fa", "w") as f:
            f.writelines(f">ref{i} s\n{s}\n" for i, s in enumerate(refs)
                         if i % 2 == half)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i, s in enumerate(refs * 3):
        a = int(rng.integers(0, len(s) - 100))
        r = s[a: a + int(rng.integers(40, 100))]
        if i % 3 == 1:
            r = r[::-1].translate(comp)
        if i % 5 == 0:
            r = r[:20] + "NN" + r[22:]
        reads.append(r)
    with open(tmp / "q.fa", "w") as f:
        f.writelines(f">q{i}\n{s}\n" for i, s in enumerate(reads))
    files = [str(tmp / "refs0.fa"), str(tmp / "refs1.fa")]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        for g, mode, k in (("g15", "basic", 15), ("g33", "basic", 33),
                           ("c33", "canonical", 33)):
            jax_main(["build", "--mode", mode, "-k", str(k), "-o",
                      str(tmp / g), *files])
            jax_main(["annotate", "-i", str(tmp / f"{g}.dbg"),
                      "--anno-header", "--count-kmers", "-o",
                      str(tmp / f"{g}a"), *files])
        jax_main(["annotate", "-i", str(tmp / "g15.dbg"), "--coordinates",
                  "--index-header-coords", "-o", str(tmp / "g15s"), *files])
    return tmp


ROUTES = {"wire": ("g15", "g15a"), "codes": ("g33", "g33a"),
          "map": ("c33", "c33a"), "seqs": ("g15", "g15s")}
FLAGS = (["-p", "2"], ["--parallel-each", "3"], ["-p", "1"])


def test_parallel_prints_the_jax_bytes(par_index):
    """-p 2 and --parallel-each 3 (and -p 1, the sequential run) on every
    route, 400 bp batches: the JAX CLI's bytes, and the same bytes for all
    three flags."""
    from metagraph_tpu.cli.main import main as jax_main
    tmp = par_index
    lines = [["query", "-i", str(tmp / f"{g}.dbg"), "-a",
              str(tmp / f"{a}.column.annodbg"), "--query-mode", mode,
              "--batch-size", "400", *flag, "--device", str(tmp / "q.fa")]
             for g, a in ROUTES.values() for mode in ("labels", "counts")
             for flag in FLAGS]
    spec, res = tmp / "lines.json", tmp / "out.json"
    spec.write_text(json.dumps([a + ["--torch-device", "cpu"]
                                for a in lines]))
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", RUNNER, str(spec), str(res)],
                         capture_output=True, env=env, cwd=str(tmp),
                         timeout=600)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    got = json.loads(res.read_text())
    for i, args in enumerate(lines):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jax_main(args)
        assert got[i] == [buf.getvalue(), 0], args
        assert buf.getvalue().count("\n") == 24
        assert got[i] == got[i - i % len(FLAGS)]       # as sequential
    assert len({g[0] for g in got}) >= 6


def _engine(tmp, g, a):
    from metagraph_tpu_torch.convert import load
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    return QueryEngine(load(str(tmp / f"{g}.dbg"),
                            str(tmp / f"{a}.column.annodbg")), device="cpu")


@pytest.mark.parametrize("route", ("wire", "map"))
def test_batch_seconds_are_each_batch_own(par_index, route):
    """Two batches in flight, the second finishing first: the seconds read
    as each batch's results come out are that batch's (the first one's
    payloads held 0.3 s)."""
    from metagraph_tpu_torch.seq_io.fasta import FastaRecord
    engine = _engine(par_index, *ROUTES[route])
    assert engine.route == route
    recs = [FastaRecord("a", b"ACGTTGCAAGGCTTAACCGTAGCTAGGATC" * 3),
            FastaRecord("b", b"TTGACCAGTAGGCATCCAGTACGATTAGCA")]
    second_done = threading.Event()
    payloads = engine._payloads_from_hits

    def held(*args):
        first = args[4] == [len(recs[0].seq) - engine.k + 1]
        if first:
            assert second_done.wait(60)
            time.sleep(0.3)
        out = payloads(*args)
        if not first:
            second_done.set()
        return out
    engine._payloads_from_hits = held
    it = engine.query_records(recs, "labels", batch_size_bp=1, n_threads=2)
    next(it)
    first = dict(engine.last_batch_seconds)
    next(it)
    second = dict(engine.last_batch_seconds)
    assert first["collect"] >= 0.3 > second["collect"]
    assert set(first) == set(second) == {"pack", "device", "collect"}


def test_launch_counters_exact_under_threads():
    """Eight threads add launches to one counter at once, with the
    interpreter switching threads as often as it can: none is lost."""
    from metagraph_tpu_torch import _build
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def kernel():
        pass
    kernel.launches = 0
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count(kernel, 2) for _ in range(20_000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert kernel.launches == 8 * 20_000 * 2
