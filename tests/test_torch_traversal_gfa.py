"""The port's BOSS traversal (graph/traversal.py ``call_paths``) and
``align -o *.gfa`` against the JAX package's.

``call_paths`` on graphs the JAX CLI builds from seeded random references
(basic, canonical and primary DNA at k = 7 and k = 11, with repeats,
shared stretches and a tandem cycle), as the JAX function's unitigs with
sentinel trimming: the same paths and sequences in the same order.  The
GFA branch of ``align`` through the JAX CLI and the port's
(``--torch-device cpu``, in one subprocess without JAX), each writing its
own ``.path.gfa``: the same stdout, exit code and file bytes, with and
without ``--compacted``, and a missing read file reported as the JAX CLI
reports it.
"""

import numpy as np
import pytest

from metagraph_tpu.graph import traversal as jt
from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu_torch.graph import traversal as tt
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
from torch_parity import (jax_cli, mosaic_references, reads_from, run_jax,
                          run_port, write_fasta)

MODES = ("basic", "canonical", "primary")


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traversal_gfa")
    rng = np.random.default_rng(17)
    refs = mosaic_references(rng, n_refs=10, n_blocks=8, per_ref=3)
    refs += [refs[0][:50] * 3, "".join(rng.choice(list("ACGT"), 90))]
    write_fasta(tmp / "r.fa", [(f"ref{i}", s) for i, s in enumerate(refs)])
    reads = reads_from(rng, refs, 14) + [refs[1][:30] + "NNN" + refs[1][40:90],
                                         refs[2][:8], ""]
    write_fasta(tmp / "q.fa", [(f"q{i}", s) for i, s in enumerate(reads)])
    for mode in MODES:
        jax_cli("build", "-k", "11", "--mode", mode, "-o", tmp / mode,
                tmp / "r.fa")
        jax_cli("build", "-k", "7", "--mode", mode, "-o", tmp / f"{mode}7",
                tmp / "r.fa")
    return tmp


def paths(res):
    return [([int(x) for x in p], [int(x) for x in s]) for p, s in res]


@pytest.mark.parametrize("k", ["", "7"], ids=["k11", "k7"])
@pytest.mark.parametrize("mode", MODES)
def test_call_paths_equal_jax(graphs, mode, k):
    path = str(graphs / f"{mode}{k}.dbg")
    want = jt.call_paths(JaxDBG.load(path).boss, True, False, True)
    got = tt.call_paths(DBGSuccinct.load(path).boss)
    assert paths(got) == paths(want) and len(want) > 5


GFA_CASES = [f"{mode}{c}" for mode in MODES for c in ("", "-compacted")] \
    + ["missing-reads"]


@pytest.fixture(scope="module")
def gfa_runs(graphs):
    """Each case's line through the port's CLI (all in one subprocess) and
    the JAX CLI, each side writing ``<side>/<case>.path.gfa``."""
    tmp = graphs
    lines = {}
    for case in GFA_CASES:
        missing = case == "missing-reads"
        mode = "basic" if missing else case.split("-")[0]
        flags = ["--compacted"] if case.endswith("-compacted") else []
        reads = tmp / ("none.fa" if missing else "q.fa")
        lines[case] = ["align", "-i", tmp / f"{mode}.dbg", *flags, "-o",
                       f"{{side}}/{case}.gfa", reads]
    for side in ("port", "jax"):
        (tmp / side).mkdir()
    got = run_port(tmp, [[str(a).format(side=tmp / "port") for a in line]
                         for line in lines.values()], stderr=True)
    return tmp, lines, dict(zip(lines, got))


@pytest.mark.parametrize("case", GFA_CASES)
def test_gfa_equal_jax(gfa_runs, case):
    tmp, lines, got = gfa_runs
    want = run_jax([str(a).format(side=tmp / "jax") for a in lines[case]],
                   stderr=True)
    got = got[case]
    assert got[:3] == want[:3]
    files = [tmp / side / f"{case}.path.gfa" for side in ("port", "jax")]
    if case == "missing-reads":
        err = [ln for ln in want[3].splitlines() if ln.startswith("[error]")]
        assert want[1] == 1 and err and err[-1] in got[3]
        # both open their file before they read the reads
        assert [f.read_bytes() for f in files] == [b"", b""]
        return
    assert want[1] == 0
    assert got[3] == f"wrote {files[0]}\n" and want[3] == f"wrote {files[1]}\n"
    port, jax = (f.read_bytes() for f in files)
    assert port == jax and jax.startswith(b"P\t1\t") and jax.count(b"\n") >= 14
