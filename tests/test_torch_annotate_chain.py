"""The whole annotation chain on each side gives the same query bytes.

From the same seeded references and reads, the port's chain (``build``
-> ``annotate`` -> ``transform_anno`` -> ``query``, all through its CLI
with ``--torch-device cpu`` in one subprocess without JAX) and the JAX
CLI's own chain (in this process, ``query --device``) must print the
same stdout and exit with the same code, for basic, canonical and
primary graphs, on the column annotation and its ``brwt``,
``row_diff_brwt`` (unstaged and staged) and ``int_brwt`` conversions, in
the labels, matches and counts modes; and with a budget of 0 bytes
(``METAGRAPH_DENSE_ANNO_BUDGET``) a ``brwt`` beside the ``devsparse``
file that ``transform_anno`` wrote for it, which both queries read.
"""

import os

import numpy as np
import pytest

from torch_parity import (jax_cli, references_and_reads, run_jax, run_port,
                          write_fasta)

K = 17
MODES = ("basic", "canonical", "primary")
# case -> (graph mode, annotation file under the side's directory, query
# flags)
CASES = {}
for m in MODES:
    CASES[f"{m}-column"] = (m, "a.column.annodbg", [])
    CASES[f"{m}-brwt"] = (m, "b.brwt.annodbg", ["--query-mode", "matches"])
    CASES[f"{m}-row_diff_brwt"] = (m, "r.row_diff_brwt.annodbg", [])
CASES.update({
    "basic-staged": ("basic", "s.row_diff_brwt.annodbg",
                     ["--query-mode", "matches"]),
    "basic-counts": ("basic", "v.column.annodbg",
                     ["--query-mode", "counts"]),
    "basic-int_brwt": ("basic", "i.int_brwt.annodbg",
                       ["--query-mode", "counts"]),
})


def _chain(side, d, fa, mode):
    """Command lines of one side's chain in directory ``d``."""
    g = os.path.join(d, "g")
    lines = [["build", "-k", K, "--mode", mode, "-o", g, fa]]
    a = ["annotate", "-i", g + ".dbg"]
    lines += [a + ["--anno-header", "-o", os.path.join(d, "a"), fa],
              a + ["--anno-header", "--count-kmers", "-o",
                   os.path.join(d, "v"), fa]]
    col = os.path.join(d, "a.column.annodbg")
    t = ["transform_anno", "-i", g + ".dbg"]
    for name, target in (("b", "brwt"), ("r", "row_diff_brwt")):
        lines.append(t + ["--anno-type", target, "-o",
                          os.path.join(d, name), col])
    lines.append(t + ["--anno-type", "int_brwt", "-o", os.path.join(d, "i"),
                      os.path.join(d, "v.column.annodbg")])
    for stage in (0, 1, 2):
        lines.append(t + ["--anno-type", "row_diff_brwt", "--row-diff-stage",
                          str(stage), "-o", os.path.join(d, "s"), col])
    lines.append(["transform_anno", "--anno-type", "devsparse", "-o",
                  os.path.join(d, "b.brwt.annodbg.devsparse"), col])
    return [[str(x) for x in line] for line in lines]


def _query(d, case, reads):
    mode, anno, flags = CASES[case]
    return ["query", "-i", os.path.join(d, mode, "g.dbg"), "-a",
            os.path.join(d, mode, anno), *flags, str(reads)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("annotate_chain")
    rng = np.random.default_rng(26)
    refs, reads = references_and_reads(rng, n_refs=6, length=(150, 320))
    write_fasta(tmp / "refs.fa", [(f"ref{i}", s) for i, s in
                                  enumerate(refs)])
    write_fasta(tmp / "q.fa", [(f"q{i}", s) for i, s in enumerate(reads)])
    port_lines = []
    for side in ("jax", "port"):
        for m in MODES:
            d = tmp / side / m
            os.makedirs(d)
            lines = _chain(side, str(d), str(tmp / "refs.fa"), m)
            if side == "jax":
                for line in lines:
                    jax_cli(*line)
            else:
                port_lines += lines
    queries = [_query(str(tmp / "port"), c, tmp / "q.fa") for c in CASES]
    got = run_port(tmp, port_lines + queries)
    assert all(g[1] == 0 and g[2] is None for g in got[:len(port_lines)])
    port = dict(zip(CASES, got[len(port_lines):]))
    # the block-sparse route, from the devsparse file beside the brwt
    old = os.environ.get("METAGRAPH_DENSE_ANNO_BUDGET")
    os.environ["METAGRAPH_DENSE_ANNO_BUDGET"] = "0"
    try:
        sparse = {m: _query(str(tmp / "port"), f"{m}-brwt", tmp / "q.fa")
                  for m in MODES}
        port.update({f"{m}-devsparse": r for m, r in zip(
            MODES, run_port(tmp, list(sparse.values())))})
        jax = {f"{m}-devsparse": run_jax(
            _query(str(tmp / "jax"), f"{m}-brwt", tmp / "q.fa")
            + ["--device"]) for m in MODES}
    finally:
        if old is None:
            del os.environ["METAGRAPH_DENSE_ANNO_BUDGET"]
        else:
            os.environ["METAGRAPH_DENSE_ANNO_BUDGET"] = old
    return tmp, port, jax


@pytest.mark.parametrize("case", list(CASES) + [f"{m}-devsparse"
                                                for m in MODES])
def test_chain_query_bytes_match_jax(runs, case):
    tmp, port, jax = runs
    if case in jax:
        want = jax[case]
    else:
        want = run_jax(_query(str(tmp / "jax"), case, tmp / "q.fa")
                       + ["--device"])
    got = port[case]
    assert want[1] == 0 and want[0].count("\n") > 5
    assert got == want
