"""The suffix-range index (``BOSS.index_suffix_ranges``) and ``build
--index-ranges`` against the JAX package.

The port's ``index_suffix_ranges`` on a JAX-built graph's table, L = 1-4
for DNA (basic and canonical) and L = 2 for Protein, against the JAX
table's ``suf_rl``, ``suf_ru`` and ``suf_ok``; L >= the node length fails
in both.  ``build --index-ranges`` through both CLIs (npz and mmap
layouts): the same files, keys, dtypes and arrays, stderr line and exit
code; each package loads the other's index.  Then the port's ``query`` on
a graph with an index, against the JAX ``query --device``.  The port's
CLI runs with ``--torch-device cpu`` in one subprocess without JAX.
"""

import os

import numpy as np
import pytest

from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu.graph import dbg_succinct as jax_dbg
from metagraph_tpu.kmer.alphabets import ALPHABETS
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
from metagraph_tpu_torch.succinct.boss import BOSS

from torch_parity import (graph_line, jax_cli, run_jax, run_port,
                          same_build_files, write_fasta)

TABLE = [("DNA", "basic", L) for L in (1, 2, 3, 4)] \
    + [("DNA", "canonical", L) for L in (1, 2, 3, 4)] + [("Protein",
                                                          "basic", 2)]
CLI = [(L, mmap) for L in (1, 2, 3, 4) for mmap in (False, True)]


def _seqs(rng, letters, n=12):
    return ["".join(rng.choice(list(letters), size=int(m))).encode()
            for m in rng.integers(30, 400, n)]


def _port_boss(g):
    b = g.boss
    return BOSS(b.k, b.alph_size, b.W, b.last, b.F, b.valid)


@pytest.mark.parametrize("alpha,mode,L", TABLE,
                         ids=[f"{a}-{m}-L{L}" for a, m, L in TABLE])
def test_index_suffix_ranges_matches_jax(alpha, mode, L):
    rng = np.random.default_rng(183 + L)
    letters = "ACGTN" if alpha == "DNA" else "ACDEFGHIKLMNPQRSTVWYX"
    g = JaxDBG.build(_seqs(rng, letters), 9 if alpha == "DNA" else 6,
                     mode=mode, alphabet=ALPHABETS[alpha])
    mine = _port_boss(g)
    g.boss.index_suffix_ranges(L)
    mine.index_suffix_ranges(L)
    assert mine.suffix_L == g.boss.suffix_L == L
    for f in ("suf_rl", "suf_ru", "suf_ok"):
        a, b = getattr(mine, f), getattr(g.boss, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    A = g.boss.alph_size
    assert len(mine.suf_ok) == (A - 1) ** L and mine.suf_ok.any()
    # L = 0 drops the index, as in JAX
    mine.index_suffix_ranges(0)
    assert mine.suffix_L == 0 and mine.suf_rl is None


def test_index_past_the_node_length_fails_as_jax():
    g = JaxDBG.build([b"ACGTACGGTCA"], 5)
    mine = _port_boss(g)
    with pytest.raises(AssertionError) as want:
        g.boss.index_suffix_ranges(4)
    with pytest.raises(AssertionError) as got:
        mine.index_suffix_ranges(4)
    assert str(got.value) == str(want.value)


def test_range_widths_count_the_nodes_with_the_suffix():
    """A live combo's range holds exactly the nodes whose last L
    characters are the combo (counted here from the decoded nodes)."""
    rng = np.random.default_rng(184)
    g = JaxDBG.build(_seqs(rng, "ACGT", 20), 11)
    mine = _port_boss(g)
    L = 3
    mine.index_suffix_ranges(L)
    edges = np.flatnonzero(mine.last)[1:]     # each node's last edge
    seq = g.boss.get_node_seq(edges)          # decoded by the JAX table
    tail = seq[:, -L:].astype(np.int64)
    real = (tail >= 1).all(axis=1)
    combo = ((tail[real] - 1) * 4 ** np.arange(L)).sum(axis=1)
    want = np.bincount(combo, minlength=4 ** L)
    cum = np.concatenate([[0], np.cumsum(mine.last.astype(np.int64))])
    width = np.where(mine.suf_ok == 1,
                     cum[mine.suf_ru + 1] - cum[mine.suf_rl], 0)
    assert np.array_equal(width, want) and want.sum() > 100


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("index_ranges")
    rng = np.random.default_rng(185)
    refs = [s.decode() for s in _seqs(rng, "ACGT", 8)]
    write_fasta(tmp / "in.fa", [(f"r{i}", s) for i, s in enumerate(refs)])
    write_fasta(tmp / "q.fa", [(f"q{i}", s[7:90]) for i, s in
                               enumerate(refs) if len(s) > 100])
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        jax_out, lines, keys = {}, [], []
        for L, mmap in CLI:
            flags = ["-k", "13", "--index-ranges", str(L)] \
                + (["--mmap"] if mmap else [])
            tag = f"L{L}" + ("-mmap" if mmap else "")
            jax_out[(L, mmap)] = run_jax(["build", *flags, "-o", f"j-{tag}",
                                          "in.fa"], stderr=True)
            jax_dbg.DEFAULT_MMAP = False
            lines.append(["build", "-v", *flags, "-o", f"p-{tag}", "in.fa"])
            keys.append((L, mmap))
        jax_cli("annotate", "-i", "j-L3.dbg", "--anno-header", "-o", "anno",
                "in.fa")
        query = ["-a", "anno.column.annodbg", "--device", "q.fa"]
        jax_out["query"] = run_jax(["query", "-i", "j-L3.dbg", *query],
                                   stderr=True)
        lines.append(["query", "-i", "p-L3.dbg", *query])
        keys.append("query")
        got = run_port(tmp, lines, stderr=True)
    finally:
        os.chdir(cwd)
        jax_dbg.DEFAULT_MMAP = False
    return dict(tmp=tmp, jax=jax_out, port=dict(zip(keys, got)))


@pytest.mark.parametrize("L,mmap", CLI, ids=[f"L{L}" + ("-mmap" if m else "")
                                             for L, m in CLI])
def test_build_index_ranges_matches_jax(runs, L, mmap):
    want, got = runs["jax"][(L, mmap)], runs["port"][(L, mmap)]
    assert got[:3] == want[:3] == ["", 0, None], (got, want)
    assert graph_line(got[3]) == graph_line(want[3]) != []
    assert any("index suffix ranges" in ln for ln in got[3].splitlines())
    tag = f"L{L}" + ("-mmap" if mmap else "")
    tmp = runs["tmp"]
    same_build_files(tmp, f"p-{tag}", f"j-{tag}", mmap)
    for path in (f"p-{tag}.dbg", f"j-{tag}.dbg"):
        g = DBGSuccinct.load(str(tmp / path), mmap=mmap)
        ref = JaxDBG.load(str(tmp / path), mmap=mmap)
        assert g.boss.suffix_L == ref.boss.suffix_L == L
        for f in ("suf_rl", "suf_ru", "suf_ok"):
            assert np.array_equal(getattr(g.boss, f), getattr(ref.boss, f))


def test_query_on_a_graph_with_an_index(runs):
    want, got = runs["jax"]["query"], runs["port"]["query"]
    assert got[:3] == want[:3] and want[1] == 0 and want[2] is None
    assert want[0].count("\n") >= 5
