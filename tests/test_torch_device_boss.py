"""The port's DeviceBOSS (kernels K2 and K3's plain versions on the CPU)
against metagraph_tpu/succinct/ops.py's DeviceBOSS.

Each graph is built once by the JAX package; the port's table holds the
same arrays (its own BOSS over them).  Same inputs, made from numpy seeds,
go through both; every comparison is exact.  tests/test_torch_gpu.py holds
K2 and K3 against their plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JDBG
from metagraph_tpu.kmer.alphabets import PROTEIN
from metagraph_tpu.kmer.extractor import KmerExtractor
from metagraph_tpu.succinct import ops as jops
from metagraph_tpu.succinct.boss import BOSS as JBOSS
from metagraph_tpu.succinct.construct import BossArrays
from metagraph_tpu_torch.succinct import ops as tops
from metagraph_tpu_torch.succinct.boss import BOSS as TBOSS

GRAPHS = ("dna2", "dna15", "dna31", "protein")


def _seqs(rng, alphabet, n, length):
    return ["".join(rng.choice(list(alphabet), size=length)).encode()
            for _ in range(n)]


def _build(name):
    rng = np.random.default_rng(len(name))
    if name == "protein":
        return JDBG.build(_seqs(rng, "ACDEFGHIKLMNPQRSTVWY", 4, 300), 6,
                          alphabet=PROTEIN)
    k = int(name[3:])
    return JDBG.build(_seqs(rng, "ACGT", 5, 400), k)


_CACHE = {}


def _tables(name):
    """-> (JAX graph, JAX DeviceBOSS, the port's DeviceBOSS on the CPU)."""
    if name not in _CACHE:
        g = _build(name)
        b = g.boss
        tb = TBOSS(b.k, b.alph_size, b.W, b.last, b.F, b.valid)
        _CACHE[name] = (g, jops.DeviceBOSS.from_host(b),
                        tops.DeviceBOSS.from_host(tb, device="cpu"))
    return _CACHE[name]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("name", GRAPHS)
def test_from_host_arrays(name):
    _, jd, td = _tables(name)
    for f in ("W_blocks", "cum_W", "last_blocks", "cum_last", "F", "NF",
              "valid"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    assert (td.M, td.alph, td.k) == (jd.M, jd.alph, jd.k)


def _rank_positions(M, rng):
    """0, M - 1, the block edges 127 and 128 (and each block's ends), and
    random places."""
    edges = np.arange(0, M, 128)
    pos = np.concatenate([[0, M - 1, 127, 128, 255, 256], edges,
                          np.maximum(edges - 1, 0), rng.integers(0, M, 300)])
    return pos[pos < M]


@pytest.mark.parametrize("name", GRAPHS)
def test_rank_select(name):
    g, jd, td = _tables(name)
    hb = g.boss
    rng = np.random.default_rng(7)
    M, A2 = len(hb.W), 2 * hb.alph_size
    ii = _rank_positions(M, rng)
    cc = rng.integers(0, A2, len(ii))
    np.testing.assert_array_equal(
        td.rank_W(_t(ii), _t(cc)).numpy(),
        np.asarray(jax.jit(jd.rank_W)(_j(ii), _j(cc))))
    np.testing.assert_array_equal(td.rank_W(_t(ii), _t(cc)).numpy(),
                                  hb.rank_W(ii, cc))
    np.testing.assert_array_equal(
        td.rank_last(_t(ii)).numpy(),
        np.asarray(jax.jit(jd.rank_last)(_j(ii))))
    # select_last at r <= 0, every rank, and past the last set bit
    n1 = int(hb.last.sum())
    rr = np.concatenate([[-3, -1, 0], np.arange(1, n1 + 1),
                         [n1 + 1, n1 + 2, n1 + 130]])
    got = td.select_last(_t(rr)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(jd.select_last)(_j(rr))))
    inside = (rr >= 0) & (rr <= n1)
    np.testing.assert_array_equal(got[inside], hb.select_last(rr[inside]))
    # select_W for every value, its ranks and one past the last
    for c in range(A2):
        cnt = int((hb.W == c).sum()) - (1 if c == 0 else 0)
        r = np.arange(1, cnt + 2)
        cv = np.full_like(r, c)
        got = td.select_W(_t(cv), _t(r)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax.jit(jd.select_W)(_j(cv), _j(r))),
            err_msg=f"select_W c={c}")
        if cnt:
            np.testing.assert_array_equal(got[:-1],
                                          hb.select_W(cv[:-1], r[:-1]))


def _kmer_rows(name, g, rng, n=600):
    """(n, k + 1) int32 edge strings: present edges, random strings (mostly
    absent), strings with a code outside the alphabet, and last codes 0
    and >= alph."""
    hb = g.boss
    K1 = hb.k + 1
    A = hb.alph_size
    ve = np.flatnonzero(hb.valid)
    present = hb.get_edge_seq(ve[rng.integers(0, len(ve), n // 3)])
    rand = rng.integers(1, A, (n // 3, K1))
    bad = hb.get_edge_seq(ve[rng.integers(0, len(ve), n // 3)]).astype(
        np.int64)
    bad[np.arange(len(bad)), rng.integers(0, K1, len(bad))] = \
        rng.integers(A, A + 3, len(bad))
    bad[::5, -1] = 0
    return np.concatenate([present, rand, bad]).astype(np.int32)


@pytest.mark.parametrize("name", GRAPHS)
def test_index_and_map_kmers(name):
    g, jd, td = _tables(name)
    rng = np.random.default_rng(11)
    rows = _kmer_rows(name, g, rng)
    got = td.map_kmers(_t(rows)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(jd.map_kmers)(_j(rows))))
    np.testing.assert_array_equal(got, g.boss.map_to_edges_batch(rows))
    assert (got[: len(rows) // 3] > 0).all()
    nodes = rows[:, :-1]
    np.testing.assert_array_equal(
        td.index(_t(nodes)).numpy(),
        np.asarray(jax.jit(jd.index)(_j(nodes))))
    # pick_edge on nodes' last edges, labels 0 .. alph + 1
    edges = td.index(_t(nodes)).numpy()
    lab = rng.integers(0, g.boss.alph_size + 2, len(edges))
    np.testing.assert_array_equal(
        td.pick_edge(_t(edges), _t(lab)).numpy(),
        np.asarray(jax.jit(jd.pick_edge)(_j(edges), _j(lab))))


def test_map_sequence_matches_host():
    """Every window of one of the graph's input sequences, and of a random
    one, maps to the host BOSS's edges."""
    g, jd, td = _tables("dna15")
    ex = KmerExtractor()
    seq = _seqs(np.random.default_rng(len("dna15")), "ACGT", 5, 400)[2]
    rand = _seqs(np.random.default_rng(3), "ACGT", 1, 300)[0]
    for s in (seq, rand):
        codes = ex.encode(s).astype(np.int32)
        wins = np.lib.stride_tricks.sliding_window_view(codes, g.boss.k + 1)
        np.testing.assert_array_equal(td.map_kmers(_t(wins)).numpy(),
                                      g.boss.map_sequence(ex.encode(s)))
    assert (td.map_kmers(_t(np.lib.stride_tricks.sliding_window_view(
        ex.encode(seq).astype(np.int32), g.boss.k + 1))).numpy() > 0).all()


def test_dense_last_block():
    """A 128-block of all-1 last bits must not overflow int8 (the JAX
    test_dense_last_block's synthetic table)."""
    M = 512
    last = np.ones(M, dtype=np.uint8)
    last[0] = 0
    W = np.ones(M, dtype=np.uint8)
    W[0] = 0
    arr = BossArrays(k=3, alph_size=5, W=W, last=last,
                     F=np.zeros(5, dtype=np.int64),
                     valid=np.ones(M, dtype=np.uint8))
    jd = jops.DeviceBOSS.from_host(JBOSS(arr))
    td = tops.DeviceBOSS.from_host(
        TBOSS(3, 5, W, last, np.zeros(5, np.int64), np.ones(M, np.uint8)),
        device="cpu")
    r = np.arange(-1, int(last.sum()) + 3)
    np.testing.assert_array_equal(
        td.select_last(_t(r)).numpy(),
        np.asarray(jax.jit(jd.select_last)(_j(r))))
    i = np.arange(M)
    np.testing.assert_array_equal(
        td.rank_last(_t(i)).numpy(),
        np.asarray(jax.jit(jd.rank_last)(_j(i))))


def test_wrappers_check_inputs():
    _, _, td = _tables("dna2")
    with pytest.raises(ValueError):
        td.rank_W(_t([1, 2]), _t([1]))
    with pytest.raises(ValueError):
        tops.boss_rank_select(td, "select_W", _t([1]))
    with pytest.raises(ValueError):
        td.map_kmers(_t(np.ones((3, 1))))
    before = (tops.boss_map.launches, tops.boss_rank_select.launches)
    td.map_kmers(_t(np.ones((3, 3))))
    td.rank_last(_t([0, 1]))
    assert (tops.boss_map.launches, tops.boss_rank_select.launches) == before
