"""The port's DeviceKmerIndex (kernel K1's plain version on the CPU)
against metagraph_tpu/succinct/ops.py's DeviceKmerIndex and _kmer_lookup.

Same inputs, made from numpy seeds, go through both; every comparison is
exact (integer ids).  tests/test_torch_gpu.py holds K1 against its plain
version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JDBG
from metagraph_tpu.kmer.extractor import KmerExtractor
from metagraph_tpu.succinct import ops as jops
from metagraph_tpu_torch._u32 import np_words
from metagraph_tpu_torch.succinct import ops as tops


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGT"), size=500)).encode()
            for _ in range(5)]
    return JDBG.build(seqs, 11), seqs


def _jax_lookup(keys, ids, q):
    return np.asarray(jops._kmer_lookup(jnp.asarray(keys),
                                        jnp.asarray(ids, jnp.int32),
                                        jnp.asarray(q)))


def _port_lookup(keys, ids, q):
    return tops.kmer_lookup(np_words(keys), torch.from_numpy(
        np.ascontiguousarray(ids, np.int32)), np_words(q)).numpy()


def test_hits_match_jax_and_host(graph):
    g, seqs = graph
    ve = np.flatnonzero(g.boss.valid)
    chars = g.boss.get_edge_seq(ve)
    jidx = jops.DeviceKmerIndex.from_host(chars, ve)
    tidx = tops.DeviceKmerIndex.from_host(chars, ve, device="cpu")
    np.testing.assert_array_equal(tidx.keys.numpy().view(np.uint32),
                                  np.asarray(jidx.keys))
    np.testing.assert_array_equal(tidx.ids.numpy(), np.asarray(jidx.ids))
    ex = KmerExtractor()
    for s in seqs[:2]:
        codes = ex.encode(s)
        wins = np.lib.stride_tricks.sliding_window_view(codes, 11)
        q = tops.pack_kmers32(wins.astype(np.uint8))
        got = tidx.lookup(np_words(q)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jidx.lookup(
            jnp.asarray(q))))
        np.testing.assert_array_equal(got, g.boss.map_sequence(codes))


def test_misses_and_unsorted_input(graph):
    """Keys given out of order (the from_host lexsort), queries half
    absent (random codes), half present."""
    g, _ = graph
    rng = np.random.default_rng(5)
    ve = np.flatnonzero(g.boss.valid)
    perm = rng.permutation(len(ve))
    chars = g.boss.get_edge_seq(ve)[perm]
    jidx = jops.DeviceKmerIndex.from_host(chars, ve[perm])
    tidx = tops.DeviceKmerIndex.from_host(chars, ve[perm], device="cpu")
    q = np.concatenate([tops.pack_kmers32(chars[:200]), tops.pack_kmers32(
        rng.integers(1, 5, (200, 11)).astype(np.uint8))])
    got = tidx.lookup(np_words(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jidx.lookup(
        jnp.asarray(q))))
    assert (got[:200] > 0).all() and (got[200:] == 0).mean() > 0.9


@pytest.mark.parametrize("W", range(1, 9))
def test_word_widths(W):
    """W32 from 1 to 8: sorted random keys with duplicates and the all-ones
    key, queries of hits, near misses (a word off by one) and the all-ones
    and all-zero rows."""
    rng = np.random.default_rng(100 + W)
    N = 257
    keys = rng.integers(0, 6, (N, W)).astype(np.uint32) << np.uint32(29)
    keys[:, -1] |= rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(
        np.uint32)
    keys[-1] = np.uint32(0xFFFFFFFF)
    keys = keys[np.lexsort(tuple(keys[:, w] for w in range(W - 1, -1, -1)))]
    ids = rng.integers(1, 2 ** 31 - 1, N).astype(np.int32)
    near = keys[rng.integers(0, N, 100)].copy()
    near[:, -1] += np.uint32(1)
    q = np.concatenate([keys[rng.integers(0, N, 100)], near,
                        np.full((1, W), 0xFFFFFFFF, np.uint32),
                        np.zeros((1, W), np.uint32)])
    np.testing.assert_array_equal(_port_lookup(keys, ids, q),
                                  _jax_lookup(keys, ids, q))


@pytest.mark.parametrize("W", [1, 4])
def test_one_key(W):
    keys = np.full((1, W), 7, np.uint32)
    ids = np.array([42], np.int32)
    q = np.stack([keys[0], keys[0] + np.uint32(1), keys[0] - np.uint32(1)])
    got = _port_lookup(keys, ids, q)
    np.testing.assert_array_equal(got, _jax_lookup(keys, ids, q))
    np.testing.assert_array_equal(got, [42, 0, 0])


def test_empty_index_answers_zero():
    """N = 0: JAX's gather refuses an empty table; the port gives 0 to
    every query, the answer of JAX's found test (lo < N is false)."""
    keys = np.zeros((0, 2), np.uint32)
    q = np.arange(6, dtype=np.uint32).reshape(3, 2)
    np.testing.assert_array_equal(
        _port_lookup(keys, np.zeros(0, np.int32), q), [0, 0, 0])


def test_cpu_wrapper_counts_no_launch(graph):
    g, _ = graph
    ve = np.flatnonzero(g.boss.valid)
    idx = tops.DeviceKmerIndex.from_host(g.boss.get_edge_seq(ve), ve,
                                         device="cpu")
    before = tops.kmer_lookup.launches
    idx.lookup(idx.keys[:10].contiguous())
    assert tops.kmer_lookup.launches == before
    with pytest.raises(ValueError):
        tops.kmer_lookup(idx.keys, idx.ids, idx.keys[:, :1].contiguous())


def test_tables_need_cuda_unless_asked(graph, monkeypatch):
    """from_host puts the tables on the card unless the caller asks for the
    CPU; without a card it raises."""
    g, _ = graph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ve = np.flatnonzero(g.boss.valid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.DeviceKmerIndex.from_host(g.boss.get_edge_seq(ve), ve)
    from metagraph_tpu_torch.succinct.boss import BOSS as TBOSS
    b = g.boss
    tb = TBOSS(b.k, b.alph_size, b.W, b.last, b.F, b.valid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.DeviceBOSS.from_host(tb)
