"""The port's hash index and kernel 1 against metagraph_tpu/succinct/ops.py.

Same inputs, made from numpy seeds, go through the JAX function and its
counterpart in metagraph_tpu_torch; every comparison is exact (integers).
On the CPU the port runs the plain PyTorch versions of its kernels
(tests/test_torch_gpu.py holds the CUDA kernels against them on the card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagraph_tpu.succinct import ops as jops
from metagraph_tpu_torch._u32 import np_words, to_u64, words_np
from metagraph_tpu_torch.query.device import TILE
from metagraph_tpu_torch.succinct import ops as tops

KS = (2, 15, 16, 17, 31)


def _chars(rng, n, K):
    return rng.integers(1, 5, (n, K)).astype(np.uint8)


def _u64(a: np.ndarray) -> torch.Tensor:
    return to_u64(np_words(a))


@pytest.mark.parametrize("K", KS)
def test_packers_match(K):
    rng = np.random.default_rng(K)
    chars = _chars(rng, 300, K)
    np.testing.assert_array_equal(tops.pack_kmers32(chars),
                                  jops.pack_kmers32(chars))
    np.testing.assert_array_equal(tops.pack_codes32(chars),
                                  jops.pack_codes32(chars))
    np.testing.assert_array_equal(tops.pack_kmers2(chars),
                                  jops.pack_kmers2(chars))


@pytest.mark.parametrize("K", KS)
def test_hash_words_match(K):
    rng = np.random.default_rng(100 + K)
    keys = jops.pack_kmers32(_chars(rng, 500, K))
    for nb in (2, 1 << 10, 12345):
        want = jops._hash_words(keys, nb, 1)
        np.testing.assert_array_equal(tops._hash_words(keys, nb, 1), want)
        got = tops._hash_words(_u64(keys), nb, 1)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", KS)
def test_hash_table_bytes_match(K):
    rng = np.random.default_rng(200 + K)
    chars = np.unique(_chars(rng, 2000, K), axis=0)
    keys = jops.pack_kmers32(chars)
    ids = rng.permutation(len(keys)).astype(np.uint32) + 1
    want = np.asarray(jops.DeviceHashIndex.from_packed(keys, ids).table)
    got = tops.DeviceHashIndex.build_table(keys, ids)
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    idx = tops.DeviceHashIndex.from_table(got, "cpu")
    assert words_np(idx.table).tobytes() == want.tobytes()


def _wire_stream(rng, C, NW, NV, p_valid=0.97):
    words = rng.integers(0, 2 ** 32, (C, NW), dtype=np.uint64) \
        .astype(np.uint32)
    bits = rng.random((C, NV * 32)) < p_valid
    vwords = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    return words, np.ascontiguousarray(vwords)


@pytest.mark.parametrize("K", KS)
def test_window_ops_match(K):
    rng = np.random.default_rng(300 + K)
    T = 64
    words, vwords = _wire_stream(rng, 5, T // 16 + 3, T // 32 + 1)
    want = np.asarray(jops.extract_windows2(jnp.asarray(words), K, T))
    got = tops.extract_windows2(_u64(words), K, T)
    np.testing.assert_array_equal(got.numpy(), want)
    want_v = np.asarray(jops.window_valid2(jnp.asarray(vwords), K, T))
    got_v = tops.window_valid2(_u64(vwords), K, T)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    keys2 = jops.pack_kmers2(_chars(rng, 257, K))
    want4 = np.asarray(jops.keys2_to_keys4(jnp.asarray(keys2), K))
    np.testing.assert_array_equal(tops.keys2_to_keys4(_u64(keys2), K).numpy(),
                                  want4)


def _index_and_stream(K, seed, T=TILE, C=6):
    """A hash index over the k-mers of random reads, and a wire stream of
    tiles cut from those reads (so most windows hit)."""
    rng = np.random.default_rng(seed)
    TK = T + K - 1
    codes = rng.integers(0, 4, (C, TK + 3)).astype(np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(codes[:, :TK], K, axis=1)
    chars = np.unique(win.reshape(-1, K)[::2] + 1, axis=0)
    keys = jops.pack_kmers32(chars)
    ids = np.arange(1, len(keys) + 1, dtype=np.uint32)
    table = np.asarray(jops.DeviceHashIndex.from_packed(keys, ids).table)
    packed = np.zeros((C, -(-TK // 4) * 4), np.uint8)
    packed[:, :TK] = codes[:, :TK]
    p2 = (packed[:, 0::4] | packed[:, 1::4] << 2 | packed[:, 2::4] << 4
          | packed[:, 3::4] << 6)
    valid = rng.random((C, TK)) < 0.995
    vb = np.packbits(valid, axis=1, bitorder="little")
    from metagraph_tpu_torch.query.device import wire_words_layout
    words, vwords = wire_words_layout(p2, vb, K, T, C)
    return table, words, vwords


@pytest.mark.parametrize("K", KS)
def test_hash_lookup_matches(K):
    table, words, _ = _index_and_stream(K, 400 + K)
    keys2 = jops.extract_windows2(jnp.asarray(words), K, TILE).reshape(-1, 2)
    q4 = np.asarray(jops.keys2_to_keys4(keys2, K))
    W = q4.shape[1]
    want = np.asarray(jops._hash_lookup_flat(jnp.asarray(table),
                                             jnp.asarray(q4), W))
    got = tops._hash_lookup_flat(np_words(table), _u64(q4), W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.3


@pytest.mark.parametrize("K", KS)
def test_wire_lookup_matches_jax(K):
    """Kernel 1's contract: the JAX wire epoch's lookup stage (funnel-shift
    keys, sliding valid AND, nibble repack, one bucket probe)."""
    table, words, vwords = _index_and_stream(K, 500 + K)
    C = len(words)
    keys2 = jops.extract_windows2(jnp.asarray(words), K, TILE)
    valid = jops.window_valid2(jnp.asarray(vwords), K, TILE)
    nodes = jops._hash_lookup(jnp.asarray(table),
                              jops.keys2_to_keys4(keys2.reshape(-1, 2), K))
    want = np.where(np.asarray(valid), np.asarray(nodes).reshape(C, TILE), 0)
    got = tops.wire_lookup(np_words(words), np_words(vwords),
                           np_words(table), K, TILE)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tops.wire_lookup.launches == 0       # the CPU runs no kernel


def test_tile_pack_matches_native():
    from metagraph_tpu import native
    from metagraph_tpu_torch.query.tile_pack import tile_pack2
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(7)
    alphabet = list("ACGTNacgtnUuRY")
    seqs = ["".join(rng.choice(alphabet, size=int(n))).encode()
            for n in rng.integers(0, 900, size=40)]
    seqs += [b"", b"ACGT", b"A" * 300]
    for K, T in ((17, TILE), (31, TILE), (2, 32), (16, 64)):
        want = native.tile_pack2(seqs, K, T)
        got = tile_pack2(seqs, K, T)
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]
