"""Kernel D4's plan on the CPU (csrc/build_emit.cu runs only on the card).

* The compaction's 3-bit key: a Python emulation of the kernel's bit
  spread, with the SPREAD masks and FIELD_ONES read from the ``.cu``
  source, against ``key3_plain`` and the JAX ``_key3_from_key2`` for every
  K in 3..21 on random wire keys from a numpy seed.
* ``emit_keys_plain``: the unique rows' keys in the order of ``skeys``,
  then the dummy rows, with no sentinel row; sorted, the first U + D rows
  of the stream that the JAX ``_build_p2`` sorts (the sentinel-padded one).
* ``device_build_boss_arrays(..., device="cpu")`` (``build_p2`` on the
  compacted stream) against the JAX ``device_build_boss_arrays`` at K
  beside those of tests/test_torch_build.py.

Every comparison is exact.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metagraph_tpu.succinct import device_build as jdb
from metagraph_tpu_torch.succinct import device_build as db

from test_torch_canonical import native_lib

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "metagraph_tpu_torch", "csrc", "build_emit.cu")
MOVES = (16, 8, 4, 2, 1)


def cu_constants():
    """{name: value} of the ``constexpr u64`` hex constants of the .cu."""
    src = open(CU).read()
    return {m.group(1): int(m.group(2), 16) for m in re.finditer(
        r"constexpr u64 (\w+) = 0x([0-9A-Fa-f]+)ull;", src)}


def spread_key3(keys: np.ndarray, K: int) -> np.ndarray:
    """The kernel's ``key3``: the node's 2(K-1) low bits spread into 3-bit
    fields by five mask-and-shift steps, high to low, FIELD_ONES masked to
    K-1 fields added, the label + 1 placed at bits 0..2."""
    c = cu_constants()
    keys = keys.astype(np.uint64)
    nb = np.uint64(2 * (K - 1))
    x = keys & np.uint64((1 << (2 * (K - 1))) - 1)
    for m in MOVES:
        mask = np.uint64(c[f"SPREAD{m}"])
        x = (x & ~mask) | ((x & mask) << np.uint64(m))
    ones = np.uint64(c["FIELD_ONES"] & ((1 << (3 * (K - 1))) - 1))
    label = ((keys >> nb) & np.uint64(3)) + np.uint64(1)
    return (((x + ones) << np.uint64(3)) | label).astype(np.int64)


def test_cu_masks_are_the_spread_of_21_fields():
    """Each SPREAD mask selects the 2-bit fields j < 21 whose index has bit
    m, where the earlier (higher) moves left them; FIELD_ONES holds a 1 in
    each of 21 fields."""
    c = cu_constants()
    for m in MOVES:
        want = 0
        for j in range(21):
            if j & m:
                want |= 3 << (2 * j + (j & ~(2 * m - 1)))
        assert c[f"SPREAD{m}"] == want, m
    assert c["FIELD_ONES"] == sum(1 << (3 * j) for j in range(21))


@pytest.mark.parametrize("K", range(3, 22))
def test_spread_matches_key3_plain_and_jax(K):
    rng = np.random.default_rng([K, 16])
    keys = rng.integers(0, 1 << (2 * K), 20_000, dtype=np.int64)
    keys[:4] = [0, (1 << (2 * K)) - 1, 0x5555555555 & ((1 << (2 * K)) - 1),
                0xAAAAAAAAAA & ((1 << (2 * K)) - 1)]
    got = spread_key3(keys, K)
    want = db.key3_plain(torch.from_numpy(keys), K).numpy()
    assert np.array_equal(got, want)
    lo = jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32))
    hi = jnp.asarray((keys >> 32).astype(np.uint32))
    lo3, hi3 = jdb._key3_from_key2(lo, hi, K)
    jkeys = np.asarray(lo3).astype(np.int64) \
        | (np.asarray(hi3).astype(np.int64) << 32)
    assert np.array_equal(got, jkeys)
    assert got.max() < 1 << (3 * K)


@pytest.mark.parametrize("K", (3, 12, 21))
@pytest.mark.parametrize("share", (0.0, 0.35, 1.0))
def test_emit_keys_plain_is_the_compacted_stream(K, share):
    """The unique rows in skeys order, then the dummy rows; sorted, the
    live rows of the sentinel-padded stream sorted as the TPU sorts it."""
    rng = np.random.default_rng([K, int(share * 100)])
    n, D = 5000, 37
    skeys = torch.from_numpy(np.sort(rng.integers(0, 1 << (2 * K), n,
                                                  dtype=np.int64)))
    uniq = torch.from_numpy(rng.random(n) < share)
    U = int(uniq.sum())
    d3 = torch.from_numpy(db.host_key3(
        rng.integers(0, 5, (D, K)).astype(np.uint8), K))
    got = db.emit_keys(skeys, uniq, U, d3, K)
    assert len(got) == U + D
    assert torch.equal(got[:U], db.key3_plain(skeys[uniq], K))
    assert torch.equal(got[U:], d3)
    sent = (1 << (3 * K)) - 1
    padded = torch.cat([torch.where(uniq, db.key3_plain(skeys, K), sent),
                        d3])
    assert torch.equal(db.radix_sort(got, 3 * K)[0],
                       torch.sort(padded).values[: U + D])
    with pytest.raises(ValueError, match="unique"):
        db.emit_keys_plain(skeys, uniq, U + 1, d3, K)
    with pytest.raises(ValueError, match="unique rows of"):
        db.emit_keys(skeys, uniq, n + 1, d3, K)


@pytest.mark.parametrize("K", (4, 7, 13, 19))
def test_device_build_on_the_compacted_stream_matches_jax(K):
    assert native_lib() is not None, "the JAX native library does not load"
    rng = np.random.default_rng([K, 61])
    seqs = ["".join(rng.choice(list("ACGTN"), size=int(m),
                               p=(.24, .24, .24, .24, .04))).encode()
            for m in rng.integers(1, 700, size=30)]
    got = db.device_build_boss_arrays(seqs, K, device="cpu")
    want = jdb.device_build_boss_arrays(seqs, K)
    for f in ("W", "last", "valid", "F"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
