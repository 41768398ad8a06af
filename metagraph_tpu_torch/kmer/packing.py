"""The BOSS comparison order of k-mer characters, the key code width and
the uint64 row packing of the host construction.

Own copy of the parts of metagraph_tpu/kmer/packing.py the port uses:
``boss_priority_order``, ``colex_priority_order`` (:27-34),
``pack_codes`` (:37-66, numpy only: the JAX package's native row packer
gives the same words) and ``_void_view`` (:122-125).
"""

from __future__ import annotations

import numpy as np


def boss_priority_order(K: int) -> np.ndarray:
    """Column order (most significant first) of the BOSS edge-k-mer
    comparison: s[K-2], s[K-3], ..., s[0], then the edge label s[K-1]."""
    return np.array(list(range(K - 2, -1, -1)) + [K - 1], dtype=np.int64)


def colex_priority_order(K: int) -> np.ndarray:
    """Column order of the plain co-lex comparison (node strings)."""
    return np.arange(K - 1, -1, -1, dtype=np.int64)


def pack_codes(chars: np.ndarray, order: np.ndarray | None = None,
               bits: int = 4) -> np.ndarray:
    """(N, K) uint8 codes -> (N, W) uint64 words, ``bits`` bits a code,
    columns taken in ``order`` (most significant first; default left to
    right), word 0 most significant, the first code of a word in its top
    slot: comparing packed rows compares the code rows."""
    chars = np.asarray(chars)
    if chars.ndim == 1:
        chars = chars[None, :]
    if order is not None:
        chars = chars[:, order]
    N, K = chars.shape
    per = 64 // bits
    out = np.zeros((N, (K + per - 1) // per), dtype=np.uint64)
    for j in range(K):
        w, slot = divmod(j, per)
        out[:, w] |= chars[:, j].astype(np.uint64) \
            << np.uint64(64 - bits - bits * slot)
    return out


def _void_view(packed: np.ndarray) -> np.ndarray:
    """(N, W) uint64 rows as opaque keys that compare bytewise as the rows
    do."""
    be = np.ascontiguousarray(packed.astype(">u8"))
    return be.view(f"V{be.shape[1] * 8}").ravel()


def bits_for_alphabet(alph_size: int) -> int:
    """Bits a packed key spends on a code: 4 when every code, the invalid
    one (== alph_size) included, fits a nibble, else 8."""
    return 4 if alph_size < 16 else 8
