"""Rank/select over a packed bit vector, as BRWT and RowSparse hold one.

Own numpy copy of metagraph_tpu/succinct/bitrank.py's ``BitRank`` (:35),
the part that reading and querying a converted annotation needs: the
packed uint64 words, the two-level rank directory (an int64 count at every
superblock of 4,096 bits, a uint16 count at every word relative to its
superblock), ``rank`` and ``select``.  The attribute names are the JAX
class's, so that its pickles restore into this one.  The JAX package's
native batch kernels are not copied; the numpy answers are the same.
"""

from __future__ import annotations

import numpy as np

_WORD = 64
_SUP = 64          # words per superblock -> 4096 bits

# in-byte popcount and select tables
_POP8 = np.array([bin(b).count("1") for b in range(256)], dtype=np.uint8)
_SEL8 = np.full((256, 8), 8, dtype=np.uint8)   # pos of (j+1)-th set bit
for _b in range(256):
    _pos = [i for i in range(8) if _b >> i & 1]
    _SEL8[_b, : len(_pos)] = _pos


def popcount64(words: np.ndarray) -> np.ndarray:
    """Set bits of each uint64 word, as int64 (numpy 1 has no
    ``bitwise_count``)."""
    w = np.ascontiguousarray(words, dtype=np.uint64)
    return _POP8[w.view(np.uint8)].reshape(w.shape + (8,)).sum(
        axis=-1, dtype=np.int64)


class BitRank:
    """rank/select over a 0/1 uint8 array, packed to uint64 words."""

    def __init__(self, bits):
        bits = np.asarray(bits, dtype=np.uint8)
        self.n = len(bits)
        pad = max((self.n + _WORD - 1) // _WORD, 1) * _WORD - self.n
        if pad:
            bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
        self.words = np.packbits(bits, bitorder="little").view(np.uint64)
        nw = len(self.words)
        cum = np.concatenate([np.zeros(1, np.int64),
                              np.cumsum(popcount64(self.words))])
        self.total = int(cum[-1])
        self._sup = cum[:-1:_SUP].copy()
        nsup = len(self._sup)
        self._sub = (cum[:-1] - np.repeat(self._sup, _SUP)[: nw]) \
            .astype(np.uint16)
        # pad sub to a superblock multiple for vectorized select
        spad = nsup * _SUP - nw
        if spad:
            self._sub = np.concatenate(
                [self._sub, np.full(spad, 0xFFFF, np.uint16)])
        self._nw = nw

    def __setstate__(self, state):
        state = dict(state)
        state.pop("_ptrs", None)   # the JAX class's native-call pointers
        self.__dict__.update(state)

    def rank(self, i):
        """#set bits in [0..i] inclusive, vectorized; i < 0 -> 0."""
        i = np.asarray(i, dtype=np.int64)
        if self.n == 0:
            return np.zeros(i.shape, dtype=np.int64)
        neg = i < 0
        i = np.where(neg, 0, np.minimum(i, self.n - 1))
        w = i >> 6
        off = (i & 63).astype(np.uint64)
        mask = ~np.uint64(0) >> (np.uint64(63) - off)
        r = (self._sup[w >> 6] + self._sub[w]
             + popcount64(self.words[w] & mask))
        return np.where(neg, 0, r)

    def select(self, r):
        """Position of the r-th set bit (r >= 1), vectorized; out-of-range
        ranks clamp to the nearest valid rank."""
        r = np.asarray(r, dtype=np.int64)
        if self.total == 0:
            return np.full(r.shape, self.n, dtype=np.int64)
        r = np.clip(r, 1, max(self.total, 1))
        sb = np.maximum(np.searchsorted(self._sup, r, side="left") - 1, 0)
        rr = r - self._sup[sb]
        sub = self._sub[(sb[:, None] * _SUP
                         + np.arange(_SUP, dtype=np.int64)[None, :])
                        .reshape(-1)].reshape(-1, _SUP).astype(np.int64)
        w_local = np.maximum((sub < rr[:, None]).sum(axis=1) - 1, 0)
        w = sb * _SUP + w_local
        rw = rr - np.take_along_axis(sub, w_local[:, None], axis=1)[:, 0]
        word = self.words[np.minimum(w, self._nw - 1)]
        byts = (word[:, None] >> (np.uint64(8)
                                  * np.arange(8, dtype=np.uint64)[None, :])
                ).astype(np.uint8)
        bcum = np.concatenate(
            [np.zeros((len(word), 1), np.int64),
             np.cumsum(_POP8[byts].astype(np.int64), axis=1)], axis=1)
        bidx = np.maximum((bcum[:, :8] < rw[:, None]).sum(axis=1) - 1, 0)
        rb = rw - np.take_along_axis(bcum, bidx[:, None], axis=1)[:, 0]
        bval = np.take_along_axis(byts, bidx[:, None].astype(np.int64),
                                  axis=1)[:, 0]
        bitpos = _SEL8[bval, np.clip(rb - 1, 0, 7)].astype(np.int64)
        return w * 64 + bidx * 8 + bitpos
