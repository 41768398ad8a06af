"""The compressed bit vectors of the "smallest" column codec, read back.

Own numpy copy of the reading part of metagraph_tpu/succinct/bitvector.py
(:77-392): the ``stat``, ``sd`` (Elias-Fano) and ``rrr`` (15-bit blocks)
kinds' ``from_dict``, ``num_set_bits`` and ``select1``, and
``bitvector_from_dict``.  Each kind decodes its set positions once, in
one vectorized pass, and ``select1`` indexes them; the positions are those
the JAX kinds' rank and select directories give.  Building a vector and
rank queries are not copied: the port only reads these columns.
"""

from __future__ import annotations

import numpy as np

from .bitrank import _POP8

_WORD = 64
_RRR_B = 15


def _bits_of(words: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` bits of little-endian uint64 words, as bool."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    return np.unpackbits(words.view(np.uint8), bitorder="little")[:n] \
        .astype(bool)


def _read_stream(words: np.ndarray, offs: np.ndarray,
                 widths: np.ndarray) -> np.ndarray:
    """The ``widths[i]``-bit values at bit offsets ``offs[i]``."""
    offs = np.asarray(offs, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.uint64)
    w = offs // _WORD
    s = (offs % _WORD).astype(np.uint64)
    lo = words[w] >> s
    hi = np.where(s > 0, words[np.minimum(w + 1, len(words) - 1)]
                  << (np.uint64(_WORD) - s), np.uint64(0))
    mask = np.where(widths >= 64, ~np.uint64(0),
                    (np.uint64(1) << widths) - np.uint64(1))
    return (lo | hi) & mask


class _Positions:
    """select1 over decoded set positions."""

    def select1(self, j):
        """Position of the (j+1)-th set bit, 0-based j."""
        return self.positions()[np.asarray(j, dtype=np.int64)]

    def positions(self) -> np.ndarray:
        if self._pos is None:
            self._pos = self._decode().astype(np.int64)
        return self._pos


class BitVectorStat(_Positions):
    """Plain packed words (with a rank directory in the JAX package)."""

    kind = "stat"

    @classmethod
    def from_dict(cls, d):
        obj = cls()
        obj.n = int(d["n"])
        obj._words = np.asarray(d["words"], dtype=np.uint64)
        obj._pos = None
        obj.num_set_bits = len(obj.positions())
        return obj

    def _decode(self):
        return np.flatnonzero(_bits_of(self._words, self.n))


class BitVectorSD(_Positions):
    """Elias-Fano: each set position's low ``lo_width`` bits packed, its
    high part unary in ``hi``: element j's high part is select1_hi(j) - j."""

    kind = "sd"

    @classmethod
    def from_dict(cls, d):
        obj = cls()
        obj.n = int(d["n"])
        obj.num_set_bits = int(d["m"])
        obj.lo_width = int(d["lo_width"])
        obj._lo_words = np.asarray(d["lo_words"], dtype=np.uint64)
        obj._hi_words = np.asarray(d["hi_words"], dtype=np.uint64)
        obj._hi_n = int(d["hi_n"])
        obj._pos = None
        return obj

    def _decode(self):
        m, l = self.num_set_bits, self.lo_width
        j = np.arange(m, dtype=np.int64)
        hi = np.flatnonzero(_bits_of(self._hi_words, self._hi_n))[:m] - j
        lo = _read_stream(self._lo_words, j * l, np.full(m, l, np.uint64)) \
            .astype(np.int64) if l else np.zeros(m, dtype=np.int64)
        return (hi << l) | lo


def _rrr_tables():
    """15-bit block patterns by (class base + offset), where a class is a
    popcount and patterns of a class ascend; each class's first code and
    offset width."""
    pats = np.arange(1 << _RRR_B, dtype=np.uint16)
    cls = _POP8[pats & 0xFF].astype(np.int64) + _POP8[pats >> 8]
    order = np.argsort(cls, kind="stable")
    counts = np.bincount(cls, minlength=_RRR_B + 1).astype(np.int64)
    base = np.concatenate([[0], np.cumsum(counts)])[:-1]
    width = np.ceil(np.log2(np.maximum(counts, 2))).astype(np.int64)
    width[counts == 1] = 0                        # classes 0 and 15
    return pats[order], base, width


class BitVectorRRR(_Positions):
    """15-bit blocks as (class, offset of the pattern in its class); the
    offsets packed at each class's width."""

    kind = "rrr"

    @classmethod
    def from_dict(cls, d):
        obj = cls()
        obj.n = int(d["n"])
        obj._classes = np.asarray(d["classes"], dtype=np.uint8)
        obj.num_set_bits = int(obj._classes.sum(dtype=np.int64))
        obj._off_words = np.asarray(d["off_words"], dtype=np.uint64)
        obj._pos = None
        return obj

    def _decode(self):
        pattern_by_code, base, width = _rrr_tables()
        cls = self._classes.astype(np.int64)
        w = width[cls]
        starts = np.concatenate([[0], np.cumsum(w)])[:-1]
        off = _read_stream(self._off_words, starts, w.astype(np.uint64)) \
            .astype(np.int64)
        pat = pattern_by_code[np.clip(base[cls] + off, 0,
                                      (1 << _RRR_B) - 1)]
        bits = (pat[:, None] >> np.arange(_RRR_B, dtype=np.uint16)) & 1
        return np.flatnonzero(bits.reshape(-1)[: self.n])


_KINDS = {"stat": BitVectorStat, "sd": BitVectorSD, "rrr": BitVectorRRR}


def bitvector_from_dict(d):
    return _KINDS[str(d["kind"])].from_dict(d)
