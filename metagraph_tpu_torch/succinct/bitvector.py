"""The compressed bit vectors of the "smallest" column codec.

Own numpy copy of metagraph_tpu/succinct/bitvector.py (:36-392): the
``stat``, ``sd`` (Elias-Fano) and ``rrr`` (15-bit blocks) kinds, built
from bits or set positions (``_pack_stream`` :36-56, the constructors),
written by ``to_dict`` (:108, :187, :333) into the JAX dicts array for
array, and read back by ``from_dict``, ``num_set_bits`` and ``select1``;
``predict_size_bits`` and ``bit_vector_smallest`` (:353-391) choose the
kind of a column, ``bitvector_from_dict`` reads one.  Each kind decodes
its set positions once, in one vectorized pass, and ``select1`` indexes
them; the positions are those the JAX kinds' rank and select directories
give.  Rank queries are not copied: the port reads these columns whole.
"""

from __future__ import annotations

import numpy as np

from .bitrank import _POP8

_WORD = 64
_RRR_B = 15
_RRR_SAMPLE = 32          # blocks a sample of the rrr directories


def _words_of(bits) -> np.ndarray:
    """0/1 bits -> little-endian uint64 words (at least one), as the JAX
    ``BitRank`` packs them."""
    bits = np.asarray(bits).astype(np.uint8)
    nw = max((len(bits) + _WORD - 1) // _WORD, 1)
    pad = np.zeros(nw * _WORD, np.uint8)
    pad[: len(bits)] = bits
    return np.packbits(pad, bitorder="little").view(np.uint64)


def _pack_stream(values: np.ndarray, widths: np.ndarray):
    """Pack values[i] (its widths[i] low bits) into a little-endian uint64
    stream with one pad word: -> (words, start bit offsets)."""
    values = np.asarray(values, dtype=np.uint64)
    widths = np.asarray(widths, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(widths)])
    total = int(starts[-1])
    nw = max((total + _WORD - 1) // _WORD, 1)
    words = np.zeros(nw + 1, dtype=np.uint64)
    nz = widths > 0            # zero-width entries write nothing (and their
    off = starts[:-1][nz]      # offsets may sit past the stream end)
    vals = values[nz]
    w = off // _WORD
    s = (off % _WORD).astype(np.uint64)
    np.bitwise_or.at(words, w, vals << s)
    np.bitwise_or.at(words, w + 1, np.where(
        s > 0, vals >> (np.uint64(_WORD) - s), np.uint64(0)))
    return words, starts


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

    @classmethod
    def from_bits(cls, bits):
        return cls.from_dict({"kind": "stat", "n": len(bits),
                              "words": _words_of(bits)})

    def to_dict(self):
        return {"kind": "stat", "n": self.n, "words": self._words}

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

    @classmethod
    def from_positions(cls, positions, n: int):
        positions = np.asarray(positions, dtype=np.int64)
        n, m = int(n), len(positions)
        l = max(int(np.floor(np.log2(max(n, 1) / m))) if m else 0, 0)
        if l:
            lo = (positions & ((1 << l) - 1)).astype(np.uint64)
            lo_words, _ = _pack_stream(lo, np.full(m, l, np.int64))
        else:
            lo_words = np.zeros(1, np.uint64)
        hi = np.zeros(m + (n >> l) + 1, dtype=np.uint8)
        hi[(positions >> l) + np.arange(m)] = 1
        return cls.from_dict({"n": n, "m": m, "lo_width": l,
                              "lo_words": lo_words,
                              "hi_words": _words_of(hi), "hi_n": len(hi)})

    def to_dict(self):
        return {"kind": "sd", "n": self.n, "m": self.num_set_bits,
                "lo_width": self.lo_width, "lo_words": self._lo_words,
                "hi_words": self._hi_words, "hi_n": self._hi_n}

    def _decode(self):
        m, l = self.num_set_bits, self.lo_width
        j = np.arange(m, dtype=np.int64)
        hi = np.flatnonzero(_bits_of(self._hi_words, self._hi_n))[:m] - j
        lo = _read_stream(self._lo_words, j * l, np.full(m, l, np.uint64)) \
            .astype(np.int64) if l else np.zeros(m, dtype=np.int64)
        return (hi << l) | lo


def _rrr_offsets():
    """Each 15-bit pattern's offset in its class, and each class's offset
    width."""
    pats = np.arange(1 << _RRR_B, dtype=np.uint16)
    cls = _POP8[pats & 0xFF].astype(np.int64) + _POP8[pats >> 8]
    order = np.argsort(cls, kind="stable")
    counts = np.bincount(cls, minlength=_RRR_B + 1).astype(np.int64)
    base = np.concatenate([[0], np.cumsum(counts)])[:-1]
    offset = np.empty(1 << _RRR_B, dtype=np.uint16)
    offset[order] = (np.arange(1 << _RRR_B)
                     - np.repeat(base, counts)).astype(np.uint16)
    return offset, _rrr_tables()[2]


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
        obj._rank_samp = np.asarray(d.get("rank_samp", ()), dtype=np.int64)
        obj._ptr_samp = np.asarray(d.get("ptr_samp", ()), dtype=np.int64)
        obj._pos = None
        return obj

    @classmethod
    def from_bits(cls, bits):
        offset_of_pattern, width = _rrr_offsets()
        bits = np.asarray(bits).astype(np.uint8)
        n = len(bits)
        nb = max(-(-n // _RRR_B), 1)
        pad = np.zeros(nb * _RRR_B, np.uint8)
        pad[:n] = bits
        blocks = (pad.reshape(nb, _RRR_B)
                  << np.arange(_RRR_B, dtype=np.uint16)).sum(
                      axis=1, dtype=np.uint16)
        classes = (_POP8[blocks & 0xFF] + _POP8[blocks >> 8]).astype(
            np.uint8)
        off_words, starts = _pack_stream(
            offset_of_pattern[blocks].astype(np.uint64),
            width[classes].astype(np.int64))
        csum = np.concatenate([[0], np.cumsum(classes, dtype=np.int64)])
        obj = cls.from_dict({"n": n, "classes": classes,
                             "off_words": off_words})
        obj._rank_samp = csum[::_RRR_SAMPLE].copy()
        obj._ptr_samp = starts[:-1][::_RRR_SAMPLE].copy()
        return obj

    def to_dict(self):
        return {"kind": "rrr", "n": self.n, "classes": self._classes,
                "off_words": self._off_words, "rank_samp": self._rank_samp,
                "ptr_samp": self._ptr_samp}

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


def predict_size_bits(n: int, m: int, kind: str) -> float:
    """Predicted footprint in bits of ``kind`` for ``m`` set bits of
    ``n``."""
    if kind == "stat":
        return n * 1.06
    if kind == "sd":
        l = max(int(np.floor(np.log2(max(n, 1) / m))) if m else 0, 0)
        return m * (l + 2.06) + (n >> l) * 1.06 + 64
    if kind == "rrr":
        nb = max(-(-n // _RRR_B), 1)
        d = m / max(n, 1)
        h0 = 0.0 if d in (0.0, 1.0) else \
            -(d * np.log2(d) + (1 - d) * np.log2(1 - d))
        return nb * (4 + h0 * _RRR_B) + (nb / _RRR_SAMPLE) * 96
    raise ValueError(kind)


def bit_vector_smallest(bits: np.ndarray = None, *, positions=None, n=None):
    """The kind with the smallest predicted footprint, built."""
    if positions is not None:
        m = len(positions)
    else:
        bits = np.asarray(bits).astype(bool)
        n = len(bits)
        m = int(np.count_nonzero(bits))
    best = min(("stat", "sd", "rrr"),
               key=lambda k: predict_size_bits(n, m, k))
    if best == "sd":
        if positions is None:
            positions = np.flatnonzero(bits)
        return BitVectorSD.from_positions(positions, n)
    if bits is None:
        bits = np.zeros(n, dtype=np.uint8)
        bits[np.asarray(positions, dtype=np.int64)] = 1
    return _KINDS[best].from_bits(bits)


def bitvector_from_dict(d):
    return _KINDS[str(d["kind"])].from_dict(d)
