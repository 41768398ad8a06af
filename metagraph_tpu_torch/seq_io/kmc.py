"""KMC3 databases: the k-mer and count inputs of ``build``.

Own numpy copy of metagraph_tpu/seq_io/kmc.py:24-106: ``KMCDatabase``
(the ``.kmc_pre`` header and prefix table, the ``.kmc_suf`` records),
``read_kmers`` (counts in [min_count, max_count), the reverse complements
appended where the database's strand byte sets ``both_strands`` and
``both_from_canonical`` asks for both) and ``is_kmc_file``.

Layout:
  .kmc_pre: "KMCP" | prefix LUT (4^lut_prefix_length uint64 record offsets)
            | header | header_offset u32 | "KMCP"
    header: kmer_length u32, mode u32, counter_size u32, lut_prefix_length
            u32, min_count u32, max_count u32, total_kmers u64, then at
            byte 32 the strand byte (0: ``both_strands``)
  .kmc_suf: "KMCS" | records (suffix bytes + counter) * total | "KMCS"
    a suffix packs k - lut_prefix_length 2-bit codes (A, C, G, T = 0-3),
    its first in the most significant bits; the record's prefix, its place
    in the LUT, packs the first lut_prefix_length codes likewise; the
    counter is little-endian.
"""

from __future__ import annotations

import struct

import numpy as np

_CODES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _strip_suffix(path: str) -> str:
    for suf in (".kmc_suf", ".kmc_pre"):
        if path.endswith(suf):
            return path[: -len(suf)]
    return path


class KMCDatabase:
    def __init__(self, path: str):
        base = _strip_suffix(path)
        with open(base + ".kmc_pre", "rb") as f:
            pre = f.read()
        if pre[:4] != b"KMCP" or pre[-4:] != b"KMCP":
            raise ValueError(f"{base}.kmc_pre: not a KMC database")
        header_offset = struct.unpack("<I", pre[-8:-4])[0]
        at = len(pre) - 8 - header_offset
        (self.k, self.mode, self.counter_size, self.lut_prefix_length,
         self.min_count, self.max_count,
         self.total_kmers) = struct.unpack_from("<6IQ", pre, at)
        self.both_strands = pre[at + 32] == 0
        self.lut = np.frombuffer(pre, dtype="<u8",
                                 count=4 ** self.lut_prefix_length, offset=4)
        with open(base + ".kmc_suf", "rb") as f:
            suf = f.read()
        if suf[:4] != b"KMCS":
            raise ValueError(f"{base}.kmc_suf: not a KMC database")
        self.suffix_bytes = (self.k - self.lut_prefix_length + 3) // 4
        rec = self.suffix_bytes + self.counter_size
        self.records = np.frombuffer(
            suf, dtype=np.uint8, count=self.total_kmers * rec,
            offset=4).reshape(self.total_kmers, rec)

    def kmers_and_counts(self):
        """-> ((N, k) ACGT byte matrix, (N,) uint64 counts), in record
        order."""
        N, k, lp = self.total_kmers, self.k, self.lut_prefix_length
        lengths = np.diff(np.concatenate([self.lut, [N]])).astype(np.int64)
        prefix = np.repeat(np.arange(len(self.lut), dtype=np.int64), lengths)
        chars = np.empty((N, k), dtype=np.uint8)
        for i in range(lp):
            chars[:, i] = _CODES[(prefix >> (2 * (lp - 1 - i))) & 3]
        for p in range(k - lp):
            byte = self.records[:, p // 4].astype(np.int64)
            chars[:, lp + p] = _CODES[(byte >> (6 - 2 * (p % 4))) & 3]
        counts = np.zeros(N, dtype=np.uint64)
        for b in range(self.counter_size):
            counts |= self.records[:, self.suffix_bytes + b].astype(
                np.uint64) << np.uint64(8 * b)
        return chars, counts


def read_kmers(path: str, both_from_canonical: bool = True,
               min_count: int = 1, max_count: int = 2 ** 63):
    """-> ((N, k) ACGT byte matrix, (N,) uint64 counts, k): the k-mers
    whose count lies in [min_count, max_count), followed by their reverse
    complements (the same counts) where the database is ``both_strands``
    and ``both_from_canonical`` asks for both (the JAX reader's rule)."""
    db = KMCDatabase(path)
    chars, counts = db.kmers_and_counts()
    keep = (counts >= min_count) & (counts < max_count)
    chars, counts = chars[keep], counts[keep]
    if both_from_canonical and db.both_strands:
        comp = np.zeros(256, dtype=np.uint8)
        comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA",
                                                               np.uint8)
        chars = np.concatenate([chars, comp[chars[:, ::-1]]], axis=0)
        counts = np.concatenate([counts, counts])
    return chars, counts, db.k


def is_kmc_file(path: str) -> bool:
    return path.endswith(".kmc_suf") or path.endswith(".kmc_pre")

