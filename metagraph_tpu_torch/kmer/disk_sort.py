"""A sorted set of packed k-mer rows in bounded RAM: the bounded-RAM build
(``build --disk-swap``, ``--mem-cap-gb``).

Own copy of ``SortedSetDisk`` of metagraph_tpu/kmer/disk_sort.py:63-226:
rows go into a RAM buffer; once it holds ``ram_cap_bytes`` it is sorted,
deduped (counts summed) and spilled as a chunk; ``merge`` is the windowed
k-way merge, a bounded block read from every chunk, cut at the least of
the chunk heads' last rows, each window sorted and deduped.  A chunk is a
pair of raw ``.npy`` files (keys, counts) where the JAX package writes
Elias-Fano-coded npz: a chunk lives only inside one build, so its layout
is no contract.  The sorts and dedupes run on ``device`` (the card unless
"cpu") through ``packing.unique_rows``; the buffer, the chunks and the
merge's windows stay on the host.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from . import packing


class SortedSetDisk:
    """Bounded-RAM sorted multiset of (N, W) uint64 rows (and counts)."""

    def __init__(self, ram_cap_bytes: int = 1 << 28,
                 tmp_dir: str | None = None, with_counts: bool = False,
                 device=None):
        self.ram_cap = max(int(ram_cap_bytes), 1 << 16)
        # as the JAX package does: a tmp_dir that does not exist raises
        # FileNotFoundError here
        self.dir = tempfile.mkdtemp(prefix="mg_sortdisk_",
                                    dir=tmp_dir or None)
        self.with_counts = with_counts
        self.device = device
        self._bufs, self._cnts, self._buf_bytes = [], [], 0
        self._chunks = []
        self.spilled_bytes = 0

    def _sort_unique_sum(self, keys, counts):
        return packing.unique_rows(keys, counts, self.device)

    def insert(self, keys: np.ndarray, counts: np.ndarray | None = None):
        if not len(keys):
            return
        if keys.dtype != np.uint64:
            raise ValueError(f"keys must be uint64 rows, not {keys.dtype}")
        self._bufs.append(np.ascontiguousarray(keys))
        self._buf_bytes += keys.nbytes
        if self.with_counts:
            self._cnts.append(np.ones(len(keys), np.uint64) if counts is None
                              else np.asarray(counts, dtype=np.uint64))
            self._buf_bytes += self._cnts[-1].nbytes
        if self._buf_bytes >= self.ram_cap:
            self._spill()

    def _spill(self):
        if not self._bufs:
            return
        keys = np.concatenate(self._bufs)
        counts = np.concatenate(self._cnts) if self.with_counts else None
        self._bufs, self._cnts, self._buf_bytes = [], [], 0
        uniq, sums = self._sort_unique_sum(keys, counts)
        base = os.path.join(self.dir, f"chunk_{len(self._chunks)}")
        np.save(base + ".keys.npy", uniq)
        self.spilled_bytes += os.path.getsize(base + ".keys.npy")
        if sums is not None:
            np.save(base + ".counts.npy", sums)
            self.spilled_bytes += os.path.getsize(base + ".counts.npy")
        self._chunks.append(base)

    @property
    def num_chunks(self) -> int:
        return len(self._chunks)

    def merge(self, block_rows: int = 1 << 18):
        """Yield (keys, counts) blocks of the merged sorted unique stream:
        each block sorted and unique, and below every later one; resident
        rows O(block_rows * chunks)."""
        self._spill()
        chunks = [(np.load(b + ".keys.npy", mmap_mode="r"),
                   np.load(b + ".counts.npy", mmap_mode="r")
                   if self.with_counts else None) for b in self._chunks]
        ptrs = [0] * len(chunks)
        carry_k = carry_c = None
        while True:
            heads, head_c, cuts = [], [], []
            for i, (keys, counts) in enumerate(chunks):
                lo = ptrs[i]
                hi = min(lo + block_rows, len(keys))
                if hi > lo:
                    heads.append(keys[lo:hi])
                    if self.with_counts:
                        head_c.append(np.asarray(counts[lo:hi],
                                                 dtype=np.uint64))
                    if hi < len(keys):
                        cuts.append(keys[hi - 1])
            if carry_k is not None and len(carry_k):
                heads.append(carry_k)
                if self.with_counts:
                    head_c.append(carry_c)
            if not heads:
                return
            window = np.concatenate(heads)
            wc = np.concatenate(head_c) if self.with_counts else None
            # cut at the least "last row read" of a chunk, so that no later
            # chunk row can sort below a row emitted now
            if cuts:
                cut = cuts[0]
                for c in cuts[1:]:
                    if packing.rows_lex_lt(c, cut):
                        cut = c
                take = ~packing.rows_lex_gt(window, cut)
            else:
                take = np.ones(len(window), dtype=bool)
            emit_k = window[take]
            emit_c = wc[take] if self.with_counts else None
            carry_k = window[~take]
            carry_c = wc[~take] if self.with_counts else None
            for i in range(len(chunks)):
                ptrs[i] = min(ptrs[i] + block_rows, len(chunks[i][0]))
            if len(emit_k):
                yield self._sort_unique_sum(emit_k, emit_c)

    def merge_all(self):
        """The whole merged set: (keys, counts or None)."""
        parts_k, parts_c = [], []
        for k, c in self.merge():
            parts_k.append(k)
            if self.with_counts:
                parts_c.append(c)
        if not parts_k:
            return (np.zeros((0, 0), np.uint64),
                    np.zeros(0, np.uint64) if self.with_counts else None)
        return (np.concatenate(parts_k),
                np.concatenate(parts_c) if self.with_counts else None)

    def cleanup(self):
        shutil.rmtree(self.dir, ignore_errors=True)
