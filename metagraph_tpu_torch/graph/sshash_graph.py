"""The minimizer-bucketed static k-mer dictionary (the SSHash-style graph),
read from the JAX package's ``.dbg.npz`` artifacts.

Own numpy copy of metagraph_tpu/graph/sshash_graph.py:24-116: ``_mix``,
``compute_minimizers``, ``DBGSSHashGraph.build``, ``rebuild`` and
``call_kmers``.  ``rebuild`` builds the graph again from the saved k-mers
as DNA sequences, as the JAX one does: node id = 1 + the k-mer's rank in
sorted order (codes compared left to right), entries bucketed by
minimizer, which sets the order of ``node_kmers_and_ids``.  The graph
takes DNA only.
"""

from __future__ import annotations

import numpy as np

from ..kmer.alphabets import DNA
from ..kmer.extractor import KmerExtractor
from .hash_graph import BASIC, CANONICAL, _KmerGraphBase

_CHUNK = 1 << 20          # k-mers a pass of compute_minimizers


def _mix(x: np.ndarray) -> np.ndarray:
    """The order-scrambling hash of m-mer codes."""
    x = x.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return x ^ (x >> np.uint64(31))


def compute_minimizers(kmers: np.ndarray, m: int) -> np.ndarray:
    """(N, k) codes -> the packed m-mer of least ``_mix`` of each k-mer
    (the first such m-mer on a tie)."""
    N, k = kmers.shape
    n_win = k - m + 1
    out = np.zeros(N, dtype=np.uint64)
    for lo in range(0, N, _CHUNK):
        part = kmers[lo: lo + _CHUNK]
        packed = np.zeros((len(part), n_win), dtype=np.uint64)
        for j in range(m):
            packed |= part[:, j: j + n_win].astype(np.uint64) << np.uint64(
                4 * (m - 1 - j))
        out[lo: lo + len(part)] = packed[np.arange(len(part)),
                                         np.argmin(_mix(packed), axis=1)]
    return out


class DBGSSHashGraph(_KmerGraphBase):
    GRAPH_TYPE = "sshash"

    @classmethod
    def build(cls, sequences, k: int, mode: str = BASIC,
              m: int | None = None) -> "DBGSSHashGraph":
        return cls._bucketed(KmerExtractor(DNA).distinct_kmers(
            sequences, k, mode="both" if mode == CANONICAL else "basic"),
            k, mode, m)

    @classmethod
    def _bucketed(cls, chars, k, mode, m=None) -> "DBGSSHashGraph":
        """``chars``: distinct k-mers in sorted order, the order of their
        ids; the entries are sorted (stably) by minimizer."""
        if m is None:
            m = max(4, min(k - 1, (k + 1) // 2))
        order = np.argsort(compute_minimizers(chars, m), kind="stable")
        return cls(chars[order], k, mode,
                   ids=np.arange(1, len(chars) + 1, dtype=np.int64)[order])

    @classmethod
    def rebuild(cls, kmers, ids, k, mode, alphabet=None) -> "DBGSSHashGraph":
        """From the raw k-mer set (the bucket layout is derived): ``build``
        of each k-mer as a DNA sequence, where a code outside A, C, G, T
        breaks its window."""
        ex = KmerExtractor(DNA)
        kmers = np.asarray(kmers, dtype=np.uint8).reshape(-1, k)
        codes = np.where((kmers >= 1) & (kmers < DNA.sigma), kmers,
                         ex.invalid).astype(np.uint8)
        codes = np.concatenate(
            [codes, np.full((len(codes), 1), ex.invalid, np.uint8)], axis=1)
        return cls._bucketed(ex.extract_codes(
            codes.ravel(), k, "both" if mode == CANONICAL else "basic"),
            k, mode)
