"""The minimizer-bucketed static k-mer dictionary (the SSHash-style graph):
built from sequences, and read from the JAX package's ``.dbg.npz``
artifacts.

Own copy of metagraph_tpu/graph/sshash_graph.py:24-116: ``_mix``,
``compute_minimizers``, ``DBGSSHashGraph.build``, ``rebuild`` and
``call_kmers``.  ``build`` takes the JAX signature (``alphabet``, ``m``)
and runs on ``device`` (the card unless "cpu"): the distinct k-mers of
the collector (``KmerExtractor.extract_tensors``), their keys packed left
to right at 4 bits a code as the JAX ``pack_codes`` default packs them,
ranked by a stable ``packing.lexsort_rows`` (kernel D2): node id = 1 +
that rank; the entries are then sorted stably by minimizer (D2), which
sets the order of ``node_kmers_and_ids``, whose k-mers are the 4-bit
keys unpacked, as the JAX ``call_kmers`` unpacks them.  The minimizers
are the JAX numpy code.  ``rebuild`` builds the graph again on the host
from the saved k-mers as DNA sequences, as the JAX one does.
"""

from __future__ import annotations

import numpy as np
import torch

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
    def build(cls, sequences, k: int, mode: str = BASIC, alphabet=DNA,
              m: int | None = None, device=None, **_) -> "DBGSSHashGraph":
        """The JAX ``DBGSSHashGraph.build`` (sshash_graph.py:56-74)."""
        from ..device import resolve_device
        from ..kmer import packing
        from ..kmer.alphabets import ALPHABETS
        from ..succinct.device_build import radix_sort
        if m is None:
            m = max(4, min(k - 1, (k + 1) // 2))
        name = getattr(alphabet, "name", alphabet)
        dev = resolve_device(device)
        chars, _ = KmerExtractor(ALPHABETS[name]).extract_tensors(
            sequences, k, "both" if mode == CANONICAL else "basic",
            device=dev)
        order = np.arange(k)
        keys = packing.pack_rows(lambda j: chars[:, j], order, 4)
        perm = packing.lexsort_rows(keys)
        chars = chars.index_select(0, perm)
        keys = keys.index_select(0, perm)
        minims = compute_minimizers(chars.cpu().numpy(), m)
        pos = torch.arange(len(minims), dtype=torch.int64, device=dev)
        _, bucket = radix_sort(torch.from_numpy(minims.view(np.int64))
                               .to(dev), 64, pos)
        ids = (bucket + 1).cpu().numpy()
        kmers = packing.unpack_rows(keys.index_select(0, bucket), k, order,
                                    4).cpu().numpy()
        return cls(kmers, k, mode, name, ids=ids)

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
