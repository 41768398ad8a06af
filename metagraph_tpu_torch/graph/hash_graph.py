"""Hash- and bitmap-backed de Bruijn graphs: built from sequences, written
to and read from the JAX package's ``.dbg.npz`` artifacts.

Own copy of the part of metagraph_tpu/graph/hash_graph.py the port uses:
``_KmerGraphBase`` (``node_kmers_and_ids``, ``save``, ``load_generic``,
:110-140), ``DBGHashGraph`` (also ``hashfast`` and ``hashstr``; :142-200)
and ``DBGBitmapGraph`` (:203-270), each with ``build``, ``rebuild``,
``call_kmers``, ``num_nodes`` and ``max_index``.

``build`` runs on ``device`` (the card unless "cpu"): the valid windows
of the sequences, in the JAX package's stream order (each sequence's
forward windows, then in canonical mode the reverse complement's), packed
left to right into 64-bit words (``_stream_windows``), every sort through
kernel D2 (``packing.lexsort_rows``, ``radix_sort``).  A hash graph's node
id is the rank of a k-mer's first occurrence in that stream, as the JAX
graph's insertion-ordered dict gives it; a bitmap graph's is the k-mer's
rank in sorted order (codes compared left to right).

Loading does not read node ids from the file: each type's ``rebuild``
makes them as the JAX one does, a hash graph by inserting the saved
k-mers in the order of their saved ids (first occurrence wins), a bitmap
graph by sorting.  A graph holds its k-mers as (N, k) codes in node-id
order; the query never walks it, so traversal is not copied.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import packing
from ..kmer.alphabets import ALPHABETS, DNA

BASIC = "basic"
CANONICAL = "canonical"


def _stream_windows(sequences, k: int, alphabet: str, canonical: bool,
                    device):
    """The valid k-windows of ``sequences`` (bytes or str) on ``device``, in
    the order the JAX graphs insert them: each sequence's forward windows
    left to right, then, if ``canonical``, the windows of its reverse
    complement left to right (the reverse complements of its forward
    windows from the last to the first).  -> (n, W) int64 words, the codes
    packed left to right (``packing.pack_rows``; 4 or 8 bits a code)."""
    from ..device import resolve_device
    from ..kmer.extractor import KmerExtractor
    dev = resolve_device(device)
    ex = KmerExtractor(ALPHABETS[alphabet])
    codes = ex._concat_codes(sequences)
    order = np.arange(k)
    n = len(codes) - k + 1
    if n <= 0:
        return torch.zeros((0, ex._words(k)), dtype=torch.int64, device=dev)
    bad = np.concatenate([[0], np.cumsum(codes >= ex.invalid)])
    at = np.flatnonzero((bad[k:] - bad[:-k]) == 0)
    codes_t = torch.from_numpy(codes).to(dev)
    comp = torch.from_numpy(ex.extended_complement_table()).to(dev) \
        if canonical else None
    if canonical and len(at):
        # a sequence's windows are a run of ``at``; its block of the stream
        # is the run, then the run reversed as reverse complements
        ends = np.cumsum([len(s) + 1 for s in sequences])
        seq = np.searchsorted(ends, at, side="right")
        start = np.searchsorted(seq, seq, side="left")
        end = np.searchsorted(seq, seq, side="right")
        pos = np.arange(len(at))
        block = 2 * start + (pos - start)               # forward slot
        rc_slot = 2 * start + (end - start) + (end - 1 - pos)
        src = np.empty(2 * len(at), np.int64)
        strand = np.empty(2 * len(at), bool)
        src[block], strand[block] = at, False
        src[rc_slot], strand[rc_slot] = at, True
        src_t = torch.from_numpy(src).to(dev)
        rc_t = torch.from_numpy(strand).to(dev)

        def col(j):
            fwd = codes_t[src_t + j]
            return torch.where(rc_t, comp[codes_t[src_t + (k - 1 - j)]
                                          .long()], fwd)
        return packing.pack_rows(col, order, ex.bits)
    at_t = torch.from_numpy(at).to(dev)
    return packing.pack_rows(lambda j: codes_t[at_t + j], order, ex.bits)


def _rows(kmers: np.ndarray) -> np.ndarray:
    """(N, k) uint8 codes -> (N,) opaque keys that compare as the rows do,
    code by code from the left."""
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    return kmers.view(f"V{kmers.shape[1]}").ravel()


class _KmerGraphBase:
    GRAPH_TYPE = "hash"

    def __init__(self, kmers: np.ndarray, k: int, mode: str = BASIC,
                 alphabet: str = DNA.name, ids: np.ndarray | None = None):
        self.k = k
        self.mode = mode
        self.alphabet = alphabet          # an ALPHABETS name
        self._kmers = kmers               # (N, k) uint8
        # node id of each row; None: row i is id i + 1
        self._ids = ids

    def node_kmers_and_ids(self):
        """-> ((N, k) uint8 codes, (N,) int64 node ids), in the order of
        the JAX graph's ``call_kmers``."""
        ids = self._ids if self._ids is not None else np.arange(
            1, len(self._kmers) + 1, dtype=np.int64)
        return self._kmers, ids

    def call_kmers(self):
        chars, ids = self.node_kmers_and_ids()
        for i in range(len(ids)):
            yield int(ids[i]), chars[i]

    def max_index(self) -> int:
        return len(self._kmers)

    def num_nodes(self) -> int:
        return len(self._kmers)

    def save(self, path: str):
        """``<path>.dbg.npz`` (or ``path`` if it ends in .npz) with the JAX
        graph's keys, dtypes and arrays (hash_graph.py:122-128)."""
        from ..utils.npz import savez
        chars, ids = self.node_kmers_and_ids()
        out = path if path.endswith(".npz") else path + ".dbg.npz"
        savez(out, graph_type=self.GRAPH_TYPE, k=self.k, mode=self.mode,
              kmers=chars, ids=ids, alphabet=self.alphabet)

    @classmethod
    def load_generic(cls, z) -> "_KmerGraphBase":
        """An open ``.dbg.npz`` with a ``graph_type`` -> its graph."""
        from . import GRAPH_CLASSES
        gcls = GRAPH_CLASSES[str(z["graph_type"])]
        alpha = str(z["alphabet"]) if "alphabet" in z.files else DNA.name
        return gcls.rebuild(z["kmers"], z["ids"], int(z["k"]),
                            str(z["mode"]), alphabet=alpha)


class DBGHashGraph(_KmerGraphBase):
    """The insertion-ordered k-mer dictionary: node id = insertion rank."""

    @classmethod
    def build(cls, sequences, k: int, mode: str = BASIC, alphabet=DNA,
              device=None, **_) -> "DBGHashGraph":
        """The JAX ``DBGHashGraph.build`` (hash_graph.py:150-171) on
        ``device``: one stable D2 sort of the stream's windows keeps each
        k-mer's first position; the positions, sorted (D2), give the k-mers
        in id order."""
        from ..succinct.device_build import radix_sort
        name = getattr(alphabet, "name", alphabet)
        packed = _stream_windows(sequences, k, name, mode == CANONICAL,
                                 device)
        n = packed.shape[0]
        if n == 0:
            return cls(np.zeros((0, k), np.uint8), k, mode, name)
        perm = packing.lexsort_rows(packed)
        first = perm[packing.new_rows(packed.index_select(0, perm))]
        first, _ = radix_sort(first, max(int(n - 1).bit_length(), 1))
        bits = packing.bits_for_alphabet(ALPHABETS[name].sigma)
        chars = packing.unpack_rows(packed.index_select(0, first), k,
                                    np.arange(k), bits)
        return cls(chars.cpu().numpy(), k, mode, name)

    @classmethod
    def rebuild(cls, kmers, ids, k, mode,
                alphabet: str = DNA.name) -> "DBGHashGraph":
        """The saved k-mers inserted in the (stable) order of their saved
        ids; a k-mer seen before keeps its first id."""
        kmers = np.asarray(kmers, dtype=np.uint8).reshape(-1, k)
        kmers = kmers[np.argsort(np.asarray(ids), kind="stable")]
        _, first = np.unique(_rows(kmers), return_index=True)
        return cls(kmers[np.sort(first)], k, mode, alphabet)


class DBGBitmapGraph(_KmerGraphBase):
    """The sorted k-mer rank dictionary: node id = rank of the k-mer in
    sorted order."""

    GRAPH_TYPE = "bitmap"

    @classmethod
    def build(cls, sequences, k: int, mode: str = BASIC, alphabet=DNA,
              device=None, **_) -> "DBGBitmapGraph":
        """The JAX ``DBGBitmapGraph.build`` (hash_graph.py:211-220) on
        ``device``: the distinct valid k-mers (both strands in canonical
        mode) sorted by their left-to-right keys (D2)."""
        name = getattr(alphabet, "name", alphabet)
        packed = _stream_windows(sequences, k, name, mode == CANONICAL,
                                 device)
        keys, _ = packing.unique_rows(packed)
        bits = packing.bits_for_alphabet(ALPHABETS[name].sigma)
        return cls(packing.unpack_rows(keys, k, np.arange(k), bits)
                   .cpu().numpy(), k, mode, name)

    @classmethod
    def rebuild(cls, kmers, ids, k, mode,
                alphabet: str = DNA.name) -> "DBGBitmapGraph":
        kmers = np.asarray(kmers, dtype=np.uint8).reshape(-1, k)
        return cls(kmers[np.argsort(_rows(kmers), kind="stable")], k, mode,
                   alphabet)
