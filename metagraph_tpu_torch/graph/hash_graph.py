"""Hash- and bitmap-backed de Bruijn graphs, read from the JAX package's
``.dbg.npz`` artifacts.

Own numpy copy of the part of metagraph_tpu/graph/hash_graph.py the query
uses: ``_KmerGraphBase`` (``node_kmers_and_ids``, ``load_generic``,
:110-140), ``DBGHashGraph`` (also ``hashfast`` and ``hashstr``; :142-200)
and ``DBGBitmapGraph`` (:203-270), each with ``rebuild``, ``call_kmers``,
``num_nodes`` and ``max_index``.  Node ids are not read from the file: each
type's ``rebuild`` makes them as the JAX one does, a hash graph by
inserting the saved k-mers in the order of their saved ids (first
occurrence wins), a bitmap graph by the rank of each k-mer in sorted
order (codes compared left to right, as its packed keys compare).  A
graph holds its k-mers as (N, k) codes in node-id order; the query never
walks it, so traversal is not copied.
"""

from __future__ import annotations

import numpy as np

from ..kmer.alphabets import DNA

BASIC = "basic"
CANONICAL = "canonical"


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
    def rebuild(cls, kmers, ids, k, mode,
                alphabet: str = DNA.name) -> "DBGBitmapGraph":
        kmers = np.asarray(kmers, dtype=np.uint8).reshape(-1, k)
        return cls(kmers[np.argsort(_rows(kmers), kind="stable")], k, mode,
                   alphabet)
