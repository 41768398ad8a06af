"""The query index: the host arrays a ``QueryEngine`` puts on the device.

A ``QueryIndex`` is the hash table over the graph's k-mers (node ids as
payload) and the dense ``(R, Lw)`` annotation bitmap, plus the label names
and, for the counts mode, the column annotation that holds per-row values.
It comes from

* ``from_graph``/``load``: a basic, canonical or primary graph of any
  alphabet and k and a column annotation, the JAX package's ``.dbg.npz``
  and ``.column.annodbg.npz`` artifacts;
* ``from_jax_arrays``: the JAX package's device state as numpy arrays, so
  that both packages compute on the same state;
* ``from_kmers``: packed k-mer keys and their node ids, for callers that
  build an index without a graph file.

The keys pack ``bits`` = 4 bits a code for the DNA family and 8 for
Protein (``bits_for_alphabet``), W = ceil(k * bits / 32) words a key, as
metagraph_tpu's ``QueryEngine._build_device_index`` packs them.

``canon`` says how windows map to nodes (``query/device.py::wire_epoch``):
0 for a basic graph, 1 for a canonical graph (the canonical strand is
probed), 2 for a primary graph, which the JAX CLI queries through
``CanonicalDBG``: the table and the bitmap cover the base graph, and
reverse-complement hits carry ids above ``offset`` = the bitmap's rows =
the base graph's ``max_index()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .annotation.column import ColumnMajorAnnotation
from .annotation.ops import pack_annotation_bitmap
from .graph.dbg_succinct import DBGSuccinct
from .kmer.alphabets import ALPHABETS
from .kmer.packing import bits_for_alphabet
from .succinct.ops import (BUCKET, DeviceHashIndex, check_slot_fill,
                           key_words, pack_kmers32)


@dataclass
class QueryIndex:
    k: int
    table: np.ndarray       # (n_buckets, BUCKET * (W + 1)) uint32
    bitmap: np.ndarray      # (R, Lw) uint32; row = node - 1
    labels: List[str]
    # per-row values for the counts mode; None means a binary annotation,
    # whose values are 0 (as the JAX package reports them)
    annotation: Optional[ColumnMajorAnnotation] = None
    canon: int = 0          # 0 basic, 1 canonical, 2 primary (CanonicalDBG)
    alphabet: str = "DNA"   # an ALPHABETS name

    def __post_init__(self):
        if self.canon not in (0, 1, 2):
            raise ValueError(f"bad canon {self.canon}")
        if self.alphabet not in ALPHABETS:
            raise ValueError(f"unknown alphabet {self.alphabet!r}")
        if self.canon and not ALPHABETS[self.alphabet].complement:
            raise ValueError(f"the {self.alphabet} alphabet has no reverse "
                             "complement: canon must be 0")
        if self.k < 2:
            raise ValueError(f"k={self.k}: k must be at least 2")
        W = key_words(self.k, self.bits)
        if self.table.dtype != np.uint32 \
                or self.table.shape[1:] != (BUCKET * (W + 1),):
            raise ValueError(f"hash table {self.table.shape} "
                             f"{self.table.dtype} does not fit k={self.k}")
        check_slot_fill(self.table)
        Lw = max((len(self.labels) + 31) // 32, 1)
        if self.bitmap.dtype != np.uint32 or self.bitmap.ndim != 2 \
                or self.bitmap.shape[1] != Lw:
            raise ValueError(f"bitmap {self.bitmap.shape} does not fit "
                             f"{len(self.labels)} labels")
        if 2 * self.offset >= 2 ** 31:
            raise ValueError(f"{self.num_rows} rows: canon 2 ids past 2^31")

    @property
    def bits(self) -> int:
        """Bits a code of the packed keys: 4 or 8."""
        return bits_for_alphabet(ALPHABETS[self.alphabet].sigma)

    @property
    def num_rows(self) -> int:
        return self.bitmap.shape[0]

    @property
    def offset(self) -> int:
        """canon 2: reverse-complement ids are base id + offset, and the
        base graph's ids are the bitmap's rows; 0 otherwise."""
        return self.num_rows if self.canon == 2 else 0


def from_jax_arrays(table, bitmap, labels, k: int, num_rows: int,
                    annotation: ColumnMajorAnnotation | None = None,
                    canon: int = 0, alphabet: str = "DNA") -> QueryIndex:
    """``table`` is ``np.asarray(engine._device_index.table)``; ``bitmap`` is
    ``DeviceAnnotation.unpacked()`` or ``pack_annotation_bitmap(anno, R)``
    (rows past ``num_rows`` are layout padding and dropped); ``canon`` is
    the engine's ``_canon_mode()``; ``alphabet`` sets the key bits."""
    return QueryIndex(k, np.ascontiguousarray(table, dtype=np.uint32),
                      np.ascontiguousarray(np.asarray(bitmap)[:num_rows],
                                           dtype=np.uint32),
                      list(labels), annotation, canon, alphabet)


def from_kmers(keys: np.ndarray, ids: np.ndarray, bitmap: np.ndarray,
               labels, k: int,
               annotation: ColumnMajorAnnotation | None = None,
               canon: int = 0, alphabet: str = "DNA") -> QueryIndex:
    """``keys``: (N, W) uint32 ``pack_kmers32`` keys of distinct k-mers, at
    the bits of ``alphabet``; ``ids``: their node ids (row = id - 1 of
    ``bitmap``)."""
    table = DeviceHashIndex.build_table(
        np.ascontiguousarray(keys, dtype=np.uint32), ids)
    return QueryIndex(k, table, np.ascontiguousarray(bitmap, dtype=np.uint32),
                      list(labels), annotation, canon, alphabet)


def from_graph(graph: DBGSuccinct,
               annotation: ColumnMajorAnnotation) -> QueryIndex:
    """A succinct graph + column annotation -> QueryIndex (the table of
    metagraph_tpu's QueryEngine._build_device_index and the bitmap of
    DeviceAnnotation.from_column_annotation): the table over the graph's
    valid edges, the bitmap over its ``max_index()`` rows.  A primary graph
    is queried as the JAX CLI queries it, through ``CanonicalDBG`` (canon
    2, offset = its ``max_index()``)."""
    canon = {"basic": 0, "canonical": 1, "primary": 2}.get(graph.mode)
    if canon is None:
        raise NotImplementedError(
            f"{graph.mode} graphs are not ported yet (ROADMAP A7)")
    boss = graph.boss
    valid_edges = np.flatnonzero(boss.valid)
    keys = pack_kmers32(boss.get_edge_seq(valid_edges),
                        bits_for_alphabet(ALPHABETS[graph.alphabet].sigma))
    bitmap = pack_annotation_bitmap(annotation, graph.max_index())
    return from_kmers(keys, valid_edges.astype(np.uint32), bitmap,
                      annotation.labels, graph.k, annotation, canon,
                      graph.alphabet)


def load(graph_path: str, anno_path: str) -> QueryIndex:
    """``.dbg``/``.dbg.npz`` graph + ``.column.annodbg(.npz)`` annotation,
    loaded in that order; a missing file raises FileNotFoundError naming
    it, as metagraph_tpu's loaders do."""
    import errno
    import os
    graph = DBGSuccinct.load(graph_path)
    if not os.path.exists(anno_path):
        if not os.path.exists(anno_path + ".npz"):
            raise FileNotFoundError(errno.ENOENT, os.strerror(errno.ENOENT),
                                    anno_path)
        anno_path += ".npz"
    if not anno_path.endswith(".column.annodbg.npz"):
        raise NotImplementedError(
            f"{anno_path}: only the column annotation (.column.annodbg.npz) "
            "is ported; other representations wait for ROADMAP A8/A9")
    return from_graph(graph, ColumnMajorAnnotation.load(anno_path))
