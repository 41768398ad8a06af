"""The query index: the host arrays a ``QueryEngine`` puts on the device.

A ``QueryIndex`` is the hash table over the graph's k-mers (node ids as
payload) and the dense ``(R, Lw)`` annotation bitmap, plus the label names
and, for the counts mode, the column annotation that holds per-row values.
It comes from

* ``from_graph``/``load``: a basic DNA graph and a column annotation, the
  JAX package's ``.dbg.npz`` and ``.column.annodbg.npz`` artifacts;
* ``from_jax_arrays``: the JAX package's device state as numpy arrays, so
  that both packages compute on the same state;
* ``from_kmers``: packed k-mer keys and their node ids, for callers that
  build an index without a graph file.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .annotation.column import ColumnMajorAnnotation
from .annotation.ops import pack_annotation_bitmap
from .graph.dbg_succinct import DBGSuccinct
from .succinct.ops import BUCKET, DeviceHashIndex, pack_kmers32


@dataclass
class QueryIndex:
    k: int
    table: np.ndarray       # (n_buckets, BUCKET * (W + 1)) uint32
    bitmap: np.ndarray      # (R, Lw) uint32; row = node - 1
    labels: List[str]
    # per-row values for the counts mode; None means a binary annotation,
    # whose values are 0 (as the JAX package reports them)
    annotation: Optional[ColumnMajorAnnotation] = None

    def __post_init__(self):
        W = -(-self.k // 8)
        if not 2 <= self.k <= 31:
            raise NotImplementedError(
                f"k={self.k}: the wire query path serves 2 <= k <= 31; other "
                "k are not ported yet (ROADMAP A7)")
        if self.table.dtype != np.uint32 \
                or self.table.shape[1:] != (BUCKET * (W + 1),):
            raise ValueError(f"hash table {self.table.shape} "
                             f"{self.table.dtype} does not fit k={self.k}")
        Lw = max((len(self.labels) + 31) // 32, 1)
        if self.bitmap.dtype != np.uint32 or self.bitmap.ndim != 2 \
                or self.bitmap.shape[1] != Lw:
            raise ValueError(f"bitmap {self.bitmap.shape} does not fit "
                             f"{len(self.labels)} labels")

    @property
    def num_rows(self) -> int:
        return self.bitmap.shape[0]


def from_jax_arrays(table, bitmap, labels, k: int, num_rows: int,
                    annotation: ColumnMajorAnnotation | None = None
                    ) -> QueryIndex:
    """``table`` is ``np.asarray(engine._device_index.table)``; ``bitmap`` is
    ``DeviceAnnotation.unpacked()`` or ``pack_annotation_bitmap(anno, R)``
    (rows past ``num_rows`` are layout padding and dropped)."""
    return QueryIndex(k, np.ascontiguousarray(table, dtype=np.uint32),
                      np.ascontiguousarray(np.asarray(bitmap)[:num_rows],
                                           dtype=np.uint32),
                      list(labels), annotation)


def from_kmers(keys: np.ndarray, ids: np.ndarray, bitmap: np.ndarray,
               labels, k: int,
               annotation: ColumnMajorAnnotation | None = None) -> QueryIndex:
    """``keys``: (N, ceil(k/8)) uint32 ``pack_kmers32`` keys of distinct
    k-mers; ``ids``: their node ids (row = id - 1 of ``bitmap``)."""
    table = DeviceHashIndex.build_table(
        np.ascontiguousarray(keys, dtype=np.uint32), ids)
    return QueryIndex(k, table, np.ascontiguousarray(bitmap, dtype=np.uint32),
                      list(labels), annotation)


def from_graph(graph: DBGSuccinct,
               annotation: ColumnMajorAnnotation) -> QueryIndex:
    """A basic DNA graph + column annotation -> QueryIndex (the table of
    metagraph_tpu's QueryEngine._build_device_index and the bitmap of
    DeviceAnnotation.from_column_annotation)."""
    if graph.mode != "basic":
        raise NotImplementedError(
            f"{graph.mode} graphs are not ported yet (ROADMAP A7)")
    if graph.alphabet != "DNA":
        raise NotImplementedError(
            f"the {graph.alphabet} alphabet is not ported yet (ROADMAP A7)")
    boss = graph.boss
    valid_edges = np.flatnonzero(boss.valid)
    keys = pack_kmers32(boss.get_edge_seq(valid_edges))
    bitmap = pack_annotation_bitmap(annotation, graph.max_index())
    return from_kmers(keys, valid_edges.astype(np.uint32), bitmap,
                      annotation.labels, graph.k, annotation)


def load(graph_path: str, anno_path: str) -> QueryIndex:
    """``.dbg``/``.dbg.npz`` graph + ``.column.annodbg(.npz)`` annotation."""
    import os
    if not anno_path.endswith(".npz") and os.path.exists(anno_path + ".npz"):
        anno_path += ".npz"
    if not anno_path.endswith(".column.annodbg.npz"):
        raise NotImplementedError(
            f"{anno_path}: only the column annotation (.column.annodbg.npz) "
            "is ported; other representations wait for ROADMAP A8/A9")
    return from_graph(DBGSuccinct.load(graph_path),
                      ColumnMajorAnnotation.load(anno_path))
