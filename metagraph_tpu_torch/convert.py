"""The query index: the host arrays a ``QueryEngine`` puts on the device.

A ``QueryIndex`` is the hash table over the graph's k-mers (node ids as
payload) and one of the device annotations: the dense ``(R, Lw)`` bitmap,
or past ``METAGRAPH_DENSE_ANNO_BUDGET`` a ``DeviceBlockSparseAnno`` or,
where that does not fit either, a ``FlatBRWT`` or ``FlatRowDiff``
(``device_annotation``, the JAX package's choice); plus the label names
and the host annotation that the payloads read.  It comes from

* ``from_graph``/``load``: a basic, canonical or primary graph of any
  type (succinct, in any of its layouts, hash, bitmap or sshash), alphabet
  and k and any annotation that the JAX package writes, its ``.dbg.npz``,
  ``.dbg`` and ``.annodbg`` artifacts; ``from_graph`` takes a graph that
  ``DBGSuccinct.build`` made as it takes a loaded one;
* ``from_annotation``: packed k-mer keys, their node ids and an
  annotation, for callers that build an index without a graph file;
* ``from_jax_arrays`` (with ``from_jax_block_sparse`` or
  ``from_jax_device_matrix``): the JAX package's device state as numpy
  arrays, so that both packages compute on the same state;
* ``from_kmers``: packed k-mer keys, their node ids and a dense bitmap.

The keys pack ``bits`` = 4 bits a code for the DNA family and 8 for
Protein (``bits_for_alphabet``), W = ceil(k * bits / 32) words a key, as
metagraph_tpu's ``QueryEngine._build_device_index`` packs them.

``canon`` says how windows map to nodes (``query/device.py::wire_epoch``):
0 for a basic graph, 1 for a canonical graph (the canonical strand is
probed), 2 for a primary graph, which the JAX CLI queries through
``CanonicalDBG``: the table and the annotation cover the base graph, and
reverse-complement hits carry ids above ``offset`` = the annotation's rows
= the base graph's ``max_index()``.

``graph_type`` records the graph's representation: a graph without a BOSS
(hash, bitmap, sshash) takes the map route (``query/pipeline.py::
route_of``), as the JAX package sends it to ``_map_windows``.
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass
from typing import List, Union

import numpy as np

from .annotation.column import ColumnMajorAnnotation
from .annotation.device_matrix import (FlatBRWT, FlatRowDiff,
                                       check_words_annotation)
from .annotation.matrix import BRWT, RowDiff, load_annotation
from .annotation.ops import pack_annotation_bitmap
from .annotation.sparse_device import (DeviceBlockSparseAnno,
                                       check_block_sparse, rows_words)
from .graph import GRAPH_CLASSES
from .graph.canonical import CanonicalDBG
from .graph.dbg_succinct import DBGSuccinct
from .kmer.alphabets import ALPHABETS
from .kmer.packing import bits_for_alphabet
from .succinct.ops import (BUCKET, DeviceHashIndex, check_slot_fill,
                           key_words, pack_kmers32)


@dataclass
class QueryIndex:
    k: int
    table: np.ndarray       # (n_buckets, BUCKET * (W + 1)) uint32
    # the device annotation (``device_annotation``): an (R, Lw) uint32
    # bitmap, row = node - 1, or past the budget a DeviceBlockSparseAnno,
    # a FlatBRWT or a FlatRowDiff
    device_anno: Union[np.ndarray, DeviceBlockSparseAnno, FlatBRWT,
                       FlatRowDiff]
    labels: List[str]
    # the host annotation the payloads read (a ColumnMajorAnnotation or a
    # StaticAnnotation); None means a binary annotation, whose values are 0
    # (as the JAX package reports them)
    annotation: object = None
    canon: int = 0          # 0 basic, 1 canonical, 2 primary (CanonicalDBG)
    alphabet: str = "DNA"   # an ALPHABETS name
    graph_type: str = "succinct"   # a GRAPH_CLASSES name

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
        try:
            GRAPH_CLASSES[self.graph_type]
        except KeyError:
            raise ValueError(f"unknown graph type {self.graph_type!r}")
        W = key_words(self.k, self.bits)
        if self.table.dtype != np.uint32 \
                or self.table.shape[1:] != (BUCKET * (W + 1),):
            raise ValueError(f"hash table {self.table.shape} "
                             f"{self.table.dtype} does not fit k={self.k}")
        check_slot_fill(self.table)
        L = len(self.labels)
        dev = self.device_anno
        if isinstance(dev, DeviceBlockSparseAnno):
            check_block_sparse(dev, L)
        elif isinstance(dev, (FlatBRWT, FlatRowDiff)):
            check_words_annotation(dev, L)
        elif not isinstance(dev, np.ndarray) or dev.dtype != np.uint32 \
                or dev.ndim != 2 or dev.shape[1] != max((L + 31) // 32, 1):
            raise ValueError(f"bitmap {getattr(dev, 'shape', None)} does not "
                             f"fit {L} labels")
        if 2 * self.offset >= 2 ** 31:
            raise ValueError(f"{self.num_rows} rows: canon 2 ids past 2^31")

    @property
    def bits(self) -> int:
        """Bits a code of the packed keys: 4 or 8."""
        return bits_for_alphabet(ALPHABETS[self.alphabet].sigma)

    @property
    def num_rows(self) -> int:
        if isinstance(self.device_anno, np.ndarray):
            return self.device_anno.shape[0]
        return self.device_anno.num_rows

    @property
    def offset(self) -> int:
        """canon 2: reverse-complement ids are base id + offset, and the
        base graph's ids are the annotation's rows; 0 otherwise."""
        return self.num_rows if self.canon == 2 else 0


def from_jax_arrays(table, device_anno, labels, k: int, num_rows: int,
                    annotation=None, canon: int = 0, alphabet: str = "DNA"
                    ) -> QueryIndex:
    """``table`` is ``np.asarray(engine._device_index.table)``;
    ``device_anno`` is ``DeviceAnnotation.unpacked()`` or
    ``pack_annotation_bitmap(anno, R)`` (rows past ``num_rows`` are layout
    padding and dropped), a block-sparse annotation
    (``from_jax_block_sparse``) or a BRWT or row-diff one
    (``from_jax_device_matrix``); ``canon`` is the engine's
    ``_canon_mode()``; ``alphabet`` sets the key bits."""
    if not isinstance(device_anno, (DeviceBlockSparseAnno, FlatBRWT,
                                    FlatRowDiff)):
        device_anno = np.ascontiguousarray(
            np.asarray(device_anno)[:num_rows], dtype=np.uint32)
    return QueryIndex(k, np.ascontiguousarray(table, dtype=np.uint32),
                      device_anno, list(labels), annotation, canon, alphabet)


def from_jax_block_sparse(entries, dmap, dense8, tau: int,
                          num_labels: int) -> DeviceBlockSparseAnno:
    """A JAX ``DeviceBlockSparseAnno``'s state (``np.asarray`` of its
    ``entries``, ``dmap`` and ``dense8``, its ``tau`` and ``num_labels``)
    -> the port's."""
    return DeviceBlockSparseAnno(
        np.ascontiguousarray(entries, dtype=np.uint32),
        np.ascontiguousarray(dmap, dtype=np.int32),
        np.ascontiguousarray(dense8, dtype=np.int8), int(tau),
        int(num_labels))


def from_jax_device_matrix(dm):
    """A JAX ``DynDeviceBRWT`` (``words``, ``rdir``, ``offs``, ``parent``
    and ``lv_nodes`` a level each, ``inv_perm``, ``num_rows``,
    ``num_labels``) or ``DeviceRowDiff`` (``succ``, ``anchors``,
    ``max_depth``, ``inner``: a DynDeviceBRWT, or a ``DeviceAnnotation``,
    whose ``unpacked()`` rows are the inner bitmap), read as numpy arrays
    -> the port's FlatBRWT or FlatRowDiff.  A level's leaves are the labels
    at its run of sorted positions (``inv_perm`` maps a label to its
    position)."""
    if hasattr(dm, "succ"):
        L = int(dm.num_labels)
        inner = dm.inner
        succ = np.asarray(dm.succ, dtype=np.int32)
        if hasattr(inner, "unpacked"):
            Lw = max((L + 31) // 32, 1)
            inner = np.ascontiguousarray(
                np.asarray(inner.unpacked()).reshape(-1, Lw)[:len(succ)],
                dtype=np.uint32)
        else:
            inner = from_jax_device_matrix(inner)
        stop = np.asarray(dm.anchors, dtype=bool) | (succ < 0)
        return FlatRowDiff(np.where(stop, -1, succ).astype(np.int32),
                           int(dm.max_depth), inner, L)
    lv_nodes = [np.asarray(x, np.int64) for x in dm.lv_nodes]
    order = np.argsort(np.asarray(dm.inv_perm, np.int64), kind="stable")
    level = np.concatenate([np.full(len(x), l) for l, x in
                            enumerate(lv_nodes)]) if lv_nodes else []
    node = np.concatenate(lv_nodes) if lv_nodes else []
    has = np.asarray(node) >= 0
    return FlatBRWT.from_levels(
        [np.asarray(w, np.uint32) for w in dm.words],
        [np.asarray(r, np.int32) for r in dm.rdir],
        [np.asarray(o, np.int64) for o in dm.offs],
        [np.asarray(p, np.int64) for p in dm.parent],
        np.asarray(level)[has], np.asarray(node)[has], order[has],
        int(dm.num_rows), int(dm.num_labels))


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


def pack_matrix_bitmap(matrix, num_rows: int) -> np.ndarray:
    """Any host matrix -> (num_rows, ceil(L/32)) uint32 bitmap, 2^16 rows
    at a time, through its packed rows where it has them (RowDiff's
    ``get_rows_words``; the bool mask is 8x the bytes)."""
    Lw = max((matrix.num_labels + 31) // 32, 1)
    bm = np.zeros((num_rows, Lw), dtype=np.uint32)
    step = 1 << 16
    for lo in range(0, min(num_rows, matrix.num_rows), step):
        rows = np.arange(lo, min(lo + step, matrix.num_rows))
        bm[lo: lo + len(rows)] = rows_words(matrix, rows, Lw)
    return bm


def device_annotation(annotation, num_rows: int, cache: str | None = None):
    """The device annotation that the JAX package's
    ``_build_device_annotation`` (query/pipeline.py:270-355) chooses ->
    a (num_rows, Lw) uint32 bitmap, a ``DeviceBlockSparseAnno``, a
    ``FlatBRWT`` or a ``FlatRowDiff``.  A BRWT or RowDiff matrix whose
    bitmap would pass ``METAGRAPH_DENSE_ANNO_BUDGET`` bytes (2 GiB by
    default, as in the JAX package) takes the block-sparse form: the
    ``cache`` file when its labels and rows match, else ``from_matrix``,
    saved to ``cache``.  Where ``from_matrix`` gives None (the overflow
    patterns pass the budget), a BRWT takes the FlatBRWT and a RowDiff the
    FlatRowDiff over its inner BRWT, or over its inner rows' dense bitmap;
    no cache is written.  Every other annotation takes the bitmap."""
    matrix = getattr(annotation, "matrix", None)
    budget = int(os.environ.get("METAGRAPH_DENSE_ANNO_BUDGET", 2 << 30))
    if isinstance(matrix, (BRWT, RowDiff)) \
            and not getattr(matrix, "needs_sidecars", False) \
            and num_rows * max((matrix.num_labels + 31) // 32, 1) * 4 \
            > budget:
        sp = _block_sparse(matrix, num_rows, budget, cache)
        return sp if sp is not None else _words(matrix, num_rows)
    if isinstance(annotation, ColumnMajorAnnotation):
        return pack_annotation_bitmap(annotation, num_rows)
    return pack_matrix_bitmap(matrix or annotation, num_rows)


def _block_sparse(matrix, num_rows: int, budget: int, cache: str | None):
    sp = None
    if cache is not None and os.path.exists(cache):
        try:
            sp = DeviceBlockSparseAnno.load(cache)
            # the JAX package's check (labels and rows), then the ranges
            # that kernel S1 indexes with
            if sp.entries.shape[0] != num_rows + 1:
                sp = None
            else:
                check_block_sparse(sp, matrix.num_labels)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            sp = None      # an unreadable cache is rebuilt, as in JAX
    if sp is None:
        sp = DeviceBlockSparseAnno.from_matrix(matrix, num_rows,
                                               max_dense_bytes=budget)
        if sp is not None and cache is not None:
            try:
                sp.save(cache)
            except OSError:
                pass       # the cache is an optimisation
    return sp


def _words(matrix, num_rows: int):
    """A BRWT -> FlatBRWT; a RowDiff -> FlatRowDiff over its inner BRWT,
    or over its inner rows packed as a bitmap (pipeline.py:329-345)."""
    if matrix.num_rows != num_rows:
        raise ValueError(f"the annotation has {matrix.num_rows} rows, the "
                         f"graph {num_rows}")
    if isinstance(matrix, BRWT):
        return FlatBRWT.from_brwt(matrix)
    inner = matrix.inner
    inner = FlatBRWT.from_brwt(inner) if isinstance(inner, BRWT) else \
        pack_matrix_bitmap(inner, inner.num_rows)
    return FlatRowDiff.from_row_diff(matrix, inner)


def from_annotation(keys: np.ndarray, ids: np.ndarray, annotation, k: int,
                    num_rows: int, canon: int = 0, alphabet: str = "DNA",
                    cache: str | None = None,
                    graph_type: str = "succinct") -> QueryIndex:
    """Packed keys of distinct k-mers (as ``from_kmers`` takes them), their
    node ids and an annotation of ``num_rows`` rows -> QueryIndex with the
    device annotation of ``device_annotation``."""
    dev = device_annotation(annotation, num_rows, cache)
    table = DeviceHashIndex.build_table(
        np.ascontiguousarray(keys, dtype=np.uint32), ids)
    return QueryIndex(k, table, dev, list(annotation.labels), annotation,
                      canon, alphabet, graph_type)


def from_graph(graph, annotation, cache: str | None = None) -> QueryIndex:
    """A graph + an annotation -> QueryIndex: the table of metagraph_tpu's
    ``QueryEngine._build_device_index`` (pipeline.py:111-125) over a
    succinct graph's valid edges, or over the k-mers and node ids of a
    graph without a BOSS (``node_kmers_and_ids``), and the device
    annotation over the graph's ``max_index()`` rows.  A primary graph, or
    a ``CanonicalDBG`` over one, is queried as the JAX CLI queries it,
    through ``CanonicalDBG`` (canon 2, offset = the base graph's
    ``max_index()``)."""
    if isinstance(graph, CanonicalDBG):
        graph, canon = graph.graph, 2
    else:
        canon = {"basic": 0, "canonical": 1, "primary": 2}.get(graph.mode)
        if canon is None:
            raise ValueError(f"unknown graph mode {graph.mode!r}")
    bits = bits_for_alphabet(ALPHABETS[graph.alphabet].sigma)
    kchars, ids = graph.node_kmers_and_ids()
    gtype = getattr(graph, "GRAPH_TYPE", "succinct")
    return from_annotation(pack_kmers32(kchars, bits), ids.astype(np.uint32),
                           annotation, graph.k, graph.max_index(), canon,
                           graph.alphabet, cache, gtype)


def load_annotation_for(graph_path: str, anno_path: str):
    """``load_annotation``, then the staged row-diff sidecars
    (``.rd_succ``/``.anchors`` beside the graph) where the matrix needs
    them (metagraph_tpu/cli/main.py:69-77)."""
    anno = load_annotation(anno_path)
    if getattr(getattr(anno, "matrix", None), "needs_sidecars", False):
        anno.matrix.attach_sidecars(graph_path)
    return anno


def load(graph_path: str, anno_path: str) -> QueryIndex:
    """``.dbg``/``.dbg.npz`` graph (any layout and type that
    ``DBGSuccinct.load`` reads) + annotation, loaded in that order; a
    missing file raises FileNotFoundError naming it, as metagraph_tpu's
    loaders do.  A block-sparse annotation is cached in
    ``<anno_path>.devsparse.npz``, where the JAX CLI caches it."""
    graph = DBGSuccinct.load(graph_path)
    return from_graph(graph, load_annotation_for(graph_path, anno_path),
                      cache=anno_path + ".devsparse.npz")
