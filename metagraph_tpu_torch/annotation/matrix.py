"""Converted (static) annotations: the matrices that ``transform_anno``
writes, read and queried on the host.

Own copy of the reading and querying part of
metagraph_tpu/annotation/matrix.py: the binary matrices ``RowFlat`` (:66),
``RowSparse`` (:87), ``UniqueRowBinmat``/``Rainbowfish`` (:259, :285),
``Rainbow`` (:289), ``BinRelWT`` (:324), ``RowDisk`` (:364), ``BRWT``
(:408) and ``RowDiff`` (:617); the value and coordinate matrices
``CSRIntMatrix`` (:909), ``IntRowDiff`` (:960), ``TupleCSCMatrix``
(:1066) and ``TupleRowDiff`` (:1157); ``MATRIX_TYPES`` (:1274),
``StaticAnnotation`` (:1287) and ``load_annotation`` (:1337).  Of the
converters ``BRWT.from_columns`` (:547, with ``greedy_linkage``) and
``RowDiff.from_annotation`` (:649-682, with its routing given) are
copied, so that a BRWT or a row-diff BRWT can be built where the JAX
package is not installed; ``build_routing`` and the other converters wait
for ROADMAP A8.4.

A ``StaticAnnotation`` file is a pickle of the JAX package's classes.  It
is read through ``_AnnotationUnpickler``, whose ``find_class`` maps those
classes (and the port's own, which ``StaticAnnotation.save`` writes) to
the copies here, allows numpy's array reconstructors, and refuses every
other global: a pickle is code, and this list also keeps
``metagraph_tpu`` unimported.  Pickle restores state by attribute name, so
every class keeps the JAX class's attribute and slot names.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import List

import numpy as np

from ..succinct.bitrank import BitRank
from .column import ColumnMajorAnnotation, LabelEncoder


class RowFlat:
    """CSR rows: ``indptr``, ``indices``."""

    NAME = "flat"

    def __init__(self, indptr, indices, num_labels):
        self.indptr = indptr
        self.indices = indices
        self.num_rows = len(indptr) - 1
        self.num_labels = num_labels

    def get_rows_mask(self, rows):
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        for i, r in enumerate(rows):
            out[i, self.indices[self.indptr[r]: self.indptr[r + 1]]] = True
        return out


class RowSparse:
    """Delta-coded rows bit-packed in blocks of 64 values, one width a
    block; row ends are the set bits of ``boundary`` (a BitRank)."""

    NAME = "row_sparse"
    BLOCK = 64

    def __init__(self, words, widths, boundary_bits, num_rows, num_labels,
                 nnz):
        self.words = words
        self.widths = widths
        self.boundary = BitRank(boundary_bits)
        self.num_rows = num_rows
        self.num_labels = num_labels
        self.nnz = nnz
        self._boff = np.zeros(len(widths) + 1, dtype=np.int64)
        np.cumsum(widths.astype(np.int64) * self.BLOCK, out=self._boff[1:])

    def _decode(self, pos: np.ndarray) -> np.ndarray:
        """Vectorized random access into the packed delta stream."""
        B = self.BLOCK
        blk = pos // B
        w = self.widths[blk].astype(np.int64)
        off = self._boff[blk] + (pos - blk * B) * w
        wi = off >> 6
        sh = (off & 63).astype(np.uint64)
        w64 = w.astype(np.uint64)
        lo = self.words[wi] >> sh
        sh2 = (np.uint64(64) - sh) & np.uint64(63)
        hi = np.where(sh > 0, self.words[wi + 1] << sh2, np.uint64(0))
        mask = np.where(w64 >= 64, ~np.uint64(0),
                        (np.uint64(1) << w64) - np.uint64(1))
        return ((lo | hi) & mask).astype(np.int64)

    def _row_ranges(self, rows: np.ndarray):
        """(start, end) positions in the delta stream of each row."""
        rows = np.asarray(rows, dtype=np.int64)
        s1 = self.boundary.select(rows + 1)
        s0 = np.where(rows > 0, self.boundary.select(np.maximum(rows, 1)) + 1,
                      0)
        return s0 - rows, s1 - rows

    def get_rows_mask(self, rows):
        rows = np.asarray(rows, dtype=np.int64)
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        if not len(rows) or not self.nnz:
            return out
        p0, p1 = self._row_ranges(rows)
        lens = p1 - p0
        tot = int(lens.sum())
        if not tot:
            return out
        seg_id = np.repeat(np.arange(len(rows)), lens)
        seg_first = np.cumsum(np.concatenate([[0], lens[:-1]]))
        within = np.arange(tot) - np.repeat(seg_first, lens)
        vals = self._decode(np.repeat(p0, lens) + within)
        cs = np.cumsum(vals)
        sf = np.minimum(seg_first, tot - 1)
        out[seg_id, cs - np.repeat(cs[sf] - vals[sf], lens)] = True
        return out


class UniqueRowBinmat:
    """Distinct rows in CSR + a code a row."""

    NAME = "unique_row"

    def __init__(self, codes, distinct_indptr, distinct_indices, num_labels):
        self.codes = codes
        self.indptr = distinct_indptr
        self.indices = distinct_indices
        self.num_rows = len(codes)
        self.num_labels = num_labels

    def get_rows_mask(self, rows):
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        for i, r in enumerate(rows):
            code = self.codes[r]
            out[i, self.indices[self.indptr[code]:
                                self.indptr[code + 1]]] = True
        return out


class Rainbowfish(UniqueRowBinmat):
    NAME = "rbfish"


class Rainbow:
    """A code a row + the distinct rows in an inner matrix of any type."""

    NAME = "rb_brwt"

    def __init__(self, codes, inner, num_labels):
        self.codes = codes
        self.inner = inner
        self.num_rows = len(codes)
        self.num_labels = num_labels

    def get_rows_mask(self, rows):
        rows = np.asarray(rows, dtype=np.int64)
        return self.inner.get_rows_mask(self.codes[rows])


class BinRelWT:
    """The concatenated label sequence with row boundaries."""

    NAME = "bin_rel_wt"

    def __init__(self, indptr, indices, num_labels):
        self.indptr = indptr
        self.indices = indices
        self.num_rows = len(indptr) - 1
        self.num_labels = num_labels

    def get_rows_mask(self, rows):
        rows = np.asarray(rows, dtype=np.int64)
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        for i, r in enumerate(rows):
            out[i, self.indices[self.indptr[r]: self.indptr[r + 1]]] = True
        return out


class RowDisk:
    """CSR rows in memory-mapped ``<path_base>.indptr.npy`` and
    ``.indices.npy``; the pickle holds only the paths."""

    NAME = "row_disk"

    def __init__(self, path_base, num_rows, num_labels):
        self.path_base = path_base
        self.num_rows = num_rows
        self.num_labels = num_labels
        self.indptr = np.load(path_base + ".indptr.npy", mmap_mode="r")
        self.indices = np.load(path_base + ".indices.npy", mmap_mode="r")

    def get_rows_mask(self, rows):
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        for i, r in enumerate(np.asarray(rows, dtype=np.int64)):
            lo, hi = int(self.indptr[r]), int(self.indptr[r + 1])
            if hi > lo:
                out[i, np.asarray(self.indices[lo:hi])] = True
        return out

    def __setstate__(self, state):
        self.__init__(state["path_base"], state["num_rows"],
                      state["num_labels"])


class BRWT:
    """Multi-BRWT: each node holds the bitmap of the rows (of its parent's
    reduced row space) with any label of its subset; leaves hold one
    label."""

    NAME = "brwt"

    class Node:
        __slots__ = ("bv", "children", "labels")

        def __init__(self, bitmap, children, labels):
            self.bv = bitmap if isinstance(bitmap, BitRank) \
                else BitRank(np.asarray(bitmap, dtype=np.uint8))
            self.children = children
            self.labels = labels                     # column ids (leaves)

    def __init__(self, root, num_rows, num_labels):
        self.root = root
        self.num_rows = num_rows
        self.num_labels = num_labels

    # labels per agglomerative group of greedy_linkage
    LINKAGE_GROUP = 2048

    @staticmethod
    def _sample_dense(columns, num_rows, max_sample_bytes):
        """Row-subsampled dense (n, m) bool sample of the columns."""
        n = len(columns)
        max_rows = max(max_sample_bytes // max(n, 1), 1024)
        if num_rows > max_rows:
            step = (num_rows + max_rows - 1) // max_rows
            m = (num_rows + step - 1) // step
            dense = np.zeros((n, m), dtype=bool)
            for c, col in enumerate(columns):
                col = np.asarray(col, dtype=np.int64)
                dense[c][col[col % step == 0] // step] = True
        else:
            dense = np.zeros((n, num_rows), dtype=bool)
            for c, col in enumerate(columns):
                dense[c][col] = True
        return dense

    @staticmethod
    def _agglomerate(mats, trees):
        """Greedy pairing of the most correlated clusters, round by round,
        until one tree is left."""
        while len(trees) > 1:
            f = mats.astype(np.float32)
            sim = (f @ f.T).astype(np.int64)
            np.fill_diagonal(sim, -1)
            order = np.dstack(np.unravel_index(
                np.argsort(sim, axis=None)[::-1], sim.shape))[0]
            used = np.zeros(len(trees), dtype=bool)
            pairs = []
            for a, b in order:
                if a < b and not used[a] and not used[b]:
                    used[a] = used[b] = True
                    pairs.append((int(a), int(b)))
                if used.all():
                    break
            new_trees, new_rows = [], []
            for a, b in pairs:
                new_trees.append((trees[a], trees[b]))
                new_rows.append(mats[a] | mats[b])
            for i in range(len(trees)):
                if not used[i]:
                    new_trees.append(trees[i])
                    new_rows.append(mats[i])
            trees = new_trees
            mats = np.stack(new_rows)
        return trees[0], mats[0]

    @classmethod
    def greedy_linkage(cls, columns, num_rows,
                       max_sample_bytes: int = 1 << 26):
        """Column clustering for the tree: a nested-tuple tree over label
        ids (direct agglomeration up to LINKAGE_GROUP labels; above it, a
        random-hyperplane sketch orders the columns into groups that
        agglomerate alone, then together)."""
        n = len(columns)
        if n == 1:
            return 0
        dense = cls._sample_dense(columns, num_rows, max_sample_bytes)
        if n <= cls.LINKAGE_GROUP:
            tree, _ = cls._agglomerate(dense, list(range(n)))
            return tree
        rng = np.random.default_rng(0)
        m = dense.shape[1]
        H = 24
        proj = dense.astype(np.float32) @ rng.standard_normal(
            (m, H)).astype(np.float32)
        bits = (proj > 0)
        key = np.zeros(n, dtype=np.uint64)
        for h in range(H):
            key = (key << np.uint64(1)) | bits[:, h].astype(np.uint64)
        order = np.argsort(key, kind="stable")
        G = cls.LINKAGE_GROUP
        group_trees, group_rows = [], []
        for lo in range(0, n, G):
            idx = order[lo: lo + G]
            t, merged = cls._agglomerate(dense[idx], [int(i) for i in idx])
            group_trees.append(t)
            group_rows.append(merged)
        if len(group_trees) == 1:
            return group_trees[0]
        top, _ = cls._agglomerate(np.stack(group_rows),
                                  list(range(len(group_trees))))

        def splice(t):
            return group_trees[t] if isinstance(t, int) \
                else (splice(t[0]), splice(t[1]))
        return splice(top)

    @classmethod
    def from_columns(cls, columns, num_rows, num_labels, arity: int = 2,
                     linkage: bool = True):
        """Per-label sorted row arrays -> BRWT, bottom up (the tree from
        greedy_linkage, or with ``linkage=False`` label ranges split
        ``arity`` ways)."""
        if num_labels == 0:
            root = cls.Node(np.zeros(num_rows, dtype=bool), [], [])
            return cls(root, num_rows, 0)
        columns = [np.asarray(col, dtype=np.int64) for col in columns]
        tree = cls.greedy_linkage(columns, num_rows) if linkage \
            and num_labels > 1 else None

        def tree_labels(t):
            return [t] if isinstance(t, int) else \
                tree_labels(t[0]) + tree_labels(t[1])

        def build(subtree, label_ids):
            """-> (the sorted global rows of the node's label subset, its
            children, its labels)."""
            if len(label_ids) == 1:
                return columns[label_ids[0]], [], list(label_ids)
            if subtree is not None and not isinstance(subtree, int):
                groups = [(subtree[0], tree_labels(subtree[0])),
                          (subtree[1], tree_labels(subtree[1]))]
            else:
                mid = (len(label_ids) + arity - 1) // arity
                groups = [(None, label_ids[i:i + mid])
                          for i in range(0, len(label_ids), mid)]
            built = [build(st, g) for st, g in groups]
            scopes = [b[0] for b in built]
            if sum(map(len, scopes)) * 8 >= num_rows:
                # dense scopes: a mask over the row space and its prefix
                # counts in place of sorted unions and binary searches
                mask = np.zeros(num_rows, dtype=bool)
                for sc in scopes:
                    mask[sc] = True
                scope = np.flatnonzero(mask)
                rank = np.cumsum(mask) - 1
                where = [rank[sc] for sc in scopes]
            else:
                # the sorted scopes merge in linear time (timsort finds the
                # runs), then repeats drop: their union1d without a sort
                scope = np.sort(np.concatenate(scopes), kind="stable")
                keep = np.ones(len(scope), dtype=bool)
                keep[1:] = scope[1:] != scope[:-1]
                scope = scope[keep]
                where = [np.searchsorted(scope, sc) for sc in scopes]
            children = []
            for (_, c_children, c_labels), at in zip(built, where):
                bm = np.zeros(len(scope), dtype=np.uint8)
                bm[at] = 1
                children.append(cls.Node(bm, c_children, c_labels))
            return scope, children, []

        scope, children, labels = build(
            tree, tree_labels(tree) if tree is not None
            else list(range(num_labels)))
        root_bm = np.zeros(num_rows, dtype=np.uint8)
        root_bm[scope] = 1
        return cls(cls.Node(root_bm, children, labels), num_rows, num_labels)

    def get_rows_mask(self, rows):
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        rows = np.asarray(rows, dtype=np.int64)

        def descend(node, rows_local, query_idx):
            if len(rows_local) == 0:
                return
            w = node.bv.words
            bits = (w[rows_local >> 6]
                    >> (rows_local & 63).astype(np.uint64)) & np.uint64(1)
            hit = np.flatnonzero(bits)
            if len(hit) == 0:
                return
            reduced = node.bv.rank(rows_local[hit]) - 1
            if not node.children:
                out[query_idx[hit], node.labels[0]] = True
                return
            for ch in node.children:
                descend(ch, reduced, query_idx[hit])

        descend(self.root, rows, np.arange(len(rows)))
        return out


def _chain_pairs(succ, anchors, rows, num_rows):
    """The lockstep successor walk of the row-diff matrices: -> ((query,
    chain node, depth) triples, every query's chain up to its anchor)."""
    owners, nodes, depths = [], [], []
    own = np.arange(len(rows), dtype=np.int64)
    cur = rows.copy()
    d = 0
    while len(own):
        owners.append(own)
        nodes.append(cur.copy())
        depths.append(np.full(len(own), d, dtype=np.int64))
        alive = ~(anchors[cur] | (succ[cur] < 0))
        own = own[alive]
        cur = succ[cur[alive]]
        d += 1
        if d > num_rows:
            raise ValueError(
                "row-diff successor walk did not terminate — "
                "inconsistent .rd_succ/.anchors sidecars")
    z = np.zeros(0, dtype=np.int64)
    return (np.concatenate(owners) if owners else z,
            np.concatenate(nodes) if nodes else z,
            np.concatenate(depths) if depths else z)


class RowDiff:
    """Rows stored as the symmetric difference with their successor row
    (``succ``, -1 = anchor), anchors stored whole; a staged build keeps
    the routing in ``.rd_succ``/``.anchors`` beside the graph."""

    NAME = "row_diff"

    def __init__(self, inner, succ, anchors, num_labels: int):
        self.inner = inner
        self.succ = succ
        self.anchors = anchors
        self.num_rows = inner.num_rows
        self.num_labels = num_labels
        self.needs_sidecars = succ is None

    def attach_sidecars(self, graph_base: str):
        """Load the staged build's ``.rd_succ``/``.anchors`` sidecars."""
        self.succ = np.load(graph_base + ".rd_succ")["succ"]
        self.anchors = np.load(graph_base + ".anchors")["anchors"]
        self.needs_sidecars = False

    @classmethod
    def from_annotation(cls, columns, num_rows, num_labels, routing,
                        inner_type: type = BRWT) -> "RowDiff":
        """Per-label sorted row arrays and the routing ``(succ, anchors)``
        -> RowDiff whose inner matrix (``inner_type.from_columns``) holds
        the diff columns: diff[r] = col[r] ^ col[succ[r]] where r is no
        anchor, as the predecessor image of each column.  Building the
        routing from a graph (``build_routing``) is not ported (ROADMAP
        A8.4), so the routing is given."""
        succ, anchors = routing
        has = succ >= 0
        src = np.flatnonzero(has)
        order = np.argsort(succ[src], kind="stable")
        pred_idx = src[order]
        pred_ptr = np.zeros(num_rows + 1, np.int64)
        np.add.at(pred_ptr, succ[src] + 1, 1)
        pred_ptr = np.cumsum(pred_ptr)
        diff_cols = []
        for col in columns:
            col = np.asarray(col, dtype=np.int64)
            cnt = pred_ptr[col + 1] - pred_ptr[col]
            starts = pred_ptr[col]
            flat = np.repeat(starts - np.cumsum(cnt) + cnt, cnt) \
                + np.arange(int(cnt.sum()))
            shifted = pred_idx[flat]
            shifted = shifted[~anchors[shifted]]
            diff_cols.append(np.setxor1d(col, shifted))
        inner = inner_type.from_columns(diff_cols, num_rows, num_labels)
        return cls(inner, succ, anchors, num_labels)

    def get_rows_words(self, rows):
        """Packed (n, ceil(L/32)) uint32 row words (little-endian bits)."""
        by = self._rows_packed_bytes(np.asarray(rows, dtype=np.int64))
        Lw = max(-(-self.num_labels // 32), 1)
        pad = Lw * 4 - by.shape[1]
        if pad:
            by = np.concatenate(
                [by, np.zeros((len(by), pad), np.uint8)], axis=1)
        return np.ascontiguousarray(by).view(np.uint32)

    def get_rows_mask(self, rows):
        by = self._rows_packed_bytes(np.asarray(rows, dtype=np.int64))
        return np.unpackbits(by, axis=1,
                             bitorder="little")[:, : self.num_labels] \
            .astype(bool)

    def _rows_packed_bytes(self, rows):
        if getattr(self, "needs_sidecars", False):
            raise ValueError(
                "row_diff annotation requires the graph's .rd_succ/.anchors "
                "sidecar files (staged build); attach_sidecars() first")
        if not len(rows):
            return np.zeros((0, -(-self.num_labels // 8)), dtype=np.uint8)
        owners, nodes, _ = _chain_pairs(self.succ, self.anchors, rows,
                                        self.num_rows)
        # inner rows in bounded slices, packed at once; then an XOR fold a
        # query (every query has its depth-0 pair, so none is empty)
        sl = max((64 << 20) // max(self.num_labels, 1), 1024)
        packed = np.concatenate(
            [np.packbits(np.asarray(
                self.inner.get_rows_mask(nodes[i: i + sl]), dtype=bool),
                axis=1, bitorder="little")
             for i in range(0, len(nodes), sl)])
        order = np.argsort(owners, kind="stable")
        starts = np.searchsorted(owners[order],
                                 np.arange(len(rows), dtype=np.int64))
        return np.bitwise_xor.reduceat(packed[order], starts, axis=0)


class CSRIntMatrix:
    """Per-row (label, value) pairs in CSR; presence = a stored pair."""

    NAME = "int_brwt"

    def __init__(self, indptr, indices, values, num_labels):
        self.indptr = indptr
        self.indices = indices
        self.values = values
        self.num_rows = len(indptr) - 1
        self.num_labels = num_labels

    def get_rows_mask(self, rows):
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        for i, r in enumerate(rows):
            out[i, self.indices[self.indptr[r]: self.indptr[r + 1]]] = True
        return out

    def get_row_values(self, rows):
        out = []
        for r in np.asarray(rows, dtype=np.int64):
            lo, hi = int(self.indptr[r]), int(self.indptr[r + 1])
            out.append([(int(c), int(v)) for c, v in
                        zip(self.indices[lo:hi], self.values[lo:hi])])
        return out


class IntRowDiff:
    """Count values stored as deltas with the row-diff successor's
    (anchors against zero); a row's values sum the deltas of its chain."""

    NAME = "row_diff_int_brwt"

    def __init__(self, deltas: CSRIntMatrix, succ, anchors, num_labels):
        self.deltas = deltas
        self.succ = succ
        self.anchors = anchors
        self.num_rows = deltas.num_rows
        self.num_labels = num_labels

    def _reconstruct_batch(self, rows):
        """(Q, L) values: the chain walk, then one scatter-add of the
        chain nodes' deltas."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.zeros((len(rows), self.num_labels), dtype=np.int64)
        if not len(rows):
            return out
        owners, nodes, _ = _chain_pairs(self.succ, self.anchors, rows,
                                        self.num_rows)
        ip = self.deltas.indptr
        cnt = (ip[nodes + 1] - ip[nodes]).astype(np.int64)
        pos = _ragged_gather(ip[nodes].astype(np.int64), cnt)
        np.add.at(out, (np.repeat(owners, cnt), self.deltas.indices[pos]),
                  self.deltas.values[pos])
        return out

    def get_rows_mask(self, rows):
        return self._reconstruct_batch(rows) > 0

    def get_row_values(self, rows):
        vals = self._reconstruct_batch(rows)
        return [[(int(c), int(v[c])) for c in np.flatnonzero(v)]
                for v in vals]


def _ragged_gather(starts, lens):
    """Indices of the slices [starts[i], starts[i] + lens[i]) of a flat
    array, concatenated."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    off = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    return np.repeat(starts - off, lens) + np.arange(total)


def _parity_triples(R, L, C):
    """The (R, L, C) triples that occur an odd number of times, sorted."""
    if not len(R):
        return R, L, C
    order = np.lexsort((C, L, R))
    R, L, C = R[order], L[order], C[order]
    eq = (R[1:] == R[:-1]) & (L[1:] == L[:-1]) & (C[1:] == C[:-1])
    first = np.concatenate([[0], np.flatnonzero(~eq) + 1])
    counts = np.diff(np.concatenate([first, [len(R)]]))
    sel = first[counts % 2 == 1]
    return R[sel], L[sel], C[sel]


class TupleCSCMatrix:
    """Coordinates in CSR: per row a slice of label codes, per (row,
    label) a slice of coordinates."""

    NAME = "brwt_coord"

    def __init__(self, lab_indptr, labels, coord_indptr, coords,
                 num_rows, num_labels):
        self.lab_indptr = lab_indptr
        self.labels = labels
        self.coord_indptr = coord_indptr
        self.coords = coords
        self.num_rows = num_rows
        self.num_labels = num_labels

    def get_rows_mask(self, rows):
        rows = np.asarray(rows, dtype=np.int64)
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        lens = self.lab_indptr[rows + 1] - self.lab_indptr[rows]
        idx = _ragged_gather(self.lab_indptr[rows], lens)
        out[np.repeat(np.arange(len(rows)), lens), self.labels[idx]] = True
        return out

    def get_row_tuples(self, rows):
        out = []
        for r in rows:
            r = int(r)
            out.append([
                (int(self.labels[j]),
                 self.coords[self.coord_indptr[j]:
                             self.coord_indptr[j + 1]].tolist())
                for j in range(int(self.lab_indptr[r]),
                               int(self.lab_indptr[r + 1]))])
        return out


class TupleRowDiff:
    """Coordinate sets stored as the symmetric difference with the
    successor's coordinates shifted by -1; anchors store whole sets."""

    NAME = "row_diff_coord"

    def __init__(self, diffs: TupleCSCMatrix, succ, anchors, num_labels):
        self.diffs = diffs
        self.succ = succ
        self.anchors = anchors
        self.num_rows = diffs.num_rows
        self.num_labels = num_labels

    def _reconstruct_triples(self, rows):
        """(owner, label, coord) sorted: the XOR over the chain nodes n_i at
        depth i of diffs(n_i) shifted by -i."""
        rows = np.asarray(rows, dtype=np.int64)
        O, N, D = _chain_pairs(self.succ, self.anchors, rows, self.num_rows)
        d = self.diffs
        p_lens = d.lab_indptr[N + 1] - d.lab_indptr[N]
        pair_idx = _ragged_gather(d.lab_indptr[N], p_lens)
        c_lens = d.coord_indptr[pair_idx + 1] - d.coord_indptr[pair_idx]
        tri_idx = _ragged_gather(d.coord_indptr[pair_idx], c_lens)
        return _parity_triples(
            np.repeat(np.repeat(O, p_lens), c_lens),
            np.repeat(d.labels[pair_idx], c_lens),
            d.coords[tri_idx] - np.repeat(np.repeat(D, p_lens), c_lens))

    def get_rows_mask(self, rows):
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        O, L, _ = self._reconstruct_triples(rows)
        out[O, L] = True
        return out

    def get_row_tuples(self, rows):
        O, L, C = self._reconstruct_triples(rows)
        out = [[] for _ in range(len(rows))]
        if not len(O):
            return out
        new = np.empty(len(O), dtype=bool)
        new[0] = True
        new[1:] = (O[1:] != O[:-1]) | (L[1:] != L[:-1])
        starts = np.flatnonzero(new)
        ends = np.concatenate([starts[1:], [len(O)]])
        for s, e in zip(starts, ends):
            out[int(O[s])].append((int(L[s]), C[s:e].tolist()))
        return out


MATRIX_TYPES = {
    "flat": RowFlat,
    "row_sparse": RowSparse,
    "brwt": BRWT,
    "rbfish": Rainbowfish,
    "rb_brwt": Rainbow,
    "bin_rel_wt": BinRelWT,
    "row_disk": RowDisk,
    "unique_row": UniqueRowBinmat,
}


class StaticAnnotation:
    """A converted annotation: matrix + label encoder."""

    def __init__(self, matrix, encoder: LabelEncoder,
                 representation: str):
        self.matrix = matrix
        self.encoder = encoder
        self.representation = representation
        self.num_rows = matrix.num_rows
        self.has_values = hasattr(matrix, "get_row_values")
        self.has_coords = hasattr(matrix, "get_row_tuples")

    @property
    def num_labels(self):
        return self.matrix.num_labels

    @property
    def labels(self) -> List[str]:
        return [self.encoder.decode(c) for c in range(self.num_labels)]

    def get_rows_mask(self, rows):
        return self.matrix.get_rows_mask(rows)

    def get_row_values(self, rows):
        if self.has_values:
            return self.matrix.get_row_values(rows)
        raise ValueError(f"k-mer counts are not indexed in a "
                         f"{self.representation} annotator")

    def get_row_tuples(self, rows):
        if self.has_coords:
            return self.matrix.get_row_tuples(rows)
        raise ValueError(f"coordinates are not indexed in a "
                         f"{self.representation} annotator")

    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self, f, protocol=4)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "StaticAnnotation":
        with open(path, "rb") as f:
            return _AnnotationUnpickler(f).load()


# the globals a StaticAnnotation pickle may name: module -> names
_PORT_CLASSES = {
    "annotation.matrix": {"StaticAnnotation", "BRWT", "BRWT.Node", "RowFlat",
                          "RowSparse", "UniqueRowBinmat", "Rainbowfish",
                          "Rainbow", "BinRelWT", "RowDisk", "RowDiff",
                          "CSRIntMatrix", "IntRowDiff", "TupleCSCMatrix",
                          "TupleRowDiff"},
    "annotation.column": {"LabelEncoder"},
    "succinct.bitrank": {"BitRank"},
}
_NUMPY_GLOBALS = {(m, n) for m in ("numpy.core.multiarray",
                                   "numpy._core.multiarray")
                  for n in ("_reconstruct", "scalar")} \
    | {("numpy", "ndarray"), ("numpy", "dtype")}


class _AnnotationUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        for pkg in ("metagraph_tpu.", "metagraph_tpu_torch."):
            if module.startswith(pkg) \
                    and name in _PORT_CLASSES.get(module[len(pkg):], ()):
                obj = sys.modules[f"metagraph_tpu_torch.{module[len(pkg):]}"]
                for part in name.split("."):
                    obj = getattr(obj, part)
                return obj
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"an annotation file may not name the global {module}.{name}")


def load_annotation(path: str):
    """A ``.column.annodbg(.npz)`` column annotation, a converted
    annotation (a pickle) or a reference-format ``.column.annodbg`` (sdsl
    serialization; ``seq_io/refformat.py``)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    if path.endswith(".npz"):
        return ColumnMajorAnnotation.load(path)
    if path.endswith(".column.annodbg"):
        with open(path, "rb") as f:
            head = f.read(2)
        if head != b"\x80\x04" and head != b"\x80\x05":   # not a pickle
            from ..seq_io.refformat import load_reference_column_annotation
            return load_reference_column_annotation(path)
    return StaticAnnotation.load(path)
