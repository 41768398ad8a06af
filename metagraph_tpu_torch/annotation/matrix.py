"""Converted (static) annotations: the matrices that ``transform_anno``
writes, built, read and queried.

Own copy of metagraph_tpu/annotation/matrix.py: the binary matrices
``RowFlat`` (:66), ``RowSparse`` (:87), ``UniqueRowBinmat``/
``Rainbowfish`` (:259, :285), ``Rainbow`` (:289), ``BinRelWT`` (:324),
``RowDisk`` (:364), ``BRWT`` (:408) and ``RowDiff`` (:617); the value and
coordinate matrices ``CSRIntMatrix`` (:909), ``IntRowDiff`` (:960),
``TupleCSCMatrix`` (:1066) and ``TupleRowDiff`` (:1157); ``MATRIX_TYPES``
(:1274), ``StaticAnnotation`` (:1287) and ``load_annotation`` (:1337);
and the converters that build each from columns (``from_columns``,
``from_pairs``, ``from_triples``, ``from_annotation``; ``_dedup_csr_rows``
:210, ``_row_diff_inner`` :1259, ``convert_annotation`` :1354), with the
JAX arrays.  ``RowDiff.build_routing`` (:685-908) takes each valid edge's
successor through ``boss.fwd`` on the host, then places the anchors by
pointer doubling (and resolves the cycle basins) as int64 tensor ops on
its device: the card unless "cpu".  ``IntRowDiff.from_annotation``
computes the JAX deltas column by column instead of through a dense
(rows x labels) matrix.

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
import torch

from ..succinct.bitrank import BitRank
from .column import ColumnMajorAnnotation, LabelEncoder


def _csr_from_columns(columns, num_rows: int):
    """Per-label sorted row arrays -> (indptr, indices), row-major CSR."""
    pairs_r = np.concatenate(columns) if columns \
        and sum(map(len, columns)) else np.zeros(0, dtype=np.int64)
    pairs_c = np.concatenate(
        [np.full(len(col), c, dtype=np.int64)
         for c, col in enumerate(columns)]) if columns and len(pairs_r) \
        else np.zeros(0, dtype=np.int64)
    order = np.lexsort((pairs_c, pairs_r))
    r, c = pairs_r[order], pairs_c[order]
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.add.at(indptr, r + 1, 1)
    return np.cumsum(indptr), c


def _csr_mask(indptr, indices, rows, num_labels: int) -> np.ndarray:
    """(Q, L) bool membership of CSR rows ``rows``, in one gather."""
    rows = np.asarray(rows, dtype=np.int64)
    out = np.zeros((len(rows), num_labels), dtype=bool)
    lo = np.asarray(indptr[rows], dtype=np.int64)
    lens = np.asarray(indptr[rows + 1], dtype=np.int64) - lo
    at = _ragged_gather(lo, lens)
    out[np.repeat(np.arange(len(rows)), lens),
        np.asarray(indices[at], dtype=np.int64)] = True
    return out


def _predecessors(succ, anchors, num_rows: int):
    """The rows that take each row as their row-diff successor (anchors
    left out): -> (ptr, rows), row r's at rows[ptr[r]:ptr[r + 1]]."""
    src = np.flatnonzero((succ >= 0) & ~anchors)
    ptr = np.zeros(num_rows + 1, np.int64)
    np.add.at(ptr, succ[src] + 1, 1)
    return np.cumsum(ptr), src[np.argsort(succ[src], kind="stable")]


def _preds_of(pred, rows):
    """Every predecessor of ``rows``, with the count of each row's."""
    ptr, idx = pred
    cnt = ptr[rows + 1] - ptr[rows]
    return idx[_ragged_gather(ptr[rows], cnt)], cnt


def _sum_rows(matrix, row_counts, min_count: int):
    """[(row, multiplicity)] -> [(label code, total >= min_count)]."""
    rows = np.array([r for r, _ in row_counts], dtype=np.int64)
    mult = np.array([m for _, m in row_counts], dtype=np.int64)
    if not len(rows):
        return []
    totals = matrix.get_rows_mask(rows).astype(np.int64).T @ mult
    return [(c, int(totals[c])) for c in range(matrix.num_labels)
            if totals[c] >= min_count]


class RowFlat:
    """CSR rows: ``indptr``, ``indices``."""

    NAME = "flat"

    def __init__(self, indptr, indices, num_labels):
        self.indptr = indptr
        self.indices = indices
        self.num_rows = len(indptr) - 1
        self.num_labels = num_labels

    @classmethod
    def from_columns(cls, columns, num_rows, num_labels):
        return cls(*_csr_from_columns(columns, num_rows), num_labels)

    def get_rows_mask(self, rows):
        return _csr_mask(self.indptr, self.indices, rows, self.num_labels)


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

    @classmethod
    def from_columns(cls, columns, num_rows, num_labels):
        """The rows' column ids delta-coded (each row's first absolute),
        packed 64 values a block at the block's width, and a terminator
        bit after each row's deltas."""
        indptr, indices = _csr_from_columns(columns, num_rows)
        nnz = len(indices)
        deltas = indices.astype(np.uint64).copy()
        if nnz > 1:
            deltas[1:] = (indices[1:] - indices[:-1]).astype(np.uint64)
        firsts = indptr[:-1][indptr[:-1] < indptr[1:]]
        deltas[firsts] = indices[firsts].astype(np.uint64)
        boundary = np.zeros(nnz + num_rows, dtype=bool)
        boundary[indptr[1:] + np.arange(num_rows)] = True
        B = cls.BLOCK
        nblk = (nnz + B - 1) // B if nnz else 0
        pad = np.zeros(nblk * B, dtype=np.uint64)
        pad[:nnz] = deltas
        if nblk:
            mx = pad.reshape(nblk, B).max(axis=1)
            widths = np.maximum(
                np.ceil(np.log2(mx.astype(np.float64) + 1)), 1
            ).astype(np.uint8)
            # exact width for powers of two (float log2 can round down)
            widths = np.maximum(widths, np.where(
                mx >> widths.astype(np.uint64) != 0, widths + 1, widths
            ).astype(np.uint8))
        else:
            widths = np.zeros(0, dtype=np.uint8)
        boff = np.zeros(nblk + 1, dtype=np.int64)
        np.cumsum(widths.astype(np.int64) * B, out=boff[1:])
        words = np.zeros(int(boff[-1]) // 64 + 2, dtype=np.uint64)
        if nnz:
            j = np.arange(nnz, dtype=np.int64)
            blk = j // B
            off = boff[blk] + (j - blk * B) * widths[blk].astype(np.int64)
            wi = off >> 6
            sh = (off & 63).astype(np.uint64)
            np.bitwise_or.at(words, wi, deltas << sh)
            spill = sh > 0
            np.bitwise_or.at(words, wi[spill] + 1,
                             deltas[spill] >> (np.uint64(64) - sh[spill]))
        return cls(words, widths, boundary, num_rows, num_labels, nnz)

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


def _dedup_csr_rows(indptr, indices):
    """Deduplicate CSR rows, codes in first-occurrence order: rows grouped
    by length, each group deduped with ``np.unique(axis=0)``, the groups
    merged by each distinct row's first row.  -> (codes, distinct indptr,
    distinct indices)."""
    num_rows = len(indptr) - 1
    lens = np.diff(indptr)
    codes = np.zeros(num_rows, dtype=np.int64)
    firsts, inv_list, base = [], [], 0
    for ln in np.unique(lens):
        rsel = np.flatnonzero(lens == ln)
        if ln == 0:
            firsts.append((np.array([rsel[0]]),
                           np.zeros((1, 0), dtype=indices.dtype)))
            inv_list.append((rsel, np.zeros(len(rsel), dtype=np.int64),
                             base))
            base += 1
            continue
        mat = indices[indptr[rsel][:, None] + np.arange(ln)]
        uniq, first_i, inv = np.unique(mat, axis=0, return_index=True,
                                       return_inverse=True)
        firsts.append((rsel[first_i], uniq))
        inv_list.append((rsel, inv.reshape(-1), base))
        base += len(uniq)
    first_rows = np.concatenate([f for f, _ in firsts]) if firsts \
        else np.zeros(0, dtype=np.int64)
    order = np.argsort(first_rows, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    for rsel, inv, b in inv_list:
        codes[rsel] = rank[b + inv]
    contents = [None] * len(order)
    pos = 0
    for f, uniq in firsts:
        for t in range(len(f)):
            contents[rank[pos + t]] = uniq[t]
        pos += len(f)
    d_indptr = np.zeros(len(order) + 1, dtype=np.int64)
    if contents:
        d_indptr[1:] = np.cumsum([len(c) for c in contents])
    d_indices = np.concatenate(contents).astype(np.int64) if contents \
        else np.zeros(0, dtype=np.int64)
    return codes, d_indptr, d_indices


class UniqueRowBinmat:
    """Distinct rows in CSR + a code a row."""

    NAME = "unique_row"

    def __init__(self, codes, distinct_indptr, distinct_indices, num_labels):
        self.codes = codes
        self.indptr = distinct_indptr
        self.indices = distinct_indices
        self.num_rows = len(codes)
        self.num_labels = num_labels

    @classmethod
    def from_columns(cls, columns, num_rows, num_labels):
        return cls(*_dedup_csr_rows(*_csr_from_columns(columns, num_rows)),
                   num_labels)

    def get_rows_mask(self, rows):
        return _csr_mask(self.indptr, self.indices,
                         self.codes[np.asarray(rows, dtype=np.int64)],
                         self.num_labels)


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

    @classmethod
    def from_columns(cls, columns, num_rows, num_labels, inner_type=None):
        """The distinct rows (``_dedup_csr_rows``) as columns of an inner
        matrix (a BRWT unless ``inner_type``)."""
        inner_type = inner_type or BRWT
        codes, d_indptr, d_indices = _dedup_csr_rows(
            *_csr_from_columns(columns, num_rows))
        ndist = len(d_indptr) - 1
        d_rows = np.repeat(np.arange(ndist, dtype=np.int64),
                           np.diff(d_indptr))
        order = np.lexsort((d_rows, d_indices))
        lab_sorted, row_sorted = d_indices[order], d_rows[order]
        starts = np.searchsorted(lab_sorted, np.arange(num_labels + 1))
        inner = inner_type.from_columns(
            [row_sorted[starts[c]: starts[c + 1]]
             for c in range(num_labels)], ndist, num_labels)
        return cls(codes, inner, num_labels)

    def get_rows_mask(self, rows):
        rows = np.asarray(rows, dtype=np.int64)
        return self.inner.get_rows_mask(self.codes[rows])


class BinRelWT:
    """The concatenated label sequence with row boundaries, and each
    label's positions in it (the wavelet tree's select)."""

    NAME = "bin_rel_wt"

    def __init__(self, indptr, indices, num_labels):
        self.indptr = indptr
        self.indices = indices
        self.num_rows = len(indptr) - 1
        self.num_labels = num_labels
        self._post = np.argsort(indices, kind="stable")
        self._post_off = np.zeros(num_labels + 1, dtype=np.int64)
        np.add.at(self._post_off, indices + 1, 1)
        self._post_off = np.cumsum(self._post_off)

    @classmethod
    def from_columns(cls, columns, num_rows, num_labels):
        return cls(*_csr_from_columns(columns, num_rows), num_labels)

    def get_column(self, c):
        """The rows holding label c, through its positions."""
        pos = self._post[self._post_off[c]: self._post_off[c + 1]]
        return np.unique(np.searchsorted(self.indptr, pos, side="right") - 1)

    def get_rows_mask(self, rows):
        return _csr_mask(self.indptr, self.indices, rows, self.num_labels)


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
        return _csr_mask(self.indptr, self.indices, rows, self.num_labels)

    @classmethod
    def from_columns(cls, columns, num_rows, num_labels, path_base=None):
        """The CSR rows saved to ``<path_base>.indptr.npy`` and
        ``.indices.npy`` (a temporary directory's without a base)."""
        if path_base is None:
            import tempfile
            path_base = os.path.join(tempfile.mkdtemp(prefix="rowdisk_"),
                                     "rows")
        indptr, indices = _csr_from_columns(columns, num_rows)
        np.save(path_base + ".indptr.npy", indptr)
        np.save(path_base + ".indices.npy", indices)
        return cls(path_base, num_rows, num_labels)

    def __getstate__(self):
        return {"path_base": self.path_base, "num_rows": self.num_rows,
                "num_labels": self.num_labels}

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
        until one tree is left.  The pairs are the JAX loop's (the same
        order, the same stop once every cluster is used), walked as Python
        ints over the upper triangle only."""
        while len(trees) > 1:
            f = mats.astype(np.float32)
            sim = (f @ f.T).astype(np.int64)
            np.fill_diagonal(sim, -1)
            first, second = np.unravel_index(
                np.argsort(sim, axis=None)[::-1], sim.shape)
            upper = first < second
            used = np.zeros(len(trees), dtype=bool)
            pairs, n_used = [], 0
            for a, b in zip(first[upper].tolist(), second[upper].tolist()):
                if not used[a] and not used[b]:
                    used[a] = used[b] = True
                    pairs.append((a, b))
                    n_used += 2
                    if n_used == len(trees):
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
    def from_annotation(cls, columns, num_rows, num_labels, routing=None,
                        inner_type: type = None, graph=None,
                        max_length: int = 100, external_routing=False,
                        device=None) -> "RowDiff":
        """Per-label sorted row arrays -> RowDiff whose inner matrix
        (``inner_type.from_columns``, RowFlat by default) holds the diff
        columns: diff[r] = col[r] ^ col[succ[r]] where r is no anchor, as
        the predecessor image of each column.  The routing ``(succ,
        anchors)`` is given or built from ``graph`` (``build_routing`` on
        ``device``); with ``external_routing`` the matrix keeps none (the
        staged build's sidecars hold it)."""
        inner_type = inner_type or RowFlat
        succ, anchors = routing if routing is not None \
            else cls.build_routing(graph, max_length, device)
        pred = _predecessors(succ, anchors, num_rows)
        diff_cols = []
        for col in columns:
            col = np.asarray(col, dtype=np.int64)
            diff_cols.append(np.setxor1d(col, _preds_of(pred, col)[0]))
        inner = inner_type.from_columns(diff_cols, num_rows, num_labels)
        if external_routing:
            return cls(inner, None, None, num_labels)
        return cls(inner, succ, anchors, num_labels)

    @staticmethod
    def build_routing(graph, max_length: int = 100, device=None):
        """-> (succ, anchors) over the graph's ``max_index()`` rows: each
        valid edge's successor is the target node's last edge
        (``boss.fwd``, on the host), -1 at sinks; paths are cut by an
        anchor every ``max_length`` rows.  The anchors come from pointer
        doubling over the successors (a node that reaches a terminal sits
        at its depth mod ``max_length``) and, in cycle basins, from
        ``_resolve_cycle_basins``: int64 tensor ops on ``device``."""
        from ..device import resolve_device
        dev = resolve_device(device)
        boss = graph.boss
        M = len(boss.W)
        valid = np.asarray(boss.valid).astype(bool)
        idx = np.flatnonzero(valid)
        labels = np.asarray(boss.W[idx]) % boss.alph_size
        non_sink = labels > 0
        tgt = np.zeros(len(idx), dtype=np.int64)
        if non_sink.any():
            tgt[non_sink] = boss.fwd(idx[non_sink])
        ok = non_sink & (tgt > 0) & valid[np.clip(tgt, 0, M - 1)]
        succ_rows = np.full(len(idx), -1, dtype=np.int64)
        succ_rows[ok] = tgt[ok] - 1            # annotation row = node - 1
        succ_full = np.full(M, -1, dtype=np.int64)
        succ_full[idx] = np.where(succ_rows >= 0, succ_rows + 1, -1)

        sf = torch.from_numpy(succ_full).to(dev)
        valid_t = torch.from_numpy(valid).to(dev)
        ar = torch.arange(M, dtype=torch.int64, device=dev)
        jump = torch.where(sf > 0, sf, ar)
        w = (sf > 0).long()
        for _ in range(max(M - 1, 1).bit_length()):
            w = w + w[jump]
            jump = jump[jump]
        dist = torch.full((M,), -1, dtype=torch.int64, device=dev)
        anchors = torch.zeros(M, dtype=torch.bool, device=dev)
        resolved = valid_t & (sf[jump] <= 0)
        dist[resolved] = w[resolved] % max_length
        anchors[resolved] = dist[resolved] == 0
        unresolved = torch.nonzero(valid_t & (dist == -1)).squeeze(1)
        if len(unresolved):
            RowDiff._resolve_cycle_basins(sf, unresolved, dist, anchors,
                                          max_length)
        anchors = anchors.cpu().numpy()
        succ_row = np.full(graph.max_index(), -1, dtype=np.int64)
        anchor_row = np.zeros(graph.max_index(), dtype=bool)
        rows_of = idx - 1
        succ_row[rows_of] = np.where(anchors[idx], -1,
                                     np.where(succ_rows >= 0, succ_rows, -1))
        anchor_row[rows_of] = anchors[idx] | (succ_rows < 0)
        return succ_row, anchor_row

    @staticmethod
    def _resolve_cycle_basins(succ_full, unresolved, dist, anchors,
                              max_length):
        """The anchors of the cycle basins that doubling leaves (tensors,
        in place): once each cycle's one entry anchor is fixed (the
        basin's least node walks into its cycle at an entry and anchors
        the entry's cycle predecessor), every basin node sits at its steps
        to that anchor mod ``max_length``.  Landing spots, cycle minima,
        min-plus distances and jumps by per-node step counts all come from
        doubling tables over the closed unresolved subgraph."""
        dev = succ_full.device
        U = len(unresolved)
        compact = torch.full((len(succ_full),), -1, dtype=torch.int64,
                             device=dev)
        ar = torch.arange(U, dtype=torch.int64, device=dev)
        compact[unresolved] = ar
        succ_c = compact[succ_full[unresolved]]
        assert bool((succ_c >= 0).all())
        L = max(int(np.ceil(np.log2(max(2 * U, 2)))) + 1, 1)
        jumps = [succ_c]                   # jumps[k][n] = advance(n, 2^k)
        for _ in range(L - 1):
            jumps.append(jumps[-1][jumps[-1]])
        land = jumps[-1][jumps[-1]]        # on the basin's cycle
        mn = unresolved.clone()
        for k in range(L):
            mn = torch.minimum(mn, mn[jumps[k]])
        comp = mn[land]                    # the cycle's least original id
        cmin_c = compact[comp]

        def dist_to(target):
            r = torch.where(target, 0, 1 << 60)
            for k in range(L):
                r = torch.minimum(r, (1 << k) + r[jumps[k]])
            return r

        def advance(start, count):
            cur = start.clone()
            for k in range(L):
                cur = torch.where(((count >> k) & 1) == 1, jumps[k][cur],
                                  cur)
            return cur

        cyclen = dist_to(ar == cmin_c)[succ_c[cmin_c]] + 1
        on_cycle = advance(ar, cyclen) == ar
        ukeys, inv = torch.unique(comp, return_inverse=True)
        emin = torch.full((len(ukeys),), torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=dev)
        emin.scatter_reduce_(0, inv, unresolved, "amin")
        emin_c = compact[emin]
        c_entry = advance(emin_c, dist_to(on_cycle)[emin_c])
        a_c = advance(c_entry, cyclen[emin_c] - 1)
        d = dist_to(ar == a_c[inv]) % max_length
        dist[unresolved] = d
        anchors[unresolved] = d == 0

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

    @classmethod
    def from_pairs(cls, cols, vals, num_rows, num_labels):
        """Per-label sorted row arrays and their values -> CSR."""
        pairs_r = np.concatenate(cols) if cols else np.zeros(0, np.int64)
        pairs_c = np.concatenate(
            [np.full(len(c), i, np.int64) for i, c in enumerate(cols)]) \
            if cols else np.zeros(0, np.int64)
        pairs_v = np.concatenate(vals) if vals else np.zeros(0, np.int64)
        order = np.lexsort((pairs_c, pairs_r))
        r, c, v = pairs_r[order], pairs_c[order], pairs_v[order]
        indptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.add.at(indptr, r + 1, 1)
        return cls(np.cumsum(indptr), c, v.astype(np.int64), num_labels)

    @classmethod
    def from_annotation_values(cls, anno):
        return cls.from_pairs(
            [anno.column_rows(c) for c in range(anno.num_labels)],
            [_values_of(anno, c) for c in range(anno.num_labels)],
            anno.num_rows, anno.num_labels)

    def get_rows_mask(self, rows):
        return _csr_mask(self.indptr, self.indices, rows, self.num_labels)

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

    @classmethod
    def from_annotation(cls, anno, graph, max_length: int = 100,
                        device=None):
        """Each row's delta with its successor's values (anchors against
        zero), kept where not zero: the JAX dense computation, column by
        column over each column's rows and their predecessors."""
        succ, anchors = RowDiff.build_routing(graph, max_length, device)
        num_rows, num_labels = anno.num_rows, anno.num_labels
        pred = _predecessors(succ, anchors, num_rows)
        cols, vals = [], []
        for c in range(num_labels):
            rows = np.asarray(anno.column_rows(c), dtype=np.int64)
            v = _values_of(anno, c)
            rows, v = rows[v != 0], v[v != 0]
            preds, cnt = _preds_of(pred, rows)
            r = np.concatenate([rows, preds])
            d = np.concatenate([v, -np.repeat(v, cnt)])
            u, inv = np.unique(r, return_inverse=True)
            total = np.zeros(len(u), np.int64)
            np.add.at(total, inv.reshape(-1), d)
            keep = total != 0
            cols.append(u[keep])
            vals.append(total[keep])
        deltas = CSRIntMatrix.from_pairs(cols, vals, num_rows, num_labels)
        return cls(deltas, succ, anchors, num_labels)

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

    @classmethod
    def from_triples(cls, rows, labs, crd, num_rows, num_labels):
        """(row, label, coordinate) triples sorted in that order."""
        if len(rows):
            new = np.empty(len(rows), dtype=bool)
            new[0] = True
            new[1:] = (rows[1:] != rows[:-1]) | (labs[1:] != labs[:-1])
            starts = np.flatnonzero(new).astype(np.int64)
            labels = labs[starts]
            pair_rows = rows[starts]
            coord_indptr = np.concatenate([starts, [len(rows)]])
        else:
            labels = np.zeros(0, dtype=np.int64)
            pair_rows = np.zeros(0, dtype=np.int64)
            coord_indptr = np.zeros(1, dtype=np.int64)
        lab_indptr = np.searchsorted(
            pair_rows, np.arange(num_rows + 1, dtype=np.int64))
        return cls(lab_indptr, labels, coord_indptr,
                   np.ascontiguousarray(crd, dtype=np.int64),
                   num_rows, num_labels)

    @classmethod
    def from_annotation(cls, anno):
        return cls.from_triples(*anno.coords_triples(), anno.num_rows,
                                anno.num_labels)

    def row_triples(self, rows, owners=None):
        """(owner, label, coordinate) triples of ``rows`` in order;
        ``owners`` renames each row (its position by default)."""
        rows = np.asarray(rows, dtype=np.int64)
        if owners is None:
            owners = np.arange(len(rows), dtype=np.int64)
        p_lens = self.lab_indptr[rows + 1] - self.lab_indptr[rows]
        pair_idx = _ragged_gather(self.lab_indptr[rows], p_lens)
        c_lens = self.coord_indptr[pair_idx + 1] - self.coord_indptr[pair_idx]
        tri_idx = _ragged_gather(self.coord_indptr[pair_idx], c_lens)
        return (np.repeat(np.repeat(owners, p_lens), c_lens),
                np.repeat(self.labels[pair_idx], c_lens),
                self.coords[tri_idx])

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

    @classmethod
    def from_annotation(cls, anno, graph, max_length: int = 100,
                        device=None):
        """diff(r) = coords(r) XOR (coords(succ(r)) - 1) for rows that are
        no anchor, the whole coordinate set at anchors."""
        succ, anchors = RowDiff.build_routing(graph, max_length, device)
        num_rows, num_labels = anno.num_rows, anno.num_labels
        full = TupleCSCMatrix.from_annotation(anno)
        R, L, C = full.row_triples(np.arange(num_rows))
        if len(R):
            keep = np.empty(len(R), dtype=bool)
            keep[0] = True
            keep[1:] = ((R[1:] != R[:-1]) | (L[1:] != L[:-1])
                        | (C[1:] != C[:-1]))
            R, L, C = R[keep], L[keep], C[keep]
        full = TupleCSCMatrix.from_triples(R, L, C, num_rows, num_labels)
        src = np.flatnonzero(~anchors & (succ >= 0))
        sR, sL, sC = full.row_triples(succ[src], owners=src)
        dR, dL, dC = _parity_triples(np.concatenate([R, sR]),
                                     np.concatenate([L, sL]),
                                     np.concatenate([C, sC - 1]))
        return cls(TupleCSCMatrix.from_triples(dR, dL, dC, num_rows,
                                               num_labels),
                   succ, anchors, num_labels)

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


def _values_of(anno, c: int) -> np.ndarray:
    """Column c's values (zeros where the annotation holds none)."""
    vals = getattr(anno, "_values", None)
    return np.zeros(len(anno.column_rows(c)), np.int64) if vals is None \
        else np.asarray(vals[c], dtype=np.int64)


def _row_diff_inner(target: str):
    """The inner matrix class of a row_diff_<inner> target; SystemExit
    with the JAX text on an unknown inner name."""
    inner_name = target[len("row_diff"):].lstrip("_") or "flat"
    inner_name = {"sparse": "row_sparse", "disk": "row_disk"}.get(
        inner_name, inner_name)
    inner = MATRIX_TYPES.get(inner_name)
    if inner is None:
        raise SystemExit(f"ERROR: unknown row_diff inner representation "
                         f"'{inner_name}' (available: "
                         f"{', '.join(sorted(MATRIX_TYPES))})")
    return inner


def convert_annotation(anno, target: str, graph=None,
                       out_base: str | None = None,
                       max_path_length: int = 100, device=None):
    """A frozen column annotation -> the ``target`` matrix (the JAX
    ``convert_annotation``; ``max_path_length`` spaces the anchors of the
    binary row-diff targets, the int and coordinate ones keep 100, as
    there); the routing of a row-diff target on ``device``."""
    if target == "int_brwt":
        return CSRIntMatrix.from_annotation_values(anno)
    if target == "row_diff_int_brwt":
        assert graph is not None, "row_diff requires the graph"
        return IntRowDiff.from_annotation(anno, graph, device=device)
    if target == "brwt_coord":
        return TupleCSCMatrix.from_annotation(anno)
    if target in ("row_diff_coord", "row_diff_brwt_coord"):
        assert graph is not None, "row_diff requires the graph"
        return TupleRowDiff.from_annotation(anno, graph, device=device)
    columns = [anno.column_rows(c) for c in range(anno.num_labels)]
    if target.startswith("row_diff"):
        assert graph is not None, "row_diff requires the graph"
        return RowDiff.from_annotation(
            columns, anno.num_rows, anno.num_labels, graph=graph,
            max_length=max_path_length, inner_type=_row_diff_inner(target),
            device=device)
    m = MATRIX_TYPES.get(target)
    if m is None:
        raise SystemExit(f"ERROR: unknown annotation representation "
                         f"'{target}' (available: "
                         f"{', '.join(sorted(MATRIX_TYPES))}, row_diff*)")
    if m is RowDisk:
        return m.from_columns(columns, anno.num_rows, anno.num_labels,
                              path_base=out_base)
    return m.from_columns(columns, anno.num_rows, anno.num_labels)


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

    def sum_rows(self, row_counts, min_count):
        return _sum_rows(self.matrix, row_counts, min_count)

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
