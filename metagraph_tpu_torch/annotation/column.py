"""Column-major multi-label annotation: the builder and the frozen form.

Own copy of metagraph_tpu/annotation/column.py for both halves:

* building (:21-222): ``LabelEncoder``'s ``insert_and_encode``,
  ``encode`` and ``rename`` (:28-56) and ``ColumnBuilder``, the JAX
  ``ColumnMajorAnnotation`` before ``freeze``: ``add_labels``,
  ``add_label_counts``, ``add_label_coords``, ``enable_disk_swap`` with its
  spill and stream-back (:83-138), and ``freeze`` (:179-222), whose rules
  it keeps (a column's rows sorted and distinct; the counts of one row
  summed, their rows unioned into the column; coordinates sorted by (row,
  coordinate); a label made only where a row reaches it).  ``freeze``
  sorts on the builder's device through kernel D2: one sort of (label,
  row) keys over all columns with the counts as payload, then one of
  (label, row, coordinate); under disk swap each column streams back and
  sorts in turn, so that the RAM cap holds.  It ends in the frozen class;
* ``ColumnMajorAnnotation``, read from ``.column.annodbg.npz`` (:347-374)
  in both codecs ("sorted": one sorted array of set rows per label;
  "smallest": each label's rows as an sd, rrr or stat bit vector,
  ``succinct/bitvector.py``), with optional per-entry k-mer counts
  (``vals_c``) and coordinates (``coords_c``: (row, coordinate) pairs
  sorted by row, then coordinate), written by ``save`` (:326-345) in both
  codecs, and its row queries ``get_rows_mask``, ``sum_rows``,
  ``get_row_values`` and ``get_row_tuples`` (:232-291); ``row_labels``
  gives the labels of many rows from a row-major index, for the labeled
  aligner's buffer.

``LabelEncoder`` (:21) is also the label table that converted
(``StaticAnnotation``) files hold.
"""

from __future__ import annotations

import inspect
import os
import shutil
import tempfile
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.npz import savez

class LabelEncoder:
    """label string <-> code; the attribute names are the JAX class's, so
    that its pickles restore into this one."""

    def __init__(self, labels: Sequence[str] = ()):
        self._labels: List[str] = list(labels)
        self._index: Dict[str, int] = {l: i for i, l in
                                       enumerate(self._labels)}

    def __setstate__(self, state):
        self.__dict__.update(state)
        if "_index" not in state:
            self._index = {l: i for i, l in enumerate(self._labels)}

    def insert_and_encode(self, label: str) -> int:
        code = self._index.get(label)
        if code is None:
            code = len(self._labels)
            self._index[label] = code
            self._labels.append(label)
        return code

    def encode(self, label: str) -> int:
        return self._index[label]

    def decode(self, code: int) -> str:
        return self._labels[code]

    def __len__(self):
        return len(self._labels)

    def rename(self, mapping: Dict[str, str]):
        """Rename labels in place; raises ValueError on a label it does not
        hold or on duplicate new labels, with the JAX messages."""
        for old in mapping:
            if old not in self._index:
                raise ValueError(f"Label '{old}' not found in annotation")
        new_labels = [mapping.get(l, l) for l in self._labels]
        if len(set(new_labels)) != len(new_labels):
            raise ValueError("renaming produces duplicate labels")
        self._labels = new_labels
        self._index = {l: i for i, l in enumerate(self._labels)}

    @property
    def labels(self) -> List[str]:
        return self._labels


def _row_major(label_rows, num_rows):
    """A row-major index of per-label row arrays: -> (ptr (num_rows + 1,),
    labels, order); row r's entries are [ptr[r], ptr[r + 1]), labels
    ascending, each label's entries in their stored order, and ``order``
    maps them to positions in the labels' concatenation."""
    n = [len(r) for r in label_rows]
    row = (np.concatenate(label_rows).astype(np.int64) if sum(n)
           else np.zeros(0, np.int64))
    order = np.argsort(row, kind="stable")
    lab = np.repeat(np.arange(len(n), dtype=np.int64), n)[order]
    return np.searchsorted(row[order], np.arange(num_rows + 1)), lab, order


def _gather(ptr, rows):
    """The entries of ``rows`` in a row-major index: -> (owner, positions),
    owner i for rows[i]."""
    rows = np.asarray(rows, dtype=np.int64)
    lo = ptr[rows]
    n = ptr[rows + 1] - lo
    at = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
    return np.repeat(np.arange(len(rows)), n), at


class ColumnMajorAnnotation:
    def __init__(self, num_rows: int, labels: Sequence[str],
                 rows: Sequence[np.ndarray],
                 values: Sequence[np.ndarray] | None = None,
                 coords: Sequence[np.ndarray] | None = None,
                 has_values: bool = False, has_coords: bool = False):
        self.num_rows = int(num_rows)
        self.encoder = LabelEncoder(labels)
        self._rows = [np.asarray(r, dtype=np.int64) for r in rows]
        self._values = None if values is None \
            else [np.asarray(v, dtype=np.int64) for v in values]
        self._coords = None if coords is None \
            else [np.asarray(c, dtype=np.int64).reshape(-1, 2)
                  for c in coords]
        self.has_values = has_values
        self.has_coords = has_coords
        self._row_index = None
        self._label_index = None
        self.column_codecs = None

    @property
    def labels(self) -> List[str]:
        return self.encoder.labels

    @property
    def num_labels(self) -> int:
        return len(self.encoder)

    def column_rows(self, code: int) -> np.ndarray:
        return self._rows[code]

    def values_of(self, rows: np.ndarray, code: int) -> np.ndarray:
        """Per-row value of label ``code`` for rows that carry it: the k-mer
        count, or the number of coordinates of a coordinate-only annotation
        (the semantics of metagraph_tpu's ``get_row_values``)."""
        rows = np.asarray(rows, dtype=np.int64)
        if not self.has_values and self.has_coords:
            rc = self._coords[code][:, 0]
            return (np.searchsorted(rc, rows, side="right")
                    - np.searchsorted(rc, rows, side="left")).astype(np.int64)
        col = self._rows[code]
        if self._values is None or not len(col):
            return np.zeros(len(rows), dtype=np.int64)
        pos = np.minimum(np.searchsorted(col, rows), len(col) - 1)
        return self._values[code][pos]

    def get_rows_mask(self, rows: np.ndarray) -> np.ndarray:
        """(Q,) rows -> (Q, L) bool membership matrix."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.zeros((len(rows), self.num_labels), dtype=bool)
        for c, col in enumerate(self._rows):
            if len(col):
                pos = np.minimum(np.searchsorted(col, rows), len(col) - 1)
                out[:, c] = col[pos] == rows
        return out

    def sum_rows(self, row_counts: Sequence[Tuple[int, int]],
                 min_count: int) -> List[Tuple[int, int]]:
        """[(row, multiplicity)] -> [(label code, total count >=
        min_count)] in code order."""
        if not len(row_counts):
            return []
        rows = np.array([r for r, _ in row_counts], dtype=np.int64)
        mult = np.array([m for _, m in row_counts], dtype=np.int64)
        totals = self.get_rows_mask(rows).astype(np.int64).T @ mult
        return [(c, int(totals[c])) for c in range(self.num_labels)
                if totals[c] >= min_count]

    def row_labels(self, rows: np.ndarray):
        """The labels of each row: -> (owner, label) int64 arrays, owner i
        for rows[i], from a row-major index of the columns built at the
        first call (O(labels found), where ``get_rows_mask`` is O(rows x
        labels))."""
        if self._label_index is None:
            ptr, lab, _ = _row_major(self._rows, self.num_rows)
            self._label_index = (ptr, lab)
        ptr, lab = self._label_index
        owner, at = _gather(ptr, rows)
        return owner, lab[at]

    def get_row_values(self, rows: np.ndarray):
        """Per row: [(label code, value)] in code order; the value of a
        coordinate-only annotation is the row's number of coordinates."""
        if not self.has_values and self.has_coords:
            return [[(c, len(t)) for c, t in row]
                    for row in self.get_row_tuples(rows)]
        rows = np.asarray(rows, dtype=np.int64)
        out = [[] for _ in range(len(rows))]
        for c, col in enumerate(self._rows):
            if not len(col):
                continue
            pos = np.minimum(np.searchsorted(col, rows), len(col) - 1)
            vals = self._values[c] if self._values is not None \
                else np.zeros(len(col), dtype=np.int64)
            for i in np.flatnonzero(col[pos] == rows):
                out[i].append((c, int(vals[pos[i]])))
        return out

    def get_row_tuples(self, rows: np.ndarray):
        """Per row: [(label code, [coordinates])] in code order."""
        rows = np.asarray(rows, dtype=np.int64)
        out = [[] for _ in range(len(rows))]
        for c in range(self.num_labels):
            lo, hi = self.coord_spans(rows, c)
            rc = self._coords[c]
            for i in np.flatnonzero(hi > lo):
                out[i].append((c, rc[lo[i]:hi[i], 1].tolist()))
        return out

    def row_index(self):
        """The coordinates in row-major order: -> (ptr (num_rows + 1,),
        labels, coordinates); row r's are [ptr[r], ptr[r + 1]), labels
        ascending, each label's coordinates as stored.  Built at the first
        call (a caller that shares the annotation between threads calls it
        first)."""
        if self._row_index is None:
            coords = self._coords or []
            ptr, lab, order = _row_major([c[:, 0] for c in coords],
                                         self.num_rows)
            crd = (np.concatenate([c[:, 1] for c in coords])[order]
                   if len(order) else np.zeros(0, np.int64))
            self._row_index = (ptr, lab, crd)
        return self._row_index

    def row_triples(self, rows: np.ndarray):
        """``get_row_tuples(rows)`` flattened: -> (owner, label,
        coordinate) arrays, owner i for rows[i], in the order of its
        tuples and their coordinates."""
        ptr, lab, crd = self.row_index()
        owner, at = _gather(ptr, rows)
        return owner, lab[at], crd[at]

    def coords_triples(self):
        """All coordinates as (rows, labels, coordinates) int64 arrays
        sorted in that order."""
        coords = self._coords or []
        n = [len(c) for c in coords]
        if not sum(n):
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        rows = np.concatenate([c[:, 0] for c in coords])
        labs = np.repeat(np.arange(len(n), dtype=np.int64), n)
        crd = np.concatenate([c[:, 1] for c in coords])
        order = np.lexsort((crd, labs, rows))
        return rows[order], labs[order], crd[order]

    def coord_spans(self, rows: np.ndarray, code: int):
        """(lo, hi): label ``code``'s coordinates of row i are
        coords[lo[i]:hi[i]], sorted; empty where it has none."""
        rows = np.asarray(rows, dtype=np.int64)
        if self._coords is None:
            z = np.zeros(len(rows), dtype=np.int64)
            return z, z
        rc = self._coords[code][:, 0]
        return (np.searchsorted(rc, rows, side="left"),
                np.searchsorted(rc, rows, side="right"))

    def coords_of(self, code: int) -> np.ndarray:
        """(n,) coordinates of label ``code``, in the order of its (row,
        coordinate) pairs."""
        return self._coords[code][:, 1]

    def compressed_columns(self):
        """Each label's rows as its smallest sd, rrr or stat bit vector."""
        from ..succinct.bitvector import bit_vector_smallest
        return [bit_vector_smallest(positions=r, n=self.num_rows)
                for r in self._rows]

    def save(self, path: str, codec: str = "sorted"):
        """``np.savez_compressed`` to ``path`` (+ ".npz") with the JAX
        file's members: codec "sorted" holds each label's row array,
        "smallest" each label's smallest bit vector (``col<c>_<field>``);
        both hold the values and coordinates."""
        payload = {"num_rows": self.num_rows,
                   "labels": np.array(self.labels, dtype=object),
                   "has_values": self.has_values,
                   "has_coords": self.has_coords}
        if codec == "smallest":
            payload["codec"] = "smallest"
            for c, v in enumerate(self.compressed_columns()):
                for k, arr in v.to_dict().items():
                    payload[f"col{c}_{k}"] = arr
        for c, rows in enumerate(self._rows):
            if codec != "smallest":
                payload[f"rows_{c}"] = rows
            payload[f"vals_{c}"] = np.zeros(len(rows), np.int64) \
                if self._values is None else self._values[c]
            payload[f"coords_{c}"] = np.zeros((0, 2), np.int64) \
                if self._coords is None else self._coords[c]
        # the JAX call, np.savez_compressed(path, **payload,
        # allow_pickle=True), stores allow_pickle as a member where numpy
        # takes no such argument
        if "allow_pickle" not in inspect.signature(
                np.savez_compressed).parameters:
            payload["allow_pickle"] = True
        savez(path if path.endswith(".npz") else path + ".npz", objects=True,
              **payload)

    @classmethod
    def load(cls, path: str) -> "ColumnMajorAnnotation":
        with np.load(path, allow_pickle=True) as z:
            labels = [str(x) for x in z["labels"]]
            n = len(labels)
            codecs = None
            if "codec" in z.files and str(z["codec"]) == "smallest":
                from ..succinct.bitvector import bitvector_from_dict
                rows, codecs = [], []
                for c in range(n):
                    pre = f"col{c}_"
                    v = bitvector_from_dict({k[len(pre):]: z[k]
                                             for k in z.files
                                             if k.startswith(pre)})
                    codecs.append(v.kind)
                    m = v.num_set_bits
                    rows.append(v.select1(np.arange(m, dtype=np.int64))
                                if m else np.zeros(0, np.int64))
            else:
                rows = [z[f"rows_{c}"] for c in range(n)]
            anno = cls(int(z["num_rows"]), labels, rows,
                       [z[f"vals_{c}"] for c in range(n)],
                       [z[f"coords_{c}"] for c in range(n)],
                       bool(z["has_values"]), bool(z["has_coords"]))
            anno.column_codecs = codecs     # each column's kind, "smallest"
            return anno


def _cat(parts, width: int = 0) -> np.ndarray:
    """The int64 parts joined: (n,) or, with a ``width``, (n, width)."""
    shape = (0, width) if width else (0,)
    return np.concatenate(parts, axis=0).astype(np.int64, copy=False) \
        if parts else np.zeros(shape, np.int64)


def _sort_keys(keys: torch.Tensor, bits: int, payload=None):
    """Kernel D2 on ``keys`` (int64, below 2^bits): -> (sorted keys,
    payload in their order)."""
    from ..succinct.device_build import radix_sort
    if not len(keys):
        return keys, payload
    return radix_sort(keys, max(bits, 1), payload)


class ColumnBuilder:
    """The JAX ``ColumnMajorAnnotation`` while it is built: label codes in
    the order labels first take rows, per label the added (rows),
    (row, count) and (row, coordinate) arrays.  ``freeze`` sorts them on
    ``device`` (the card unless "cpu") into a ``ColumnMajorAnnotation``."""

    def __init__(self, num_rows: int, device=None):
        from ..device import resolve_device
        self.num_rows = int(num_rows)
        self.device = resolve_device(device)
        self.encoder = LabelEncoder()
        self._rows: List[list] = []
        self._values: List[list] = []       # (n, 2) row, count
        self._coords: List[list] = []       # (n, 2) row, coordinate
        self.has_values = False
        self.has_coords = False
        self._frozen = None
        # bounded-RAM state: spill directory, cap, bytes held, spill files
        self._swap_dir = None
        self._swap_cap = 0
        self._acc_bytes = 0
        self._spills: List[str] = []

    @property
    def num_labels(self) -> int:
        return len(self.encoder)

    # -------------------------------------------------------- disk swap
    def enable_disk_swap(self, tmp_dir: str, mem_cap_bytes: int):
        """Spill the added arrays to npz chunks under ``tmp_dir`` once they
        pass ``mem_cap_bytes`` (at least 64 KiB); ``freeze`` streams them
        back a column at a time."""
        assert self._frozen is None
        self._swap_dir = tempfile.mkdtemp(prefix="mg_annoswap_",
                                          dir=tmp_dir or None)
        self._swap_cap = max(int(mem_cap_bytes), 1 << 16)

    def _track(self, arr: np.ndarray):
        if self._swap_dir is None:
            return
        self._acc_bytes += arr.nbytes
        if self._acc_bytes >= self._swap_cap:
            self._spill()

    def _spill(self):
        payload = {}
        for name, store in (("r", self._rows), ("v", self._values),
                            ("c", self._coords)):
            for c, parts in enumerate(store):
                if parts:
                    payload[f"{name}{c}"] = np.concatenate(
                        [np.atleast_1d(a) for a in parts], axis=0)
                    store[c] = []
        if not payload:
            return
        path = os.path.join(self._swap_dir, f"chunk{len(self._spills)}.npz")
        np.savez(path, **payload)
        self._spills.append(path)
        self._acc_bytes = 0

    def _spilled(self, chunks, c: int):
        """Column c's (rows, values, coordinates) parts of the open spill
        ``chunks`` (their members load lazily, a column at a time)."""
        got = ([], [], [])
        for z in chunks:
            for part, name in zip(got, "rvc"):
                if f"{name}{c}" in z.files:
                    part.append(z[f"{name}{c}"])
        return got

    # ------------------------------------------------------------ building
    def _col(self, label: str) -> int:
        c = self.encoder.insert_and_encode(label)
        while len(self._rows) < len(self.encoder):
            self._rows.append([])
            self._values.append([])
            self._coords.append([])
        return c

    def add_labels(self, rows: np.ndarray, labels: Sequence[str]):
        assert self._frozen is None
        for label in labels:
            a = np.asarray(rows, dtype=np.int64)
            self._rows[self._col(label)].append(a)
            self._track(a)

    def _add_pairs(self, store, rows, second, labels):
        for label in labels:
            c = self._col(label)
            a = np.stack([np.asarray(rows, dtype=np.int64),
                          np.asarray(second, dtype=np.int64)], axis=1)
            store[c].append(a)
            self._track(a)

    def add_label_counts(self, rows: np.ndarray, counts: np.ndarray,
                         labels: Sequence[str]):
        """Accumulate k-mer counts: the counts of a row add up."""
        assert self._frozen is None
        self.has_values = True
        self._add_pairs(self._values, rows, counts, labels)

    def add_label_coords(self, rows: np.ndarray, coords: np.ndarray,
                         labels: Sequence[str]):
        """Accumulate k-mer coordinates."""
        assert self._frozen is None
        self.has_coords = True
        self._add_pairs(self._coords, rows, coords, labels)

    # ------------------------------------------------------------- freezing
    def _sort(self, rows_parts, vals_parts, coord_parts):
        """Columns' parts -> per column (sorted distinct rows, summed
        values, sorted (row, coordinate) pairs), on the device: the rows
        and the (row, count) pairs in one D2 sort of (column, row) keys
        with the counts as payload (0 for a bare row), the coordinates in
        a lexicographic D2 sort of (column, row) and coordinate."""
        n_cols = len(rows_parts)
        rows = [_cat(p) for p in rows_parts]
        vals = [_cat(p, 2) for p in vals_parts]
        crds = [_cat(p, 2) for p in coord_parts]
        top = max([int(a.max(initial=0)) for a in rows]
                  + [int(a[:, 0].max(initial=0)) for a in vals + crds]
                  + [0])
        rb = max(top.bit_length(), 1)
        lb = max((n_cols - 1).bit_length(), 0)
        dev = self.device

        def keyed(arrs, rows_of):
            col = np.repeat(np.arange(n_cols, dtype=np.int64),
                            [len(a) for a in arrs])
            return (col << rb) | _cat([rows_of(a) for a in arrs])

        keys = np.concatenate([keyed(rows, lambda a: a),
                               keyed(vals, lambda a: a[:, 0])])
        pay = np.concatenate([np.zeros(sum(map(len, rows)), np.int64)]
                             + [a[:, 1] for a in vals])
        k, p = _sort_keys(torch.from_numpy(keys).to(dev), rb + lb,
                          torch.from_numpy(pay).to(dev))
        out_rows, out_vals = [np.zeros(0, np.int64)] * n_cols, \
            [np.zeros(0, np.int64)] * n_cols
        if len(k):
            new = torch.ones(len(k), dtype=torch.bool, device=dev)
            new[1:] = k[1:] != k[:-1]
            starts = torch.nonzero(new).squeeze(1)
            csum = torch.cat([p.new_zeros(1), torch.cumsum(p, 0)])
            ends = torch.cat([starts[1:], starts.new_full((1,), len(k))])
            sums = (csum[ends] - csum[starts]).cpu().numpy()
            uk = k[starts].cpu().numpy()
            cut = np.searchsorted(uk >> rb, np.arange(n_cols + 1))
            out_rows = [uk[cut[c]: cut[c + 1]] & ((1 << rb) - 1)
                        for c in range(n_cols)]
            out_vals = [sums[cut[c]: cut[c + 1]] for c in range(n_cols)]
        out_crd = [np.zeros((0, 2), np.int64)] * n_cols
        if sum(map(len, crds)):
            from ..kmer.packing import lexsort_rows
            ck = keyed(crds, lambda a: a[:, 0])
            pair = torch.from_numpy(np.stack(
                [ck, _cat([a[:, 1] for a in crds])], axis=1)).to(dev)
            perm = lexsort_rows(pair).cpu().numpy()
            ck, cc = ck[perm], pair[:, 1].cpu().numpy()[perm]
            cut = np.searchsorted(ck >> rb, np.arange(n_cols + 1))
            both = np.stack([ck & ((1 << rb) - 1), cc], axis=1)
            out_crd = [both[cut[c]: cut[c + 1]] for c in range(n_cols)]
        return out_rows, out_vals, out_crd

    def freeze(self) -> ColumnMajorAnnotation:
        """Sort and dedupe every column (once): -> the frozen annotation."""
        if self._frozen is not None:
            return self._frozen
        L = len(self.encoder)
        if not self._spills:
            rows, vals, crds = self._sort(self._rows, self._values,
                                          self._coords)
        else:
            rows, vals, crds = [], [], []
            chunks = [np.load(path) for path in self._spills]
            try:
                for c in range(L):
                    sr, sv, sc = self._spilled(chunks, c)
                    r, v, x = self._sort([self._rows[c] + sr],
                                         [self._values[c] + sv],
                                         [self._coords[c] + sc])
                    rows += r
                    vals += v
                    crds += x
            finally:
                for z in chunks:
                    z.close()
        self._rows = self._values = self._coords = None
        if self._swap_dir is not None:
            shutil.rmtree(self._swap_dir, ignore_errors=True)
            self._spills, self._swap_dir = [], None
        self._frozen = ColumnMajorAnnotation(
            self.num_rows, list(self.encoder.labels), rows, vals, crds,
            self.has_values, self.has_coords)
        return self._frozen

    def save(self, path: str, codec: str = "sorted"):
        self.freeze().save(path, codec)
