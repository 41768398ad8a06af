"""Column-major multi-label annotation, read from ``.column.annodbg.npz``.

Own copy of the loading part of metagraph_tpu/annotation/column.py:347-374
for both codecs ("sorted": one sorted array of set rows per label;
"smallest": each label's rows as an sd, rrr or stat bit vector,
``succinct/bitvector.py``), with
optional per-entry k-mer counts (``vals_c``) and coordinates
(``coords_c``: (row, coordinate) pairs sorted by row, then coordinate),
and of its row queries ``get_rows_mask``, ``get_row_values`` and
``get_row_tuples`` (:232-291).  ``LabelEncoder`` (:21) is the label table
that converted
(``StaticAnnotation``) files hold.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class LabelEncoder:
    """label string <-> code; the attribute names are the JAX class's, so
    that its pickles restore into this one."""

    def __init__(self, labels: Sequence[str] = ()):
        self._labels: List[str] = list(labels)

    def decode(self, code: int) -> str:
        return self._labels[code]

    @property
    def labels(self) -> List[str]:
        return self._labels


class ColumnMajorAnnotation:
    def __init__(self, num_rows: int, labels: Sequence[str],
                 rows: Sequence[np.ndarray],
                 values: Sequence[np.ndarray] | None = None,
                 coords: Sequence[np.ndarray] | None = None,
                 has_values: bool = False, has_coords: bool = False):
        self.num_rows = int(num_rows)
        self.labels: List[str] = list(labels)
        self._rows = [np.asarray(r, dtype=np.int64) for r in rows]
        self._values = None if values is None \
            else [np.asarray(v, dtype=np.int64) for v in values]
        self._coords = None if coords is None \
            else [np.asarray(c, dtype=np.int64).reshape(-1, 2)
                  for c in coords]
        self.has_values = has_values
        self.has_coords = has_coords
        self._row_index = None
        self.column_codecs = None

    @property
    def num_labels(self) -> int:
        return len(self.labels)

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
            n = [len(c) for c in coords]
            if sum(n):
                rc = np.concatenate(coords)
                lab = np.repeat(np.arange(len(coords), dtype=np.int64), n)
                order = np.lexsort((lab, rc[:, 0]))       # stable
                row, lab, crd = rc[order, 0], lab[order], rc[order, 1]
            else:
                row = lab = crd = np.zeros(0, np.int64)
            ptr = np.searchsorted(row, np.arange(self.num_rows + 1))
            self._row_index = (ptr, lab, crd)
        return self._row_index

    def row_triples(self, rows: np.ndarray):
        """``get_row_tuples(rows)`` flattened: -> (owner, label,
        coordinate) arrays, owner i for rows[i], in the order of its
        tuples and their coordinates."""
        rows = np.asarray(rows, dtype=np.int64)
        ptr, lab, crd = self.row_index()
        lo = ptr[rows]
        n = ptr[rows + 1] - lo
        at = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
        return np.repeat(np.arange(len(rows)), n), lab[at], crd[at]

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
