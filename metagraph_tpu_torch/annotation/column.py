"""Column-major multi-label annotation, read from ``.column.annodbg.npz``.

Own copy of the loading part of metagraph_tpu/annotation/column.py:347-374
for the "sorted" codec: one sorted array of set rows per label, with
optional per-entry k-mer counts (``vals_c``) and coordinates
(``coords_c``).  The "smallest" codec is not ported yet and raises.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


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

    @classmethod
    def load(cls, path: str) -> "ColumnMajorAnnotation":
        with np.load(path, allow_pickle=True) as z:
            labels = [str(x) for x in z["labels"]]
            if "codec" in z.files and str(z["codec"]) == "smallest":
                raise NotImplementedError(
                    "the 'smallest' column codec is not ported yet "
                    "(ROADMAP A7)")
            n = len(labels)
            return cls(int(z["num_rows"]), labels,
                       [z[f"rows_{c}"] for c in range(n)],
                       [z[f"vals_{c}"] for c in range(n)],
                       [z[f"coords_{c}"] for c in range(n)],
                       bool(z["has_values"]), bool(z["has_coords"]))
