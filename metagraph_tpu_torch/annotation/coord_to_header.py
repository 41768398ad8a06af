"""CoordToHeader: per-column mapping from global k-mer coordinates to the
headers of the sequences they came from.

Own copy of metagraph_tpu/annotation/coord_to_header.py:20-66.  A column
annotated with ``--coordinates`` numbers the k-mers of all sequences of its
label consecutively; ``annotate --index-header-coords`` writes each
sequence's header and k-mer count to ``<annotation base>.seqs``, and
``query`` then reports per-sequence results (``annotated_dbg.
cth_aggregate``).  The file is an npz archive: ``n_cols``, and per column
``h<c>`` (headers) and ``o<c>`` (cumulative k-mer offsets, from 0).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

EXTENSION = ".seqs"


class CoordToHeader:
    def __init__(self, headers: List[List[str]],
                 num_kmers: List[List[int]]):
        self.headers = headers
        # offsets[c][i] = the first global coordinate of sequence i
        self.offsets = [np.concatenate([[0], np.cumsum(nk)]).astype(np.int64)
                        for nk in num_kmers]

    def num_columns(self) -> int:
        return len(self.headers)

    def num_sequences(self, col: int) -> int:
        return len(self.headers[col])

    def num_kmers_in_sequence(self, col: int, seq_id: int) -> int:
        return int(self.offsets[col][seq_id + 1] - self.offsets[col][seq_id])

    def get_headers(self, col: int) -> List[str]:
        return self.headers[col]

    def map_single_coord(self, col: int, coord: int) -> Tuple[int, int]:
        """Global coordinate -> (sequence id, local coordinate)."""
        off = self.offsets[col]
        seq_id = int(np.searchsorted(off, coord, side="right")) - 1
        return seq_id, int(coord - off[seq_id])

    def save(self, path_base: str):
        path = path_base if path_base.endswith(EXTENSION) \
            else path_base + EXTENSION
        n = len(self.headers)
        np.savez_compressed(
            path + ".npz", n_cols=n,
            **{f"h{c}": np.array(self.headers[c]) for c in range(n)},
            **{f"o{c}": self.offsets[c] for c in range(n)})
        os.replace(path + ".npz", path)

    @classmethod
    def load(cls, path: str) -> "CoordToHeader":
        z = np.load(path, allow_pickle=False)
        n = int(z["n_cols"])
        obj = cls.__new__(cls)
        obj.headers = [[str(x) for x in z[f"h{c}"]] for c in range(n)]
        obj.offsets = [z[f"o{c}"].astype(np.int64) for c in range(n)]
        return obj
