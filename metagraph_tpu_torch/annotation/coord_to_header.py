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


def format_alignment_coords(alignment, encoder, k: int,
                            cth: CoordToHeader | None = None) -> str:
    """An alignment's coordinates (metagraph_tpu/annotation/
    coord_to_header.py:69-126; ref Alignment::format_coords): without the
    index, ``label:coord+1-coord+len`` per coordinate; with it, the range
    split across sequence boundaries into 1-based inclusive
    ``header:start-end`` local ranges, ';'-joined."""
    if not getattr(alignment, "label_coordinates", None):
        return ""
    L = len(alignment.sequence)
    parts = []
    if cth is None:
        for col, coords in zip(alignment.label_columns,
                               alignment.label_coordinates):
            s = encoder.decode(col)
            for coord in coords:
                s += f":{coord + 1}-{coord + L}"
            parts.append(s)
        return ";".join(parts)
    seq_ranges = {}
    order = []
    for col, coords in zip(alignment.label_columns,
                           alignment.label_coordinates):
        n_seqs = cth.num_sequences(col)
        for coord in coords:
            cur_seq, cur_local = cth.map_single_coord(col, coord)
            remaining = L
            while remaining and cur_seq < n_seqs:
                nt_len = cth.num_kmers_in_sequence(col, cur_seq) + k - 1
                span = min(remaining, nt_len - cur_local)
                if span > 0:
                    # an empty sequence spans nothing (no 'header:1-0')
                    key = (col, cur_seq)
                    if key not in seq_ranges:
                        seq_ranges[key] = []
                        order.append(key)
                    seq_ranges[key].append((cur_local, cur_local + span - 1))
                    remaining -= span
                cur_seq += 1
                cur_local = 0
    for col, seq_id in order:
        s = cth.get_headers(col)[seq_id]
        for start, end in seq_ranges[(col, seq_id)]:
            s += f":{start + 1}-{end + 1}"
        parts.append(s)
    return ";".join(parts)
