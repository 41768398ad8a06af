"""Query result formatting, byte-identical to metagraph_tpu's.

Own copy of metagraph_tpu/query/results.py:15-179 for the payload kinds
of the six query modes (``KIND_FOR_MODE``: counts-sum prints as matches)
and the coordinate ranges; alignment headers are not ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

import numpy as np

from ..align.kmer_presence import score_kmer_presence_mask

# payload kind of each query mode (metagraph_tpu/query/pipeline.py:22-29)
KIND_FOR_MODE = {"labels": "labels", "matches": "matches",
                 "counts-sum": "matches", "counts": "counts",
                 "signature": "signature", "coords": "coords"}


def encode_presence_mask(bits: np.ndarray) -> str:
    """Run-length encode a presence mask as alternating x<len>/o<len> runs
    (x = ones, o = zeros), e.g. 11100110 -> x3o2x2o1."""
    bits = np.asarray(bits, dtype=bool)
    out = []
    pos = 0
    n = len(bits)
    while pos < n:
        bit = bits[pos]
        start = pos
        while pos < n and bits[pos] == bit:
            pos += 1
        out.append(("x" if bit else "o") + str(pos - start))
    return "".join(out)


def _runs_counts(abundances) -> str:
    """Run-compress abundance vectors: ':<i>=<v>' or ':<i>-<j>=<v>', zero
    runs skipped."""
    out = []
    n = len(abundances)
    last_start, last_val = 0, abundances[0]
    for i in range(1, n + 1):
        if i < n and abundances[i] == last_val:
            continue
        if last_val:
            if i == last_start + 1:
                out.append(f":{last_start}={last_val}")
            else:
                out.append(f":{last_start}-{i - 1}={last_val}")
        if i < n:
            last_start, last_val = i, abundances[i]
    return "".join(out)


def collapse_coord_ranges(tuples: List[List[int]]) -> List[str]:
    """Per-position sorted coordinates -> diagonal ranges
    'pos-first[-last]': a range (pos, first, last) extends iff last + 1
    occurs at the next position (a two-pointer merge)."""
    out: List[str] = []
    ranges: List[list] = []            # [start_pos, first, last] by last
    for i, coords in enumerate(tuples):
        j = 0
        next_ranges: List[list] = []
        for c in coords:
            while j < len(ranges) and ranges[j][2] + 1 < c:
                out.append(_fmt_range(ranges[j]))
                j += 1
            if j < len(ranges) and ranges[j][2] + 1 == c:
                r = ranges[j]
                j += 1
                next_ranges.append([r[0], r[1], r[2] + 1])
            else:
                next_ranges.append([i, c, c])
        while j < len(ranges):
            out.append(_fmt_range(ranges[j]))
            j += 1
        ranges = next_ranges
    for r in ranges:
        out.append(_fmt_range(r))
    return out


def _fmt_range(r) -> str:
    pos, first, last = r
    return f"{pos}-{first}" if last == first else f"{pos}-{first}-{last}"


@dataclass
class QuerySequence:
    id: int
    name: str
    sequence: str


@dataclass
class SeqSearchResult:
    """One query sequence's result; ``kind`` selects the payload format."""

    sequence: QuerySequence
    kind: str                 # labels | matches | counts | signature | coords
    payload: list

    def to_string(self, delimiter: str = ":", suppress_unlabeled: bool = False,
                  verbose: bool = False, k: int = 0) -> str:
        if suppress_unlabeled and not self.payload:
            return ""
        out = f"{self.sequence.id}\t{self.sequence.name}"
        if self.kind == "labels":
            out += "\t" + delimiter.join(self.payload)
        elif self.kind == "matches":
            for label, count in self.payload:
                out += f"\t<{label}>:{count}"
        elif self.kind == "signature":
            for label, count, bits in self.payload:
                mask = ("".join("1" if b else "0" for b in bits) if verbose
                        else encode_presence_mask(bits))
                score = score_kmer_presence_mask(k, bits)
                out += f"\t<{label}>:{count}:{mask}:{score}"
        elif self.kind == "counts":
            for label, count, abundances in self.payload:
                out += f"\t<{label}>"
                if verbose:
                    out += "".join(f":{v}" for v in abundances)
                else:
                    out += _runs_counts(list(abundances))
        elif self.kind == "coords":
            for label, count, tuples in self.payload:
                out += f"\t<{label}>"
                if verbose:
                    for coords in tuples:
                        out += ":" + ",".join(str(c) for c in coords)
                else:
                    out += "".join(":" + r
                                   for r in collapse_coord_ranges(tuples))
        return out

    def to_json(self, verbose: bool = False, k: int = 0) -> str:
        results = []
        for item in self.payload:
            if self.kind == "labels":
                results.append({"sample": item})
            elif self.kind == "matches":
                results.append({"sample": item[0], "kmer_count": item[1]})
            elif self.kind == "counts":
                results.append({"sample": item[0], "kmer_count": item[1],
                                "kmer_abundances": [str(v) for v in item[2]]})
            elif self.kind == "signature":
                results.append({
                    "sample": item[0], "kmer_count": item[1],
                    "signature": encode_presence_mask(item[2]),
                    "score": score_kmer_presence_mask(k, item[2])})
            elif self.kind == "coords":
                results.append({"sample": item[0], "kmer_count": item[1],
                                "kmer_coords": collapse_coord_ranges(item[2])})
        return json.dumps({"seq_description": self.sequence.name,
                           "results": results})
