"""Query result formatting, byte-identical to metagraph_tpu's.

Own copy of metagraph_tpu/query/results.py:15-179 for the four modes the
port serves (labels, matches, counts, signature); coordinate output and
alignment headers are not ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from ..align.kmer_presence import score_kmer_presence_mask


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


@dataclass
class QuerySequence:
    id: int
    name: str
    sequence: str


@dataclass
class SeqSearchResult:
    """One query sequence's result; ``kind`` selects the payload format."""

    sequence: QuerySequence
    kind: str                 # labels | matches | counts | signature
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
        return json.dumps({"seq_description": self.sequence.name,
                           "results": results})
