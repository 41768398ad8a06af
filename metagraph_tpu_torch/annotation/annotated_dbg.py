"""Query semantics of the annotated graph.

Own copy of metagraph_tpu/annotation/annotated_dbg.py:26-63 and :119-124:
annotation row = base node - 1 (reverse-complement ids of a primary graph
seen through ``CanonicalDBG`` fold back to their base node), the min-count
rule of the reference, the top-label order (count descending, label code
ascending) and the row multiset of a sequence.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..graph.canonical import base_node


def get_min_count(discovery_fraction: float, presence_fraction: float,
                  num_kmers: int, num_present: int) -> int:
    if num_present < max(1.0, math.ceil(presence_fraction * num_kmers)):
        return num_kmers + 1
    return int(max(1.0, math.ceil(discovery_fraction * num_kmers)))


def _top_n_sorted(code_counts: List[Tuple[int, int]], n: int):
    code_counts.sort(key=lambda p: (-p[1], p[0]))
    del code_counts[n:]


def graph_to_anno_index(node, offset: int = 0):
    """row = base node - 1; with an ``offset`` (CanonicalDBG over a primary
    graph) ids above it fold to ``node - offset`` first (ref
    annotated_dbg.hpp:50-56, canonical_dbg.hpp:38-41)."""
    return base_node(node, offset) - 1


def row_multiset(rows):
    """[(row, multiplicity)] in first-seen order (``_row_multiset``)."""
    uniq, first, counts = np.unique(rows, return_index=True,
                                    return_counts=True)
    order = np.argsort(first, kind="stable")
    return list(zip(uniq[order].tolist(), counts[order].tolist()))
