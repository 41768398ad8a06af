"""Query semantics of the annotated graph.

Own copy of metagraph_tpu/annotation/annotated_dbg.py:26-63 for basic-mode
graphs: annotation row = node - 1, the min-count rule of the reference, and
the top-label order (count descending, label code ascending).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def get_min_count(discovery_fraction: float, presence_fraction: float,
                  num_kmers: int, num_present: int) -> int:
    if num_present < max(1.0, math.ceil(presence_fraction * num_kmers)):
        return num_kmers + 1
    return int(max(1.0, math.ceil(discovery_fraction * num_kmers)))


def _top_n_sorted(code_counts: List[Tuple[int, int]], n: int):
    code_counts.sort(key=lambda p: (-p[1], p[0]))
    del code_counts[n:]


def graph_to_anno_index(node):
    """Basic-mode graphs: annotation row = node - 1."""
    return np.asarray(node) - 1
