"""A primary graph seen as canonical: the node-id arithmetic of the query.

Own copy of the id part of metagraph_tpu/graph/canonical.py:20-45
(``CanonicalDBG``; ref canonical_dbg.hpp:22-41): node ids 1..offset are the
base graph's nodes, offset+1..2*offset their reverse complements, with
offset = the base graph's ``max_index()``.  Traversal is not ported.
"""

from __future__ import annotations

import numpy as np


def base_node(node, offset: int):
    """Fold ids above ``offset`` (reverse complements) to their base node;
    an ``offset`` of 0 folds nothing."""
    node = np.asarray(node)
    return np.where(node > offset, node - offset, node) if offset else node


class CanonicalDBG:
    def __init__(self, graph):
        if graph.mode not in ("primary", "basic"):
            raise ValueError(f"CanonicalDBG wraps a primary or basic graph, "
                             f"not a {graph.mode} one")
        self.graph = graph
        self.k = graph.k
        self.mode = "canonical"
        self.alphabet = graph.alphabet
        self.offset = graph.max_index()

    def max_index(self) -> int:
        return self.offset * 2

    def get_base_node(self, node):
        """Node id(s) of the base graph (ref canonical_dbg.hpp:38-41)."""
        return base_node(node, self.offset)

    def reverse_complement_node(self, node):
        node = np.asarray(node)
        return np.where(node > self.offset, node - self.offset,
                        node + self.offset)
