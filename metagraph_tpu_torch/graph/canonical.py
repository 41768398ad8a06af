"""A primary graph seen as canonical.

Own copy of metagraph_tpu/graph/canonical.py:20-131 (``CanonicalDBG``; ref
canonical_dbg.hpp:22-41): node ids 1..offset are the base graph's nodes,
offset+1..2*offset their reverse complements, with offset = the base
graph's ``max_index()``.  The query maps through the id arithmetic; the
aligner of ``query --align`` and the server's ``/align`` walk the graph
through the traversal calls (each k-mer looked up forward, else as its
reverse complement), and the batch graph of ``--batch-align`` expands its
hull through ``call_outgoing_kmers``.
"""

from __future__ import annotations

import numpy as np

from ..align.alignment import revcomp


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
        # traversal caches (ref node_first_cache.hpp)
        self._out_cache: dict = {}
        self._in_cache: dict = {}
        self._seq_cache: dict = {}

    @property
    def extractor(self):
        return self.graph.extractor

    def max_index(self) -> int:
        return self.offset * 2

    def get_base_node(self, node):
        """Node id(s) of the base graph (ref canonical_dbg.hpp:38-41)."""
        return base_node(node, self.offset)

    def reverse_complement_node(self, node):
        node = np.asarray(node)
        return np.where(node > self.offset, node - self.offset,
                        node + self.offset)

    # ------------------------------------------------------------- mapping
    def map_to_nodes_sequentially(self, sequence) -> np.ndarray:
        """Map in the given orientation: a forward hit is its base id, a
        reverse-complement hit its base id + offset."""
        if isinstance(sequence, str):
            sequence = sequence.encode()
        fwd = self.graph.map_to_nodes_sequentially(sequence)
        missing = fwd == 0
        if missing.any():
            rc = self.graph.map_to_nodes_sequentially(revcomp(sequence))[::-1]
            fwd = np.where(missing & (rc > 0), rc + self.offset, fwd)
        return fwd

    # ------------------------------------------------------------ traversal
    def get_node_sequence(self, node: int) -> bytes:
        hit = self._seq_cache.get(node)
        if hit is not None:
            return hit
        s = self.graph.get_node_sequence(int(self.get_base_node(node)))
        if node > self.offset:
            s = revcomp(s)
        self._seq_cache[node] = s
        return s

    def _lookup_batch(self, kmers: list) -> list:
        """Each k-mer's forward id, else its reverse complement's + offset,
        else 0."""
        chars = np.stack([self.extractor.encode(km) for km in kmers])
        fwd = self.graph.map_kmers_batch(chars)
        comp = self.graph.alph.complement_table
        bwd = self.graph.map_kmers_batch(comp[chars[:, ::-1]])
        return np.where(fwd > 0, fwd,
                        np.where(bwd > 0, bwd + self.offset, 0)).tolist()

    def _neighbours(self, node: int, cache: dict, outgoing: bool):
        hit = cache.get(node)
        if hit is not None:
            return hit
        seq = self.get_node_sequence(node)
        chars = self.graph.alph.letters[1:]
        cands = [seq[1:] + ch.encode() if outgoing else ch.encode() + seq[:-1]
                 for ch in chars]
        out = [(nid, ch) for nid, ch in zip(self._lookup_batch(cands), chars)
               if nid]
        cache[node] = out
        return out

    def call_outgoing_kmers(self, node: int):
        """[(next node, char)] in the alphabet's order."""
        return self._neighbours(node, self._out_cache, True)

    def call_incoming_kmers(self, node: int):
        return self._neighbours(node, self._in_cache, False)

    def call_outgoing_batch(self, nodes: np.ndarray):
        """``call_outgoing_kmers`` over a node array: -> (owner, child,
        upper-case char code), the flat engine's form of the JAX engine's
        per-node loop (metagraph_tpu/align/flat.py:125-138)."""
        owner, child, code = [], [], []
        for i, n in enumerate(nodes):
            for nxt, ch in self.call_outgoing_kmers(int(n)):
                if ch != "$":
                    owner.append(i)
                    child.append(nxt)
                    code.append(ord(ch.upper()))
        return (np.array(owner, dtype=np.int64),
                np.array(child, dtype=np.int64),
                np.array(code, dtype=np.int64))

    def has_multiple_outgoing(self, node: int) -> bool:
        return len(self.call_outgoing_kmers(node)) > 1

    def has_single_incoming(self, node: int) -> bool:
        return len(self.call_incoming_kmers(node)) == 1
