"""A primary graph seen as canonical.

Own copy of metagraph_tpu/graph/canonical.py:20-131 (``CanonicalDBG``; ref
canonical_dbg.hpp:22-41): node ids 1..offset are the base graph's nodes,
offset+1..2*offset their reverse complements, with offset = the base
graph's ``max_index()``.  The query maps through the id arithmetic; the
aligner of ``query --align`` and the server's ``/align`` walk the graph
through the traversal calls (each k-mer looked up forward, else as its
reverse complement), and the batch graph of ``--batch-align`` expands its
hull through ``call_outgoing_kmers``.  The base graph is succinct or not
(hash, bitmap, sshash: JAX's per-k-mer fallback of :80-97 gives the same
ids as the base's ``map_kmers_batch``).  The batch forms the aligner
calls (``map_to_nodes_sequentially_batch``, ``call_outgoing_batch`` and
the junction tests of the MEM seeder) look up every node they have not
seen in one ``map_kmers_batch`` of both strands, which on a hash, bitmap
or sshash base is one launch of kernel A; each gives the values of the
per-node calls.
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

    def map_to_nodes_sequentially_batch(self, sequences) -> list:
        """``map_to_nodes_sequentially`` of each sequence, both strands in
        one call of the base graph's batch form."""
        seqs = [s.encode() if isinstance(s, str) else s for s in sequences]
        got = self.graph.map_to_nodes_sequentially_batch(
            seqs + [revcomp(s) for s in seqs])
        n = len(seqs)
        return [np.where((f == 0) & (r[::-1] > 0), r[::-1] + self.offset, f)
                for f, r in zip(got[:n], got[n:])]

    def map_to_nodes_batch(self, sequences) -> list:
        """``map_to_nodes`` of each sequence (JAX ``map_to_nodes_
        sequentially``: a forward hit, else the reverse complement's id +
        offset), both strands of every sequence in one call of the base
        graph's ``map_to_nodes_batch``: one launch of kernel A."""
        seqs = [s.encode() if isinstance(s, str) else s for s in sequences]
        got = self.graph.map_to_nodes_batch(
            seqs + [revcomp(s) for s in seqs], sequentially=True)
        n = len(seqs)
        return [np.where((f == 0) & (r[::-1] > 0), r[::-1] + self.offset, f)
                for f, r in zip(got[:n], got[n:])]

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
        else 0: both strands in one ``map_kmers_batch``."""
        chars = np.stack([self.extractor.encode(km) for km in kmers])
        comp = self.graph.alph.complement_table
        both = self.graph.map_kmers_batch(
            np.concatenate([chars, comp[chars[:, ::-1]]]))
        fwd, bwd = both[: len(chars)], both[len(chars):]
        return np.where(fwd > 0, fwd,
                        np.where(bwd > 0, bwd + self.offset, 0)).tolist()

    def _neighbours(self, nodes, outgoing: bool) -> list:
        """Each node's [(neighbour, char)] in the alphabet's order; the
        nodes not cached yet are looked up together."""
        cache = self._out_cache if outgoing else self._in_cache
        nodes = [int(n) for n in nodes]
        todo = list(dict.fromkeys(n for n in nodes if n not in cache))
        if todo:
            chars = self.graph.alph.letters[1:]
            cands = []
            for n in todo:
                seq = self.get_node_sequence(n)
                cands += [seq[1:] + ch.encode() if outgoing
                          else ch.encode() + seq[:-1] for ch in chars]
            ids = self._lookup_batch(cands)
            m = len(chars)
            for i, n in enumerate(todo):
                cache[n] = [(nid, ch) for nid, ch in
                            zip(ids[i * m: (i + 1) * m], chars) if nid]
        return [cache[n] for n in nodes]

    def call_outgoing_kmers(self, node: int):
        """[(next node, char)] in the alphabet's order."""
        return self._neighbours([node], True)[0]

    def call_incoming_kmers(self, node: int):
        return self._neighbours([node], False)[0]

    def call_outgoing_batch(self, nodes: np.ndarray):
        """``call_outgoing_kmers`` over a node array: -> (owner, child,
        upper-case char code), the flat engine's form of the JAX engine's
        per-node loop (metagraph_tpu/align/flat.py:125-138)."""
        owner, child, code = [], [], []
        for i, out in enumerate(self._neighbours(nodes, True)):
            for nxt, ch in out:
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

    def has_multiple_outgoing_batch(self, nodes) -> np.ndarray:
        return np.array([len(o) > 1 for o in self._neighbours(nodes, True)],
                        dtype=bool)

    def has_single_incoming_batch(self, nodes) -> np.ndarray:
        return np.array([len(o) == 1
                         for o in self._neighbours(nodes, False)],
                        dtype=bool)
