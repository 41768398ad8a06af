"""The batch graph of ``query --align --batch-align``; own copy of
metagraph_tpu/query/batch_graph.py (ref src/cli/query.cpp:874-1110
construct_query_graph, :494-606 call_hull_sequences, :718-806
add_hull_contigs).

A batch's reads align against a small graph instead of the full one: the
segments of each read whose k-mers the full graph holds, and a "hull" of
full-graph contigs reached from the batch's sinks and from the batch
predecessors of its unmatched k-mers, within bounded depth and forks.

On the port the batch's windows map through the engine's ``map_batch``
(kernel A on the card), the distinct k-mers are sorted through
``packing.lexsort_rows`` (kernel D2), and the small graph is built by
``DBGSuccinct.build`` on the engine's device: DNA at 3 <= k <= 21 on the
device route (D1-D4), every other graph on the general route (its sorts
through D2).  Every k-mer of the small graph is a k-mer of the full one,
so the respelled reads query the full index unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..kmer import packing


@dataclass
class BatchGraphStats:
    num_query_kmers: int = 0
    num_matched_kmers: int = 0
    num_hull_contigs: int = 0
    num_hull_chars: int = 0


def _valid_windows(codes: np.ndarray, k: int, sigma: int):
    """(n-k+1, k) windows of a code array and their validity (no invalid
    code)."""
    if len(codes) < k:
        return (np.zeros((0, k), np.uint8), np.zeros(0, bool))
    wins = np.lib.stride_tricks.sliding_window_view(codes, k)
    bad = np.concatenate([[0], np.cumsum(codes >= sigma)])
    return wins, (bad[k:] - bad[:-k]) == 0


def hull_contigs(full_graph, starts, kmer_set, max_forks: int,
                 max_depth: int) -> List[np.ndarray]:
    """Depth-first hull walk of the full graph (ref query.cpp:494-606).

    ``starts``: (k-mer codes (k,) uint8, full-graph node) pairs to expand
    from; ``kmer_set``: the batch's k-mers as code bytes, where a walk that
    re-enters the batch graph stops.  -> contig code arrays, every k-mer of
    which is a full-graph k-mer."""
    enc = full_graph.extractor.alphabet.encode_table
    visited: dict = {}      # node -> least depth seen
    out: List[np.ndarray] = []

    def cont(kmer_bytes: bytes, node: int, depth: int, forks: int) -> bool:
        if forks > max_forks or depth >= max_depth:
            return False
        if kmer_bytes in kmer_set:
            return False
        prev = visited.get(node)
        if prev is None or depth < prev:
            visited[node] = depth
            return True
        return False

    for kmer, node in starts:
        if not node:
            continue
        base = list(kmer[1:])
        stack = []
        for nnode, c in full_graph.call_outgoing_kmers(node):
            if c == "$":
                continue
            k2 = base + [enc[ord(c)]]
            if cont(bytes(k2), nnode, 1, 0):
                stack.append((k2, nnode, 1, 0))
            else:
                out.append(np.array(k2, dtype=np.uint8))
        while stack:
            seq, node2, depth, forks = stack.pop()
            extend = True
            while extend:
                outs = [(n, c) for n, c in full_graph.call_outgoing_kmers(
                    node2) if c != "$"]
                if len(outs) != 1:
                    break
                nnode, c = outs[0]
                seq.append(enc[ord(c)])
                node2 = nnode
                depth += 1
                extend = cont(bytes(seq[-len(kmer):]), node2, depth, forks)
            out.append(np.array(seq, dtype=np.uint8))
            if not extend:
                continue
            # a fork (or a sink) before the depth limit: walk on from it
            last = seq[-len(kmer) + 1:]
            for nnode, c in full_graph.call_outgoing_kmers(node2):
                if c == "$":
                    continue
                k2 = last + [enc[ord(c)]]
                if cont(bytes(k2), nnode, depth + 1, forks + 1):
                    stack.append((k2, nnode, depth + 1, forks + 1))
                else:
                    out.append(np.array(k2, dtype=np.uint8))
    return out


def construct_batch_graph(engine, seqs: List[bytes],
                          max_hull_forks: int = 4,
                          max_hull_depth: Optional[int] = None,
                          max_nodes_per_seq_char: float = 5.0,
                          seconds: Optional[dict] = None):
    """The batch's alignment graph (ref construct_query_graph).

    ``engine``: a ``QueryEngine`` holding the full graph (``engine.graph``,
    a ``DBGSuccinct`` or a primary one seen through ``CanonicalDBG``);
    ``seconds``: the batch's seconds, which the mapping adds to.  -> (a
    ``DBGSuccinct`` over the batch's matched segments and the hull, in the
    full graph's mode, and its ``BatchGraphStats``), or (None, None) where
    the batch has no valid window or nothing to build."""
    from ..graph.dbg_succinct import DBGSuccinct
    full = engine.graph
    mode = getattr(full, "mode", "basic")
    if mode not in ("basic", "canonical"):
        return None, None
    k = full.k
    ex = full.extractor
    sigma = ex.alphabet.sigma
    stats = BatchGraphStats()

    if max_hull_depth is None:
        max_hull_depth = 1 << 62
    maxlen = max((len(s) for s in seqs), default=0)
    max_hull_depth = min(max_hull_depth,
                         int(max_nodes_per_seq_char * maxlen))

    # 1. matched segments: every window of the batch mapped in one lookup
    nodes_list = engine.map_batch(seqs, seconds)
    segments: List[bytes] = []
    all_wins = []
    for s, nodes in zip(seqs, nodes_list):
        codes = ex.encode(s)
        wins, valid = _valid_windows(codes, k, sigma)
        if valid.any():
            all_wins.append(wins[valid])
        hit = nodes > 0
        if hit.any():
            # runs of matched windows -> substrings (ref query.cpp:806-824)
            d = np.diff(np.concatenate([[0], hit.view(np.int8), [0]]))
            for a, b in zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)):
                segments.append(bytes(s[a: b + k - 1]).upper())

    if not all_wins:
        return None, None

    # 2. the distinct batch k-mers, their full-graph nodes, and the batch
    #    adjacency that finds the hull's starts
    wins_cat = np.concatenate(all_wins)
    if mode == "canonical":
        comp = ex.extended_complement_table()
        wins_cat = np.concatenate([wins_cat, comp[wins_cat][:, ::-1]])
    bits = packing.bits_for_alphabet(ex.alphabet.sigma)
    keys = packing.pack_codes(wins_cat, bits=bits)
    order = packing.lexsort_rows(keys, device=engine.device)
    skeys = keys[order]
    new = np.empty(len(skeys), dtype=bool)
    new[0] = True
    np.any(skeys[1:] != skeys[:-1], axis=1, out=new[1:])
    keys_u = skeys[new]
    wins_u = wins_cat[order[new]]
    U = len(wins_u)
    stats.num_query_kmers = U

    dec = ex.alphabet.decode_table
    kmer_bytes_list = [dec[wins_u[i]].tobytes() for i in range(U)]
    nodes_u = np.array(
        [int(a[0]) if len(a) else 0
         for a in engine.map_batch(kmer_bytes_list, seconds)],
        dtype=np.int64)
    stats.num_matched_kmers = int((nodes_u > 0).sum())

    # which successors of each k-mer are batch k-mers (its out-degree in
    # the batch graph, for the sink test, ref query.cpp:805); sequence
    # codes are 1..sigma-1 (code 0 is the $ sentinel)
    bases = np.arange(1, sigma, dtype=np.uint8)
    nb = len(bases)
    succ = np.repeat(wins_u[:, 1:], nb, axis=0)
    succ = np.concatenate([succ, np.tile(bases, U)[:, None]], axis=1)
    succ_in = packing.rows_in(keys_u, packing.pack_codes(succ, bits=bits))
    outdeg = succ_in.reshape(U, nb).sum(axis=1)

    starts = []
    # the batch graph's sinks that the full graph holds
    for i in np.flatnonzero((outdeg == 0) & (nodes_u > 0)):
        starts.append((wins_u[i], int(nodes_u[i])))
    # unmatched k-mers: expand from their batch predecessors (ref
    # query.cpp:780-795)
    unmatched = np.flatnonzero(nodes_u == 0)
    if len(unmatched):
        pred = np.repeat(wins_u[unmatched][:, :-1], nb, axis=0)
        pred = np.concatenate(
            [np.tile(bases, len(unmatched))[:, None], pred], axis=1)
        pkeys = packing.pack_codes(pred, bits=bits)
        ppos = packing.searchsorted_rows(keys_u, pkeys)
        ppos_c = np.minimum(ppos, U - 1)
        pin = (ppos < U) & np.all(keys_u[ppos_c] == pkeys, axis=1)
        for j in np.unique(ppos_c[pin]):
            if nodes_u[j] > 0:
                starts.append((wins_u[j], int(nodes_u[j])))

    hull = []
    if max_hull_forks and starts:
        kmer_set = {wins_u[i].tobytes() for i in range(U)}
        hull = hull_contigs(full, starts, kmer_set, max_hull_forks,
                            max_hull_depth)
        stats.num_hull_contigs = len(hull)
        stats.num_hull_chars = int(sum(len(h) for h in hull))

    build_seqs = segments + [dec[h].tobytes() for h in hull]
    if not build_seqs:
        return None, None
    small = DBGSuccinct.build(build_seqs, k, mode=mode,
                              alphabet=ex.alphabet.name,
                              device=engine.device)
    return small, stats
