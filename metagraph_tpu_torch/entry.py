"""The flagship step as a callable: ``entry()`` -> ``(fn, args)``.

The counterpart of ``__graft_entry__.entry`` (__graft_entry__.py:21-38):
the same tiny annotated graph from the seed (4 random DNA sequences of
200 bp, k = 11, label ``sample<i>`` on the nodes of sequence i), built by
the port, and ``fn`` the port's ``query_step`` (kernel A, then kernel 2)
over the first 100 bp of each sequence, packed by
``DeviceQueryPipeline.prepare_batch``.  ``args`` lie on ``device``: the
card unless "cpu".

    fn, args = entry()
    counts, present, nodes = fn(*args)
"""

from __future__ import annotations

import numpy as np


def tiny_annotated_graph(k: int = 11, n_seqs: int = 4, seq_len: int = 200,
                         seed: int = 0, device=None):
    """-> (graph, annotation, sequences): the random sequences of
    ``__graft_entry__._tiny_annotated_graph`` (the same generator calls),
    their graph built by the port, and a column annotation whose label
    ``sample<i>`` holds the rows (node - 1) of sequence i's k-mers."""
    from .annotation.column import ColumnMajorAnnotation
    from .graph.dbg_succinct import DBGSuccinct
    from .succinct.ops import pack_kmers32
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), size=seq_len)).encode()
            for _ in range(n_seqs)]
    g = DBGSuccinct.build(seqs, k, device=device)
    edges = np.flatnonzero(g.boss.valid)
    keys = pack_kmers32(g.boss.get_edge_seq(edges))
    node_of = {row.tobytes(): int(e) for row, e in zip(keys, edges)}
    ex = g.extractor
    labels, rows = [], []
    for i, s in enumerate(seqs):
        wins = np.lib.stride_tricks.sliding_window_view(ex.encode(s), k)
        ids = [node_of.get(row.tobytes(), 0) for row in pack_kmers32(wins)]
        hit = np.unique([n for n in ids if n > 0]).astype(np.int64) - 1
        if len(hit):
            labels.append(f"sample{i}")
            rows.append(hit)
    return g, ColumnMajorAnnotation(g.max_index(), labels, rows), seqs


def entry(device=None):
    """(fn, args): the annotated batch query of the tiny graph, ``fn``
    taking (table, bitmap, queries, seq_ids) -> (counts, present,
    nodes)."""
    from .query.device import DeviceQueryPipeline, query_step
    g, anno, seqs = tiny_annotated_graph(device=device)
    pipe = DeviceQueryPipeline(g, anno, device=device)
    queries, seq_ids, _ = pipe._prepare([s[:100] for s in seqs])
    S = len(seqs)
    L = pipe.annotation.num_labels

    def fn(table, bitmap, queries, seq_ids):
        return query_step(table, bitmap, queries, seq_ids, S, L)

    return fn, (pipe.index.table, pipe.annotation.bitmap, queries, seq_ids)
