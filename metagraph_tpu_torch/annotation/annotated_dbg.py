"""Query semantics of the annotated graph.

Own copy of metagraph_tpu/annotation/annotated_dbg.py:26-63 and :119-124:
annotation row = base node - 1 (reverse-complement ids of a primary graph
seen through ``CanonicalDBG`` fold back to their base node), the min-count
rule of the reference, the top-label order (count descending, label code
ascending) and the row multiset of a sequence; and of ``_cth_aggregate``
(:126-200), the per-sequence results of a ``.seqs`` mapping
(``cth_aggregate``), computed for a whole batch in numpy; and
``AnnotatedDBG`` (the graph, its annotation and their row mapping) for
the labeled aligner and ``annotate`` (:56-100, with a batch form).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

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


def row_triples(annotation, rows: np.ndarray):
    """The coordinate annotation's ``get_row_tuples(rows)`` flattened: ->
    (owner, label, coordinate) int64 arrays, owner i for rows[i], in the
    order of the tuples and their coordinates."""
    if hasattr(annotation, "row_triples"):
        return annotation.row_triples(rows)
    tuples = annotation.get_row_tuples(rows)
    owner, lab, crd = [], [], []
    for i, row in enumerate(tuples):
        for c, coords in row:
            owner += [i] * len(coords)
            lab += [c] * len(coords)
            crd += list(coords)
    return tuple(np.asarray(a, dtype=np.int64) for a in (owner, lab, crd))


class HeaderIndex:
    """A ``CoordToHeader`` as one sorted array: column c's sequence i is
    header ``base[c] + i``, whose first global coordinate is ``start``
    at that index; ``locate`` maps (column, coordinate) pairs to (header,
    local coordinate) for many pairs at once."""

    _SHIFT = 40          # a column's coordinates stay below 2^40

    def __init__(self, cth):
        n = [cth.num_sequences(c) for c in range(cth.num_columns())]
        self.headers = [h for c in range(len(n)) for h in cth.get_headers(c)]
        self.base = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
        self.start = np.concatenate(
            [o[:-1] for o in cth.offsets] or [np.zeros(0, np.int64)])
        self.end = np.array([o[-1] for o in cth.offsets], dtype=np.int64)
        col = np.repeat(np.arange(len(n), dtype=np.int64), n)
        self._keys = (col << self._SHIFT) + self.start

    def locate(self, col: np.ndarray, coord: np.ndarray):
        if len(col) and (col.max() >= len(self.end)
                         or (coord >= self.end[col]).any()):
            raise IndexError("a coordinate lies past its column's "
                             "sequences in the .seqs mapping")
        h = np.searchsorted(self._keys, (col << self._SHIFT) + coord,
                            side="right") - 1
        return h, coord - self.start[h]


def cth_aggregate(annotation, headers: HeaderIndex,
                  nodes_list: Sequence[np.ndarray], mode: str,
                  num_top_labels: int, discovery_fraction: float,
                  presence_fraction: float, offset: int = 0) -> list:
    """Per-sequence payloads of ``_cth_aggregate`` for a batch of mapped
    node arrays (0 = miss): each k-mer's coordinates name (header, local
    coordinate) pairs; a header's count is the number of k-mers that carry
    it; thresholds and the top-n cap run per sequence; headers in
    first-seen order, sorted (count descending, first seen) only where the
    cap filters, and only outside the labels mode."""
    out: list = [[] for _ in nodes_list]
    take, rows, pos, seq_of = {}, [], [], []
    for s, nodes in enumerate(nodes_list):
        p = np.flatnonzero(nodes > 0)
        min_count = get_min_count(discovery_fraction, presence_fraction,
                                  len(nodes), len(p))
        if not len(nodes) or len(p) < min_count:
            continue
        take[s] = min_count
        rows.append(graph_to_anno_index(nodes[p], offset))
        pos.append(p)
        seq_of.append(np.full(len(p), s, np.int64))
    if not take:
        return out
    pos, seq_of = np.concatenate(pos), np.concatenate(seq_of)
    owner, col, coord = row_triples(annotation, np.concatenate(rows))
    if not len(owner):
        # no coordinates (an annotation without them beside a .seqs
        # mapping): every sequence that passed its threshold has no header
        return out
    hdr, local = headers.locate(col, coord)
    # distinct (k-mer, header) pairs in first-seen order, with their
    # coordinates (counts, counts-sum) and their k-mer's sequence
    G = len(headers.headers) + 1
    pair_key = owner * G + hdr
    order = np.lexsort((local, pair_key))
    pk, first, ncrd = np.unique(pair_key, return_index=True,
                                return_counts=True)
    p_owner, p_hdr = pk // G, pk % G
    p_seq = seq_of[p_owner]
    crd_start = np.concatenate([[0], np.cumsum(ncrd)])
    # (sequence, header) groups: their pairs, in k-mer order
    grp = np.lexsort((p_owner, p_hdr, p_seq))
    gkey = p_seq[grp] * G + p_hdr[grp]
    gstart = np.flatnonzero(np.concatenate([[True], gkey[1:] != gkey[:-1]]))
    gend = np.concatenate([gstart[1:], [len(grp)]])
    g_seq, g_hdr = p_seq[grp[gstart]], p_hdr[grp[gstart]]
    g_match = gend - gstart
    g_first = np.minimum.reduceat(first[grp], gstart)
    g_coords = np.add.reduceat(ncrd[grp], gstart)
    seq_lo = np.searchsorted(g_seq, np.arange(len(nodes_list) + 1))
    for s, min_count in take.items():
        nk = len(nodes_list[s])
        mine = np.arange(seq_lo[s], seq_lo[s + 1])
        mine = mine[np.argsort(g_first[mine], kind="stable")]
        sel = mine[g_match[mine] >= min_count]
        if mode != "labels" and len(sel) > num_top_labels:
            sel = sel[np.lexsort((g_first[sel], -g_match[sel]))]
            sel = sel[:num_top_labels]
        result = []
        for g in sel:
            name = headers.headers[g_hdr[g]]
            n = int(g_match[g])
            if mode == "labels":
                result.append(name)
                continue
            if mode == "matches":
                result.append((name, n))
                continue
            if mode == "counts-sum":
                result.append((name, int(g_coords[g])))
                continue
            pairs = grp[gstart[g]: gend[g]]
            at = pos[p_owner[pairs]]
            if mode == "signature":
                bits = np.zeros(nk, dtype=bool)
                bits[at] = True
                result.append((name, n, bits))
            elif mode == "counts":
                ab = np.zeros(nk, dtype=np.int64)
                ab[at] = ncrd[pairs]
                result.append((name, n, ab))
            else:
                co = [[] for _ in range(nk)]
                for a, lo, hi in zip(at, crd_start[pairs],
                                     crd_start[pairs + 1]):
                    co[a] = local[order[lo:hi]].tolist()
                result.append((name, n, co))
        out[s] = result
    return out


class AnnotatedDBG:
    """A graph and its annotation: the row mapping the labeled aligner
    reads, and the annotate methods (own copy of metagraph_tpu/annotation/
    annotated_dbg.py:35-100) with their batch form, which maps every
    record of a batch in one ``map_to_nodes_batch`` (one launch of kernel
    A) and adds each record's rows in record order, so that the frozen
    columns are the record-at-a-time ones."""

    def __init__(self, graph, annotator):
        self.graph = graph
        self.annotator = annotator

    def graph_to_anno_index(self, node):
        """row = base node - 1; a canonical wrapper's reverse-complement
        ids fold to their base node first."""
        off = self.graph.offset if hasattr(self.graph, "get_base_node") \
            else 0
        return graph_to_anno_index(np.asarray(node), off)

    def annotate_batch(self, sequences, labels, starts=None,
                       abundances=None):
        """Annotate each ``sequences[i]`` with ``labels[i]``: its mapped
        rows (``annotate_sequence``), or with ``starts`` its coordinates
        from ``starts[i]`` (``annotate_kmer_coords``); then, with
        ``abundances``, its k-mer counts times ``abundances[i]``
        (``annotate_kmer_counts``)."""
        self.add_batch(self.graph.map_to_nodes_batch(sequences), labels,
                       starts, abundances)

    def add_batch(self, nodes_list, labels, starts=None, abundances=None):
        """``annotate_batch`` of sequences already mapped to
        ``nodes_list``."""
        anno = self.annotator
        for i, (nodes, labs) in enumerate(zip(nodes_list, labels)):
            pos = np.flatnonzero(nodes > 0)
            if not len(pos):
                # no k-mer mapped: no column is made
                continue
            rows = self.graph_to_anno_index(nodes[pos])
            if starts is not None:
                anno.add_label_coords(rows, starts[i] + pos, labs)
            anno.add_labels(rows, labs)
            if abundances is not None:
                uniq, counts = np.unique(rows, return_counts=True)
                anno.add_label_counts(uniq, counts * int(abundances[i]),
                                      labs)

    def annotate_sequence(self, sequence, labels: Sequence[str]):
        self.annotate_batch([sequence], [labels])

    def annotate_kmer_counts(self, sequence, labels: Sequence[str],
                             abundance: int = 1):
        """The k-mer multiplicities within the sequence, times its
        abundance, added to its rows' counts."""
        nodes = self.graph.map_to_nodes_batch([sequence])[0]
        hit = nodes[nodes > 0]
        if len(hit):
            uniq, counts = np.unique(self.graph_to_anno_index(hit),
                                     return_counts=True)
            self.annotator.add_label_counts(uniq, counts * int(abundance),
                                            labels)

    def annotate_kmer_coords(self, sequence, labels: Sequence[str],
                             start_coord: int = 0):
        self.annotate_batch([sequence], [labels], starts=[start_coord])
