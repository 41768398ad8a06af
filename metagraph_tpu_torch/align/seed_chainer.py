"""Seed chaining with label coordinates (``align --align-chain``); own
copy of metagraph_tpu/align/seed_chainer.py (ref aligner_chainer.cpp
:64-546 call_seed_chains_both_strands / chain_seeds, dbg_aligner.cpp
:546-640, which calls them); ``iter_seed_chains`` yields the chains that
the JAX ``call_seed_chains_both_strands`` passes to its callback.

Chains exact-match seeds per (label, coordinate) anchor with the
minimap2-derived scoring DP (ref aligner_chainer.cpp:399-537, its scalar
reference implementation), splices each chain into one alignment with the
post-chaining splice of chainer.py and extends its end through the graph.
Anchors need a coordinate annotation, as in the reference ("Chaining only
supported for seeds with coordinates", dbg_aligner.cpp:547-550).

The chain-end extension is one flat-engine job: ``align_chained_seeds_gen``
is a generator of ``("extend", ...)`` requests like
``DBGAligner.align_gen``, so that ``drive_batch`` runs the chain ends of
every read of a batch in shared waves (kernel B11 ``align_wave`` on the
card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from .alignment import Alignment, revcomp, seed_to_alignment
from .chainer import (_append, _from_alignment, _to_alignment,
                      insert_gap_prefix, trim_query_prefix)
from .cigar import MATCH
from .config import AlignerConfig


@dataclass
class Anchor:
    label: int
    coord: int
    clipping: int       # seed query start
    end: int            # seed query end
    score: int          # chain DP score (init: seed length)
    seed_i: int


def chain_seeds(config: AlignerConfig, query_len: int, anchors: List[Anchor]):
    """Minimap2-style anchor chaining DP (ref aligner_chainer.cpp:399-537,
    scalar reference at :516-537).  Sorts anchors by (label, coord,
    clipping, end) descending; -> (sorted anchors, backtrace)."""
    anchors = sorted(anchors, key=lambda a: (a.label, a.coord, a.clipping,
                                             a.end), reverse=True)
    n = len(anchors)
    backtrace = [-1] * n
    if not n:
        return anchors, backtrace
    bandwidth = 65
    sl = config.min_seed_length * 0.01

    i = 0
    while i < n:
        j0 = i
        label = anchors[i].label
        while i < n and anchors[i].label == label:
            i += 1
        label_end = i
        for p in range(j0, label_end):
            prev = anchors[p]
            if not prev.clipping:
                continue
            it_end = min(p + bandwidth, label_end)
            coord_cutoff = prev.coord - query_len
            for j in range(p + 1, it_end):
                a = anchors[j]
                if coord_cutoff > a.coord:
                    break
                dist = prev.clipping - a.clipping
                coord_dist = prev.coord - a.coord
                if dist > 0 and max(dist, coord_dist) < query_len:
                    match = min(dist, coord_dist, a.end - a.clipping)
                    cur = prev.score + match
                    if coord_dist != dist:
                        cd = abs(coord_dist - dist)
                        cur -= int(cd * sl + math.log2(cd + 1) * 0.5)
                    if cur >= a.score:
                        a.score = cur
                        backtrace[j] = p
    return anchors, backtrace


def _merge_chain_seeds(chain: list):
    """Merge overlapping colinear seeds of a backtracked chain (ref
    aligner_chainer.cpp:237-266), then drop seeds with the coordinate of
    the one before (:270-295); ``chain`` is [[(start, length, nodes,
    offset), coord], ...] in ascending clipping."""
    for i in range(len(chain) - 1, 0, -1):
        if chain[i][0] is None or chain[i - 1][0] is None:
            continue
        (cs, cl, cn, _co), ccoord = chain[i]
        (ps, pl, pn, po), pcoord = chain[i - 1]
        prev_end = ps + pl
        if prev_end > cs:
            coord_dist = ccoord + cl - pcoord - pl
            dist = cs + cl - prev_end
            if dist == coord_dist and len(cn) >= dist:
                chain[i - 1][0] = (ps, pl + dist, pn + cn[-dist:], po)
                chain[i][0] = None
    out = [c for c in chain if c[0] is not None]
    for i in range(len(out) - 1, 0, -1):
        if out[i][1] == out[i - 1][1]:
            if out[i - 1][0][1] <= out[i][0][1]:
                out[i - 1][0] = None
            else:
                out[i][0] = None
    return [c for c in out if c[0] is not None]


def iter_seed_chains(query: bytes, config: AlignerConfig, fwd_anchors_seeds,
                     bwd_anchors_seeds):
    """The highest-scoring anchor chains of both strands, best first (ref
    aligner_chainer.cpp:64-340).  ``*_anchors_seeds`` is (anchors, seeds)
    of a strand; yields (chain, score, orientation, label) with chain =
    [((start, length, nodes, offset), coord delta), ...]."""
    tables = [chain_seeds(config, len(query), anchors)
              for anchors, _seeds in (fwd_anchors_seeds, bwd_anchors_seeds)]
    starts = []
    for strand, (anchors, _bt) in enumerate(tables):
        for i, a in enumerate(anchors):
            starts.append((a.score, strand, -i))
    starts.sort(reverse=True)
    used = [[False] * len(t[0]) for t in tables]

    for chain_score, strand, neg_i in starts:
        i = -neg_i
        if used[strand][i]:
            continue
        anchors, bt = tables[strand]
        seeds = (fwd_anchors_seeds, bwd_anchors_seeds)[strand][1]
        chain = []
        label = anchors[i].label
        while i != -1:
            a = anchors[i]
            used[strand][i] = True
            chain.append([seeds[a.seed_i], a.coord])
            i = bt[i]
        chain = _merge_chain_seeds(chain)
        if not chain:
            continue
        ok = True
        for j in range(len(chain) - 1, 0, -1):
            chain[j][1] -= chain[j - 1][1]
            if chain[j][1] <= 0:
                ok = False
        if not ok:
            continue
        chain[0][1] = 0
        yield chain, chain_score, bool(strand), label


def _splice(chain, q: bytes, orientation: bool, config: AlignerConfig,
            k: int):
    """One chain's seeds spliced into one alignment; None where a splice
    empties it."""
    cur = _from_alignment(seed_to_alignment(
        q, chain[0][0][0], chain[0][0][1], chain[0][0][2], orientation,
        chain[0][0][3], config))
    for (start, length, nodes, offset), _delta in chain[1:]:
        aln = _from_alignment(seed_to_alignment(
            q, start, length, nodes, orientation, offset, config))
        if aln.begin >= cur.end:
            insert_gap_prefix(aln, aln.begin - cur.end, k - 1, config)
        else:
            last_op_len = cur.ops[-1][1] if cur.ops else 0
            t = trim_query_prefix(aln, cur.end - aln.begin, k - 1, config)
            if t is None or aln.empty() or len(aln.sequence) <= k - 1 \
                    or not aln.ops or aln.ops[0][0] != MATCH:
                continue
            if min(last_op_len, t) < k - 1:
                insert_gap_prefix(aln, -min(last_op_len, t), k - 1, config)
            else:
                aln.clip = 0
        if aln.empty():
            continue
        cur.end_clip = 0
        _append(cur, aln)
        if cur.empty():
            return None
    return _to_alignment(cur)


def align_chained_seeds_gen(aligner, anno_graph, query: bytes):
    """``--align-chain`` for one read (ref dbg_aligner.cpp:546-640): seeds
    on both strands, their (label, coordinate) anchors from the coordinate
    annotation, the chains, each spliced and its end extended through the
    graph (one flat-engine job, yielded).  A generator for
    ``drive_batch``; returns the read's alignments."""
    from .aligner import AlignmentAggregator
    from .extender import DefaultColumnExtender

    config = aligner.config
    g = aligner.graph
    k = g.k
    query = bytes(query).upper()
    query_rc = revcomp(query)
    anno = anno_graph.annotator

    def anchors_for(q, orientation):
        seeds = aligner._make_seeder(q, orientation).get_seeds()
        anchors = []
        for si, (start, length, nodes, offset) in enumerate(seeds):
            first = next((n for n in nodes if n), 0)
            if not first or offset:
                continue
            row = int(anno_graph.graph_to_anno_index(np.array([first]))[0])
            for code, coords in anno.get_row_tuples(np.array([row]))[0]:
                for coord in sorted(
                        coords, reverse=True)[: config.max_num_seeds_per_locus]:
                    anchors.append(Anchor(code, int(coord), start,
                                          start + length, length, si))
        return anchors, seeds

    fwd = anchors_for(query, False)
    bwd = anchors_for(query_rc, True)
    if not fwd[0] and not bwd[0]:
        return []

    aggregator = AlignmentAggregator(config)
    extenders = {False: DefaultColumnExtender(g, config, query),
                 True: DefaultColumnExtender(g, config, query_rc)}

    for chain, _score, orientation, label in iter_seed_chains(
            query, config, fwd, bwd):
        covered = 0
        last_end = -1
        for (start, length, _, _), _d in chain:
            s, e = max(start, last_end), start + length
            if e > s:
                covered += e - s
            last_end = max(last_end, e)
        if covered / len(query) < config.min_exact_match:
            break               # the chains that follow score no better
        best = _splice(chain, query_rc if orientation else query,
                       orientation, config, k)
        if best is None:
            continue
        # the chain end extended through the graph (ref
        # dbg_aligner.cpp:470-480)
        best.label_columns = [label]
        if best.get_end_clipping() and all(best.nodes):
            exts = yield ("extend", (extenders[orientation], best,
                                     -2 ** 30, True))
            if exts and exts[0].get_end_clipping() < best.get_end_clipping() \
                    and exts[0].score > best.score:
                best = exts[0]
        aggregator.add(best)
    return aggregator.get_alignments()


def align_chained_seeds(aligner, anno_graph, query: bytes) -> List[Alignment]:
    """``align_chained_seeds_gen`` for one read, its extensions on the
    aligner's device."""
    from .batch import drive_batch
    return drive_batch([align_chained_seeds_gen(aligner, anno_graph, query)],
                       aligner.device, max_window=len(query) + 1)[0]
