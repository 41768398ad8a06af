"""Post-chaining of local alignments (``--align-post-chain``); own copy of
metagraph_tpu/align/chainer.py (ref src/graph/alignment/aligner_chainer.cpp
:554-733, alignment.cpp:94-278 append/trim_query_prefix,
alignment.cpp:1154-1234 insert_gap_prefix).

``chain_alignments`` combines partial local alignments of one query into
longer chains via sparse DP: alignments are sorted by query end position and
each is greedily extended with later alignments, either trimming the query
overlap or inserting an unaligned gap spelled with ``$`` dummy nodes.

The working representation ``_CAln`` keeps the query window (begin/end) and
the clipping amounts independent, mirroring the reference's
``std::string_view`` + CIGAR-S split: after trimming, internal soft-clips
(unaligned gap characters between chained segments) live inside the CIGAR.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .alignment import Alignment
from .cigar import (CLIPPED, DELETION, INSERTION, MATCH, MISMATCH,
                    NODE_INSERTION, Cigar)
from .config import AlignerConfig


@dataclass
class _CAln:
    query: bytes
    begin: int                 # query view [begin, end)
    end: int
    clip: int                  # S chars immediately before the view
    end_clip: int              # S chars immediately after the view
    ops: list                  # [[op, n]] without boundary clipping
    nodes: list
    sequence: bytes
    score: int
    offset: int
    orientation: bool
    label_columns: list = field(default_factory=list)

    def empty(self) -> bool:
        return not self.nodes

    def clear(self):
        self.nodes = []
        self.ops = []
        self.sequence = b""

    def copy(self) -> "_CAln":
        return _CAln(self.query, self.begin, self.end, self.clip,
                     self.end_clip, [list(o) for o in self.ops],
                     list(self.nodes), self.sequence, self.score, self.offset,
                     self.orientation, list(self.label_columns))


def _from_alignment(a: Alignment) -> _CAln:
    c, e = a.get_clipping(), a.get_end_clipping()
    ops = [list(o) for o in a.cigar.ops]
    if ops and ops[0][0] == CLIPPED:
        ops.pop(0)
    if ops and ops[-1][0] == CLIPPED:
        ops.pop()
    return _CAln(a.query, c, len(a.query) - e, c, e, ops, list(a.nodes),
                 bytes(a.sequence), a.score, a.offset, a.orientation,
                 list(a.label_columns))


def _to_alignment(a: _CAln) -> Alignment:
    cig = Cigar()
    if a.clip:
        cig.append(CLIPPED, a.clip)
    for op, n in a.ops:
        cig.append(op, n)
    if a.end_clip:
        cig.append(CLIPPED, a.end_clip)
    return Alignment(query=a.query, nodes=a.nodes, sequence=a.sequence,
                     score=a.score, cigar=cig, orientation=a.orientation,
                     offset=a.offset, label_columns=a.label_columns)


def _trim_offset(a: _CAln):
    """ref Alignment::trim_offset."""
    if not a.offset or len(a.nodes) <= 1:
        return
    trim = min(a.offset, len(a.nodes) - 1)
    a.nodes = a.nodes[trim:]
    a.offset -= trim


def trim_query_prefix(a: _CAln, n: int, node_overlap: int,
                      config: AlignerConfig,
                      trim_excess_deletions: bool = True) -> Optional[int]:
    """Cut the first ``n`` query chars off the alignment, rescoring
    (ref alignment.cpp:192-278).  Returns the number of characters consumed
    from the first remaining CIGAR op, or None if the alignment collapses."""
    had_clipping = a.clip > 0
    full_begin = a.begin - a.clip
    mat = config.score_matrix
    i_op, op_off = 0, 0
    qpos, spos, node_i = a.begin, 0, 0

    while n > 0 or (trim_excess_deletions and i_op < len(a.ops)
                    and a.ops[i_op][0] == DELETION):
        if i_op >= len(a.ops):
            a.clear()
            return None
        op, length = a.ops[i_op]
        if op in (MATCH, MISMATCH):
            a.score -= int(mat[a.query[qpos], a.sequence[spos]])
            qpos += 1
            n -= 1
            spos += 1
            if a.offset < node_overlap:
                a.offset += 1
            elif node_i + 1 < len(a.nodes):
                node_i += 1
            else:
                a.clear()
                return None
        elif op == INSERTION:
            a.score -= (config.gap_opening_penalty
                        if length - op_off == 1
                        else config.gap_extension_penalty)
            qpos += 1
            n -= 1
        elif op == DELETION:
            a.score -= (config.gap_opening_penalty
                        if length - op_off == 1
                        else config.gap_extension_penalty)
            spos += 1
            if a.offset < node_overlap:
                a.offset += 1
            elif node_i + 1 < len(a.nodes):
                node_i += 1
            else:
                a.clear()
                return None
        else:                       # CLIPPED / NODE_INSERTION: chains only
            a.clear()
            return None
        op_off += 1
        if op_off == length:
            i_op += 1
            op_off = 0

    if not had_clipping and (i_op > 0 or op_off > 0):
        a.score -= config.left_end_bonus

    a.nodes = a.nodes[node_i:]
    a.sequence = a.sequence[spos:]
    a.ops = [list(o) for o in a.ops[i_op:]]
    if a.ops and op_off:
        a.ops[0][1] -= op_off
    a.begin = qpos
    a.clip = qpos - full_begin
    return op_off


def insert_gap_prefix(a: _CAln, gap_length: int, node_overlap: int,
                      config: AlignerConfig):
    """Prepend an unaligned-gap connector (ref alignment.cpp:1154-1234).

    ``gap_length < 0``: the previous chain segment overlaps this one by
    ``-gap_length`` matched chars — add ``k-1+gap_length`` dummy nodes.
    ``gap_length >= 0``: disjoint — splice a ``$`` char plus dummy nodes;
    the gap's query chars become internal clipping."""
    extra = node_overlap + 1
    if gap_length < 0:
        a.clip = 0
        extra += gap_length - 1
        if a.offset:
            a.nodes = a.nodes[a.offset + gap_length:]
        if extra:
            a.score += (config.gap_opening_penalty
                        + (extra - 1) * config.gap_extension_penalty)
            a.ops.insert(0, [NODE_INSERTION, extra])
    else:
        a.clip = 0
        a.sequence = b"$" + a.sequence
        a.ops.insert(0, [DELETION, 1])
        a.score += config.gap_opening_penalty
        if gap_length <= node_overlap:
            _trim_offset(a)
            a.score += (config.gap_opening_penalty
                        + (extra - 2) * config.gap_extension_penalty)
            a.ops.insert(0, [NODE_INSERTION, extra - 1])
        a.clip = gap_length
    a.nodes = [0] * extra + a.nodes
    a.offset = node_overlap


def _append(chain: _CAln, other: _CAln) -> bool:
    """Concatenate query-adjacent alignments (ref alignment.cpp:94-175).
    Returns True if the label set narrowed."""
    changed = False
    if chain.label_columns and not other.label_columns:
        chain.label_columns = []
    if chain.label_columns:
        merged = sorted(set(chain.label_columns) & set(other.label_columns))
        if not merged:
            chain.clear()
            return True
        changed = len(merged) < len(chain.label_columns)
        chain.label_columns = merged
    chain.nodes = chain.nodes + other.nodes
    chain.sequence = chain.sequence + other.sequence
    chain.score += other.score
    if other.clip:
        if chain.ops and chain.ops[-1][0] == CLIPPED:
            chain.ops[-1][1] += other.clip
        else:
            chain.ops.append([CLIPPED, other.clip])
    for op, cnt in other.ops:
        if chain.ops and chain.ops[-1][0] == op:
            chain.ops[-1][1] += cnt
        else:
            chain.ops.append([op, cnt])
    chain.end = other.end
    chain.end_clip = other.end_clip
    return changed


def _construct_chain(chain: _CAln, group: List[_CAln], i0: int,
                     this_query: bytes, best_score: list, node_overlap: int,
                     config: AlignerConfig, callback):
    """ref aligner_chainer.cpp:construct_alignment_chain (623-719)."""
    if i0 >= len(group) or chain.end == len(this_query):
        callback(chain)
        return
    score = chain.score
    called = False
    for it in range(i0, len(group)):
        nxt = group[it]
        if nxt.offset:
            continue
        if nxt.begin <= chain.begin or nxt.end == chain.end:
            continue
        if chain.label_columns and not (set(nxt.label_columns)
                                        & set(chain.label_columns)):
            continue
        aln = nxt.copy()
        if aln.begin >= chain.end:
            insert_gap_prefix(aln, aln.begin - chain.end, node_overlap, config)
        else:
            # overlap: trim the front of the incoming alignment first
            last_op_len = chain.ops[-1][1] if chain.ops else 0
            t = trim_query_prefix(aln, chain.end - aln.begin, node_overlap,
                                  config)
            if t is None or aln.empty() \
                    or len(aln.sequence) <= node_overlap \
                    or not aln.ops or aln.ops[0][0] != MATCH:
                continue
            overlap = min(last_op_len, t)
            if overlap < node_overlap:
                insert_gap_prefix(aln, -overlap, node_overlap, config)
            else:
                aln.clip = 0
        if aln.empty():
            continue
        next_score = score + aln.score
        if next_score <= best_score[aln.end]:
            continue
        best_score[aln.end] = next_score
        next_chain = chain.copy()
        next_chain.end_clip = 0                 # trim_end_clipping
        chain_changed = _append(next_chain, aln)
        if next_chain.nodes:
            _construct_chain(next_chain, group, it + 1, this_query,
                             best_score, node_overlap, config, callback)
            called |= chain_changed
    if not called:
        callback(chain)


def chain_alignments(alignments: List[Alignment], query: bytes,
                     rc_query: bytes, config: AlignerConfig,
                     node_overlap: int) -> List[Alignment]:
    """Sparse-DP chaining over collected local alignments
    (ref aligner_chainer.cpp:554-620).  Returns chain candidates (plus any
    full-coverage alignments that bypass chaining); callers re-aggregate."""
    if len(alignments) < 2 or not config.post_chain_alignments:
        return list(alignments)

    results: List[Alignment] = []
    chainable: List[_CAln] = []
    for a in alignments:
        if not a.get_clipping() and not a.get_end_clipping():
            results.append(a)
        else:
            chainable.append(_from_alignment(a))

    chainable.sort(key=lambda a: (a.orientation, a.end, a.begin, -a.score,
                                  len(a.sequence)))

    def run(this_query: bytes, group: List[_CAln]):
        best = [0] * (len(this_query) + 1)
        for idx, a in enumerate(group):
            if a.score > best[a.end]:
                best[a.end] = a.score
                _construct_chain(
                    a.copy(), group, idx + 1, this_query, best, node_overlap,
                    config, lambda c: results.append(_to_alignment(c)))

    fwd = [a for a in chainable if not a.orientation]
    bwd = [a for a in chainable if a.orientation]
    run(query, fwd)
    run(rc_query, bwd)
    return results
