"""Per-read extension state; own copy of the parts of
metagraph_tpu/align/extender.py that the flat wave engine (flat.py) reads
and writes (ref src/graph/alignment/aligner_extender_methods.cpp): the
query's profiles and partial sums, the convergence filter that
``check_seed`` reads across seeds, and the backtrack from the candidate
cells that the engine collects.  The column DP itself runs in the
engine's waves (kernel B11 ``align_wave`` on the card).

Each DP-table column aligns a band of the query window against one graph node
(tree of nodes rooted at the seed).  Recurrence per column j (band [begin,end)):

    F[j] = max(S_prev[j] + gap_open, F_prev[j] + gap_extend) + node_score
    M[j] = S_prev[j-1] + profile[j] + node_score
    S[j] = max(M[j], F[j], E[j]),  E[j+1] = max(S[j] + gap_open, E[j] + gap_ext)

with x-drop banding, branch-and-bound via suffix partial sums, and a
per-node convergence filter.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kmer.alphabets import ALPHABETS
from .alignment import Alignment
from .cigar import (CLIPPED, DELETION, INSERTION, MATCH, MISMATCH,
                    NODE_INSERTION, Cigar)
from .config import NINF, AlignerConfig


class Column:
    """One table column as the backtrack sees it: S, E and F are views
    into the engine's store (flat.py ``_materialize_table``)."""
    __slots__ = ("S", "E", "F", "node", "parent", "c", "offset", "max_pos",
                 "trim", "score")


class DefaultColumnExtender:
    def __init__(self, graph, config: AlignerConfig, query: bytes):
        self.graph = graph
        self.config = config
        self.query = query
        q = np.frombuffer(query, dtype=np.uint8)
        diag = config.score_matrix[q, q].astype(np.int64)
        # partial_sums_[i] = exact-match score of query[i:]
        ps = np.zeros(len(query) + 1, dtype=np.int64)
        ps[:-1] = diag[::-1].cumsum()[::-1]
        self.partial_sums = ps
        # profile per char: score row indexed by query pos + 1 shift.
        # Chars come from the graph's alphabet (DNA default keeps the fixed
        # 6-row ACGT$N layout for stable device shapes; Protein profiles all
        # 26 letters, 'X' is the catch-all wildcard row)
        alpha = ALPHABETS[graph.alphabet]
        if alpha.name != "DNA":
            # full letter set, case preserved (DNA_CASE keeps lowercase
            # rows); wildcard = the alphabet's catch-all character
            self.profile_chars = alpha.letters.encode()
            self.wildcard = ord("X") if "X" in alpha.letters else ord("N")
        else:
            self.profile_chars = b"ACGT$N"
            self.wildcard = ord("N")
        self.profile: Dict[int, np.ndarray] = {}
        for c in self.profile_chars:
            row = config.score_matrix[c].astype(np.int64)
            prof = np.full(len(query) + 1, NINF, dtype=np.int64)
            prof[1:] = row[q]
            self.profile[c] = prof
        # per-char profile row index for the batched wave kernel (built once;
        # unknown chars take the wildcard row)
        self.char_idx = np.full(
            256, list(self.profile_chars).index(self.wildcard),
            dtype=np.int64)
        for _i, _c in enumerate(self.profile_chars):
            self.char_idx[_c] = _i
        self.conv_checker: Dict[int, Tuple[int, np.ndarray]] = {}
        self.seed: Optional[Alignment] = None

    # ------------------------------------------------------------ filtering
    def clear_conv_checker(self):
        self.conv_checker.clear()

    def check_seed(self, seed: Alignment) -> bool:
        """ref SeedFilteringExtender::check_seed (:66-88)."""
        if seed.empty():
            return False
        ent = self.conv_checker.get(seed.nodes[-1])
        if ent is None:
            return True
        pos = len(seed.query_view()) + seed.get_clipping() - 1
        start, vec = ent
        return (pos < start or pos - start >= len(vec)
                or vec[pos - start] < seed.score)

    # ----------------------------------------------------------- backtrack
    def _backtrack_consume(self, indices, min_start_score, window, start,
                           seed_offset) -> List[Alignment]:
        """Trace alignments from pre-collected candidate start cells
        (``indices`` sorted descending by (score, -off_diag, -idx, pos))."""
        cfg = self.config
        seed = self.seed
        k = self.graph.k
        k_minus_1 = k - 1
        min_trace_length = k - seed.offset
        extensions: List[Alignment] = []
        best_score = -(2 ** 62)

        for (start_score, neg_off_diag, neg_j, start_pos) in indices:
            if len(extensions) >= cfg.num_alternative_paths:
                break
            j = -neg_j
            if j in self.prev_starts:
                continue
            self.prev_starts.add(j)

            if start_score - self.min_cell_score < best_score:
                break

            path: List[int] = []
            ops = Cigar()
            seq = bytearray()
            score = start_score
            dummy_counter = 0
            extra_score = 0
            pos = start_pos
            end_pos = start_pos
            align_offset = seed.offset

            def append_node(node, c, offset, op):
                nonlocal dummy_counter, extra_score
                seq.append(c)
                ops.append(op)
                if offset >= k_minus_1:
                    path.append(node)
                    if not node:
                        dummy_counter += 1
                    elif dummy_counter:
                        ops.append(NODE_INSERTION, dummy_counter)
                        extra_score -= cfg.gap_opening_penalty \
                            + (dummy_counter - 1) * cfg.gap_extension_penalty
                        dummy_counter = 0

            trace_len = 0
            jj = j
            while jj:
                col = self.table[jj]
                prev = self.table[col.parent]
                align_offset = min(col.offset, k_minus_1)
                if pos == col.max_pos:
                    self.prev_starts.add(jj)
                S = col.S
                pt = pos - col.trim
                if pt < 0 or pt >= len(S) or S[pt] == NINF:
                    jj = 0
                    break
                prof = self.profile.get(col.c)
                sc = int(prof[start + pos]) if prof is not None else NINF

                took_ins = False
                if (pos and pt < len(col.E) and S[pt] == col.E[pt]
                        and (not ops or ops.ops[-1][0] != DELETION)):
                    # insertion run
                    last_op = INSERTION
                    while last_op == INSERTION:
                        ops.append(INSERTION)
                        e_here = col.E[pos - col.trim]
                        e_prev_idx = pos - col.trim - 1
                        ext = (e_prev_idx >= 0
                               and col.E[e_prev_idx] != NINF
                               and e_here == col.E[e_prev_idx]
                               + cfg.gap_extension_penalty)
                        last_op = INSERTION if ext else MATCH
                        pos -= 1
                    took_ins = True
                    continue

                pos_p = pos - prev.trim - 1
                if (pos and pos >= prev.trim + 1
                        and 0 <= pos_p < len(prev.S)
                        and S[pt] == prev.S[pos_p] + col.score + sc):
                    trace_len += 1
                    extra_score += col.score
                    op = MATCH if window[pos - 1] == col.c else MISMATCH
                    append_node(col.node, col.c, col.offset, op)
                    pos -= 1
                    jj = col.parent
                    continue

                if (pt < len(col.F) and S[pt] == col.F[pt]
                        and (not ops or ops.ops[-1][0] != INSERTION)):
                    last_op = DELETION
                    while last_op == DELETION and jj:
                        col = self.table[jj]
                        prev = self.table[col.parent]
                        align_offset = min(col.offset, k_minus_1)
                        pf = pos - prev.trim
                        ext = (0 <= pf < len(prev.F)
                               and prev.F[pf] != NINF
                               and col.F[pos - col.trim] == prev.F[pf]
                               + col.score + cfg.gap_extension_penalty)
                        last_op = DELETION if ext else MATCH
                        trace_len += 1
                        extra_score += col.score
                        append_node(col.node, col.c, col.offset, DELETION)
                        jj = col.parent
                    continue

                break

            if trace_len >= min_trace_length and path and path[-1]:
                cur_cell = int(self.table[jj].S[pos - self.table[jj].trim])
                best_score = max(best_score, score - cur_cell)
                if score - self.min_cell_score < best_score:
                    break
                root_S0 = int(self.table[0].S[0])
                if (score >= min_start_score
                        and (pos == 0 or cur_cell == 0)
                        and (pos != 0 or cur_cell == root_S0)
                        and (cfg.allow_left_trim or jj == 0)):
                    aln = self._construct_alignment(
                        ops, pos, window[pos:end_pos], path, bytes(seq),
                        score, align_offset, extra_score, start)
                    extensions.append(aln)

        return extensions

    def _construct_alignment(self, ops: Cigar, pos, window_sub, path, seq,
                             score, offset, extra_score, start) -> Alignment:
        """ref construct_alignment (:774-798): reverse the backtracked ops and
        wrap with full-query clipping."""
        rev_ops = [list(x) for x in ops.ops][::-1]
        clipping = start + pos
        c2 = Cigar(CLIPPED, clipping)
        for op, n in rev_ops:
            c2.append(op, n)
        c2.append(CLIPPED, len(self.query) - clipping - c2.num_query_chars())
        a = Alignment(query=self.query, nodes=path[::-1], sequence=bytes(seq[::-1]),
                      score=score, cigar=c2, orientation=self.seed.orientation,
                      offset=offset, extra_score=extra_score)
        return a
