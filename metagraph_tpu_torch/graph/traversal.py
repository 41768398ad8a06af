"""BOSS path and unitig extraction; own copy of ``call_paths`` of
metagraph_tpu/graph/traversal.py (:459, with ``_TravIndex`` :54 and
``_Traversal`` :217; ref boss.cpp:2044-3100 call_paths), over the port's
BOSS (succinct/boss.py), in the one form ``align -o *.gfa`` needs:
unitigs with their sentinel characters trimmed (the JAX function with
``split_to_unitigs`` and ``trim_sentinels``).  ``align -o *.gfa`` reads
the unitigs' last edges from it.

Emission semantics mirror the reference traversal exactly:

  phase 1 — start from the source-dummy edges (node $^k), last to first
  phase 2 — start from every unvisited out-edge of multi-out forks
            (forks ascending by node; each fork's out-edges in the
            descending-index order the reference's LIFO stack pops them)
  phase 3 — remaining cycles, each started at its minimum edge

A walk stops at forks (queueing the unvisited out-edges LIFO) and at
multi-in nodes.  The JAX function's contig mode, untrimmed paths, primary
contigs (``kmers_in_single_form``) and subgraph masks wait for
``assemble``, with ``call_sequences`` and the unitig tip filter.

The walk is chain-compressed: a vectorized precompute decomposes the graph
into unitig-grain chains (maximal runs where the continuation is
deterministic: unique outgoing edge at the target and single incoming
occurrence), and the walk consumes a whole chain slice per Python step.
Only chain boundaries (forks, multi-in nodes, sentinel edges) run the
scalar reference logic; every emitted path is the sequential reference
order's.
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

from ..succinct.boss import BOSS


class _TravIndex:
    """Vectorized per-edge navigation tables + chain decomposition.

    All arrays are indexed by edge (0..M-1, edge 0 is the sentinel row):

      succ_last[e]   last edge of e's node
      block_begin[e] first edge of e's node
      fwd[e]         target node's last edge (ref boss.cpp:640-672)
      grp_cnt[e]     #masked edges in e's incoming group (the W==d edge plus
                     its W==d+alph run; ref masked_pick_single_incoming,
                     boss.cpp:1893-1935) — computed per symbol with merged
                     position scans instead of per-edge succ_W loops
      grp_first[e]   first masked edge of that group (0 if none)
      out_cnt_t[e]   #masked out-edges of e's target node
      unique_out[e]  the single masked out-edge when out_cnt_t == 1
      chain_*        unitig-grain chain decomposition via pointer doubling
    """

    def __init__(self, boss: BOSS):
        M = len(boss.W)
        alph = boss.alph_size
        Wraw = boss.W
        self.Wmod = (Wraw % alph).astype(np.uint8)
        self.M = M

        ends = np.flatnonzero(boss.last).astype(np.int64)
        eidx = np.searchsorted(ends, np.arange(M), side="left")
        self.node_ends = ends
        self.succ_last = ends[np.minimum(eidx, len(ends) - 1)]
        prev_end = np.where(eidx > 0, ends[np.maximum(eidx - 1, 0)], 0)
        self.block_begin = prev_end + 1

        # every edge but the sentinel row 0
        mask01 = np.ones(M, np.uint8)
        mask01[0] = 0
        self.mask01 = mask01
        cm = np.zeros(M + 1, np.int64)
        np.cumsum(mask01, out=cm[1:])
        self.cmask = cm
        self.masked_pos = np.flatnonzero(mask01).astype(np.int64)

        # batched fwd for every edge (one native rank/select pass)
        fwd = np.zeros(M, np.int64)
        if M > 1:
            fwd[1:] = boss.fwd(np.arange(1, M, dtype=np.int64))
        self.fwd = fwd

        # masked out-degree + unique out-edge at each edge's target
        tb = self.block_begin[fwd]
        out_cnt = np.where(fwd > 0, cm[fwd + 1] - cm[np.maximum(tb, 0)], 0)
        self.out_cnt_t = out_cnt
        uo = np.zeros(M, np.int64)
        one = out_cnt == 1
        if one.any():
            uo[one] = self.masked_pos[cm[fwd[one] + 1] - 1]
        self.unique_out = uo

        # incoming groups, per symbol (vectorized masked_pick_single_incoming)
        grp_cnt = np.zeros(M, np.int64)
        grp_first = np.zeros(M, np.int64)
        for d in range(alph):
            pd = np.flatnonzero(Wraw == d).astype(np.int64)
            if d == 0:
                pd = pd[pd > 0]
            if not len(pd):
                continue
            pm = (np.flatnonzero(Wraw == d + alph).astype(np.int64)
                  if d + alph < 256 else np.zeros(0, np.int64))
            nxt_d = np.concatenate([pd[1:], [M]])
            lo = np.searchsorted(pm, pd, side="right")
            hi = np.searchsorted(pm, nxt_d, side="left")
            cmm = np.zeros(len(pm) + 1, np.int64)
            if len(pm):
                np.cumsum(mask01[pm], out=cmm[1:])
            cnt = mask01[pd].astype(np.int64) + cmm[hi] - cmm[lo]
            mpos = pm[mask01[pm] > 0] if len(pm) else pm
            fm = np.zeros(len(pd), np.int64)
            hm = cmm[hi] > cmm[lo]
            if hm.any():
                fm[hm] = mpos[cmm[lo[hm]]]
            fm = np.where(mask01[pd] > 0, pd, fm)
            grp_cnt[pd] = cnt
            grp_first[pd] = fm
            if len(pm):
                gi = np.searchsorted(pd, pm, side="left") - 1
                ok = gi >= 0
                grp_cnt[pm[ok]] = cnt[gi[ok]]
                grp_first[pm[ok]] = fm[gi[ok]]
        self.grp_cnt = grp_cnt
        self.grp_first = grp_first

        # ---- chain decomposition: ch[e] = deterministic continuation ----
        # continuation exists iff the edge is non-sentinel, its target has
        # exactly one masked out-edge, AND the edge's incoming occurrence is
        # single (so chains have in-degree <= 1 and never merge)
        ch = np.where((self.Wmod != 0) & one & (grp_cnt == 1), uo, 0)
        ch[0] = 0
        idx = np.arange(M, dtype=np.int64)
        for _ in range(2):                      # second pass after cycle break
            pred = np.zeros(M, np.int64)
            has = ch > 0
            pred[ch[has]] = idx[has]
            heads = pred == 0
            pred[heads] = idx[heads]
            anc = pred.copy()
            dep = (anc != idx).astype(np.int64)
            steps = max(1, int(np.ceil(np.log2(max(M, 2)))) + 1)
            for _ in range(steps):
                dep = dep + dep[anc]
                anc = anc[anc]
            cyc = pred[anc] != anc
            if not cyc.any():
                break
            # break each ch-cycle right before its minimum edge so the chain
            # starts there (phase 3 emits cycles from their min edge)
            mnv = idx.copy()
            nx = np.where(ch > 0, ch, idx)
            for _ in range(steps):
                mnv = np.minimum(mnv, mnv[nx])
                nx = nx[nx]
            ch[cyc & (ch == mnv)] = 0
        self.head = anc
        order = np.lexsort((dep, anc))
        self.chain_arr = order.astype(np.int64)
        cp = np.empty(M, np.int64)
        cp[order] = np.arange(M)
        self.chain_pos = cp
        heads_in_order = anc[order]
        change = np.flatnonzero(np.diff(heads_in_order)) + 1
        starts = np.concatenate([[0], change])
        ends_ = np.concatenate([change, [M]])
        re_pos = np.repeat(ends_, ends_ - starts)
        self.run_end = re_pos[cp]

    # scalar helpers (chain-boundary only) --------------------------------
    def outgoing(self, t: int) -> List[int]:
        """Masked out-edges of the node whose last edge is t, descending
        (ref call_outgoing boss.hpp:779-784 + masked variant)."""
        b = int(self.block_begin[t])
        m = self.mask01
        return [x for x in range(t, b - 1, -1) if m[x]]


class _Traversal:
    def __init__(self, boss: BOSS):
        self.boss = boss
        self.ix = _TravIndex(boss)
        M = len(boss.W)
        self.visited = np.zeros(M, dtype=bool)
        self.visited[0] = True
        self.visited[boss.W == 0] = True
        self.results: List[Tuple[List[int], List[int]]] = []

    # ----------------------------------------------------------- traversal
    def run(self):
        boss = self.boss
        ix = self.ix
        # phase 1: source dummy edges, last to first
        start = int(boss.succ_last(np.array([1]))[0])
        for i in range(start, 0, -1):
            if not self.visited[i]:
                self.walk(deque([(i, None)]))

        # phase 2: forks, ascending by node; out-edges descending
        ne = ix.node_ends
        out_cnt_node = ix.cmask[ne + 1] - ix.cmask[ix.block_begin[ne]]
        for last_i in ne[out_cnt_node >= 2]:
            block = ix.outgoing(int(last_i))
            for e in block:
                if not self.visited[e]:
                    self.walk(deque([(e, None)]))

        # phase 3: cycles
        for i in np.flatnonzero(~self.visited):
            if not self.visited[i]:
                self.process_cycle(int(i))

    def process_cycle(self, start: int):
        """Walk the remaining cycle through `start` chain-by-chain to find
        its minimum edge, then emit from there (ref boss.cpp:2243-2265)."""
        ix = self.ix
        mn = start
        e = start
        guard = 0
        while True:
            i0 = int(ix.chain_pos[e])
            i1 = int(ix.run_end[e])
            if (e != start and ix.head[e] == ix.head[start]
                    and i0 < ix.chain_pos[start] < i1):
                seg = ix.chain_arr[i0:int(ix.chain_pos[start])]
                if len(seg):
                    mn = min(mn, int(seg.min()))
                break
            seg = ix.chain_arr[i0:i1]
            mn = min(mn, int(seg.min()))
            tail = int(seg[-1])
            cnt = int(ix.out_cnt_t[tail])
            if cnt == 1:
                e = int(ix.unique_out[tail])
            elif cnt >= 2:
                e = int(ix.fwd[tail])          # ref pick returns node's last
            else:
                raise AssertionError("cycle walk lost its continuation")
            if e == start:
                break
            guard += len(seg) + 1
            if guard > ix.M + 1:
                raise AssertionError("cycle walk did not terminate")
        if not self.visited[mn]:
            self.walk(deque([(mn, None)]))

    def walk(self, queue: deque):
        boss = self.boss
        ix = self.ix
        alph = boss.alph_size
        Wraw = boss.W
        visited = self.visited
        chain_arr = ix.chain_arr
        chain_pos = ix.chain_pos
        run_end = ix.run_end
        Wmod = ix.Wmod
        while queue:
            edge, kmer = queue.pop()
            if visited[edge]:
                continue
            if kmer is not None:
                sequence = list(kmer)
            else:
                sequence = list(boss.get_node_seq(np.array([edge]))[0])
            path = []

            while not visited[edge]:
                # ---- fast path: consume the rest of the edge's chain ----
                i0 = int(chain_pos[edge])
                i1 = int(run_end[edge])
                if i1 - i0 > 1:
                    seg = chain_arr[i0:i1]
                    vis = visited[seg]
                    j = int(np.argmax(vis)) if vis.any() else len(seg)
                    if j > 1:
                        if j < len(seg):
                            consume = seg[:j]
                            nxt_edge = int(seg[j])     # visited -> loop exits
                        else:
                            consume = seg[:-1]
                            nxt_edge = int(seg[-1])    # tail: scalar step
                        visited[consume] = True
                        path.extend(consume.tolist())
                        sequence.extend(Wmod[consume].tolist())
                        edge = nxt_edge
                        continue

                # ---- scalar step (chain boundary; ref boss.cpp:2280-2350)
                visited[edge] = True
                w = int(Wraw[edge])
                d = w % alph
                sequence.append(d)
                path.append(edge)
                if not d:
                    break

                single_in = ix.grp_cnt[edge] == 1
                out_edges = ix.outgoing(int(ix.fwd[edge]))
                if len(out_edges) == 1 and single_in:
                    edge = out_edges[0]
                    continue
                for e in out_edges:
                    if not visited[e]:
                        queue.append((e, list(sequence[-boss.k:])))
                break

            if path:
                self.call_path(path, sequence)

    # ------------------------------------------------------- path finishing
    def call_path(self, path, sequence):
        """Emit a path with its sentinel characters cut (nothing where no
        k-mer is left)."""
        if sequence[-1] == 0:                       # trailing sentinel
            sequence = sequence[:-1]
            path = path[:-1]
        first_valid = 0
        while first_valid < len(sequence) and sequence[first_valid] == 0:
            first_valid += 1
        if first_valid + self.boss.k >= len(sequence):
            return
        self.results.append((path[first_valid:], sequence[first_valid:]))


def call_paths(boss: BOSS):
    """The graph's unitigs, sentinels trimmed, as (edges, codes) pairs in
    the reference's order."""
    t = _Traversal(boss)
    t.run()
    return t.results
