"""Flat multi-extension alignment engine with continuous job admission;
own copy of the numpy ``FlatEngine`` of metagraph_tpu/align/flat.py
(:202-995), whose column store and waves live on the engine's torch
device: each wave is one ``align_wave`` (wave_extender.py, kernel B11 on
the card, its plain version on the CPU) over the store, which computes
the parents' hulls, the recurrence, the pad and the row statistics and
writes the children's rows into the store.  A wave copies to the card
its packed per-child vectors (and, in one copy before it, the tables and
root columns of the jobs admitted since the wave before; after it, in one
copy, the branch pops' re-masked rows) and reads back the statistics, the
children's S rows (for the convergence filter) and, for later siblings
of a branch pop, their E rows and parents' S rows.  A finished job's
table comes back with the others of its step in one copy
(``fetch_tables``).  The JAX package's native engine is left out; the
numpy path its native wave short-circuits gives the same bytes.

A labeled job (its extender carries an ``AnnotationBuffer``, labeled.py)
prunes its children before the wave, as the JAX ``LabeledExtender``
prunes inside its per-read column DP: each store row of the job keeps
label words (its root row the seed's), a child's are its parent's ANDed
with its node's, and a child left without labels never reaches the wave,
the store, the convergence filter or the branch loop; a parent that loses
every child is a tip.  Jobs without a buffer run exactly as before.

Runs MANY seed extensions (across reads) concurrently while preserving each
extension's EXACT best-first column order (ref per-read loop:
aligner_extender_methods.cpp:412-700; the single-extension reference
implementation is ``DefaultColumnExtender._extend`` of
metagraph_tpu/align/extender.py).  Per global
wave, every active extension pops its next best-first column — the same pop
the sequential extender would make — and all popped columns' children are
scored by ONE stacked column-DP call and one batched graph-traversal call.
Branch pops (2+ children, where the sequential semantics update the x-drop
cutoff and best score between siblings) take a per-child exact loop; chain
pops (one child, the vast majority in a de Bruijn graph — ~99% measured)
are handled fully vectorized: per-wave bookkeeping (cutoff/best raises,
min-cell tracking, backtrack-candidate checks) runs as array ops over all
single-child jobs at once, since each job contributes at most one child per
wave and jobs are independent.

Columns live in a COLUMNAR store (``G``, a (rows, 3, Wp) int32 tensor of S,
E and F rows on the device, each row padded to Wp, a multiple of 4, so
that it starts on 16 bytes; per-column metadata arrays on the host) shared
across jobs: each wave writes every child into a row of its own, the rows
of children that are not kept go back to the free list at once, parent
rows are read where they lie, and rows are recycled through the free list
when a job finalizes — no per-column Python objects during extension.
Backtracking sees the table through a lazy adapter that materializes
Column views only for the cells a trace actually touches.

The engine admits new extension jobs while others are mid-flight (continuous
batching): when a read finishes one extension, its next seed's extension
joins the running wave pool immediately.  Value arrays are int32 — NINF
(= INT32_MIN + 100) fits exactly and all score arithmetic stays within the
+-100 headroom (see wave_dp_plain's wrap-safe E clamp).  Outputs are
bit-identical to that single-extension loop run per read.
"""

from __future__ import annotations

import heapq
import time
from typing import List

import numpy as np
import torch

from .alignment import Alignment
from .config import NINF
from .extender import Column
from . import wave_extender as wx

_POS = np.int32(2 ** 31 - 1)

def _materialize_table(eng, gcols, WS, block):
    """Bulk-construct the per-job Column list from the columnar store
    (attribute scalars come from one .tolist() pass per field; S/E/F are
    views into ``block``, the job's rows as ``fetch_tables`` read them,
    valid until the next fetch)."""
    gi = np.array(gcols, dtype=np.int64)
    nodes = eng.g_node[gi].tolist()
    parents = eng.g_parent[gi].tolist()
    cs = eng.g_c[gi].tolist()
    offs = eng.g_off[gi].tolist()
    mps = eng.g_maxpos[gi].tolist()
    scores = eng.g_score[gi].tolist()
    table = []
    app = table.append
    for t in range(len(gcols)):
        col = Column.__new__(Column)
        col.S = block[t, 0, :WS]
        col.E = block[t, 1, :WS]
        col.F = block[t, 2, :WS]
        col.node = nodes[t]
        col.parent = parents[t]
        col.c = cs[t]
        col.offset = offs[t]
        col.max_pos = mps[t]
        col.trim = 0
        col.score = scores[t]
        app(col)
    return table


def _group_key(ext):
    # the score matrix too: the engine builds its jobs' profile rows on the
    # device from one table of it
    return (id(ext.graph), ext.config.gap_opening_penalty,
            ext.config.gap_extension_penalty, bytes(ext.profile_chars),
            id(ext.config.score_matrix))


class _Job:
    __slots__ = ("ext", "seed", "min_path_score", "ffs", "start", "window",
                 "wsize", "WS", "seed_offset", "tips", "conv_rows", "cand",
                 "queue", "next_nodes", "gcols", "col_max", "cur", "done",
                 "rows")

    def __init__(self, ext, seed, min_path_score, ffs):
        self.ext = ext
        self.seed = seed
        # the extension's entry clamp (metagraph_tpu/align/extender.py
        # ``_extend``)
        self.min_path_score = max(0, min_path_score)
        self.ffs = ffs
        self.tips: List[int] = []
        self.conv_rows = {}      # node -> row index into the CONV store
        self.cand: List[tuple] = []   # per-wave backtrack candidate arrays
        # best-first pop state (the pop discipline of
        # metagraph_tpu/align/extender.py:236-252)
        self.queue = [(0, 0, 0)]
        self.next_nodes: List[tuple] = []
        self.gcols: List[int] = []    # per-job tidx -> global store row
        self.col_max: List[int] = []  # stored column max per table entry
        self.cur = -1
        self.done = False
        self.rows = None      # the table's rows, read by fetch_tables

    def pop_next(self):
        """Next table index to process, per the reference pop discipline
        (pop a batch of equal-priority entries, serve it LIFO); -1 when the
        extension is finished."""
        while True:
            if not self.next_nodes:
                if not self.queue:
                    return -1
                item = heapq.heappop(self.queue)
                self.next_nodes = [item]
                while self.queue and self.queue[0][0] == item[0]:
                    self.next_nodes.append(heapq.heappop(self.queue))
            while self.next_nodes:
                return -self.next_nodes.pop()[2]

    def push_child(self, converged_score, off_diag, tidx):
        entry = (-converged_score, off_diag, -tidx)
        if self.next_nodes and -converged_score == self.next_nodes[0][0]:
            self.next_nodes.append(entry)
        else:
            heapq.heappush(self.queue, entry)

    def kill(self):
        self.queue = []
        self.next_nodes = []


def _grow1(a, cap, fill=None):
    out = np.empty(cap, dtype=a.dtype) if fill is None \
        else np.full(cap, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


class FlatEngine:
    """Stacked wave loop over a dynamic pool of best-first extension jobs.

    ``add_job`` may be called between ``step`` calls; each ``step`` advances
    every active extension by one best-first column pop and returns the job
    slots that completed.  ``finalize`` backtracks a completed job and
    returns its extensions.
    """

    def __init__(self, graph, config, profile_chars, char_idx, W, device):
        self.graph = graph
        self.k = graph.k
        self.go = config.gap_opening_penalty
        self.ge = config.gap_extension_penalty
        self.device = torch.device(device)   # where the store and waves are
        self.W = int(W)
        self.Wp = -(-self.W // 4) * 4        # a store row's stride
        self.C = len(profile_chars)
        self.profile_chars = profile_chars
        self.char_idx = char_idx
        W = self.W
        self.jj = np.arange(W, dtype=np.int64)
        self.jj32 = self.jj.astype(np.int32)

        self.jobs: List[_Job] = []
        self.active_ids: List[int] = []
        cap = self.jcap = 64
        self.WSv = np.empty(cap, dtype=np.int64)
        self.wsizev = np.empty(cap, dtype=np.int64)
        self.seed_off = np.empty(cap, dtype=np.int64)    # seed.offset - 1
        self.seed_off0 = np.empty(cap, dtype=np.int64)   # seed.offset
        self.seed_len = np.empty(cap, dtype=np.int64)
        self.seed_node0 = np.empty(cap, dtype=np.int64)
        self.ffs_v = np.zeros(cap, dtype=bool)
        self.lab_v = np.zeros(cap, dtype=bool)           # labeled job
        self.pso_v = np.empty(cap, dtype=np.int64)
        self.max_nodes_cap = np.empty(cap, dtype=np.float64)
        self.xdrop_v = np.empty(cap, dtype=np.int32)
        self.rcut_v = np.empty(cap, dtype=np.float64)
        self.cutoff = np.empty(cap, dtype=np.int32)
        self.best = np.zeros(cap, dtype=np.int32)
        self.TL = np.ones(cap, dtype=np.int64)
        self.mcs = np.zeros(cap, dtype=np.int32)
        self.msc_v = np.empty(cap, dtype=np.int64)      # min start score
        self.reb_v = np.empty(cap, dtype=np.int64)      # right end bonus
        self.sdist_v = np.empty(cap, dtype=np.int64)    # seed_dist
        self.Ln = 8
        self.Ls = 8
        self.seed_nodes = np.zeros((cap, self.Ln), dtype=np.int64)
        self.seed_seq = np.zeros((cap, self.Ls), dtype=np.int64)
        self.P = np.full((cap, self.C, W), NINF, dtype=np.int32)
        self.pss = np.zeros((cap, W), dtype=np.int32)
        self.winb = np.zeros((cap, W), dtype=np.int64)  # window bytes
        # the same profile rows and partial sums on the device, C + 1 rows
        # of Wp a job (align_wave's tables), built in _flush before the
        # first wave that reads them from each job's window, partial sums
        # and root column, which go up in one copy: the profile rows from
        # the window's characters through ``score``, the score matrix's
        # rows of the profile characters (column 256: NINF, the cells
        # before the query and past WS)
        self.T = torch.empty((cap, self.C + 1, self.Wp), dtype=torch.int32,
                             device=self.device)
        rows = config.score_matrix[list(profile_chars)]
        sc = np.full((self.C, 257), NINF, dtype=np.int32)
        sc[:, : rows.shape[1]] = rows
        self.score = torch.from_numpy(sc.T.copy()).to(self.device)
        self.flushed = 0                 # jobs whose rows are on the device
        self.roots: List[np.ndarray] = []   # their root columns' S, (W,)
        self.root_rows: List[int] = []
        self.host = {}                   # reused host buffers, by name
        self.flush_bytes = 0             # the last step's _flush

        # columnar table store shared across jobs (rows recycle via `free`
        # when a job finalizes)
        self.gcap = 1 << 12
        self.g_n = 0
        self.free: List[int] = []
        self.G = torch.empty((self.gcap, 3, self.Wp), dtype=torch.int32,
                             device=self.device)
        self.g_node = np.empty(self.gcap, dtype=np.int64)
        self.g_parent = np.empty(self.gcap, dtype=np.int64)
        self.g_c = np.empty(self.gcap, dtype=np.int64)
        self.g_off = np.empty(self.gcap, dtype=np.int64)
        self.g_maxpos = np.empty(self.gcap, dtype=np.int64)
        self.g_score = np.empty(self.gcap, dtype=np.int64)
        # the labeled jobs' AnnotationBuffer (labeled.py) and each of their
        # store rows' label words: a root row the seed's, a child's its
        # parent's ANDed with its node's
        self.labels = None
        self.g_lab = None

        # convergence-filter store: rows of width W-1 (np.empty = virtual
        # allocation; pages commit only on write)
        self.conv_cap = 1 << 18
        self.CONV = np.empty((self.conv_cap, max(W - 1, 1)), dtype=np.int32)
        self.conv_n = 0

    # ------------------------------------------------------------- admission
    def _grow_jobs(self, need):
        cap = self.jcap
        while cap < need:
            cap *= 2
        if cap == self.jcap:
            return
        self.jcap = cap
        for name in ("WSv", "wsizev", "seed_off", "seed_off0", "seed_len",
                     "seed_node0", "pso_v", "max_nodes_cap", "xdrop_v",
                     "rcut_v", "cutoff", "msc_v", "reb_v", "sdist_v"):
            setattr(self, name, _grow1(getattr(self, name), cap))
        self.ffs_v = _grow1(self.ffs_v, cap, fill=False)
        self.lab_v = _grow1(self.lab_v, cap, fill=False)
        self.best = _grow1(self.best, cap, fill=0)
        self.TL = _grow1(self.TL, cap, fill=1)
        self.mcs = _grow1(self.mcs, cap, fill=0)
        for name, width in (("seed_nodes", self.Ln), ("seed_seq", self.Ls)):
            old = getattr(self, name)
            new = np.zeros((cap, width), dtype=np.int64)
            new[: len(old)] = old
            setattr(self, name, new)
        newP = np.full((cap, self.C, self.W), NINF, dtype=np.int32)
        newP[: len(self.P)] = self.P
        self.P = newP
        newT = torch.empty((cap,) + tuple(self.T.shape[1:]),
                           dtype=torch.int32, device=self.device)
        newT[: self.flushed] = self.T[: self.flushed]
        self.T = newT
        for name in ("pss", "winb"):
            old = getattr(self, name)
            new = np.zeros((cap, self.W), dtype=old.dtype)
            new[: len(old)] = old
            setattr(self, name, new)

    def _grow_seed_tables(self, ln, ls):
        if ln > self.Ln:
            while self.Ln < ln:
                self.Ln *= 2
            new = np.zeros((self.jcap, self.Ln), dtype=np.int64)
            new[:, : self.seed_nodes.shape[1]] = self.seed_nodes
            self.seed_nodes = new
        if ls > self.Ls:
            while self.Ls < ls:
                self.Ls *= 2
            new = np.zeros((self.jcap, self.Ls), dtype=np.int64)
            new[:, : self.seed_seq.shape[1]] = self.seed_seq
            self.seed_seq = new

    # --------------------------------------------------------- column store
    def _grow_store(self, need):
        cap = self.gcap
        while cap < need:
            cap *= 2
        newG = torch.empty((cap, 3, self.Wp), dtype=torch.int32,
                           device=self.device)
        newG[: self.g_n] = self.G[: self.g_n]
        self.G = newG
        for name in ("g_node", "g_parent", "g_c", "g_off", "g_maxpos",
                     "g_score"):
            setattr(self, name, _grow1(getattr(self, name), cap))
        if self.g_lab is not None:
            lab = np.zeros((cap, self.g_lab.shape[1]), dtype=np.uint64)
            lab[: self.g_n] = self.g_lab[: self.g_n]
            self.g_lab = lab
        self.gcap = cap

    def _galloc(self, n):
        """Allocate n store rows (recycled rows first)."""
        free = self.free
        if len(free) >= n:
            rows = np.array(free[-n:], dtype=np.int64)
            del free[-n:]
            return rows
        need = self.g_n + n
        if need > self.gcap:
            self._grow_store(need)
        rows = np.arange(self.g_n, need, dtype=np.int64)
        self.g_n = need
        return rows

    def add_job(self, ext, seed, min_path_score, force_fixed_seed) -> int:
        """Admit one extension; returns its job slot.  The job joins the
        wave pool at the next step()."""
        assert ext.graph is self.graph
        job = _Job(ext, seed, min_path_score, force_fixed_seed)
        j = len(self.jobs)
        self.jobs.append(job)
        self._grow_jobs(j + 1)
        self._grow_seed_tables(len(seed.nodes), len(seed.sequence))

        ext.seed = seed
        ext.clear_conv_checker()
        job.start = seed.get_clipping()
        job.window = ext.query[job.start:]
        job.wsize = len(job.window)
        job.WS = job.wsize + 1
        assert job.WS <= self.W, (job.WS, self.W)
        job.seed_offset = seed.offset - 1
        cfgj = ext.config
        cut0 = max(-cfgj.xdrop, NINF + 1)

        WS, W = job.WS, self.W
        self.WSv[j] = WS
        self.wsizev[j] = job.wsize
        self.seed_off[j] = job.seed_offset
        self.seed_off0[j] = seed.offset
        self.seed_len[j] = len(seed.sequence)
        self.seed_node0[j] = seed.nodes[0]
        self.ffs_v[j] = job.ffs
        buf = getattr(ext, "buffer", None)
        self.lab_v[j] = buf is not None
        if buf is not None and self.labels is not buf:
            if self.labels is not None:
                raise ValueError("the labeled jobs of one engine share one "
                                 "annotation buffer")
            self.labels = buf
            self.g_lab = np.zeros((self.gcap, buf.n_words), dtype=np.uint64)
        self.pso_v[j] = int(ext.partial_sums[job.start + job.wsize])
        self.max_nodes_cap[j] = cfgj.max_nodes_per_seq_char
        self.xdrop_v[j] = cfgj.xdrop
        self.rcut_v[j] = cfgj.rel_score_cutoff
        self.cutoff[j] = cut0
        self.best[j] = 0
        self.TL[j] = 1
        self.mcs[j] = 0
        self.msc_v[j] = job.min_path_score
        self.reb_v[j] = cfgj.right_end_bonus
        self.sdist_v[j] = max(self.k, len(seed.sequence)) - 1
        self.seed_nodes[j, : len(seed.nodes)] = seed.nodes
        self.seed_nodes[j, len(seed.nodes):] = 0
        self.seed_seq[j, : len(seed.sequence)] = np.frombuffer(
            seed.sequence, dtype=np.uint8)
        self.seed_seq[j, len(seed.sequence):] = 0
        s = job.start
        self.P[j, :, WS:] = NINF
        for ci, c in enumerate(ext.profile_chars):
            self.P[j, ci, :WS] = ext.profile[c][s: s + WS]
        self.pss[j, :WS] = ext.partial_sums[s: s + WS]
        self.pss[j, WS:] = 0
        self.winb[j, : job.wsize] = np.frombuffer(job.window, dtype=np.uint8)
        self.winb[j, job.wsize:] = 0

        # root column (extender.py:219-231)
        rS = np.full(WS, NINF, dtype=np.int32)
        rE = np.full(WS, NINF, dtype=np.int32)
        rF = np.full(WS, NINF, dtype=np.int32)
        rS[0] = cfgj.left_end_bonus \
            if (cfgj.left_end_bonus and not job.start) else 0
        if WS > 1:
            chain = rS[0] + self.go \
                + np.arange(WS - 1, dtype=np.int64) * self.ge
            ok = chain >= cut0
            ok &= np.minimum.accumulate(ok)
            rE[1:] = np.where(ok, chain, NINF)
            rS[1:] = rE[1:]
        g = int(self._galloc(1)[0])
        # rE is rS but for cell 0, and rF is NINF: _flush makes both
        root = np.full(W, NINF, dtype=np.int32)
        root[:WS] = rS
        self.roots.append(root)
        self.root_rows.append(g)
        self.g_node[g] = seed.nodes[0]
        self.g_parent[g] = -1
        self.g_c[g] = 0
        self.g_off[g] = job.seed_offset
        self.g_maxpos[g] = 0
        self.g_score[g] = 0
        if buf is not None:
            self.g_lab[g] = ext.seed_words
        job.gcols = [g]
        ext.prev_starts = set()
        ext.min_cell_score = 0
        job.col_max = [int(rS.max())]
        self.active_ids.append(j)
        return j

    @property
    def active(self) -> bool:
        return bool(self.active_ids)

    def _conv_alloc(self, n):
        while self.conv_n + n > self.conv_cap:
            self.conv_cap *= 4
            newC = np.empty((self.conv_cap, self.CONV.shape[1]),
                            dtype=np.int32)
            newC[: self.conv_n] = self.CONV[: self.conv_n]
            self.CONV = newC
        rows = np.arange(self.conv_n, self.conv_n + n)
        self.conv_n += n
        return rows

    # ------------------------------------------------------- device copies
    def _host(self, name: str, n: int) -> torch.Tensor:
        """A host int32 buffer of ``n`` elements, kept by ``name`` and
        reused (pinned where the engine runs on the card).  Every copy out
        of it has ended before it is written again: each wave waits for
        its read-back."""
        buf = self.host.get(name)
        if buf is None or buf.numel() < n:
            size = max(n, 2 * (buf.numel() if buf is not None else 0), 4096)
            buf = torch.empty(size, dtype=torch.int32,
                              pin_memory=self.device.type == "cuda")
            self.host[name] = buf
        return buf[:n]

    def _flush(self) -> int:
        """Copy what the jobs admitted since the last wave need on the
        device, in one copy: a job's profile characters (the query
        character before each window cell, 256 where there is none), its
        partial sums and its root column's S; then build their profile
        rows and root columns there.  -> the bytes copied."""
        j0, j1 = self.flushed, len(self.jobs)
        if j0 == j1:
            return 0
        n, C, W, Wp = j1 - j0, self.C, self.W, self.Wp
        buf = self._host("jobs", n * 3 * Wp + n)
        a = buf.numpy()
        blk = a[: n * 3 * Wp].reshape(n, 3, Wp)
        blk[:, 0] = 256
        for t, job in enumerate(self.jobs[j0:j1]):
            s = job.start
            if s:
                blk[t, 0, 0] = job.ext.query[s - 1]
            blk[t, 0, 1: job.WS] = np.frombuffer(job.window, dtype=np.uint8)
        blk[:, 1:, W:] = NINF
        blk[:, 1, :W] = self.pss[j0:j1]
        blk[:, 2, :W] = self.roots
        a[n * 3 * Wp:] = self.root_rows
        d = buf.to(self.device, non_blocking=True)
        dblk = d[: n * 3 * Wp].view(n, 3, Wp)
        prof = wx.take_rows(self.score, dblk[:, 0].reshape(-1).long())
        self.T[j0:j1, :C] = prof.view(n, Wp, C).transpose(1, 2)
        self.T[j0:j1, C] = dblk[:, 1]
        root = torch.full((n, 3, Wp), NINF, dtype=torch.int32,
                          device=self.device)
        root[:, 0] = root[:, 1] = dblk[:, 2]
        root[:, 1, 0] = NINF
        wx.put_rows(self.G, d[n * 3 * Wp:].long(), root)
        self.flushed = j1
        self.roots, self.root_rows = [], []
        return buf.numel() * 4

    def fetch_tables(self, slots: List[int]):
        """Read the store rows of the finished jobs ``slots`` that have a
        backtrack candidate, in one copy, for their ``finalize`` (a job
        without one backtracks nothing and never reads its table)."""
        jobs = [self.jobs[j] for j in slots if self.jobs[j].cand
                and not self.jobs[j].ext.config.no_backtrack]
        if not jobs:
            return
        t0 = time.perf_counter()
        idx = np.concatenate([np.asarray(j.gcols, dtype=np.int64)
                              for j in jobs])
        rows = wx.take_rows(self.G, torch.from_numpy(idx).to(self.device))
        if self.device.type == "cuda":
            host = self._host("tables", rows.numel()).view(rows.shape)
            host.copy_(rows, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            rows = host
        block = rows.numpy()
        wx.STATS["bytes_tables"] += block.nbytes
        wx.STATS["seconds"] += time.perf_counter() - t0
        at = 0
        for job in jobs:
            job.rows = block[at: at + len(job.gcols)]
            at += len(job.gcols)

    # ------------------------------------------------------------- one wave
    def step(self) -> List[int]:
        """Advance every active extension by one best-first pop; returns
        newly finished job slots."""
        if not self.active_ids:
            return []
        t0 = time.perf_counter()
        self.flush_bytes = self._flush()
        wx.STATS["seconds"] += time.perf_counter() - t0
        wx.STATS["bytes_up"] += self.flush_bytes
        done: List[int] = []
        parents: List[int] = []     # job ids with a column to process
        for j in self.active_ids:
            job = self.jobs[j]
            tidx = self._pop_parent(j, job)
            if tidx < 0:
                job.done = True
                done.append(j)
            else:
                job.cur = tidx
                parents.append(j)
        self.active_ids = parents
        if parents:
            self._wave(parents)
        return done

    def _pop_parent(self, j: int, job) -> int:
        """Pop the next processable column per the reference discipline:
        node-cap kill (extender.py:248-253) and in-range skip (:255-260)
        happen at pop time."""
        cutoff = int(self.cutoff[j])
        best = int(self.best[j])
        wsize = max(int(self.wsizev[j]), 1)
        cap = self.max_nodes_cap[j]
        while True:
            tidx = job.pop_next()
            if tidx < 0:
                return -1
            cmax = job.col_max[tidx]
            if cmax < best and len(job.gcols) / wsize >= cap:
                job.kill()
                return -1
            if cmax >= cutoff:
                return tidx

    def _wave(self, parents: List[int]):
        jobs = self.jobs
        graph = self.graph
        k = self.k
        go, ge = self.go, self.ge
        W, C = self.W, self.C
        jj, jj32 = self.jj, self.jj32
        STATS = wx.STATS

        J = len(parents)
        pj = np.array(parents, dtype=np.int64)
        # the parents' store rows (read by align_wave where they lie)
        ptidx = np.empty(J, dtype=np.int64)
        g_cur = np.empty(J, dtype=np.int64)
        for t, j in enumerate(parents):
            job = jobs[j]
            ptidx[t] = job.cur
            g_cur[t] = job.gcols[job.cur]
        pnode = self.g_node[g_cur]
        poff = self.g_off[g_cur]

        # ---- enumerate children (extender.py call_outgoing :168-195)
        next_off = poff + 1
        seed_pos = next_off - self.seed_off0[pj]
        in_seed = (seed_pos >= 0) & (seed_pos < self.seed_len[pj])
        cls_a = in_seed & (next_off < k)
        cls_b = in_seed & ~cls_a & self.ffs_v[pj]
        cls_c = ~cls_a & ~cls_b

        rows_c = np.flatnonzero(cls_c)
        ab_rows = np.flatnonzero(cls_a | cls_b)
        a_of = cls_a[ab_rows]
        node_i = np.maximum(next_off[ab_rows] - k + 1, 0)
        ab_nodes = np.where(a_of, self.seed_node0[pj[ab_rows]],
                            self.seed_nodes[pj[ab_rows], node_i])
        ab_chars = self.seed_seq[pj[ab_rows], seed_pos[ab_rows]]
        ab_score = np.where(
            ~a_of & (ab_nodes == 0),
            np.where(pnode[ab_rows] == 0, ge, go), 0).astype(np.int32)

        if len(rows_c):
            own, chd, cde = graph.call_outgoing_batch(pnode[rows_c])
            has_child = np.zeros(len(rows_c), dtype=bool)
            has_child[own] = True
            for r in rows_c[~has_child]:
                jobs[int(pj[r])].tips.append(int(ptidx[r]))
            c_rows = rows_c[own]
            c_nodes = chd
            c_chars = cde
        else:
            c_rows = np.empty(0, dtype=np.int64)
            c_nodes = np.empty(0, dtype=np.int64)
            c_chars = np.empty(0, dtype=np.int64)

        ch_rows = np.concatenate([ab_rows, c_rows])
        if len(ch_rows) == 0:
            return
        ch_nodes = np.concatenate([ab_nodes, c_nodes])
        ch_chars = np.concatenate([ab_chars, c_chars])
        ch_score = np.concatenate(
            [ab_score, np.zeros(len(c_rows), dtype=np.int32)])
        # children are already in per-parent emission order within each
        # class, and each parent is in exactly one class; sort rows (stable)
        # to group each parent's children contiguously in emission order
        corder = np.argsort(ch_rows, kind="stable")
        ch_rows = ch_rows[corder]
        ch_nodes = ch_nodes[corder]
        ch_chars = ch_chars[corder]
        ch_score = ch_score[corder]
        ch_lab = None
        if self.labels is not None and self.lab_v[pj].any():
            alive, ch_lab = self._prune_labels(pj, ptidx, g_cur, ch_rows,
                                               ch_nodes)
            if not alive.all():
                ch_rows, ch_nodes, ch_chars, ch_score, ch_lab = (
                    ch_rows[alive], ch_nodes[alive], ch_chars[alive],
                    ch_score[alive], ch_lab[alive])
                if len(ch_rows) == 0:
                    return
        ch_jid = pj[ch_rows]
        ch_off = next_off[ch_rows]

        # ---- one align_wave over the store (pre-pop cutoff; sibling-
        # sequential cutoff raises are corrected below)
        CH = len(ch_rows)
        ccut = self.cutoff[ch_jid]
        diag = (ch_off - self.seed_off[ch_jid]).astype(np.int32)
        spos_c = ch_off - self.seed_off0[ch_jid]
        in_seed_c = (spos_c >= 0) & (spos_c < self.seed_len[ch_jid])
        ext_cut = (self.best[ch_jid] * self.rcut_v[ch_jid]
                   + self.pso_v[ch_jid]).astype(np.float64)
        P2 = self.P.reshape(-1, W)
        cidx = self.char_idx[ch_chars]
        prof_rows = ch_jid * C + cidx

        # group children per parent (ch_rows ascending after the sort);
        # later siblings of a branch pop get a read-back slot
        grp_first = np.searchsorted(ch_rows, ch_rows, side="left")
        grp_size = np.searchsorted(ch_rows, ch_rows, side="right") - grp_first
        ar = np.arange(CH)
        later = np.flatnonzero(grp_first != ar)
        slot = np.full(CH, -1, dtype=np.int64)
        slot[later] = np.arange(len(later))
        orow = self._galloc(CH)      # every child's store row

        pack_t = self._host("pack", CH * wx.NPACK)
        pack = pack_t.numpy().reshape(CH, wx.NPACK)
        pack[:, wx.PK_PARENT] = g_cur[ch_rows]
        pack[:, wx.PK_ROW] = orow
        pack[:, wx.PK_PROF] = ch_jid * (C + 1) + cidx
        pack[:, wx.PK_PSS] = ch_jid * (C + 1) + C
        pack[:, wx.PK_SCORE] = ch_score
        pack[:, wx.PK_DEL] = ch_off > 1
        pack[:, wx.PK_CUT] = ccut
        pack[:, wx.PK_WS] = self.WSv[ch_jid]
        pack[:, wx.PK_WSIZE] = self.wsizev[ch_jid]
        pack[:, wx.PK_DIAG] = diag
        pack[:, wx.PK_SLOT] = slot
        pack[:, wx.PK_XCUT:] = ext_cut.view(np.int32).reshape(CH, 2)
        out_t = self._host("out", wx.out_size(CH, W, len(later)))
        stats, S, brows = wx.run_wave(self.G, self.T.view(-1, self.Wp),
                                      pack_t.view(CH, wx.NPACK), W, go, ge,
                                      out_t)
        secs = 0.0
        up = pack_t.numel() * 4
        down = out_t.numel() * 4
        STATS["waves"] += 1
        STATS["rows"] += CH
        STATS["cells"] += CH * W
        Smax = stats[:, wx.ST_SMAX].copy()
        mp = stats[:, wx.ST_MP].astype(np.int64)
        col_min = stats[:, wx.ST_COLMIN].copy()
        blo = stats[:, wx.ST_LO]
        bhi = stats[:, wx.ST_HI]
        has_ext0 = in_seed_c | (stats[:, wx.ST_HASEXT] != 0)
        keep0 = in_seed_c | ((Smax >= ccut) & has_ext0)
        kept = np.zeros(CH, dtype=bool)    # rows that stay in the store
        fixes = []                         # re-masked kept rows: (row, S, E)

        # candidate collection inputs, from align_wave for ALL children
        kws_all = self.wsizev[ch_jid]
        sc_mp_all = stats[:, wx.ST_SCMP].astype(np.int64)
        p_mp_all = stats[:, wx.ST_PMP].copy()
        s_lp_all = stats[:, wx.ST_SLP].copy()
        p_lp_all = stats[:, wx.ST_PLP]
        winc_mp_all = self.winb[ch_jid, np.maximum(mp - 1, 0)]

        single = grp_size == 1
        si = np.flatnonzero(single)
        mi = np.flatnonzero(~single)

        # conv-filter entries staged per wave: (wave row, job, node, tidx,
        # off_diag); singles append their arrays, multis append in loop order
        conv_parts = []

        # ---- vectorized single-child (chain) pops: each job contributes at
        # most one child this wave, so per-job scalar updates are disjoint
        # fancy-index writes (extender.py:269-331 semantics, no siblings)
        if len(si):
            jid_s = ch_jid[si]
            # min cell score tracks every computed child (kept or not)
            cm = col_min[si]
            mold = self.mcs[jid_s]
            self.mcs[jid_s] = np.where((cm != _POS) & (cm < mold), cm, mold)

            ki = si[keep0[si]]
            if len(ki):
                kjid = ch_jid[ki]
                smax_k = Smax[ki]
                tidx_k = self.TL[kjid].copy()
                rows = orow[ki]
                kept[ki] = True
                self.g_node[rows] = ch_nodes[ki]
                self.g_parent[rows] = ptidx[ch_rows[ki]]
                self.g_c[rows] = ch_chars[ki]
                self.g_off[rows] = ch_off[ki]
                self.g_maxpos[rows] = mp[ki]
                self.g_score[rows] = ch_score[ki]
                self.TL[kjid] += 1
                # x-drop cutoff / best raises (int64: Smax may be NINF for
                # in-seed children; int32 subtraction would wrap)
                cand_cut = smax_k.astype(np.int64) - self.xdrop_v[kjid]
                self.cutoff[kjid] = np.maximum(
                    self.cutoff[kjid].astype(np.int64),
                    cand_cut).astype(np.int32)
                self.best[kjid] = np.maximum(self.best[kjid], smax_k)
                for j_, g_, cm_ in zip(kjid.tolist(), rows.tolist(),
                                       smax_k.tolist()):
                    jb = jobs[j_]
                    jb.gcols.append(g_)
                    jb.col_max.append(cm_)

                # backtrack candidate cells (extender.py:445-478
                # check_and_add), all conditions as array ops
                off_k = ch_off[ki]
                elig = off_k >= self.sdist_v[kjid]
                if elig.any():
                    mpos = mp[ki]
                    kws = kws_all[ki]
                    s_sp = smax_k.astype(np.int64)
                    s_lp = s_lp_all[ki].astype(np.int64)
                    p_mp = p_mp_all[ki].astype(np.int64)
                    p_lp = p_lp_all[ki].astype(np.int64)
                    reb = self.reb_v[kjid]
                    msc = self.msc_v[kjid]
                    at_end = mpos == kws
                    bonus = np.where(at_end, reb, 0)
                    sc1 = s_sp + bonus
                    c1 = elig & (mpos >= 1) & (s_sp != NINF) \
                        & (p_mp != NINF) & (sc1 >= msc)
                    is_m = (s_sp == p_mp + ch_score[ki] + sc_mp_all[ki]) \
                        & (winc_mp_all[ki] == ch_chars[ki])
                    tipf = ~(is_m | at_end)
                    sc2 = s_lp + reb
                    c2 = elig & ~at_end & (kws >= 1) & (s_lp != NINF) \
                        & (p_lp != NINF) & (sc2 >= msc)
                    offd1 = np.abs(mpos - diag[ki])
                    i1 = np.flatnonzero(c1)
                    for j_, t_, s_, o_, p_, f_ in zip(
                            kjid[i1].tolist(), tidx_k[i1].tolist(),
                            sc1[i1].tolist(), offd1[i1].tolist(),
                            mpos[i1].tolist(), tipf[i1].tolist()):
                        jobs[j_].cand.append((t_, s_, o_, p_, f_))
                    i2 = np.flatnonzero(c2)
                    if len(i2):
                        offd2 = np.abs(kws - diag[ki])
                        for j_, t_, s_, o_, p_ in zip(
                                kjid[i2].tolist(), tidx_k[i2].tolist(),
                                sc2[i2].tolist(), offd2[i2].tolist(),
                                kws[i2].tolist()):
                            jobs[j_].cand.append((t_, s_, o_, p_, False))

                # convergence filter (extender.py:130-165), batched below
                cf = self.wsizev[kjid] > 0
                if cf.any():
                    cfi = np.flatnonzero(cf)
                    conv_parts.append((ki[cfi], kjid[cfi],
                                       ch_nodes[ki][cfi], tidx_k[cfi],
                                       np.abs(mp[ki] - diag[ki])[cfi]))

        # ---- per-child sequential bookkeeping for branch pops (2+
        # siblings), exactly in sibling order (extender.py:269-331): the
        # x-drop cutoff and best score can rise between siblings.
        # Convergence-filter updates are deferred and batched after the
        # loop: every (job, node) key in one wave is distinct (children of
        # one pop are distinct edges), and queue pushes can't interleave
        # with pops inside a wave, so deferral preserves sequential order.
        m_conv = []
        for i in mi.tolist():
            j = int(ch_jid[i])
            job = jobs[j]
            first_sib = grp_first[i] == i
            if not first_sib:
                # later sibling: the cutoff may have risen since the wave
                # was computed — re-mask (masking is monotone in the cutoff,
                # so re-masking the pre-masked column is exact)
                cut_now = int(self.cutoff[j])
                if cut_now > int(ccut[i]):
                    Si = np.where(S[i] < cut_now, NINF, S[i])
                    in_band = (jj >= blo[i]) & (jj <= bhi[i])
                    Ei, Spar = brows[slot[i]]
                    Ei = np.where(in_band | (Si != NINF), Ei, NINF)
                    S[i] = Si
                    fixes.append((i, Si, Ei))
                    Smax_i = int(Si.max())
                    Smax[i] = Smax_i
                    dist_i = np.abs(jj32 - diag[i])
                    wl = int(self.WSv[j])
                    if wl < W:
                        dist_i = np.where(jj >= wl, _POS, dist_i)
                    mp[i] = int(np.argmin(
                        np.where(Si == Smax_i, dist_i, _POS)))
                    col_min[i] = _POS if Smax_i == NINF \
                        else np.where(Si == NINF, _POS, Si).min()
                    # refresh candidate inputs that read S / the max pos
                    s_lp_all[i] = Si[kws_all[i]]
                    p_mp_all[i] = Spar[max(int(mp[i]) - 1, 0)]
                    sc_mp_all[i] = int(P2[prof_rows[i], mp[i]])
                    winc_mp_all[i] = self.winb[j, max(int(mp[i]) - 1, 0)]
                # recompute keep with the running best/cutoff
                cut_i = int(self.cutoff[j])
                if in_seed_c[i]:
                    keep_i = True
                else:
                    ecut = self.best[j] * self.rcut_v[j] + self.pso_v[j]
                    has_ext = ((S[i] + self.pss[j]) >= ecut).any()
                    keep_i = (Smax[i] >= cut_i) and has_ext
            else:
                keep_i = bool(keep0[i])

            # min cell score tracks every computed child (kept or not)
            if col_min[i] != _POS and col_min[i] < self.mcs[j]:
                self.mcs[j] = col_min[i]

            if not keep_i:
                continue

            tidx = int(self.TL[j])
            g = int(orow[i])
            kept[i] = True
            self.g_node[g] = ch_nodes[i]
            self.g_parent[g] = ptidx[ch_rows[i]]
            self.g_c[g] = ch_chars[i]
            self.g_off[g] = ch_off[i]
            self.g_maxpos[g] = mp[i]
            self.g_score[g] = ch_score[i]
            job.gcols.append(g)
            job.col_max.append(int(Smax[i]))
            self.TL[j] += 1
            max_val = int(Smax[i])
            if max_val - self.xdrop_v[j] > self.cutoff[j]:
                self.cutoff[j] = max_val - self.xdrop_v[j]
            if max_val > self.best[j]:
                self.best[j] = max_val

            # backtrack candidate cells (extender.py:445-478 check_and_add)
            self._collect_candidates(
                j, job, tidx, int(ch_off[i]), int(mp[i]),
                int(kws_all[i]), int(Smax[i]), int(s_lp_all[i]),
                int(p_mp_all[i]), int(p_lp_all[i]), int(sc_mp_all[i]),
                int(winc_mp_all[i]), int(ch_chars[i]), int(ch_score[i]),
                int(diag[i]))

            # convergence filter (extender.py:130-165), batched below
            if self.wsizev[j] == 0:
                continue
            m_conv.append((i, j, int(ch_nodes[i]), tidx,
                           abs(int(mp[i]) - int(diag[i]))))

        # the store keeps the rows of kept children, the re-masked ones as
        # re-masked (one copy); the others go back to the free list
        fixes = [f for f in fixes if kept[f[0]]]
        if fixes:
            t0 = time.perf_counter()
            n = len(fixes)
            buf = self._host("fix", n * (2 * W + 1))
            a = buf.numpy()
            rows_f = a[: 2 * n * W].reshape(n, 2, W)
            for t, (i, Si, Ei) in enumerate(fixes):
                rows_f[t, 0], rows_f[t, 1] = Si, Ei
            a[2 * n * W:] = orow[[f[0] for f in fixes]]
            d = buf.to(self.device, non_blocking=True)
            idx = d[2 * n * W:].long()
            cur = wx.take_rows(self.G, idx)
            cur[:, :2, :W] = d[: 2 * n * W].view(n, 2, W)
            wx.put_rows(self.G, idx, cur)
            secs += time.perf_counter() - t0
            up += buf.numel() * 4
        self.free.extend(orow[~kept].tolist())
        if ch_lab is not None:
            li = np.flatnonzero(kept & self.lab_v[ch_jid])
            self.g_lab[orow[li]] = ch_lab[li]
        STATS["seconds"] += secs
        STATS["bytes_up"] += up
        STATS["bytes_down"] += down
        if wx.WAVE_LOG is not None:
            wx.WAVE_LOG.append((CH, self.flush_bytes + up, down))

        if m_conv:
            arr = np.array(m_conv, dtype=np.int64)
            conv_parts.append((arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3],
                               arr[:, 4]))
        if conv_parts:
            if len(conv_parts) == 1:
                ci, cj, cnode, ctidx, coffd = conv_parts[0]
            else:
                ci, cj, cnode, ctidx, coffd = (
                    np.concatenate([p[t] for p in conv_parts])
                    for t in range(5))
            self._conv_flush(ci, cj, cnode, ctidx, coffd, S)

    def _prune_labels(self, pj, ptidx, g_cur, ch_rows, ch_nodes):
        """The label pruning of a wave's children (metagraph_tpu/align/
        labeled.py:93-113, ``LabeledExtender.call_outgoing``): a labeled
        job's child keeps its parent's label words ANDed with its node's,
        or its parent's where the node is 0 (a dummy), and is dropped when
        none is left; a parent that loses every child is a tip.  ->
        (children kept, (CH, n_words) label words, 0 where unlabeled)."""
        lab = self.lab_v[pj[ch_rows]]
        li = np.flatnonzero(lab)
        words = np.zeros((len(ch_rows), self.g_lab.shape[1]),
                         dtype=np.uint64)
        nodes = ch_nodes[li]
        nw = self.labels.node_words(nodes)
        nw[nodes == 0] = ~np.uint64(0)
        words[li] = self.g_lab[g_cur[ch_rows[li]]] & nw
        alive = ~lab | words.any(axis=1)
        wx.STATS["pruned"] += int(len(alive) - alive.sum())
        if not alive.all():
            lost = np.setdiff1d(ch_rows, ch_rows[alive])
            for r in lost.tolist():
                self.jobs[int(pj[r])].tips.append(int(ptidx[r]))
        return alive, words

    def _conv_flush(self, ci, cj, cnode, ctidx, coffd, S):
        """Batched update_seed_filter over this wave's kept children, then
        the deferred queue pushes in child order."""
        jobs = self.jobs
        n = len(ci)
        ret = np.full(n, NINF, dtype=np.int64)
        rows = np.empty(n, dtype=np.int64)
        kind = np.zeros(n, dtype=np.int8)      # 0 new, 1 existing, 2 dummy
        cjl = cj.tolist()
        cnl = cnode.tolist()
        for t in range(n):
            node = cnl[t]
            if node == 0:
                kind[t] = 2
                continue
            r = jobs[cjl[t]].conv_rows.get(node)
            if r is not None:
                kind[t] = 1
                rows[t] = r
        newi = np.flatnonzero(kind == 0)
        if len(newi):
            nr = self._conv_alloc(len(newi))
            rows[newi] = nr
            for t, r in zip(newi.tolist(), nr.tolist()):
                jobs[cjl[t]].conv_rows[cnl[t]] = r
        CONV = self.CONV
        scores = S[ci, 1:]
        if len(newi):
            CONV[rows[newi]] = scores[newi]
            ret[newi] = scores[newi].max(axis=1)
        dumi = np.flatnonzero(kind == 2)
        if len(dumi):
            ret[dumi] = scores[dumi].max(axis=1)
        oldi = np.flatnonzero(kind == 1)
        if len(oldi):
            orow = rows[oldi]
            seg = CONV[orow]
            sc = scores[oldi]
            rc = self.rcut_v[cj[oldi]]
            improved = sc > seg * rc[:, None]
            upd = np.where(improved, np.maximum(seg, sc), seg)
            CONV[orow] = upd
            chg = np.where(improved, upd, NINF).max(axis=1)
            ret[oldi] = np.where(improved.any(axis=1), chg, NINF)
        rl = ret.tolist()
        ctl = ctidx.tolist()
        col_ = coffd.tolist()
        for t in range(n):
            if rl[t] != NINF:
                jobs[cjl[t]].push_child(rl[t], col_[t], ctl[t])

    def _collect_candidates(self, j, job, tidx, off, mpos, kws, s_sp,
                            s_lp, p_mp, p_lp, sc_mp, winc_mp, ch, score,
                            diag_i):
        if off < self.sdist_v[j]:
            return
        reb = int(self.reb_v[j])
        msc = int(self.msc_v[j])
        # candidate at the column max
        if mpos >= 1 and s_sp != NINF and p_mp != NINF:
            bonus = reb if mpos == kws else 0
            if s_sp + bonus >= msc:
                is_m = (s_sp == p_mp + score + sc_mp) and winc_mp == ch
                if is_m or mpos == kws:
                    job.cand.append((tidx, s_sp + bonus,
                                     abs(mpos - diag_i), mpos, False))
                else:
                    job.cand.append((tidx, s_sp + bonus,
                                     abs(mpos - diag_i), mpos, True))
        # candidate at the window end (start_pos == last_pos accepts
        # unconditionally once it clears the threshold)
        if mpos != kws and kws >= 1 and s_lp != NINF and p_lp != NINF \
                and s_lp + reb >= msc:
            job.cand.append((tidx, s_lp + reb, abs(kws - diag_i), kws,
                             False))

    # ------------------------------------------------------------- finalize
    def finalize(self, j: int) -> List[Alignment]:
        """Backtrack a finished job slot, after ``fetch_tables`` of its
        step; returns its extensions."""
        job = self.jobs[j]
        ext = job.ext
        ext.min_cell_score = int(self.mcs[j])
        # persist the convergence filter for check_seed across seeds: one
        # fancy-index gather per job, then per-node views into the block
        startj = job.start
        WSj = job.WS
        if job.conv_rows:
            items = list(job.conv_rows.items())
            block = self.CONV[np.fromiter(
                (r for _, r in items), dtype=np.int64,
                count=len(items)), : WSj - 1]
            cc = ext.conv_checker
            for t, (node, _row) in enumerate(items):
                cc[node] = (startj, block[t])
        if ext.config.no_backtrack:
            self._release(job)
            return [job.seed]
        if job.cand:
            if job.rows is None:
                raise RuntimeError("finalize: fetch_tables first")
            ext.table = _materialize_table(self, job.gcols, WSj, job.rows)
        # resolve tip-gated candidates and order exactly like the
        # reference's indices.sort(reverse=True) on
        # (score, -off_diag, -idx, pos)
        indices = []
        if job.cand:
            arr = np.array(job.cand, dtype=np.int64)
            tidx, score, offd, pos, tipf = (arr[:, 0], arr[:, 1], arr[:, 2],
                                            arr[:, 3], arr[:, 4] != 0)
            if tipf.any():
                istip = np.isin(tidx, np.array(job.tips, dtype=np.int64))
                keep = ~tipf | istip
                tidx, score, offd, pos = (tidx[keep], score[keep],
                                          offd[keep], pos[keep])
            order = np.lexsort((-pos, tidx, offd, -score))
            indices = list(zip(score[order].tolist(),
                               (-offd[order]).tolist(),
                               (-tidx[order]).tolist(),
                               pos[order].tolist()))
        exts = ext._backtrack_consume(indices, job.min_path_score,
                                      job.window, startj, job.seed_offset)
        for e in exts:
            e.trim_offset()
        self._release(job)
        return exts

    def _release(self, job):
        """Recycle the job's store rows (its table adapter is dead after
        finalize — alignments hold no references into the store)."""
        job.ext.table = None
        self.free.extend(job.gcols)
        job.gcols = []
        job.rows = None
