"""The BOSS table, read from and written to the JAX package's ``.dbg.npz``
artifact or its mmap layout.

Own numpy copy of the part of metagraph_tpu/succinct/boss.py the port
uses: the table of a ``BossArrays`` with its ``state`` tag and
``count_width`` (boss.py:36-53), writing (``save``, ``save_mmap``,
:622-657: the same npz keys and dtypes, the suffix-range index's among
them), loading (:660-700: the npz, or the mmap layout's ``.meta.npz``
beside raw ``.W/.last/.valid/.weights.npy`` arrays, mapped read-only with
``mmap``), the suffix-range index (``tighten_range``, ``initial_range``,
``index_suffix_ranges``, :319-372) and the navigation needed to decode
edge k-mers (``rank_last``, ``select_last``, ``rank_W``, ``select_W``,
``node_last_char``, ``bwd``, ``get_node_seq``, ``get_edge_seq``;
boss.py:113-300, 593-610) and the walks and mapping the aligner needs
(boss.py:113-600: ``succ_last``, ``pred_last``, ``fwd``, ``pick_edge``,
their scalar forms, ``_next_W``/``_prev_W``, ``bwd_scalar``,
``index_batch``, ``index_range_batch``, ``index_range_host``,
``map_to_edges_batch``, ``map_sequence``).  Rank and select are plain
prefix counts and position lists instead of the JAX package's succinct
directories, and the JAX package's native lookups are left out; the
answers are the same.

Conventions: row 0 is the sentinel row and edge indices are 1-based; a W
value ``c + alph_size`` marks a non-first incoming edge.
"""

from __future__ import annotations

import os

import numpy as np


class _BitIndex:
    """rank/select over one boolean array (positions are 0-based)."""

    def __init__(self, bits: np.ndarray):
        self._cum = np.cumsum(bits, dtype=np.int64)
        self._pos = np.flatnonzero(bits).astype(np.int64)

    @property
    def total(self) -> int:
        return len(self._pos)

    def rank(self, i):
        """#set bits in [0..i] inclusive; i < 0 -> 0."""
        i = np.asarray(i, dtype=np.int64)
        if not len(self._cum):
            return np.zeros(i.shape, dtype=np.int64)
        r = self._cum[np.clip(i, 0, len(self._cum) - 1)]
        return np.where(i < 0, 0, r)

    def select(self, r):
        """Position of the r-th set bit (r >= 1); out-of-range ranks clamp."""
        r = np.asarray(r, dtype=np.int64)
        if not self.total:
            return np.full(r.shape, len(self._cum), dtype=np.int64)
        return self._pos[np.clip(r, 1, self.total) - 1]

    def rank_scalar(self, i: int) -> int:
        if i < 0 or not len(self._cum):
            return 0
        return int(self._cum[min(i, len(self._cum) - 1)])

    def select_scalar(self, r: int) -> int:
        if not self.total:
            return len(self._cum)
        return int(self._pos[min(max(r, 1), self.total) - 1])

    def succ_scalar(self, i: int) -> int:
        """First set position >= i, or -1."""
        t = int(np.searchsorted(self._pos, i, side="left"))
        return int(self._pos[t]) if t < self.total else -1

    def pred_scalar(self, i: int) -> int:
        """Last set position <= i, or -1."""
        t = int(np.searchsorted(self._pos, i, side="right")) - 1
        return int(self._pos[t]) if t >= 0 else -1


class BOSS:
    def __init__(self, k: int, alph_size: int, W: np.ndarray,
                 last: np.ndarray, F: np.ndarray, valid: np.ndarray,
                 weights: np.ndarray | None = None):
        self.k = k                         # node length; edges are (k+1)-mers
        self.alph_size = alph_size
        self.W = np.asarray(W, dtype=np.uint8)
        self.last = np.asarray(last, dtype=np.uint8)
        self.F = np.asarray(F, dtype=np.int64)
        self.valid = np.asarray(valid, dtype=np.uint8)
        self.weights = weights             # k-mer counts by edge, or None
        # the representation tag ('fast' selects the mmap layout) and the
        # bits a stored count takes, both kept in the artifact
        self.state = "stat"
        self.count_width = 8
        # the suffix-range index: empty until index_suffix_ranges(L)
        self.suffix_L = 0
        self.suf_rl = self.suf_ru = self.suf_ok = None
        self._index()

    def _index(self):
        self._last = _BitIndex(self.last == 1)
        # one index a W value; the minus-flagged values (c + alph_size)
        # are indexed at their first use
        self._W = [_BitIndex(self.W == c) for c in range(self.alph_size)]
        self._W_minus: dict = {}
        self.NF = self._last.rank(self.F)            # rank_last(F[c])

    def __getstate__(self):
        """The table without its indexes (rebuilt on unpickling: a worker
        of ``align -p`` receives the arrays alone)."""
        state = self.__dict__.copy()
        for key in ("_last", "_W", "_W_minus", "NF"):
            state.pop(key)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._index()

    @classmethod
    def from_arrays(cls, arrays) -> "BOSS":
        """The table of a ``construct.BossArrays``."""
        return cls(arrays.k, arrays.alph_size, arrays.W, arrays.last,
                   arrays.F, arrays.valid, arrays.weights)

    def _save_tags(self, extra: dict):
        """The artifact's tags, and its suffix-range index where it has
        one."""
        extra.setdefault("state", self.state)
        extra.setdefault("count_width", self.count_width)
        if self.suffix_L:
            extra.setdefault("suffix_L", self.suffix_L)
            extra.setdefault("suf_rl", self.suf_rl)
            extra.setdefault("suf_ru", self.suf_ru)
            extra.setdefault("suf_ok", self.suf_ok)
        return extra

    def save(self, path: str, **extra):
        """The npz artifact, compressed (boss.py:622-635)."""
        self._save_tags(extra)
        np.savez_compressed(
            path, k=self.k, alph_size=self.alph_size, W=self.W,
            last=self.last, F=self.F, valid=self.valid,
            weights=self.weights if self.weights is not None
            else np.zeros(0), **extra)

    def save_mmap(self, path: str, **extra):
        """The mmap layout: a raw ``.npy`` an array beside a small
        ``.meta.npz`` (boss.py:637-657)."""
        base = path[:-4] if path.endswith(".npz") else path
        for name in ("W", "last", "valid"):
            np.save(base + f".{name}.npy", getattr(self, name))
        if self.weights is not None:
            np.save(base + ".weights.npy", self.weights)
        self._save_tags(extra)
        np.savez(base + ".meta.npz", k=self.k, alph_size=self.alph_size,
                 F=self.F, **extra)

    @classmethod
    def load(cls, path: str, mmap: bool = False) -> "BOSS":
        """``path`` is the ``.dbg.npz``, or its name without ``.npz``; the
        mmap layout is read where its ``.meta.npz`` exists and ``mmap`` is
        asked for or no npz is there."""
        base = path[:-4] if path.endswith(".npz") else path
        if os.path.exists(base + ".meta.npz") and (
                mmap or not os.path.exists(base + ".npz")
                and not os.path.exists(path)):
            mode = "r" if mmap else None
            wpath = base + ".weights.npy"
            with np.load(base + ".meta.npz") as meta:
                boss = cls(int(meta["k"]), int(meta["alph_size"]),
                           np.load(base + ".W.npy", mmap_mode=mode),
                           np.load(base + ".last.npy", mmap_mode=mode),
                           meta["F"],
                           np.load(base + ".valid.npy", mmap_mode=mode),
                           np.load(wpath, mmap_mode=mode)
                           if os.path.exists(wpath) else None)
                boss._tags(meta, "fast")
                return boss
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            w = z["weights"] if "weights" in z.files else np.zeros(0)
            boss = cls(int(z["k"]), int(z["alph_size"]), z["W"], z["last"],
                       z["F"], z["valid"], w if len(w) else None)
            boss._tags(z, "stat")
            return boss

    def _tags(self, z, state: str):
        """``state``, ``count_width`` and the suffix-range index as the
        artifact records them (boss.py:677-700); an older one without a
        state tag reads as ``state``."""
        self.state = str(z["state"]) if "state" in z.files else state
        if "count_width" in z.files:
            self.count_width = int(z["count_width"])
        if "suffix_L" in z.files and int(z["suffix_L"]):
            self.suffix_L = int(z["suffix_L"])
            self.suf_rl = z["suf_rl"].astype(np.int64)
            self.suf_ru = z["suf_ru"].astype(np.int64)
            self.suf_ok = z["suf_ok"].astype(np.uint8)

    def _plane(self, c: int) -> _BitIndex:
        """The index of W value c, 0 <= c < 2 alph_size; a negative c
        counts from the end, as the JAX package's list of planes does (the
        node_last_char -1 of row 0)."""
        if c < 0:
            c += 2 * self.alph_size
        if c < self.alph_size:
            return self._W[c]
        p = self._W_minus.get(c)
        if p is None:
            p = self._W_minus[c] = _BitIndex(self.W == c)
        return p

    @property
    def num_valid(self) -> int:
        return int(np.count_nonzero(self.valid))

    @property
    def num_edges(self) -> int:
        return len(self.W) - 1

    def rank_last(self, i):
        """#set bits in last[1..i]."""
        return self._last.rank(i)

    def select_last(self, r):
        """Position of the r-th set bit of last; select_last(0) = 0."""
        r = np.asarray(r, dtype=np.int64)
        return np.where(r > 0, self._last.select(r), 0)

    def rank_W(self, i, c):
        """#occurrences of value c (< 2 alph_size) in W[1..i] (vectorised
        over mixed c; the sentinel W[0] = 0 is not counted)."""
        i, c = np.broadcast_arrays(np.asarray(i, dtype=np.int64),
                                   np.asarray(c, dtype=np.int64))
        out = np.zeros(i.shape, dtype=np.int64)
        for sym in np.unique(c):
            m = c == sym
            out[m] = self._plane(int(sym)).rank(i[m])
        return out - (c == 0)

    # -------------------------------------------------- suffix-range index

    def tighten_range(self, rl, ru, s, alive):
        """One step of the range-tightening node search (boss.py:319-329):
        the edge range [rl, ru] of the nodes ending in a string x -> that
        of the nodes ending in x + s, where ``alive``."""
        rk_rl = self.rank_W(np.maximum(rl - 1, 0), s) + 1
        rk_ru = self.rank_W(ru, s)
        ok = alive & (rk_rl <= rk_ru)
        nf = self.NF[s]
        rl = np.where(ok, self.select_last(nf + rk_rl - 1) + 1, rl)
        ru = np.where(ok, self.select_last(nf + rk_ru), ru)
        return rl, ru, ok

    def initial_range(self, s):
        """The F-based range of the nodes ending in character s
        (boss.py:331-338)."""
        M = len(self.W)
        s = np.asarray(s, dtype=np.int64)
        rl = np.where(self.F[s] + 1 < M, self.F[s] + 1, M)
        ru = np.concatenate([self.F, [M - 1]])[s + 1]
        return rl, ru

    def index_suffix_ranges(self, L: int):
        """The node ranges of all (alph_size-1)^L sentinel-free strings of
        length L (boss.py:340-372): L rounds of tightening over the cross
        product; combo id = sum_t (c_t - 1) * (A-1)^t, position 0 the least
        significant digit.  Dead combos get the empty range [1, 0]."""
        A = self.alph_size
        if L <= 0:
            self.suffix_L = 0
            self.suf_rl = self.suf_ru = self.suf_ok = None
            return
        assert L < self.k, (L, self.k)
        chars = np.arange(1, A, dtype=np.int64)
        rl, ru = self.initial_range(chars)
        alive = rl <= ru
        for _ in range(1, L):
            n = len(rl)
            rl, ru, alive = self.tighten_range(
                np.tile(rl, A - 1), np.tile(ru, A - 1), np.repeat(chars, n),
                np.tile(alive, A - 1))
        self.suffix_L = int(L)
        self.suf_rl = np.where(alive, rl, 1).astype(np.int64)
        self.suf_ru = np.where(alive, ru, 0).astype(np.int64)
        self.suf_ok = alive.astype(np.uint8)

    def select_W(self, c, r):
        """Position of the r-th occurrence of value c in W[1..] (vectorised
        over mixed c < 2 alph_size; c = 0 skips the sentinel W[0])."""
        c, r = np.broadcast_arrays(np.asarray(c, dtype=np.int64),
                                   np.asarray(r, dtype=np.int64))
        out = np.zeros(c.shape, dtype=np.int64)
        for sym in np.unique(c):
            m = c == sym
            out[m] = self._plane(int(sym)).select(r[m] + (sym == 0))
        return out

    def node_last_char(self, i):
        """Last character of the source node of edge(s) i (F scan)."""
        idx = np.searchsorted(self.F, np.asarray(i, dtype=np.int64),
                              side="left")
        return np.where(idx < self.alph_size, idx - 1, self.alph_size - 1)

    def bwd(self, i):
        """Last incoming edge of the source node of edge(s) i."""
        i = np.asarray(i, dtype=np.int64)
        target = self.rank_last(i - 1) + 1
        c = self.node_last_char(i)
        res = self.select_W(c, target - self.NF[c])
        return np.where(target == 1, 1, res)

    def get_node_seq(self, i) -> np.ndarray:
        """(Q, k) source-node code strings of edge(s) i.  Where Q passes a
        quarter of the table (``convert.from_graph`` decodes every valid
        edge) each step is a gather from ``bwd`` and ``node_last_char`` of
        every row, computed once, instead of computing both anew for Q
        rows k times."""
        cur = np.atleast_1d(np.asarray(i, dtype=np.int64))
        out = np.zeros((len(cur), self.k), dtype=np.uint8)
        step, last_char = self.bwd, self.node_last_char
        if len(cur) * 4 > len(self.W) and self.k > 2:
            rows = np.arange(len(self.W), dtype=np.int64)
            bwd_all = self.bwd(rows)
            nlc_all = self.node_last_char(rows).astype(np.uint8)
            del rows

            def step(c):
                return bwd_all[c]

            def last_char(c):
                return nlc_all[c]
        for pos in range(self.k - 1, -1, -1):
            out[:, pos] = last_char(cur)
            if pos:
                cur = step(cur)
        return out

    def get_edge_seq(self, i) -> np.ndarray:
        """(Q, k+1) edge strings: source node + label (minus flag dropped)."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        lab = (self.W[i] % self.alph_size).astype(np.uint8)[:, None]
        return np.concatenate([self.get_node_seq(i), lab], axis=1)

    # ------------------------------------------------- walks (boss.py:113-300)

    def succ_last(self, i):
        """Position of the first set bit of last in [i..] (the node's last
        edge)."""
        i = np.asarray(i, dtype=np.int64)
        return self.select_last(self.rank_last(np.maximum(i, 1) - 1) + 1)

    def pred_last(self, i):
        return self.select_last(self.rank_last(np.asarray(i, dtype=np.int64)))

    def fwd(self, i, c=None):
        """The target node's last edge for edge(s) i; c, where given, is
        W[i] % alph_size."""
        i = np.asarray(i, dtype=np.int64)
        cc = self.W[i].astype(np.int64) % self.alph_size if c is None \
            else np.asarray(c, dtype=np.int64)
        return self.select_last(self.NF[cc] + self.rank_W(i, cc))

    def _next_W(self, i: int, c: int) -> int:
        """First position >= i with W value c, or 0."""
        return max(self._plane(c).succ_scalar(i), 0)

    def _prev_W(self, i: int, c: int) -> int:
        """Last position <= i with W value c, or 0."""
        return max(self._plane(c).pred_scalar(i), 0)

    def rank_W_scalar(self, i: int, c: int) -> int:
        return self._plane(c).rank_scalar(i) - (1 if c == 0 else 0)

    def select_W_scalar(self, c: int, r: int) -> int:
        return self._plane(c).select_scalar(r + (1 if c == 0 else 0))

    def select_last_scalar(self, r: int) -> int:
        return self._last.select_scalar(r) if r > 0 else 0

    def rank_last_scalar(self, i: int) -> int:
        return self._last.rank_scalar(i)

    def succ_last_scalar(self, i: int) -> int:
        return self.select_last_scalar(
            self._last.rank_scalar(max(i, 1) - 1) + 1)

    def pred_last_scalar(self, i: int) -> int:
        return self.select_last_scalar(self._last.rank_scalar(i))

    def fwd_scalar(self, i: int, c: int | None = None) -> int:
        if c is None:
            c = int(self.W[i]) % self.alph_size
        return self.select_last_scalar(
            int(self.NF[c]) + self.rank_W_scalar(i, c))

    def node_last_char_scalar(self, i: int) -> int:
        idx = int(np.searchsorted(self.F, i, side="left"))
        return idx - 1 if idx < self.alph_size else self.alph_size - 1

    def bwd_scalar(self, i: int) -> int:
        target = self._last.rank_scalar(i - 1) + 1
        if target == 1:
            return 1
        c = self.node_last_char_scalar(i)
        return self.select_W_scalar(c, target - int(self.NF[c]))

    def pick_edge_scalar(self, edge: int, c: int) -> int:
        """The edge labelled c out of the node ending at ``edge``, or 0."""
        begin = self.pred_last_scalar(max(edge - 1, 0)) + 1
        for cand in (c, c + self.alph_size):
            lo = self.rank_W_scalar(max(begin - 1, 0), cand)
            if self.rank_W_scalar(edge, cand) > lo:
                return self.select_W_scalar(cand, lo + 1)
        return 0

    def pick_edge(self, edge, c):
        """The edge labelled c out of the node whose last edge is ``edge``,
        or 0 (vectorised)."""
        edge = np.asarray(edge, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        begin = self.pred_last(np.maximum(edge - 1, 0)) + 1
        res = np.zeros(edge.shape, dtype=np.int64)
        for base in (0, self.alph_size):
            cand = c + base
            lo = self.rank_W(np.maximum(begin - 1, 0), cand)
            found = self.rank_W(edge, cand) > lo
            pos = self.select_W(cand, lo + 1)
            res = np.where(found & (res == 0), pos, res)
        return res

    # ------------------------------------------ node lookup (boss.py:374-600)

    def _suffix_combo(self, codes2d: np.ndarray):
        """(Q, >= L) codes -> (combo id, sentinel-free mask) for the
        suffix-range tables."""
        L, A = self.suffix_L, self.alph_size
        c = codes2d[:, :L].astype(np.int64)
        nosent = np.all((c >= 1) & (c < A), axis=1)
        cc = np.clip(c - 1, 0, A - 2)
        idx = np.zeros(len(c), dtype=np.int64)
        for t in range(L):
            idx += cc[:, t] * (A - 1) ** t
        return idx, nosent

    def index_batch(self, nodes: np.ndarray) -> np.ndarray:
        """(Q, k) node code rows -> the node's last edge, or 0: the k - 1
        tightening steps in lockstep over the batch, from L levels deep
        where the suffix-range index holds the row's first L codes."""
        Q, k = nodes.shape
        assert k == self.k
        alive = np.all(nodes < self.alph_size, axis=1)
        L = self.suffix_L
        s0 = np.where(alive, nodes[:, 0].astype(np.int64), 0)
        rl, ru = self.initial_range(s0)
        off = np.ones(Q, dtype=np.int64)
        if L and k > L:
            idx, nosent = self._suffix_combo(nodes)
            use = alive & nosent
            rl = np.where(use, self.suf_rl[idx], rl)
            ru = np.where(use, self.suf_ru[idx], ru)
            off = np.where(use, L, 1)
        alive = alive & (rl <= ru)
        for pos in range(1, k):
            act = alive & (pos >= off)
            if not act.any():
                continue
            s = np.where(act, nodes[:, pos].astype(np.int64), 0)
            nrl, nru, ok = self.tighten_range(rl, ru, s, act)
            rl = np.where(act, nrl, rl)
            ru = np.where(act, nru, ru)
            alive = alive & (ok | ~act)
        return np.where(alive, ru, 0)

    def index_range_batch(self, codes: np.ndarray, starts: np.ndarray,
                          lens: np.ndarray):
        """Longest-prefix node-range match of each window
        ``codes[starts[i]: starts[i] + lens[i]]``, in lockstep; a window
        with an invalid code matches nothing.  -> (first, last, matched),
        (0, 0, 0) where nothing matched."""
        codes = np.asarray(codes, dtype=np.int64)
        starts = np.asarray(starts, dtype=np.int64)
        lens = np.asarray(lens, dtype=np.int64)
        n = len(starts)
        if not n:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        bad = np.concatenate([[0], np.cumsum(codes >= self.alph_size)])
        ends = np.minimum(starts + lens, len(codes))
        valid0 = (lens > 0) & (bad[ends] - bad[starts] == 0)
        s0 = np.where(valid0, codes[np.minimum(starts, len(codes) - 1)], 0)
        rl, ru = self.initial_range(s0)
        alive = valid0 & (rl <= ru)
        matched = alive.astype(np.int64)
        off = np.ones(n, dtype=np.int64)
        L = self.suffix_L
        if L:
            # an empty indexed range restarts from the F-based one, so
            # shorter prefixes still match
            gidx = np.minimum(starts[:, None]
                              + np.arange(L, dtype=np.int64)[None, :],
                              len(codes) - 1)
            idx, nosent = self._suffix_combo(codes[gidx])
            use = valid0 & (lens >= L) & nosent \
                & (self.suf_ok[idx].astype(bool))
            rl = np.where(use, self.suf_rl[idx], rl)
            ru = np.where(use, self.suf_ru[idx], ru)
            alive = np.where(use, True, alive)
            matched = np.where(use, L, matched)
            off = np.where(use, L, off)
        for t in range(1, int(lens.max())):
            if not (alive & (t < lens)).any():
                break
            act = alive & (t < lens) & (t >= off)
            if not act.any():
                continue
            s = np.where(act, codes[np.minimum(starts + t, len(codes) - 1)],
                         0)
            nrl, nru, ok = self.tighten_range(rl, ru, s, act)
            rl = np.where(act, nrl, rl)
            ru = np.where(act, nru, ru)
            matched += ok.astype(np.int64)
            alive = alive & ~(act & ~ok)
        first = np.where(matched > 0, self.succ_last(rl), 0)
        last = np.where(matched > 0, ru, 0)
        return first, last, matched

    def index_range_host(self, encoded: np.ndarray):
        """Match the longest prefix of one code string from the F-based
        range: -> (first, last, matched length)."""
        encoded = np.asarray(encoded, dtype=np.int64)
        if len(encoded) == 0:
            return 1, 1, 0
        if (encoded >= self.alph_size).any():
            return 0, 0, 0
        rl, ru = self.initial_range(encoded[:1])
        rl, ru = int(rl[0]), int(ru[0])
        if rl > ru:
            return 0, 0, 0
        matched = 1
        for pos in range(1, len(encoded)):
            rl_a, ru_a, ok = self.tighten_range(
                np.array([rl]), np.array([ru]), encoded[pos: pos + 1],
                np.array([True]))
            if not ok[0]:
                break
            rl, ru = int(rl_a[0]), int(ru_a[0])
            matched += 1
        return self.succ_last_scalar(rl), ru, matched

    def map_to_edges_batch(self, kmers: np.ndarray) -> np.ndarray:
        """(Q, k + 1) edge strings -> edge, or 0."""
        node_edge = self.index_batch(kmers[:, :-1])
        label = kmers[:, -1].astype(np.int64)
        ok = (node_edge > 0) & (label < self.alph_size)
        res = np.zeros(len(kmers), dtype=np.int64)
        if ok.any():
            res[ok] = self.pick_edge(node_edge[ok], label[ok])
        return res

    def map_sequence(self, codes: np.ndarray) -> np.ndarray:
        """The edge of every (k + 1)-window of a code string (0 = miss)."""
        K = self.k + 1
        n = len(codes)
        if n < K:
            return np.zeros(0, dtype=np.int64)
        windows = np.lib.stride_tricks.sliding_window_view(codes, K)
        bad = np.concatenate([[0], np.cumsum(codes >= self.alph_size)])
        good = (bad[K:] - bad[:-K]) == 0
        res = np.zeros(n - K + 1, dtype=np.int64)
        if good.any():
            res[good] = self.map_to_edges_batch(windows[good])
        return res
