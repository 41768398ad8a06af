"""The BOSS table, read from the JAX package's ``.dbg.npz`` artifact or its
mmap layout.

Own numpy copy of the part of metagraph_tpu/succinct/boss.py the query
slice uses: loading (boss.py:660-700: the npz, or the mmap layout's
``.meta.npz`` beside raw ``.W/.last/.valid/.weights.npy`` arrays, mapped
read-only with ``mmap``) and the navigation needed to decode
edge k-mers (``rank_last``, ``select_W``, ``node_last_char``, ``bwd``,
``get_node_seq``, ``get_edge_seq``; boss.py:113-300, 593-610).  Rank and
select are plain prefix counts and position lists instead of the JAX
package's succinct directories; the answers are the same.

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
        self._last = _BitIndex(self.last == 1)
        self._W = [_BitIndex(self.W == c) for c in range(alph_size)]
        self.NF = self._last.rank(self.F)            # rank_last(F[c])

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
                return cls(int(meta["k"]), int(meta["alph_size"]),
                           np.load(base + ".W.npy", mmap_mode=mode),
                           np.load(base + ".last.npy", mmap_mode=mode),
                           meta["F"],
                           np.load(base + ".valid.npy", mmap_mode=mode),
                           np.load(wpath, mmap_mode=mode)
                           if os.path.exists(wpath) else None)
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            w = z["weights"] if "weights" in z.files else np.zeros(0)
            return cls(int(z["k"]), int(z["alph_size"]), z["W"], z["last"],
                       z["F"], z["valid"], w if len(w) else None)

    @property
    def num_valid(self) -> int:
        return int(np.count_nonzero(self.valid))

    @property
    def num_edges(self) -> int:
        return len(self.W) - 1

    def rank_last(self, i):
        """#set bits in last[1..i]."""
        return self._last.rank(i)

    def select_W(self, c, r):
        """Position of the r-th occurrence of value c in W[1..] (vectorised
        over mixed c < alph_size; c = 0 skips the sentinel W[0])."""
        c, r = np.broadcast_arrays(np.asarray(c, dtype=np.int64),
                                   np.asarray(r, dtype=np.int64))
        out = np.zeros(c.shape, dtype=np.int64)
        for sym in np.unique(c):
            m = c == sym
            out[m] = self._W[sym].select(r[m] + (sym == 0))
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
        """(Q, k) source-node code strings of edge(s) i."""
        cur = np.atleast_1d(np.asarray(i, dtype=np.int64))
        out = np.zeros((len(cur), self.k), dtype=np.uint8)
        for pos in range(self.k - 1, -1, -1):
            out[:, pos] = self.node_last_char(cur).astype(np.uint8)
            if pos:
                cur = self.bwd(cur)
        return out

    def get_edge_seq(self, i) -> np.ndarray:
        """(Q, k+1) edge strings: source node + label (minus flag dropped)."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        lab = (self.W[i] % self.alph_size).astype(np.uint8)[:, None]
        return np.concatenate([self.get_node_seq(i), lab], axis=1)
