"""The BOSS table, read from and written to the JAX package's ``.dbg.npz``
artifact or its mmap layout.

Own numpy copy of the part of metagraph_tpu/succinct/boss.py the port
uses: the table of a ``BossArrays`` with its ``state`` tag and
``count_width`` (boss.py:36-53), writing (``save``, ``save_mmap``,
:622-657: the same npz keys and dtypes; the suffix-range keys are not
written, as the port's ``build`` refuses ``--index-ranges``), loading
(:660-700: the npz, or the mmap layout's ``.meta.npz`` beside raw
``.W/.last/.valid/.weights.npy`` arrays, mapped read-only with ``mmap``)
and the navigation needed to decode
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
        # the representation tag ('fast' selects the mmap layout) and the
        # bits a stored count takes, both kept in the artifact
        self.state = "stat"
        self.count_width = 8
        self._last = _BitIndex(self.last == 1)
        self._W = [_BitIndex(self.W == c) for c in range(alph_size)]
        self.NF = self._last.rank(self.F)            # rank_last(F[c])

    @classmethod
    def from_arrays(cls, arrays) -> "BOSS":
        """The table of a ``construct.BossArrays``."""
        return cls(arrays.k, arrays.alph_size, arrays.W, arrays.last,
                   arrays.F, arrays.valid, arrays.weights)

    def save(self, path: str, **extra):
        """The npz artifact, compressed (boss.py:622-635)."""
        extra.setdefault("state", self.state)
        extra.setdefault("count_width", self.count_width)
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
        extra.setdefault("state", self.state)
        extra.setdefault("count_width", self.count_width)
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
        """``state`` and ``count_width`` as the artifact records them
        (boss.py:677-695); an older one without a state tag reads as
        ``state``."""
        self.state = str(z["state"]) if "state" in z.files else state
        if "count_width" in z.files:
            self.count_width = int(z["count_width"])

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
