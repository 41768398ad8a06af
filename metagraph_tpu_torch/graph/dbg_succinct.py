"""DBGSuccinct graphs from the JAX package's ``.dbg.npz`` artifacts.

Own copy of the loading part of metagraph_tpu/graph/dbg_succinct.py:611-642
for the npz layout.  The reference-format ``.dbg`` and the mmap layout
(``.meta.npz`` beside raw ``.npy`` arrays) are not ported yet and raise.
"""

from __future__ import annotations

import os

import numpy as np

from ..succinct.boss import BOSS


class DBGSuccinct:
    def __init__(self, boss: BOSS, k: int, mode: str, alphabet: str):
        self.boss = boss
        self.k = k                      # dbg k (= boss.k + 1)
        self.mode = mode
        self.alphabet = alphabet

    def max_index(self) -> int:
        return self.boss.num_edges

    @classmethod
    def load(cls, path: str) -> "DBGSuccinct":
        if path.endswith(".dbg") and os.path.exists(path):
            with open(path, "rb") as f:
                if f.read(2) != b"PK":
                    raise NotImplementedError(
                        "reference-format .dbg graphs are not ported yet "
                        "(ROADMAP A7)")
        base = path[:-4] if path.endswith(".npz") else path
        if os.path.exists(base + ".meta.npz") \
                and not os.path.exists(base + ".npz"):
            raise NotImplementedError(
                "the mmap graph layout is not ported yet (ROADMAP A7)")
        npz = base + ".npz"
        with np.load(npz) as z:
            if "graph_type" in z.files \
                    and str(z["graph_type"]) != "succinct":
                raise NotImplementedError(
                    f"graph type {str(z['graph_type'])!r} is not ported yet "
                    "(ROADMAP A7)")
            mode = str(z["mode"]) if "mode" in z.files else "basic"
            alph_size = int(z["alph_size"])
            alphabet = str(z["alphabet"]) if "alphabet" in z.files \
                else ("DNA" if alph_size == 5 else f"sigma={alph_size}")
        boss = BOSS.load(npz)
        return cls(boss, boss.k + 1, mode, alphabet)
