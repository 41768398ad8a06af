"""The raw BOSS table that construction makes.

Own copy of ``BossArrays`` of metagraph_tpu/succinct/construct.py:30-46,
and the one result of its host pipeline that the port's ``build`` gives:
the table of no k-mers (``build_boss_arrays`` of an empty set), which the
JAX ``build --device`` takes when no sequence holds a window.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BossArrays:
    """Row 0 is the sentinel zero row (ref boss_chunk.cpp:60-62)."""

    k: int                      # BOSS node length (dbg k - 1)
    alph_size: int              # sentinel-included alphabet size (5 for DNA)
    W: np.ndarray               # (M,) uint8, values in [0, 2 * alph_size)
    last: np.ndarray            # (M,) uint8 in {0, 1}
    F: np.ndarray               # (alph_size,) int64
    valid: np.ndarray           # (M,) uint8: 1 iff a real (non-dummy) edge
    weights: np.ndarray | None = None   # (M,) uint64 or None

    @classmethod
    def from_arrays(cls, other) -> "BossArrays":
        """Any object with the fields of a BossArrays (the JAX package's,
        in the tests) -> the port's, its arrays as numpy arrays."""
        w = getattr(other, "weights", None)
        return cls(int(other.k), int(other.alph_size), np.asarray(other.W),
                   np.asarray(other.last), np.asarray(other.F),
                   np.asarray(other.valid),
                   None if w is None else np.asarray(w))


def empty_boss_arrays(K: int, alph_size: int = 5) -> BossArrays:
    """The host pipeline's table of no edge k-mers of length K: the all-$
    row alone, emitted behind the zero row (construct.py:252-279 with
    N = 0)."""
    F = np.ones(alph_size, dtype=np.int64)
    F[0] = 0
    return BossArrays(k=K - 1, alph_size=alph_size,
                      W=np.zeros(2, np.uint8), last=np.array([0, 1], np.uint8),
                      F=F, valid=np.zeros(2, np.uint8))
