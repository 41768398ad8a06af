"""The BOSS comparison order of k-mer characters and the key code width.

Own copy of the part of metagraph_tpu/kmer/packing.py the query slice uses.
"""

from __future__ import annotations

import numpy as np


def boss_priority_order(K: int) -> np.ndarray:
    """Column order (most significant first) of the BOSS edge-k-mer
    comparison: s[K-2], s[K-3], ..., s[0], then the edge label s[K-1]."""
    return np.array(list(range(K - 2, -1, -1)) + [K - 1], dtype=np.int64)


def bits_for_alphabet(alph_size: int) -> int:
    """Bits a packed key spends on a code: 4 when every code, the invalid
    one (== alph_size) included, fits a nibble, else 8."""
    return 4 if alph_size < 16 else 8
