"""The DNA alphabet in the BOSS code space ($=0, A=1, C=2, G=3, T=4).

Own copy of the part of metagraph_tpu/kmer/alphabets.py the query slice
uses.  Bytes outside the alphabet (N included) encode to ``SIGMA``, an
invalid code that breaks every window it falls in.
"""

from __future__ import annotations

import numpy as np

LETTERS = "$ACGT"
SIGMA = len(LETTERS)


def dna_encode_table() -> np.ndarray:
    """(256,) uint8: byte -> code; U encodes as T; invalid bytes -> SIGMA."""
    table = np.full(256, SIGMA, dtype=np.uint8)
    for code, ch in enumerate(LETTERS[1:], start=1):
        table[ord(ch)] = code
        table[ord(ch.lower())] = code
    table[ord("U")] = table[ord("u")] = 4
    return table
