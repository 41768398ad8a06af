"""Sequence encoding for the query's host window mapping.

Own copy of the part of metagraph_tpu/kmer/extractor.py that
``QueryEngine.map_batch`` uses: the per-alphabet encode table
(``KmerExtractor.__init__``/``encode``), the complement table extended to
the invalid code (``extended_complement_table``) and ``_rows_greater``.
"""

from __future__ import annotations

import numpy as np

from .alphabets import DNA, Alphabet, dna_encode_table
from .packing import bits_for_alphabet

# the catch-all character that unknown bytes encode to, per alphabet
_CATCH_ALL = {"DNA5": "N", "DNA_CASE": "N", "Protein": "X"}


class KmerExtractor:
    def __init__(self, alphabet: Alphabet = DNA):
        self.alphabet = alphabet
        if alphabet.name == "DNA":
            enc = dna_encode_table()
        else:
            enc = alphabet.encode_table
            catch = _CATCH_ALL.get(alphabet.name)
            if catch is not None:
                enc[enc == alphabet.sigma] = enc[ord(catch)]
            if alphabet.name == "DNA5":
                enc[ord("U")] = enc[ord("u")] = enc[ord("T")]
            elif alphabet.name == "DNA_CASE":
                enc[ord("U")], enc[ord("u")] = enc[ord("T")], enc[ord("t")]
        self._enc = enc
        self.invalid = alphabet.sigma
        self.bits = bits_for_alphabet(alphabet.sigma)

    def encode(self, seq: bytes | str) -> np.ndarray:
        if isinstance(seq, str):
            seq = seq.encode()
        return self._enc[np.frombuffer(seq, dtype=np.uint8)]

    def extended_complement_table(self) -> np.ndarray:
        """The complement map with the invalid code mapping to itself."""
        return np.concatenate(
            [self.alphabet.complement_table,
             np.arange(self.alphabet.sigma, self.invalid + 1)]).astype(
                 np.uint8)


def _rows_greater(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic a > b per row over the trailing word axis."""
    gt = np.zeros(a.shape[:-1], dtype=bool)
    decided = np.zeros(a.shape[:-1], dtype=bool)
    for w in range(a.shape[-1]):
        aw, bw = a[..., w], b[..., w]
        gt |= ~decided & (aw > bw)
        decided |= aw != bw
    return gt
