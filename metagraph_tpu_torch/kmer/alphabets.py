"""Alphabets in the BOSS code space (the sentinel ``$`` is code 0).

Own copy of metagraph_tpu/kmer/alphabets.py: DNA ($ACGT), DNA5 ($ACGTN),
Protein and the case-sensitive DNA_CASE, with their encode tables and
complement maps.  Bytes outside an alphabet encode to its ``sigma``, an
invalid code that breaks every window it falls in (``KmerExtractor`` maps
them to a catch-all character instead for DNA5, DNA_CASE and Protein).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Alphabet:
    name: str
    letters: str          # the sentinel first, e.g. "$ACGT"
    complement: tuple     # complement code of codes 0 .. sigma-1; () if none

    @property
    def sigma(self) -> int:
        return len(self.letters)

    @property
    def encode_table(self) -> np.ndarray:
        """(256,) uint8: byte -> code; invalid bytes -> sigma."""
        table = np.full(256, self.sigma, dtype=np.uint8)
        for code, ch in enumerate(self.letters):
            if code:
                table[ord(ch)] = code
                table[ord(ch.lower())] = code
        return table

    @property
    def decode_table(self) -> np.ndarray:
        """(sigma + 1,) uint8: code -> byte; the invalid code -> N."""
        return np.frombuffer((self.letters + "N").encode(),
                             dtype=np.uint8).copy()

    @property
    def complement_table(self) -> np.ndarray:
        if not self.complement:
            raise ValueError(f"alphabet {self.name} has no complement")
        return np.array(self.complement, dtype=np.uint8)


DNA = Alphabet("DNA", "$ACGT", (0, 4, 3, 2, 1))
# N is a real, self-complementary character
DNA5 = Alphabet("DNA5", "$ACGTN", (0, 4, 3, 2, 1, 5))
# no complement; X at the end is the catch-all
PROTEIN = Alphabet("Protein", "$ABCDEFGHIJKLMNOPQRSTUVWYZX", ())
# case flips across strands: A <-> t, C <-> g, G <-> c, T <-> a, N <-> N
DNA_CS = Alphabet("DNA_CASE", "$ACGTNacgt", (0, 9, 8, 7, 6, 5, 4, 3, 2, 1))

ALPHABETS = {a.name: a for a in (DNA, DNA5, PROTEIN, DNA_CS)}

LETTERS = DNA.letters
SIGMA = DNA.sigma


def dna_encode_table() -> np.ndarray:
    """(256,) uint8: byte -> DNA code; U encodes as T; invalid bytes (N
    included) -> SIGMA."""
    table = DNA.encode_table
    table[ord("U")] = table[ord("u")] = 4
    return table
