"""Sequence encoding for the query's host window mapping.

Own copy of the part of metagraph_tpu/kmer/extractor.py that
``QueryEngine.map_batch`` uses: the per-alphabet encode table
(``KmerExtractor.__init__``/``encode``), the complement table extended to
the invalid code (``extended_complement_table``) and ``_rows_greater``;
and ``extract`` (:96-172: its distinct k-mers, without counts, weights or
the BOSS order of its output), from which the sshash graph rebuilds.
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

    def extract(self, seqs, K: int, mode: str = "basic") -> np.ndarray:
        """The distinct valid k-mers of ``seqs`` -> (N, K) uint8 codes,
        sorted (codes compared left to right).  ``mode``: 'basic' (forward
        windows) or 'both' (both strands, as a canonical graph holds
        them)."""
        sep = np.array([self.invalid], dtype=np.uint8)
        parts = [p for s in seqs for p in (self.encode(s), sep)]
        return self.extract_codes(np.concatenate(parts) if parts else sep[:0],
                                  K, mode)

    def extract_codes(self, codes: np.ndarray, K: int,
                      mode: str = "basic") -> np.ndarray:
        """``extract`` of encoded sequences, each followed by the invalid
        code."""
        if mode not in ("basic", "both"):
            raise ValueError(f"unknown mode {mode!r}")
        if len(codes) < K:
            return np.zeros((0, K), dtype=np.uint8)
        bad = np.concatenate([[0], np.cumsum(codes >= self.invalid)])
        valid = (bad[K:] - bad[:-K]) == 0
        wins = np.lib.stride_tricks.sliding_window_view(codes, K)[valid]
        if mode == "both":
            # the reverse complement of window j is window n-K-j of the
            # reverse-complemented codes
            rc = np.lib.stride_tricks.sliding_window_view(
                self.extended_complement_table()[codes[::-1]], K)[::-1][valid]
            wins = np.concatenate([wins, rc])
        wins = np.ascontiguousarray(wins)
        if not len(wins):
            return wins
        uniq = np.unique(wins.view(f"V{K}").ravel())
        return np.frombuffer(uniq.tobytes(), np.uint8).reshape(-1, K)


def _rows_greater(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic a > b per row over the trailing word axis."""
    gt = np.zeros(a.shape[:-1], dtype=bool)
    decided = np.zeros(a.shape[:-1], dtype=bool)
    for w in range(a.shape[-1]):
        aw, bw = a[..., w], b[..., w]
        gt |= ~decided & (aw > bw)
        decided |= aw != bw
    return gt
