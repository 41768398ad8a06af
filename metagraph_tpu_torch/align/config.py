"""Aligner configuration and scoring: ``AlignerConfig``, ``NINF`` and the
score matrices (DNA, unit cost, BLOSUM62).

Own copy of metagraph_tpu/align/config.py (plain Python and numpy), so that
the port builds the same config from the same command line.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NINF = -(2 ** 31) + 100      # ref aligner_config.hpp ninf = INT32_MIN + 100


def dna_scoring_matrix(match: int = 2, transition: int = -3,
                       transversion: int = -3) -> np.ndarray:
    """(128, 128) int32 char-indexed score matrix
    (ref aligner_config.cpp:165-183)."""
    m = np.full((128, 128), transversion, dtype=np.int32)
    pairs = [("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")]
    for a, b in pairs:
        m[ord(a), ord(b)] = transition
    for c in "ACGT":
        m[ord(c), ord(c)] = match
    # lowercase mirrors
    for a in "ACGTacgt":
        for b in "ACGTacgt":
            m[ord(a), ord(b)] = m[ord(a.upper()), ord(b.upper())]
    return m


# Standard BLOSUM62 substitution matrix (Henikoff & Henikoff 1992), the
# protein scoring the reference selects for Protein builds
# (ref aligner_config.cpp:146-152,207-254).
_BLOSUM62_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX"
_BLOSUM62 = [
    [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0, -2, -1, 0],
    [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3, -1, 0, -1],
    [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3, 3, 0, -1],
    [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3, -3, 4, 1, -1],
    [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1, -3, -3, -2],
    [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2, 0, 3, -1],
    [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2, 1, 4, -1],
    [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3, -3, -1, -2, -1],
    [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3, 0, 0, -1],
    [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3, -3, -3, -1],
    [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1, -4, -3, -1],
    [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2, 0, 1, -1],
    [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1, -3, -1, -1],
    [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1, -3, -3, -1],
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3, -2, -2, -1, -2],
    [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2, 0, 0, 0],
    [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0, -1, -1, 0],
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2, -3, -4, -3, -2],
    [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7, -1, -3, -2, -1],
    [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4, -3, -2, -1],
    [-2, -1, 3, 4, -3, 0, 1, -1, 0, -3, -4, 0, -3, -3, -2, 0, -1, -4, -3, -3, 4, 1, -1],
    [-1, 0, 0, 1, -3, 3, 4, -2, 0, -3, -3, 1, -1, -3, -1, 0, -1, -3, -2, -2, 1, 4, -1],
    [0, -1, -1, -1, -2, -1, -1, -1, -1, -1, -1, -1, -1, -1, -2, 0, 0, -2, -1, -1, -1, -1, -1],
]


def blosum62_scoring_matrix() -> np.ndarray:
    """(128, 128) int32 char-indexed BLOSUM62 matrix; unknown letters
    (J/O/U) score -4 off-diagonal, +1 on the diagonal
    (ref aligner_config.cpp:238-247)."""
    m = np.full((128, 128), -4, dtype=np.int32)
    np.fill_diagonal(m, 1)
    for i, a in enumerate(_BLOSUM62_ALPHABET):
        for j, b in enumerate(_BLOSUM62_ALPHABET):
            m[ord(a), ord(b)] = _BLOSUM62[i][j]
    return m


def unit_scoring_matrix(match: int = 1) -> np.ndarray:
    """Edit-distance (unit-cost) matrix: every mismatch scores -match, every
    valid-character match scores +match (ref aligner_config.cpp:186-205)."""
    m = np.full((128, 128), -match, dtype=np.int32)
    for c in "ACGT":
        m[ord(c), ord(c)] = match
    for a in "ACGTacgt":
        for b in "ACGTacgt":
            m[ord(a), ord(b)] = m[ord(a.upper()), ord(b.upper())]
    return m


@dataclass
class AlignerConfig:
    num_alternative_paths: int = 1
    min_seed_length: int = 19            # clamped to k at init
    max_seed_length: int = 2 ** 63
    max_num_seeds_per_locus: int = 1000
    min_path_score: int = 0
    min_cell_score: int = NINF
    xdrop: int = 27
    min_exact_match: float = 0.7
    max_nodes_per_seq_char: float = 5.0
    max_ram_per_alignment: float = 200.0
    rel_score_cutoff: float = 0.95
    gap_opening_penalty: int = -6
    gap_extension_penalty: int = -2
    left_end_bonus: int = 5
    right_end_bonus: int = 5
    forward_and_reverse_complement: bool = True
    global_xdrop: bool = True
    allow_left_trim: bool = True
    seed_complexity_filter: bool = True
    no_backtrack: bool = False
    chain_alignments: bool = False
    post_chain_alignments: bool = False
    match_score_val: int = 2
    transition: int = -3
    transversion: int = -3
    edit_distance: bool = False          # --align-edit-distance: unit costs
    protein: bool = False                # BLOSUM62, no reverse complement
    score_matrix: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.score_matrix is None:
            if self.edit_distance:
                self.score_matrix = unit_scoring_matrix(1)
            elif self.protein:
                # ref aligner_config.cpp:146-152 (alphabet-keyed selection)
                self.score_matrix = blosum62_scoring_matrix()
            else:
                self.score_matrix = dna_scoring_matrix(
                    self.match_score_val, self.transition, self.transversion)
        if self.protein:
            # amino acids have no reverse complement
            self.forward_and_reverse_complement = False

    def clamp_to_k(self, k: int):
        self.min_seed_length = min(self.min_seed_length, k)
        return self

    def match_score(self, seq: bytes | str) -> int:
        if isinstance(seq, str):
            seq = seq.encode()
        a = np.frombuffer(seq, dtype=np.uint8)
        return int(self.score_matrix[a, a].sum())
