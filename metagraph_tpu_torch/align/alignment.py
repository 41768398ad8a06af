"""Alignment representation; own copy of metagraph_tpu/align/alignment.py.

An alignment maps a window of the query (``query[clipping : len-end_clipping]``)
to a path of graph nodes spelling ``sequence``; ``offset`` counts prefix
characters of the first node's k-mer that are not part of the alignment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .cigar import CLIPPED, MATCH, Cigar
from .config import AlignerConfig

REVCOMP = bytes.maketrans(b"ACGTacgtUu", b"TGCAtgcaAa")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(REVCOMP)[::-1]


@dataclass
class Alignment:
    query: bytes = b""                 # the full query (this orientation)
    nodes: List[int] = field(default_factory=list)
    sequence: bytes = b""              # graph spelling of the path
    score: int = 0
    cigar: Cigar = field(default_factory=Cigar)
    orientation: bool = False
    offset: int = 0
    extra_score: int = 0
    label_columns: list = field(default_factory=list)
    label_coordinates: list = field(default_factory=list)

    # ------------------------------------------------------------ accessors
    def empty(self) -> bool:
        return not self.nodes

    def size(self) -> int:
        return len(self.nodes)

    def get_clipping(self) -> int:
        return self.cigar.get_clipping()

    def get_end_clipping(self) -> int:
        return self.cigar.get_end_clipping()

    def query_view(self) -> bytes:
        c, e = self.get_clipping(), self.get_end_clipping()
        return self.query[c: len(self.query) - e]

    # ------------------------------------------------------------ mutation
    def trim_offset(self):
        """ref Alignment::trim_offset: drop leading nodes covered by offset."""
        if not self.offset or len(self.nodes) <= 1:
            return
        trim = min(self.offset, len(self.nodes) - 1)
        self.nodes = self.nodes[trim:]
        self.offset -= trim

    def reverse_complement(self, graph, query_rc: bytes) -> "Alignment":
        """In-place rc (ref alignment.cpp reverse_complement); only supported
        for offset == 0 alignments (the only case the aligner reverses).
        On failure, clears the alignment."""
        if self.offset:
            self.nodes = []
            return self
        rc_seq = revcomp(self.sequence)
        nodes = graph.map_to_nodes_sequentially(rc_seq)
        if (nodes == 0).any():
            self.nodes = []
            return self
        self.nodes = [int(x) for x in nodes]
        self.sequence = rc_seq
        self.query = query_rc
        self.cigar.reverse()
        # swap clipping: cigar reversal already swaps S ops
        self.orientation = not self.orientation
        return self

    # ------------------------------------------------------------ ordering
    def sort_key(self):
        """LocalAlignmentLess (ref alignment.hpp:337-349): better first."""
        return (-self.score, -len(self.query_view()),
                self.orientation, self.get_clipping())

    def format_tsv(self) -> str:
        """ref fmt formatter (alignment.hpp:418-436)."""
        return "\t".join([
            "-" if self.orientation else "+",
            self.sequence.decode(),
            str(self.score),
            str(self.cigar.get_num_matches()),
            self.cigar.to_string(),
            str(self.offset),
        ])

    def __repr__(self):
        return (f"Alignment({self.sequence.decode()}, score={self.score}, "
                f"{self.cigar.to_string()}, offset={self.offset})")


def seed_to_alignment(query: bytes, start: int, length: int, nodes: List[int],
                      orientation: bool, offset: int,
                      config: AlignerConfig) -> Alignment:
    """ref Alignment(const Seed&, config) (alignment.hpp:154-166)."""
    end_clipping = len(query) - start - length
    window = query[start: start + length]
    score = config.match_score(window)
    if start == 0:
        score += config.left_end_bonus
    if end_clipping == 0:
        score += config.right_end_bonus
    cigar = Cigar(CLIPPED, start)
    cigar.append(MATCH, length)
    cigar.append(CLIPPED, end_clipping)
    a = Alignment(query=query, nodes=list(nodes), sequence=window,
                  score=score, cigar=cigar, orientation=orientation,
                  offset=offset)
    a.trim_offset()
    return a
