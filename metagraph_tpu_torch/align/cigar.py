"""CIGAR strings; own copy of metagraph_tpu/align/cigar.py.

Op chars: '=' match, 'X' mismatch, 'I' insertion (query char not in graph),
'D' deletion (graph char not in query), 'S' soft clip, 'G' node insertion.
"""

from __future__ import annotations

from typing import List

CLIPPED = "S"
MATCH = "="
MISMATCH = "X"
INSERTION = "I"
DELETION = "D"
NODE_INSERTION = "G"


class Cigar:
    def __init__(self, op: str | None = None, num: int = 0):
        self._ops: List[list] = []
        if op is not None and num:
            self._ops.append([op, num])

    def append(self, op: str, num: int = 1):
        if num == 0:
            return
        if self._ops and self._ops[-1][0] == op:
            self._ops[-1][1] += num
        else:
            self._ops.append([op, num])

    def extend(self, other: "Cigar"):
        for op, n in other._ops:
            self.append(op, n)

    def reverse(self):
        self._ops.reverse()

    @property
    def ops(self) -> List[list]:
        return self._ops

    def __len__(self):
        return len(self._ops)

    def __bool__(self):
        return bool(self._ops)

    def get_clipping(self) -> int:
        return self._ops[0][1] if self._ops and self._ops[0][0] == CLIPPED else 0

    def get_end_clipping(self) -> int:
        return self._ops[-1][1] if self._ops and self._ops[-1][0] == CLIPPED else 0

    def trim_end_clipping(self) -> int:
        if self._ops and self._ops[-1][0] == CLIPPED:
            return self._ops.pop()[1]
        return 0

    def get_num_matches(self) -> int:
        return sum(n for op, n in self._ops if op == MATCH)

    def num_query_chars(self) -> int:
        """query characters consumed (excl. clipping)."""
        return sum(n for op, n in self._ops
                   if op in (MATCH, MISMATCH, INSERTION))

    def to_string(self) -> str:
        return "".join(f"{n}{op}" for op, n in self._ops)

    def __repr__(self):
        return f"Cigar({self.to_string()})"

    def __eq__(self, other):
        return isinstance(other, Cigar) and self._ops == other._ops

    def copy(self) -> "Cigar":
        c = Cigar()
        c._ops = [list(x) for x in self._ops]
        return c
