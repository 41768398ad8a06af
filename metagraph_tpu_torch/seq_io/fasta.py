"""FASTA / FASTQ reading, gzip included.

Own copy of metagraph_tpu/seq_io/fasta.py:19-120 (``FastaRecord`` and
``read_fasta``): the whole file is read into memory and split on record
markers; multi-line sequences and qualities are joined.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import List


@dataclass
class FastaRecord:
    name: str
    seq: bytes
    quality: bytes | None = None
    comment: str = ""          # header text after the first token


def _open(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def read_fasta(path: str) -> List[FastaRecord]:
    data = _open(path).lstrip()
    if not data:
        return []
    if data[:1] == b">":
        return _parse_fasta(data)
    if data[:1] == b"@":
        return _parse_fastq(data)
    raise ValueError(f"{path}: not FASTA/FASTQ (starts with {data[:1]!r})")


def _parse_fasta(data: bytes) -> List[FastaRecord]:
    records = []
    for chunk in data.split(b"\n>"):
        chunk = chunk.lstrip(b">")
        if not chunk.strip():
            continue
        nl = chunk.find(b"\n")
        header, body = (chunk, b"") if nl < 0 else (chunk[:nl], chunk[nl + 1:])
        parts = header.split(None, 1)
        records.append(FastaRecord(
            parts[0].decode() if parts else "",
            body.replace(b"\n", b"").replace(b"\r", b""),
            comment=parts[1].decode() if len(parts) > 1 else ""))
    return records


def _parse_fastq(data: bytes) -> List[FastaRecord]:
    """kseq-style FASTQ: the quality block ends once its length reaches the
    sequence length."""
    lines = data.split(b"\n")
    records = []
    i, n = 0, len(lines)
    while i < n:
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        if not line.startswith(b"@"):
            raise ValueError(f"malformed FASTQ: expected '@' header, got "
                             f"{line[:30]!r}")
        toks = line[1:].split(None, 1)
        i += 1
        seq_parts = []
        while i < n and not lines[i].startswith(b"+"):
            seq_parts.append(lines[i].strip())
            i += 1
        seq = b"".join(seq_parts)
        i += 1                                   # the '+' separator line
        qual_parts, qlen = [], 0
        while i < n and qlen < len(seq):
            q = lines[i].strip()
            qual_parts.append(q)
            qlen += len(q)
            i += 1
        records.append(FastaRecord(
            toks[0].decode() if toks else "", seq,
            b"".join(qual_parts) if qual_parts else None,
            comment=toks[1].decode() if len(toks) > 1 else ""))
    return records
