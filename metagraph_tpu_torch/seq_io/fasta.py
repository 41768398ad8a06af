"""FASTA / FASTQ reading, gzip included, and the k-mer counts of
``build --count-kmers``.

Own copy of metagraph_tpu/seq_io/fasta.py:19-120 (``FastaRecord`` and
``read_fasta``): the whole file is read into memory and split on record
markers; multi-line sequences and qualities are joined.  And of
``parse_abundance`` (:26-41: a Logan-style ``ka:f:``/``km:f:`` header
abundance), ``_counts_sidecar`` (:148) and ``read_kmer_counts`` (:156:
the per-window counts that ``write_extended_fasta`` stores beside a
FASTA file as ``<base>.kmer_counts.npz``).
"""

from __future__ import annotations

import gzip
import math
import os
import re
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class FastaRecord:
    name: str
    seq: bytes
    quality: bytes | None = None
    comment: str = ""          # header text after the first token


def parse_abundance(comment: str):
    """The k-mer abundance of a ``ka:f:``/``km:f:`` header field, rounded
    as ``llround`` rounds (halves away from zero), at least 1; None
    without one."""
    m = re.search(r"(ka|km):f:([0-9.eE+-]+)", comment)
    if not m:
        return None
    try:
        v = float(m.group(2))
        return max(1, int(math.floor(v + 0.5)) if v >= 0
                   else int(math.ceil(v - 0.5)))
    except ValueError:
        return None


def _counts_sidecar(path: str) -> str:
    base = path
    for suf in (".gz", ".fasta", ".fa"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    return base + ".kmer_counts.npz"


def read_kmer_counts(path: str):
    """The per-window counts stored beside a FASTA file, one array a
    record, or None where there is no sidecar."""
    counts_path = _counts_sidecar(path)
    if not os.path.exists(counts_path):
        return None
    z = np.load(counts_path)
    flat, offs = z["counts"], z["offsets"]
    return [flat[offs[i]: offs[i + 1]] for i in range(len(offs) - 1)]


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
