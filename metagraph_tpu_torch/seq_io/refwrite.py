"""The reference's on-disk column annotation, written.

Own copy of the annotation half of metagraph_tpu/seq_io/refwrite.py
(:28-352, :389-404): the sdsl serialization helpers (``Writer``,
``pack_words``, ``write_int_vector``, ``write_bit_vector``, the rrr_vector<63>
writer with its fitted sample directories, ``write_bit_vector_small``),
``write_label_encoder`` and ``save_reference_column_annotation``, whose
bytes are the JAX writer's.  Each column is a bit_vector_small (tag 0, an
rrr vector), so the wavelet-tree writer of the graph format is not reached
here; ``seq_io/refformat.py`` reads the files back.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from .refformat import _binom_table, _rrr_space_for_bt


class Writer:
    def __init__(self):
        self.buf = bytearray()

    def be64(self, v: int):
        self.buf += struct.pack(">Q", v)

    def le64(self, v: int):
        self.buf += struct.pack("<Q", v)

    def u8(self, v: int):
        self.buf.append(v & 0xFF)

    def u16(self, v: int):
        self.buf += struct.pack("<H", v)

    def raw(self, b: bytes):
        self.buf += b

    def utf8_len(self, n: int):
        """encode_utf8 length prefix (ref serialization.cpp:172-178):
        classic extended UTF-8 of the integer, valid for any n < 2^31
        (chr(n).encode would reject surrogate-range and > 0x10FFFF values
        that are legal lengths here)."""
        if n < 0:
            raise ValueError(n)
        if n < 0x80:
            self.buf += bytes([n])
            return
        for length, limit in ((2, 0x800), (3, 0x10000), (4, 0x200000),
                              (5, 0x4000000), (6, 0x80000000)):
            if n < limit:
                break
        else:
            raise ValueError("Encoding value out of range for code.")
        lead = (0xFF << (8 - length)) & 0xFF
        out = [lead | (n >> (6 * (length - 1)))]
        for i in range(length - 2, -1, -1):
            out.append(0x80 | ((n >> (6 * i)) & 0x3F))
        self.buf += bytes(out)


def pack_words(values: np.ndarray, width: int) -> np.ndarray:
    """Pack ints LSB-first into little-endian u64 words (sdsl layout)."""
    n = len(values)
    bits = n * width
    words = np.zeros(bits // 64 + 2, dtype=np.uint64)
    if n:
        v = values.astype(np.uint64)
        off = np.arange(n, dtype=np.int64) * width
        wi = off >> 6
        sh = (off & 63).astype(np.uint64)
        np.bitwise_or.at(words, wi, v << sh)
        spill = (sh.astype(np.int64) + width) > 64
        np.bitwise_or.at(words, wi[spill] + 1,
                         v[spill] >> (np.uint64(64) - sh[spill]))
    return words[: (bits + 63) // 64]


def write_int_vector(w: Writer, values: np.ndarray, width: int,
                     fixed_width: bool = False):
    """sdsl::int_vector serialization: size-in-bits u64 LE, width byte for
    int_vector<0>, raw words."""
    values = np.asarray(values)
    w.le64(len(values) * width)
    if not fixed_width:
        w.u8(width)
    w.raw(pack_words(values, width).tobytes())


def write_bit_vector(w: Writer, bits: np.ndarray):
    """sdsl::bit_vector: size bits + words, no width byte."""
    bits = np.asarray(bits, dtype=bool)
    w.le64(len(bits))
    if len(bits):
        packed = np.packbits(bits, bitorder="little")
        pad = (-len(packed)) % 8
        w.raw(packed.tobytes() + b"\0" * pad)


def _rrr_rank_blocks(blocks: np.ndarray, bt: np.ndarray,
                     n: int = 63) -> np.ndarray:
    """The combinadic rank of every block (the inverse of refformat's
    ``_rrr_decode_block``), 63 numpy steps in all.  Ranks fit uint64 for
    n = 63 (C(63, 31) - 1 < 2^63)."""
    C = np.array(_binom_table(n), dtype=np.uint64)       # (n+1, n+1)
    nb = len(bt)
    nr = np.zeros(nb, dtype=np.uint64)
    kk = bt.astype(np.int64).copy()
    for i in range(n):
        active = kk > 0
        bit = blocks[:, i]
        add = active & ~bit
        if add.any():
            nr[add] += C[n - 1 - i, kk[add] - 1]
        kk[active & bit] -= 1
    flip = 2 * bt <= n
    nr[flip] = C[n, bt[flip]] - np.uint64(1) - nr[flip]
    return nr


def write_rrr_vector(w: Writer, bits: np.ndarray, block_size: int = 63,
                     t_k: int = 32):
    """sdsl::rrr_vector<63> (layout per refformat.read_rrr_vector plus the
    fitted m_btnrp / m_rank sample directories, rate t_k=32)."""
    bits = np.asarray(bits, dtype=bool)
    m_size = len(bits)
    nb = (m_size + block_size - 1) // block_size
    pad = np.zeros(nb * block_size, dtype=bool)
    pad[:m_size] = bits
    blocks = pad.reshape(nb, block_size) if nb else pad.reshape(0, block_size)
    bt = blocks.sum(axis=1).astype(np.int64)

    # offset stream: variable-width combinadic rank per block — fully
    # vectorized (the per-block/per-bit Python loops made every .dbg save
    # O(total bits) interpreted work)
    width_by_k = np.array([_rrr_space_for_bt(k, block_size)
                           for k in range(block_size + 1)], dtype=np.int64)
    widths = width_by_k[bt] if nb else np.zeros(0, dtype=np.int64)
    offs = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(widths, out=offs[1:])
    rank_cum = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(bt, out=rank_cum[1:])
    btnrp_samples = offs[:-1:t_k].tolist() if nb else [0]
    rank_samples = rank_cum[:-1:t_k].tolist() if nb else [0]
    if nb == 0:
        btnrp_samples, rank_samples = [0], [0]
    rank_samples.append(int(rank_cum[-1]))         # final total (fitted)
    total = int(offs[-1])
    if total:
        nr = _rrr_rank_blocks(blocks, bt, block_size)
        owner = np.repeat(np.arange(nb), widths)
        j = (np.arange(total, dtype=np.int64)
             - np.repeat(offs[:-1], widths)).astype(np.uint64)
        stream = ((nr[owner] >> j) & np.uint64(1)).astype(bool)
    else:
        stream = np.zeros(0, dtype=bool)
    btnr_bits = np.zeros(max(len(stream), 64), dtype=bool)
    btnr_bits[: len(stream)] = stream

    w.le64(m_size)
    bt_width = max(int(block_size).bit_length(), 1)   # hi(63)+1 = 6
    write_int_vector(w, bt, bt_width)
    write_bit_vector(w, btnr_bits)
    ptr_width = max(int(len(stream)).bit_length(), 1)  # sdsl: hi(btnr_pos)+1
    write_int_vector(w, np.array(btnrp_samples, dtype=np.int64), ptr_width)
    rank_width = max(int(m_size).bit_length(), 1)
    write_int_vector(w, np.array(rank_samples, dtype=np.int64), rank_width)


def write_bit_vector_small(w: Writer, bits: np.ndarray):
    """metagraph bit_vector_small/smart (bit_vector_adaptive): tag 0 (RRR)
    + the rrr vector (ref bit_vector_adaptive.hpp:48-56)."""
    w.be64(0)
    write_rrr_vector(w, bits)


# ------------------------------------------------------------- label encoder
def write_label_encoder(w: Writer, labels: List[str]):
    """Legacy LabelEncoder layout (ref annotation.cpp:46-80 backward-compat
    branch): string-map keys + value int_vector + decode string vector."""
    w.be64(len(labels))
    for i, lab in enumerate(labels):
        b = lab.encode()
        w.utf8_len(len(b))
        w.raw(b)
    width = max(int(max(len(labels) - 1, 1)).bit_length(), 1)
    write_int_vector(w, np.arange(len(labels), dtype=np.int64), width)
    w.be64(len(labels))
    for lab in labels:
        b = lab.encode()
        w.utf8_len(len(b))
        w.raw(b)


def save_reference_column_annotation(anno, path: str):
    """Write a `.column.annodbg` the reference can load
    (ref annotate_column_compressed.cpp serialize)."""
    w = Writer()
    w.be64(anno.num_rows)
    labels = list(anno.labels)
    write_label_encoder(w, labels)
    for c in range(anno.num_labels):
        col = np.zeros(anno.num_rows, dtype=bool)
        col[anno.column_rows(c)] = True
        write_bit_vector_small(w, col)
    out = path if path.endswith(".annodbg") else path + ".column.annodbg"
    with open(out, "wb") as f:
        f.write(bytes(w.buf))
    return out
