"""Readers of the reference's on-disk formats: the sdsl ``.column.annodbg``
and the ``.dbg`` BOSS of state SMALL, with its ``.weights`` sidecar.

Own copy of the reading half of metagraph_tpu/seq_io/refformat.py
(``Cursor`` :20, ``read_int_vector`` :59, ``read_bit_vector`` :86,
``skip_select_support_mcl`` :97, ``read_sd_vector`` :112,
``read_bit_vector_sd`` :132, ``read_utf8_len`` :144,
``read_label_encoder`` :161, ``read_bit_vector_smart`` :192,
``load_reference_column_annotation`` :211, the rrr_vector<63> reader
:237-311, ``read_wt_huff`` :312-364, ``load_reference_boss`` :365 and
``load_reference_node_weights`` :432), bit for bit: the same bytes give
the same rows, labels, BOSS arrays and weights.
"""

from __future__ import annotations

import os
import struct
import sys
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


class Cursor:
    def __init__(self, data: bytes, off: int = 0):
        self.data = data
        self.off = off

    def be64(self) -> int:
        v = struct.unpack_from(">Q", self.data, self.off)[0]
        self.off += 8
        return v

    def le64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.off)[0]
        self.off += 8
        return v

    def le32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.off)[0]
        self.off += 4
        return v

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.data, self.off)[0]
        self.off += 4
        return v

    def u8(self) -> int:
        v = self.data[self.off]
        self.off += 1
        return v

    def raw(self, n: int) -> bytes:
        v = self.data[self.off: self.off + n]
        self.off += n
        return v

    def eof(self) -> bool:
        return self.off >= len(self.data)


def read_int_vector(cur: Cursor, fixed_width: int = 0):
    """sdsl::int_vector serialization: size-in-bits (u64 LE), a width byte
    for int_vector<0>, then ceil(bits/64) raw words."""
    bits = cur.le64()
    width = cur.u8() if fixed_width == 0 else fixed_width
    nwords = (bits + 63) // 64
    words = np.frombuffer(cur.raw(nwords * 8), dtype="<u8")
    if width == 0:
        return np.zeros(0, dtype=np.int64), width
    n = bits // width
    out = np.zeros(n, dtype=np.uint64)
    if n:
        bitpos = np.arange(n, dtype=np.uint64) * np.uint64(width)
        wi = (bitpos >> np.uint64(6)).astype(np.int64)
        sh = bitpos & np.uint64(63)
        lo = words[wi] >> sh
        need_hi = (sh + np.uint64(width)) > np.uint64(64)
        hi = np.zeros(n, dtype=np.uint64)
        nh = np.flatnonzero(need_hi)
        if len(nh):
            hi[nh] = words[wi[nh] + 1] << (np.uint64(64) - sh[nh])
        mask = np.uint64((1 << width) - 1) if width < 64 \
            else np.uint64(0xFFFFFFFFFFFFFFFF)
        out = (lo | hi) & mask
    return out, width


def read_bit_vector(cur: Cursor) -> np.ndarray:
    """sdsl::bit_vector (int_vector<1>): size bits + words, no width byte."""
    bits = cur.le64()
    nwords = (bits + 63) // 64
    words = np.frombuffer(cur.raw(nwords * 8), dtype="<u8")
    if not bits:
        return np.zeros(0, dtype=bool)
    out = np.unpackbits(words.view(np.uint8), bitorder="little")[:bits]
    return out.astype(bool)


def skip_select_support_mcl(cur: Cursor):
    """sdsl::select_support_mcl serialization (parse-and-discard):
    arg_cnt (u64); if nonzero: superblock int_vector<0>, mini_or_long
    bit_vector, then one int_vector<0> per superblock (long or mini)."""
    arg_cnt = cur.le64()
    if not arg_cnt:
        return
    read_int_vector(cur)                       # superblock positions
    mini_or_long = read_bit_vector(cur)
    sb = (arg_cnt + 4095) >> 12
    for i in range(sb):
        # empty indicator -> all miniblocks
        read_int_vector(cur)


def read_sd_vector(cur: Cursor) -> np.ndarray:
    """sdsl::sd_vector<> -> positions of set bits (Elias-Fano decode)."""
    m_size = cur.le64()
    wl = cur.u8()
    low, low_w = read_int_vector(cur)
    high = read_bit_vector(cur)
    skip_select_support_mcl(cur)               # high_1_select
    skip_select_support_mcl(cur)               # high_0_select
    ones_h = np.flatnonzero(high)
    m = len(low)
    # i-th set bit: value = ((select1(i) - i) << wl) | low[i]
    if m:
        idx = np.arange(m)
        pos = ((ones_h[:m] - idx).astype(np.int64) << int(wl)) \
            | low[:m].astype(np.int64)
    else:
        pos = np.zeros(0, dtype=np.int64)
    return pos, m_size


def read_bit_vector_sd(cur: Cursor) -> Tuple[np.ndarray, int]:
    """metagraph bit_vector_sd = sd_vector + 1-byte inverted flag
    (ref bit_vector_sd.hpp:273-277).  Returns (set positions, size)."""
    pos, size = read_sd_vector(cur)
    inverted = cur.u8()
    if inverted:
        mask = np.ones(size, dtype=bool)
        mask[pos] = False
        pos = np.flatnonzero(mask)
    return pos, size


def read_utf8_len(cur: Cursor) -> int:
    """encode_utf8-encoded length (ref serialization.cpp:224-233)."""
    b0 = cur.u8()
    if b0 < 0x80:
        return b0
    # multi-byte utf8 length
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    val = b0 & (mask - 1) if mask > 1 else 0
    for _ in range(n_extra):
        val = (val << 6) | (cur.u8() & 0x3F)
    return val


def read_label_encoder(cur: Cursor) -> List[str]:
    """LabelEncoder (ref annotation.cpp:32-80): either the LE-v2.0
    tsl::ordered_set dump or the legacy map+vector pair."""
    if cur.data[cur.off: cur.off + 7] == b"LE-v2.0":
        cur.off += 7
        version = cur.le64()
        nb = cur.le64()
        bucket_count = cur.le64()
        cur.f32()                              # max_load_factor
        labels = []
        for _ in range(nb):
            L = cur.be64()                     # Serializer: BE length + bytes
            labels.append(cur.raw(L).decode())
        # bucket entries: (index, truncated hash) as u64 pairs
        cur.off += bucket_count * 16
        return labels
    # legacy: string->number map (strings + number int_vector), then the
    # decode vector of strings
    n = cur.be64()
    for _ in range(n):
        L = read_utf8_len(cur)
        cur.raw(L)
    read_int_vector(cur)                       # the discarded values
    n2 = cur.be64()
    labels = []
    for _ in range(n2):
        L = read_utf8_len(cur)
        labels.append(cur.raw(L).decode())
    return labels


def read_bit_vector_smart(cur: Cursor) -> Tuple[np.ndarray, int]:
    """metagraph bit_vector_smart/small (bit_vector_adaptive): a
    representation tag (serialize_number, ref bit_vector_adaptive.hpp:48-56)
    followed by the tagged vector.  Returns (set positions, size)."""
    code = cur.be64()
    if code == 1:                            # SD_VECTOR
        return read_bit_vector_sd(cur)
    if code == 0:                            # RRR_VECTOR
        bv = read_rrr_vector(cur)
        return np.flatnonzero(bv), len(bv)
    if code == 2:                            # STAT_VECTOR (plain bit_vector)
        bv = read_bit_vector(cur)
        cur.be64()                           # num_set_bits
        read_int_vector(cur, fixed_width=64)  # rank_support_v basic blocks
        skip_select_support_mcl(cur)         # select1 (select0 is scan-based)
        return np.flatnonzero(bv), len(bv)
    raise ValueError(f"unsupported bit vector representation {code}")


def load_reference_column_annotation(path: str):
    """A reference ``.column.annodbg`` (ref
    annotate_column_compressed.cpp:179-199) -> ColumnMajorAnnotation."""
    from ..annotation.column import ColumnMajorAnnotation

    with open(path, "rb") as f:
        cur = Cursor(f.read())
    num_rows = cur.be64()
    labels = read_label_encoder(cur)
    rows = []
    for c in range(len(labels)):
        pos, size = read_bit_vector_smart(cur)
        if size != num_rows:
            raise ValueError(
                f"column {c}: bitmap size {size} != num_rows {num_rows}")
        rows.append(np.unique(pos.astype(np.int64)))
    return ColumnMajorAnnotation(num_rows, labels, rows)


_BINOM = None


def _binom_table(n: int = 63):
    global _BINOM
    if _BINOM is None:
        from math import comb
        _BINOM = [[comb(i, j) for j in range(n + 1)] for i in range(n + 1)]
    return _BINOM


def _rrr_decode_block(nr: int, k: int, n: int = 63) -> List[int]:
    """Combinadic unranking (fitted against reference artifacts).

    sdsl's rrr_helper encodes blocks with more than n/2 ones via the mirror
    rank (the complement block's enumeration), so the two conventions are
    selected by k: k > n/2 uses the direct lexicographic-0 rank (a 0-bit at
    position i contributes C(n-1-i, k-1)); k <= n/2 uses its mirror
    nr' = C(n,k) - 1 - nr.  Verified block-exact on both reference example
    graphs (all 10 blocks)."""
    C = _binom_table(n)
    if 2 * k <= n:
        nr = C[n][k] - 1 - nr
    out = []
    for i in range(n):
        if k == 0:
            out.extend([0] * (n - i))
            break
        c = C[n - 1 - i][k - 1]
        if nr < c:
            out.append(1)
            k -= 1
        else:
            out.append(0)
            nr -= c
    return out


def _rrr_space_for_bt(k: int, n: int = 63) -> int:
    if k == 0 or k == n:
        return 0
    C = _binom_table(n)
    return (C[n][k] - 1).bit_length()


def read_rrr_vector(cur: Cursor, block_size: int = 63) -> np.ndarray:
    """sdsl::rrr_vector<63> -> bool array.  Layout (fitted against reference
    artifacts): size u64, block-type int_vector (class per 63-bit block),
    offset bit_vector (combinadic block ranks, variable width per class),
    pointer-sample int_vector, rank-sample int_vector."""
    m_size = cur.le64()
    bt, _ = read_int_vector(cur)
    btnr = read_bit_vector(cur)
    read_int_vector(cur)          # btnrp pointer samples (recomputable)
    read_int_vector(cur)          # rank samples (recomputable)
    out = np.zeros(m_size, dtype=bool)
    pos = 0
    for i, k in enumerate(bt.astype(np.int64)):
        k = int(k)
        lo = i * block_size
        hi = min(lo + block_size, m_size)
        if k == 0:
            continue
        if k == block_size:
            out[lo:hi] = True
            continue
        width = _rrr_space_for_bt(k, block_size)
        bits = btnr[pos: pos + width]
        nr = 0
        for j in range(width - 1, -1, -1):     # LSB-first within the stream
            nr = (nr << 1) | int(bits[j])
        blk = _rrr_decode_block(nr, k, block_size)
        out[lo:hi] = blk[: hi - lo]
        pos += width
    return out


@dataclass
class _WTNode:
    bv_pos: int
    bv_pos_rank: int
    parent: int
    child: Tuple[int, int]


def read_wt_huff(cur: Cursor) -> np.ndarray:
    """sdsl::wt_huff<rrr_vector<63>> -> symbol array
    (layout fitted: size u64, sigma u64, rrr bitvector, node count u64,
    nodes {bv_pos u64, bv_pos_rank u64, parent u16, child0 u16, child1 u16},
    c_to_leaf 256xu16, path 256xu64)."""
    m_size = cur.le64()
    m_sigma = cur.le64()
    bv = read_rrr_vector(cur)
    n_nodes = cur.le64()
    nodes = []
    for _ in range(n_nodes):
        bv_pos = cur.le64()
        bv_pos_rank = cur.le64()
        parent = struct.unpack_from("<H", cur.data, cur.off)[0]
        c0, c1 = struct.unpack_from("<HH", cur.data, cur.off + 2)
        cur.off += 6
        nodes.append(_WTNode(bv_pos, bv_pos_rank, parent, (c0, c1)))
    c_to_leaf = np.frombuffer(cur.raw(256 * 2), dtype="<u2")
    cur.raw(256 * 8)                         # m_path (recomputable)
    leaf_char = {int(v): c for c, v in enumerate(c_to_leaf) if v != 0xFFFF}
    if m_size == 0:
        return np.zeros(0, dtype=np.int64)
    rank = np.concatenate([[0], np.cumsum(bv)])

    out = np.zeros(m_size, dtype=np.int64)
    # decode level-wise: indices at each node descend together
    stack = [(0, np.arange(m_size, dtype=np.int64))]
    while stack:
        v, idx = stack.pop()
        node = nodes[v]
        if node.child[0] == 0xFFFF:          # leaf
            out[idx] = leaf_char.get(v, 0)
            continue
        # local positions: idx stays in W order; the j-th routed symbol
        # sits at local offset j in this node's stream
        j = np.arange(len(idx), dtype=np.int64)
        b = bv[node.bv_pos + j]
        left = idx[~b]
        right = idx[b]
        if len(left):
            stack.append((node.child[0], left))
        if len(right):
            stack.append((node.child[1], right))
    return out


def load_reference_boss(path: str):
    """A reference ``.dbg`` (BOSS) file (ref boss.cpp:262-394, state SMALL)
    -> DBGSuccinct.  Its valid edges are those whose k-mer holds no
    sentinel and whose label is not the sentinel."""
    from ..graph.dbg_succinct import DBGSuccinct
    from ..succinct.boss import BOSS

    with open(path, "rb") as f:
        data = f.read()
    cur = Cursor(data)
    nF = cur.be64()
    F = np.array([cur.be64() for _ in range(nF)], dtype=np.int64)
    k_boss = cur.be64()
    state = cur.be64()
    if state != 1:
        raise ValueError(
            f"only BOSS state SMALL (1) is supported, got {state}; "
            "re-serialize with the reference's default state")
    alph_size = nF

    def boss_consistent(W, last):
        # for every char c, the edges labelled exactly c (minus copies
        # W == c + alph excluded) are the node rows of c's F-range
        if last[0] or len(W) != len(last):
            return False
        F_ext = np.concatenate([F, [len(W) - 1]])
        for c in range(1, alph_size):
            lo, hi = F_ext[c], F_ext[c + 1]
            if int((W == c).sum()) != int(last[lo + 1: hi + 1].sum()):
                return False
        return True

    W = read_wt_huff(cur)
    cur.be64()                               # logsigma
    code = cur.be64()                        # bit_vector_adaptive tag
    if code != 0:
        raise ValueError(f"unexpected last-vector representation {code}")
    last = read_rrr_vector(cur)
    if not boss_consistent(W, last.astype(np.int64)):
        raise ValueError("decoded BOSS vectors are inconsistent")
    mode = cur.be64() if cur.off + 8 <= len(data) else 0
    M = len(W)
    W8, last8 = W.astype(np.uint8), last.astype(np.uint8)
    kchars = BOSS(int(k_boss), alph_size, W8, last8, F,
                  np.ones(M, dtype=np.uint8)).get_edge_seq(
                      np.arange(1, M, dtype=np.int64))
    valid = np.zeros(M, dtype=np.uint8)
    valid[1:] = ((kchars != 0).all(axis=1)) & (W[1:] % alph_size != 0)
    boss = BOSS(int(k_boss), alph_size, W8, last8, F, valid,
                load_reference_node_weights(path, M))
    mode_name = {0: "basic", 1: "canonical", 2: "primary"}.get(int(mode),
                                                               "basic")
    return DBGSuccinct(boss, int(k_boss) + 1, mode_name)


def load_reference_node_weights(graph_path: str, num_positions: int):
    """A ``<graph>.weights`` sidecar (ref node_weights.cpp:36-61: a bare
    sdsl::int_vector<> of max_index + 1 values, index 0 = npos) -> uint64
    weights by BOSS edge position, or None where it is absent or does not
    fit the graph (ref node_weights.cpp:73-82)."""
    wpath = graph_path + ".weights"
    if not os.path.exists(wpath):
        return None
    with open(wpath, "rb") as f:
        w, _width = read_int_vector(Cursor(f.read()))
    if len(w) != num_positions:
        print(f"[warning] weights file {wpath} does not match number of "
              f"nodes in graph; ignored", file=sys.stderr)
        return None
    return w.astype(np.uint64)
