"""The k-mer hash index and kernel 1, ``wire_lookup``.

Own copies of metagraph_tpu/succinct/ops.py: the host packers
``pack_codes32``/``pack_kmers32``/``pack_kmers2`` (:49-95), ``_hash_words``
(:345-360, numpy and torch), the ``DeviceHashIndex`` builder (:389-431,
byte-identical tables) and plain PyTorch versions of ``_funnel_shift``,
``extract_windows2``, ``window_valid2``, ``keys2_to_keys4`` and
``_hash_lookup_flat`` (:98-268, :438-455).

``wire_lookup`` is the hand-written kernel that replaces those five XLA
programs as ``query/device.py::_wire_epoch_core`` composes them; its source
is ``csrc/wire_lookup.cu``.  The plain versions carry uint32 words as int64
masked to 32 bits (see ``_u32``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .._u32 import MASK32, mul32, np_words, to_u64
from ..kmer.packing import boss_priority_order

BUCKET = 16  # slots per bucket; bucket row = BUCKET * (W + 1) uint32 words

_HASH_C = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
           0x165667B1, 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)

EMPTY_WORD = np.uint32(0xFFFFFFFF)


def _ceil_div(a, b):
    return -(-a // b)


# --------------------------------------------------------------------------
# host packers
# --------------------------------------------------------------------------

def pack_codes32(chars: np.ndarray,
                 order: np.ndarray | None = None) -> np.ndarray:
    """(N, K) uint8 codes < 16 -> (N, ceil(K/8)) uint32 nibble words, the
    first code of each word in its top slot (the DNA-family layout)."""
    chars = np.asarray(chars)
    if chars.ndim == 1:
        chars = chars[None, :]
    if order is not None:
        chars = chars[:, order]
    N, K = chars.shape
    out = np.zeros((N, _ceil_div(K, 8)), dtype=np.uint32)
    for j in range(K):
        w, slot = divmod(j, 8)
        out[:, w] |= chars[:, j].astype(np.uint32) << np.uint32(28 - 4 * slot)
    return out


def pack_kmers32(chars: np.ndarray) -> np.ndarray:
    """Edge k-mer code rows -> nibble keys in BOSS comparison order (the
    hash index's key layout)."""
    return pack_codes32(chars, boss_priority_order(chars.shape[1]))


def pack_kmers2(chars: np.ndarray) -> np.ndarray:
    """(N, K) DNA codes 1..4 -> (N, 2) uint32 2-bit wire-order keys: bit 2i
    holds char i's code - 1, little-endian across the two words (the layout
    ``tile_pack2`` puts on the wire).  2 <= K <= 31."""
    chars = np.asarray(chars)
    N, K = chars.shape
    if not 2 <= K <= 31:
        raise ValueError(f"pack_kmers2 needs 2 <= K <= 31, got {K}")
    out = np.zeros((N, 2), dtype=np.uint32)
    c = (chars.astype(np.uint32) - 1) & np.uint32(3)
    for i in range(K):
        out[:, i >> 4] |= c[:, i] << np.uint32(2 * (i & 15))
    return out


# --------------------------------------------------------------------------
# hash index
# --------------------------------------------------------------------------

def _hash_words(words, n_buckets: int, salt: int):
    """32-bit multiplicative hash of multiword keys -> bucket id.

    numpy uint32 words give int32 buckets (the host builder); torch int64
    words holding uint32 values give int64 buckets (the plain lookup)."""
    W = words.shape[-1]
    if isinstance(words, np.ndarray):
        h = np.uint32(salt)
        for w in range(W):
            c = _HASH_C[w % len(_HASH_C)]
            h = (np.uint32(h) ^ (words[..., w] * np.uint32(c))).astype(
                np.uint32)
            h = (h * np.uint32(0x9E3779B1)).astype(np.uint32)
            h = h ^ (h >> np.uint32(15))
        return (h % np.uint32(n_buckets)).astype(np.int32)
    h = torch.full(words.shape[:-1], salt, dtype=torch.int64,
                   device=words.device)
    for w in range(W):
        h = mul32(h ^ mul32(words[..., w], _HASH_C[w % len(_HASH_C)]),
                  0x9E3779B1)
        h = h ^ (h >> 15)
    return h % n_buckets


@dataclass
class DeviceHashIndex:
    """Single-probe bucketed hash table over packed k-mers: bucket b is one
    row of BUCKET slots x (W key words + id); empty slots hold EMPTY_WORD.
    ``table`` holds the uint32 words as int32 bit patterns."""

    table: torch.Tensor    # (n_buckets, BUCKET * (W + 1)) int32

    @classmethod
    def from_table(cls, table: np.ndarray, device) -> "DeviceHashIndex":
        table = np.asarray(table, dtype=np.uint32)
        if table.ndim != 2 or table.shape[1] % BUCKET:
            raise ValueError(f"bad hash table shape {table.shape}")
        return cls(np_words(table).to(device))

    @staticmethod
    def build_table(keys: np.ndarray, ids: np.ndarray,
                    load: float = 0.45) -> np.ndarray:
        """(N, W) uint32 keys + (N,) ids -> (n_buckets, BUCKET*(W+1)) uint32,
        byte-identical to metagraph_tpu's DeviceHashIndex.from_packed."""
        N, W = keys.shape
        ids = np.asarray(ids, dtype=np.uint32)
        n_buckets = max(2, int(2 ** np.ceil(np.log2(max(N, 1)
                                                    / (BUCKET * load)))))
        while True:
            table = DeviceHashIndex._build(keys, ids, n_buckets)
            if table is not None:
                return table.reshape(n_buckets, BUCKET * (W + 1))
            n_buckets *= 2

    @staticmethod
    def _build(keys, ids, n_buckets):
        N, W = keys.shape
        table = np.full((n_buckets, BUCKET, W + 1), EMPTY_WORD,
                        dtype=np.uint32)
        fill = np.zeros(n_buckets, dtype=np.int32)
        remaining = np.arange(N)
        h = _hash_words(keys, n_buckets, 1)
        # stable first-come placement per bucket, vectorised in rounds
        for _ in range(BUCKET):
            if remaining.size == 0:
                break
            hh = h[remaining]
            order = np.argsort(hh, kind="stable")
            s = hh[order]
            first = np.ones(len(s), dtype=bool)
            first[1:] = s[1:] != s[:-1]
            cand = order[first]
            b = hh[cand]
            ok = fill[b] < BUCKET
            cand, b = cand[ok], b[ok]
            table[b, fill[b], :W] = keys[remaining[cand]]
            table[b, fill[b], W] = ids[remaining[cand]]
            fill[b] += 1
            placed = np.zeros(len(remaining), dtype=bool)
            placed[cand] = True
            remaining = remaining[~placed]
        if remaining.size:
            return None     # a bucket overflowed: grow the directory, retry
        return table


# --------------------------------------------------------------------------
# plain PyTorch versions (int64 words holding uint32 values)
# --------------------------------------------------------------------------

def _funnel_shift(words: torch.Tensor, s: int) -> torch.Tensor:
    """(..., NW) bitstream >> s across word boundaries (0 <= s <= 31); bits
    past the last word read as 0."""
    if s == 0:
        return words
    nxt = torch.cat([words[..., 1:], torch.zeros_like(words[..., :1])], -1)
    return (words >> s) | ((nxt << (32 - s)) & MASK32)


def _key_masks(K: int):
    mask_lo = MASK32 if K >= 16 else (1 << (2 * K)) - 1
    mask_hi = (1 << max(2 * K - 32, 0)) - 1
    return mask_lo, mask_hi


def extract_windows2(words: torch.Tensor, K: int, T: int) -> torch.Tensor:
    """(C, NW) 2-bit code stream -> (C, T, 2) window keys: window j's key is
    bits [2j, 2j+2K) of the stream.  Needs NW >= ceil(T/16) + 2."""
    C, NW = words.shape
    if NW < _ceil_div(T, 16) + 2:
        raise ValueError(f"extract_windows2 needs NW >= {_ceil_div(T, 16) + 2}"
                         f", got {NW}")
    j = torch.arange(T, device=words.device)
    g, sh = j >> 4, 2 * (j & 15)
    mask_lo, mask_hi = _key_masks(K)
    w0, w1, w2 = words[:, g], words[:, g + 1], words[:, g + 2]
    lo = ((w0 >> sh) | ((w1 << (32 - sh)) & MASK32)) & mask_lo
    hi = ((w1 >> sh) | ((w2 << (32 - sh)) & MASK32)) & mask_hi
    return torch.stack([lo, hi], dim=-1)


def window_valid2(vwords: torch.Tensor, K: int, T: int) -> torch.Tensor:
    """(C, NV) per-char valid bits -> (C, T) bool: window j is valid iff
    bits j .. j+K-1 are all set, as an AND of funnel shifts in log2(K)
    steps.  T must be a multiple of 32."""
    if T % 32:
        raise ValueError(f"window_valid2 needs T % 32 == 0, got {T}")
    pows = {1: vwords}
    p, ln = vwords, 1
    while ln * 2 <= K:
        p = p & _funnel_shift(p, ln)
        ln *= 2
        pows[ln] = p
    acc, off, rem = p, ln, K - ln
    while rem:
        b = 1 << (rem.bit_length() - 1)
        acc = acc & _funnel_shift(pows[b], off)
        off += b
        rem -= b
    shifts = torch.arange(32, device=vwords.device)
    bits = (acc[:, : T // 32, None] >> shifts) & 1
    return bits.reshape(acc.shape[0], T).bool()


def keys2_to_keys4(keys2: torch.Tensor, K: int) -> torch.Tensor:
    """(..., 2) 2-bit wire keys -> (..., ceil(K/8)) nibble keys in BOSS
    priority order: characters K-2 .. 0, then K-1."""
    lo, hi = keys2[..., 0], keys2[..., 1]
    words = []
    for w in range(_ceil_div(K, 8)):
        acc = torch.zeros_like(lo)
        for slot in range(8):
            p = w * 8 + slot
            if p >= K:
                break
            j = (K - 2 - p) if p < K - 1 else (K - 1)
            ch = (((lo if j < 16 else hi) >> ((2 * j) & 31)) & 3) + 1
            acc = acc | (ch << (28 - 4 * slot))
        words.append(acc)
    return torch.stack(words, dim=-1)


def _hash_lookup_flat(table: torch.Tensor, queries: torch.Tensor,
                      W: int) -> torch.Tensor:
    """(n_buckets, BUCKET*(W+1)) int32 table, (Q, W) keys -> (Q,) int32 ids
    (0 = miss): one bucket row per query, the id of the matching slot."""
    Q = queries.shape[0]
    b = _hash_words(queries, table.shape[0], 1)
    rows = to_u64(table[b]).reshape(Q, BUCKET, W + 1)
    eq = torch.all(rows[:, :, :W] == queries[:, None, :], dim=-1)
    ids = torch.where(eq, rows[:, :, W], 0).amax(dim=-1)
    return torch.where(eq.any(dim=-1), ids, 0).to(torch.int32)


def wire_lookup_plain(words: torch.Tensor, vwords: torch.Tensor,
                      table: torch.Tensor, K: int, T: int,
                      chunk: int = 1024) -> torch.Tensor:
    """Plain version of kernel 1, ``chunk`` tiles at a time."""
    W = table.shape[1] // BUCKET - 1
    out = []
    for lo in range(0, words.shape[0], chunk):
        wd = to_u64(words[lo: lo + chunk])
        vw = to_u64(vwords[lo: lo + chunk])
        C = wd.shape[0]
        keys = extract_windows2(wd, K, T).reshape(C * T, 2)
        nodes = _hash_lookup_flat(table, keys2_to_keys4(keys, K), W)
        valid = window_valid2(vw, K, T)
        out.append(torch.where(valid, nodes.reshape(C, T), 0))
    if not out:
        return torch.zeros((0, T), dtype=torch.int32, device=words.device)
    return torch.cat(out)


# --------------------------------------------------------------------------
# kernel 1
# --------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _check_words(name: str, t: torch.Tensor, device: torch.device):
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D int32 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def wire_lookup(words: torch.Tensor, vwords: torch.Tensor,
                table: torch.Tensor, K: int, T: int) -> torch.Tensor:
    """(N, NW) 2-bit wire words, (N, NV) valid words, hash table ->
    (N, T) int32 node ids (0 = miss).  All int32 bit patterns of uint32.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/wire_lookup.cu`` or raises."""
    dev = words.device
    for name, t in (("words", words), ("vwords", vwords), ("table", table)):
        _check_words(name, t, dev)
    N, NW = words.shape
    W = table.shape[1] // BUCKET - 1
    if not 2 <= K <= 31 or W != _ceil_div(K, 8) \
            or table.shape[1] != BUCKET * (W + 1):
        raise ValueError(f"table shape {tuple(table.shape)} does not fit K={K}")
    if T % 32 or not 32 <= T <= 1024 or NW < _ceil_div(T, 16) + 2 \
            or vwords.shape[0] != N or vwords.shape[1] * 32 < T:
        raise ValueError(f"bad tile layout: T={T} words {tuple(words.shape)} "
                         f"vwords {tuple(vwords.shape)}")
    if dev.type == "cpu":
        return wire_lookup_plain(words, vwords, table, K, T)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nodes = torch.empty((N, T), dtype=torch.int32, device=dev)
    if N == 0:
        return nodes
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    fn = _build.function("wire_lookup", "mg_wire_lookup",
                         [_P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _P])
    _build.check(fn(words.data_ptr(), vwords.data_ptr(), table.data_ptr(),
                    nodes.data_ptr(), N, NW, vwords.shape[1], table.shape[0],
                    K, T, torch.cuda.current_stream(dev).cuda_stream),
                 "wire_lookup")
    wire_lookup.launches += 1
    return nodes


wire_lookup.launches = 0
