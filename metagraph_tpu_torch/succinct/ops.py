"""The k-mer hash index and its probe kernels.

Own copies of metagraph_tpu/succinct/ops.py: the host packers
``pack_codes32``/``pack_kmers32``/``pack_kmers2`` (:49-95, 4-bit and 8-bit
codes), ``_hash_words`` (:345-360, numpy and torch), the
``DeviceHashIndex`` builder (:389-431, ``from_packed``: byte-identical
tables) and its ``lookup``, and plain
PyTorch versions of ``_funnel_shift``, ``extract_windows2``,
``window_valid2``, ``keys2_to_keys4``, ``_hash_lookup_flat`` and
``device_pack_windows`` (:98-268, :438-490), and of the canonical key ops
``_rev2_word``, ``rc_keys2``, ``boss_rot2`` and ``keys2_greater``
(:112-177).

``hash_lookup`` is ``DeviceHashIndex.lookup``: kernel A on every key but
the all-EMPTY_WORD padding rows of the JAX batches, which get the JAX
probe's answer (``sentinel_answer``).

Three hand-written kernels probe the table:

* ``wire_lookup`` (``csrc/wire_lookup.cu``) replaces the XLA programs that
  ``query/device.py::_wire_epoch_core`` composes from 2-bit wire words, for
  basic (canon 0), canonical (canon 1) and primary graphs seen through
  ``CanonicalDBG`` (canon 2), 2 <= K <= 31;
* ``key_lookup`` (``csrc/key_lookup.cu``) replaces
  ``DeviceHashIndex.lookup`` -> ``_hash_lookup_flat`` on packed 4-bit or
  8-bit keys of any width: a thread a key up to ``STATIC_KEY_WORDS``
  words, a warp a key past it;
* ``codes_lookup`` (``csrc/codes_lookup.cu``) replaces the front end of
  ``query/device.py::query_epoch_codes2``: 2-bit code tiles ->
  ``device_pack_windows`` -> ``_hash_lookup_flat``, for any K (a thread a
  window up to K = 136, a warp a window past it).

The plain versions carry uint32 words as int64 masked to 32 bits (see
``_u32``).
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

def key_words(K: int, bits: int = 4) -> int:
    """uint32 words of a packed K-mer key with ``bits`` bits a code."""
    if bits not in (4, 8):
        raise ValueError(f"keys pack 4 or 8 bits a code, not {bits}")
    return _ceil_div(K, 32 // bits)


def pack_codes32(chars: np.ndarray, order: np.ndarray | None = None,
                 bits: int = 4) -> np.ndarray:
    """(N, K) uint8 codes -> (N, key_words(K, bits)) uint32 words, ``bits``
    bits a code (4: 8 codes a word, the DNA family; 8: 4 codes a word,
    Protein), the first code of each word in its top slot."""
    chars = np.asarray(chars)
    if chars.ndim == 1:
        chars = chars[None, :]
    if order is not None:
        chars = chars[:, order]
    N, K = chars.shape
    per = 32 // bits
    out = np.zeros((N, key_words(K, bits)), dtype=np.uint32)
    for j in range(K):
        w, slot = divmod(j, per)
        out[:, w] |= chars[:, j].astype(np.uint32) \
            << np.uint32(32 - bits - bits * slot)
    return out


def pack_kmers32(chars: np.ndarray, bits: int = 4) -> np.ndarray:
    """Edge k-mer code rows -> keys in BOSS comparison order (the hash
    index's key layout)."""
    return pack_codes32(chars, boss_priority_order(chars.shape[1]), bits)


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

    @property
    def W(self) -> int:
        """Key words."""
        return self.table.shape[1] // BUCKET - 1

    @classmethod
    def from_table(cls, table: np.ndarray, device) -> "DeviceHashIndex":
        table = np.asarray(table, dtype=np.uint32)
        if table.ndim != 2 or table.shape[1] % BUCKET:
            raise ValueError(f"bad hash table shape {table.shape}")
        return cls(np_words(table).to(device))

    @classmethod
    def from_packed(cls, keys: np.ndarray, ids: np.ndarray,
                    load: float = 0.45, device=None) -> "DeviceHashIndex":
        """(N, W) uint32 keys + (N,) ids -> the index on ``device`` (the
        card unless "cpu"), its table the bytes of the JAX
        ``DeviceHashIndex.from_packed`` (ops.py:390-403)."""
        from ..device import resolve_device
        return cls.from_table(cls.build_table(keys, ids, load),
                              resolve_device(device))

    def lookup(self, queries: torch.Tensor) -> torch.Tensor:
        """(Q, W) int32 keys -> (Q,) int32 ids: ``hash_lookup``."""
        return hash_lookup(self.table, queries)

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
        """The JAX package places keys in rounds, each bucket's first
        remaining key (in input order) at its next slot: a key's slot is
        its rank among its bucket's keys in input order, which one stable
        sort by bucket gives.  None where a bucket holds more than BUCKET
        keys."""
        N, W = keys.shape
        h = _hash_words(keys, n_buckets, 1)
        counts = np.bincount(h, minlength=n_buckets)
        if N and counts.max() > BUCKET:
            return None     # a bucket overflowed: grow the directory, retry
        order = np.argsort(h, kind="stable")
        b = h[order]
        slot = np.arange(N) - (np.cumsum(counts) - counts)[b]
        table = np.full((n_buckets, BUCKET, W + 1), EMPTY_WORD,
                        dtype=np.uint32)
        table[b, slot, :W] = keys[order]
        table[b, slot, W] = ids[order]
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


def _rev2_word(w: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 16 2-bit groups within each uint32."""
    w = ((w & 0xFFFF0000) >> 16) | ((w & 0x0000FFFF) << 16)
    w = ((w & 0xFF00FF00) >> 8) | ((w & 0x00FF00FF) << 8)
    w = ((w & 0xF0F0F0F0) >> 4) | ((w & 0x0F0F0F0F) << 4)
    return ((w & 0xCCCCCCCC) >> 2) | ((w & 0x33333333) << 2)


def rc_keys2(keys: torch.Tensor, K: int) -> torch.Tensor:
    """Reverse complement of (..., 2) 2-bit wire keys: complement (NOT, as
    A/T and C/G pair across the 2-bit code), reverse the 32 groups of the
    64-bit key (word-wise reversal plus a word swap), realign by 64 - 2K
    bits.  2 <= K <= 31."""
    lo = ~keys[..., 0] & MASK32
    hi = ~keys[..., 1] & MASK32
    rlo, rhi = _rev2_word(hi), _rev2_word(lo)
    s = 64 - 2 * K
    if s >= 32:
        out_lo, out_hi = rhi >> (s - 32), torch.zeros_like(rhi)
    else:
        out_lo = ((rlo >> s) | (rhi << (32 - s))) & MASK32
        out_hi = rhi >> s
    mask_lo, mask_hi = _key_masks(K)
    return torch.stack([out_lo & mask_lo, out_hi & mask_hi], dim=-1)


def boss_rot2(keys: torch.Tensor, K: int):
    """(..., 2) wire keys -> (lo, hi) surrogates whose integer order is BOSS
    priority order (chars K-2 .. 0, then K-1): a 2-bit rotate left within
    the 2K-bit key."""
    lo, hi = keys[..., 0], keys[..., 1]
    top2 = (hi >> (2 * K - 34)) & 3 if 2 * K - 2 >= 32 \
        else (lo >> (2 * K - 2)) & 3
    mask_lo, mask_hi = _key_masks(K)
    rlo = ((lo << 2) | top2) & mask_lo
    rhi = ((hi << 2) | (lo >> 30)) & mask_hi
    return rlo, rhi


def keys2_greater(a: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """a > b in BOSS priority order, for (..., 2) wire keys."""
    alo, ahi = boss_rot2(a, K)
    blo, bhi = boss_rot2(b, K)
    return (ahi > bhi) | ((ahi == bhi) & (alo > blo))


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


def check_slot_fill(table: np.ndarray, chunk: int = 1 << 20):
    """Raise ValueError unless every bucket row of the (n_buckets,
    BUCKET*(W+1)) uint32 ``table`` fills its slots from slot 0 with no gap
    (no occupied slot after an empty one), as ``_build`` places them.
    Kernel 1 stops each probe at the first slot group holding its key or
    an empty slot, which is exact only on such tables.  A slot is empty iff
    its first key word is EMPTY_WORD (a real key's codes stay below 15 at
    4 bits and below 255 at 8 bits, so no key word is all ones)."""
    n_buckets, row = table.shape
    for lo in range(0, n_buckets, chunk):
        empty = table[lo: lo + chunk].reshape(-1, BUCKET, row // BUCKET)[
            :, :, 0] == EMPTY_WORD
        gap = empty[:, :-1] & ~empty[:, 1:]
        if gap.any():
            b = lo + int(np.flatnonzero(gap.any(axis=1))[0])
            raise ValueError(f"hash table bucket {b} has an occupied slot "
                             "after an empty one: slots must fill from 0")


def probe_groups(table: torch.Tensor, queries: torch.Tensor, W: int):
    """(n_buckets, BUCKET*(W+1)) int32 table, (Q, W) keys -> ((Q,) bucket
    ids, (Q,) groups read): how many 4-slot groups of its bucket row a probe
    reads when it stops after the group that holds its key or an empty
    slot (1 to BUCKET // 4), the rule of kernel 1."""
    Q = queries.shape[0]
    b = _hash_words(queries, table.shape[0], 1)
    rows = to_u64(table[b]).reshape(Q, BUCKET, W + 1)
    stop = torch.all(rows[:, :, :W] == queries[:, None, :], dim=-1) \
        | (rows[:, :, 0] == int(EMPTY_WORD))
    # argmax returns the first maximum; a row with no stop reads every group
    slot = torch.where(stop.any(dim=-1), stop.to(torch.int8).argmax(dim=-1),
                       BUCKET - 1)
    return b, slot // 4 + 1


def wire_lookup_plain(words: torch.Tensor, vwords: torch.Tensor,
                      table: torch.Tensor, K: int, T: int,
                      chunk: int = 1024, canon: int = 0,
                      offset: int = 0) -> torch.Tensor:
    """Plain version of kernel 1, ``chunk`` tiles at a time.

    canon 0 probes each valid window's key; canon 1 (canonical graph)
    probes the smaller of the key and its reverse complement in BOSS order;
    canon 2 (primary graph) probes the key and, where that misses, its
    reverse complement, whose hit is emitted as id + ``offset``."""
    W = table.shape[1] // BUCKET - 1
    out = []
    for lo in range(0, words.shape[0], chunk):
        wd = to_u64(words[lo: lo + chunk])
        vw = to_u64(vwords[lo: lo + chunk])
        C = wd.shape[0]
        keys = extract_windows2(wd, K, T).reshape(C * T, 2)
        if canon == 1:
            rck = rc_keys2(keys, K)
            keys = torch.where(keys2_greater(keys, rck, K)[:, None], rck,
                               keys)
        nodes = _hash_lookup_flat(table, keys2_to_keys4(keys, K), W)
        if canon == 2:
            rc = _hash_lookup_flat(
                table, keys2_to_keys4(rc_keys2(keys, K), K), W)
            nodes = torch.where(nodes > 0, nodes,
                                torch.where(rc > 0, rc + offset, 0))
        valid = window_valid2(vw, K, T)
        out.append(torch.where(valid, nodes.reshape(C, T), 0))
    if not out:
        return torch.zeros((0, T), dtype=torch.int32, device=words.device)
    return torch.cat(out)


def key_lookup_plain(keys: torch.Tensor, table: torch.Tensor,
                     chunk: int = 1 << 16) -> torch.Tensor:
    """Plain version of kernel A: (Q, W) int32 key words -> (Q,) int32 ids
    (0 = miss), ``chunk`` keys at a time."""
    W = keys.shape[1]
    out = [_hash_lookup_flat(table, to_u64(keys[lo: lo + chunk]), W)
           for lo in range(0, keys.shape[0], chunk)]
    return torch.cat(out) if out else \
        torch.zeros(0, dtype=torch.int32, device=keys.device)


def device_pack_windows(codes: torch.Tensor, K: int):
    """(B, L) codes -> ((B, L-K+1, ceil(K/8)) nibble window keys in BOSS
    priority order (chars K-2 .. 0, then K-1; int64 holding uint32 words),
    (B, L-K+1) valid): a code >= 5 invalidates every window it falls in
    and packs as 0."""
    B, L = codes.shape
    n_win = L - K + 1
    codes = codes.to(torch.int64)
    bad = (codes >= 5).to(torch.int64).cumsum(dim=1)
    bad = torch.cat([torch.zeros_like(bad[:, :1]), bad], dim=1)
    valid = (bad[:, K:] - bad[:, :-K]) == 0
    safe = torch.where(codes >= 5, 0, codes)
    words = []
    for w in range(_ceil_div(K, 8)):
        acc = torch.zeros((B, n_win), dtype=torch.int64, device=codes.device)
        for slot in range(min(8, K - 8 * w)):
            p = w * 8 + slot
            off = (K - 2 - p) if p < K - 1 else (K - 1)
            acc |= safe[:, off: off + n_win] << (28 - 4 * slot)
        words.append(acc)
    return torch.stack(words, dim=-1), valid


def codes_lookup_plain(packed2: torch.Tensor, validb: torch.Tensor,
                       table: torch.Tensor, K: int, T: int,
                       chunk: int = 256) -> torch.Tensor:
    """Plain version of kernel B, ``chunk`` tiles at a time, as
    query_epoch_codes2's body computes it: unpack the 2-bit codes and the
    valid bits of TK = T + K - 1 positions (valid ? code + 1 : 5), pack
    every window, probe, and zero the invalid windows."""
    W = table.shape[1] // BUCKET - 1
    out = []
    for lo in range(0, packed2.shape[0], chunk):
        packed, valid = device_pack_windows(
            tile_codes(packed2[lo: lo + chunk], validb[lo: lo + chunk],
                       T + K - 1), K)
        C = packed.shape[0]
        nodes = _hash_lookup_flat(table, packed.reshape(C * T, W), W)
        out.append(torch.where(valid, nodes.reshape(C, T), 0))
    return torch.cat(out) if out else \
        torch.zeros((0, T), dtype=torch.int32, device=packed2.device)


def tile_codes(packed2: torch.Tensor, validb: torch.Tensor,
               TK: int) -> torch.Tensor:
    """(C, TKp/4) 2-bit code bytes and (C, ceil(TK/8)) valid bytes ->
    (C, TK) int64 codes: code + 1 where valid, else 5."""
    dev = packed2.device
    C = packed2.shape[0]
    c4 = ((packed2.to(torch.int64)[..., None]
           >> torch.arange(0, 8, 2, device=dev)) & 3).reshape(C, -1)[:, :TK]
    v8 = ((validb.to(torch.int64)[..., None]
           >> torch.arange(8, device=dev)) & 1).reshape(C, -1)[:, :TK]
    return torch.where(v8 == 1, c4 + 1, 5)


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
                table: torch.Tensor, K: int, T: int, canon: int = 0,
                offset: int = 0) -> torch.Tensor:
    """(N, NW) 2-bit wire words, (N, NV) valid words, hash table ->
    (N, T) int32 node ids (0 = miss).  All int32 bit patterns of uint32.
    ``canon`` and ``offset`` as in ``wire_lookup_plain``; ``offset`` plus
    the largest id in the table must stay below 2^31.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/wire_lookup.cu`` or raises.  The kernel stops each probe at the
    first 4-slot group holding the key or an empty slot, so ``table`` must
    fill its slots from slot 0 (``check_slot_fill``), as the builders do."""
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
    if canon not in (0, 1, 2) or not 0 <= offset < 2 ** 31 \
            or (offset and canon != 2):
        raise ValueError(f"bad canon {canon} / offset {offset}: an offset "
                         "belongs to canon 2 only")
    if dev.type == "cpu":
        return wire_lookup_plain(words, vwords, table, K, T, canon=canon,
                                 offset=offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nodes = torch.empty((N, T), dtype=torch.int32, device=dev)
    if N == 0:
        return nodes
    if table.data_ptr() % 16 or table.shape[0] >= 2 ** 31 \
            or N * T + 256 >= 2 ** 31:
        raise ValueError("the kernel needs a 16-byte aligned table of fewer "
                         "than 2^31 buckets and fewer than 2^31 - 256 "
                         "windows")
    # canon 2 scratch: the list of forward misses and its length
    scratch = [None, None]
    if canon == 2:
        scratch = [torch.empty(N * T, dtype=torch.int32, device=dev),
                   torch.zeros(1, dtype=torch.int32, device=dev)]
    fn = _build.function("wire_lookup", "mg_wire_lookup",
                         [_P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _I, _I,
                          _P, _P, _P])
    _build.check(fn(words.data_ptr(), vwords.data_ptr(), table.data_ptr(),
                    nodes.data_ptr(), N, NW, vwords.shape[1], table.shape[0],
                    K, T, canon, offset,
                    *[t if t is None else t.data_ptr() for t in scratch],
                    torch.cuda.current_stream(dev).cuda_stream),
                 "wire_lookup")
    # canon 2 runs two kernels: forward probes, then the misses' rc probes
    _build.count(wire_lookup, 2 if canon == 2 else 1)
    return nodes


wire_lookup.launches = 0


# --------------------------------------------------------------------------
# kernels A and B
# --------------------------------------------------------------------------

STATIC_KEY_WORDS = 17  # kernel A's block form; wider keys take a warp a key
# the dynamic shared memory a block may ask for on an H100 (227 KB)
MAX_DYNAMIC_SMEM = 232_448


def _check_table(table: torch.Tensor):
    if table.data_ptr() % 16 or table.shape[0] >= 2 ** 31:
        raise ValueError("the kernels need a 16-byte aligned table of fewer "
                         "than 2^31 buckets")


def key_lookup(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(Q, W) packed keys (int32 bit patterns of the uint32 words, 4 or 8
    bits a code), (n_buckets, BUCKET * (W + 1)) table -> (Q,) int32 ids
    (0 = miss): ``DeviceHashIndex.lookup``.  A key is never all EMPTY_WORD,
    so callers pass no padding.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/key_lookup.cu`` or raises.  The kernel stops each probe at the
    first 4-slot group holding the key or an empty slot, so ``table`` must
    fill its slots from slot 0 (``check_slot_fill``)."""
    dev = keys.device
    _check_words("keys", keys, dev)
    _check_words("table", table, dev)
    Q, W = keys.shape
    if table.shape[1] != BUCKET * (W + 1):
        raise ValueError(f"table shape {tuple(table.shape)} does not fit "
                         f"keys of {W} words")
    if dev.type == "cpu":
        return key_lookup_plain(keys, table)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return out
    if W < 1:
        raise ValueError("keys need at least one word")
    _check_table(table)
    fn = _build.function("key_lookup", "mg_key_lookup",
                         [_P, _P, _P, _L, _I, _L, _P])
    _build.check(fn(keys.data_ptr(), table.data_ptr(), out.data_ptr(), Q, W,
                    table.shape[0],
                    torch.cuda.current_stream(dev).cuda_stream),
                 "key_lookup")
    _build.count(key_lookup)
    return out


key_lookup.launches = 0


def sentinel_answer(table: torch.Tensor) -> int:
    """What the JAX probe (``_hash_lookup_flat``, ops.py:438-448) answers
    for the all-EMPTY_WORD key that pads its batches: every empty slot of
    that key's bucket matches it, and the max of their EMPTY_WORD ids is -1
    as int32; a bucket without an empty slot gives 0."""
    W = table.shape[1] // BUCKET - 1
    key = torch.full((1, W), int(EMPTY_WORD), dtype=torch.int64,
                     device=table.device)
    b = int(_hash_words(key, table.shape[0], 1)[0])
    row = table[b].view(BUCKET, W + 1)
    return -1 if bool((row == -1).all(dim=1).any()) else 0


def hash_lookup(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """``DeviceHashIndex.lookup`` / ``_hash_lookup`` (ops.py:433-452) of
    (Q, W) int32 keys that may hold the all-EMPTY_WORD padding row ->
    (Q,) int32 ids: kernel A (``key_lookup``) on the other keys, the JAX
    probe's ``sentinel_answer`` on the padding rows."""
    pad = (queries == -1).all(dim=1)
    if not bool(pad.any()):
        return key_lookup(queries, table)
    out = torch.full((queries.shape[0],), sentinel_answer(table),
                     dtype=torch.int32, device=queries.device)
    live = torch.nonzero(~pad).squeeze(1)
    out[live] = key_lookup(queries.index_select(0, live), table)
    return out


def codes_lookup(packed2: torch.Tensor, validb: torch.Tensor,
                 table: torch.Tensor, K: int, T: int) -> torch.Tensor:
    """(N, TKp/4) uint8 2-bit code tiles and (N, ceil(TK/8)) uint8 valid
    bits (``tile_pack2``'s layout, TK = T + K - 1), 4-bit table of
    ceil(K/8) key words -> (N, T) int32 ids (0 for a miss or an invalid
    window).

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/codes_lookup.cu`` or raises.  The probe stops as kernel A's."""
    dev = packed2.device
    for name, t in (("packed2", packed2), ("validb", validb)):
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D uint8 tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    _check_words("table", table, dev)
    N, PB = packed2.shape
    W = table.shape[1] // BUCKET - 1
    TK = T + K - 1
    if K < 2 or W != _ceil_div(K, 8) or table.shape[1] != BUCKET * (W + 1):
        raise ValueError(f"table shape {tuple(table.shape)} does not fit K={K}")
    if T % 32 or not 32 <= T <= 1024 or PB * 4 < TK \
            or validb.shape[0] != N or validb.shape[1] * 8 < TK:
        raise ValueError(f"bad tile layout: T={T}, K={K}, packed2 "
                         f"{tuple(packed2.shape)}, validb "
                         f"{tuple(validb.shape)}")
    if dev.type == "cpu":
        return codes_lookup_plain(packed2, validb, table, K, T)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nodes = torch.empty((N, T), dtype=torch.int32, device=dev)
    if N == 0:
        return nodes
    _check_table(table)
    if N >= 2 ** 31:
        raise ValueError(f"{N} tiles: the grid takes fewer than 2^31")
    if K > 136:
        smem = _build.function("codes_lookup", "mg_codes_lookup_smem",
                               [_I, _I], ctypes.c_int64)(T, K)
        if smem > MAX_DYNAMIC_SMEM:
            raise ValueError(f"K={K}: a tile's stage needs {smem} bytes of "
                             f"shared memory, past {MAX_DYNAMIC_SMEM}")
    fn = _build.function("codes_lookup", "mg_codes_lookup",
                         [_P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _P])
    _build.check(fn(packed2.data_ptr(), validb.data_ptr(), table.data_ptr(),
                    nodes.data_ptr(), N, PB, validb.shape[1], table.shape[0],
                    K, T, torch.cuda.current_stream(dev).cuda_stream),
                 "codes_lookup")
    _build.count(codes_lookup)
    return nodes


codes_lookup.launches = 0
