"""Device construction of the BOSS table (``build --device``).

Own copy of metagraph_tpu/succinct/device_build.py for the card:

* ``sort_kmers_device`` (:26), ``sort_kmers_device_with_counts`` (:43),
  ``_pad_pow2`` (:52), ``device_sort_unique`` (:63) and
  ``build_kmer_set_device`` (:90): multiword keys sorted a word at a time
  (last word first) by kernel D2's stable passes, deduped and counted;
* ``device_build_boss_arrays`` (:344): the whole BOSS edge stream of a
  DNA graph (3 <= k <= 21) built on the card from the 2-bit wire tiles of
  ``query/tile_pack.py``, with the host dummy-chain expansion of :385-403
  between its two device stages, ``build_p1`` (:179) and ``build_p2``
  (:242): of the forward windows (basic and primary mode), or of both
  strands (canonical mode, which the JAX package builds on its host:
  D1's strand mode, no dummy-node limit).

The device stages run on four hand-written kernels (``csrc/``), each with
a plain PyTorch version beside it; a wrapper takes the plain version for a
CPU tensor and launches its kernel, or raises, for a CUDA one:

* D1 ``build_windows`` (``build_windows.cu``): every window's 2-bit key,
  and in its strand mode the key of the window's reverse complement;
* D2 ``radix_sort`` (``radix_sort.cu``): a stable LSD radix sort over a
  key's live bits (one histogram launch, then one onesweep launch a pass
  whose digit does not hold every key in one bin), with an optional
  payload: every sort of the module, and of the host construction's rows
  (``kmer/packing.lexsort_rows``, a 64-bit pass set a word);
* D3 ``build_join`` / ``join_nodes`` (``build_join.cu``): dedupe, the join
  entries, then the dummy sink and level-1 source nodes of the sorted
  join;
* D4 ``emit_keys`` / ``build_emit`` (``build_emit.cu``): the unique
  rows' 3-bit BOSS keys, compacted, then W, last, valid and F of the
  sorted stream.

A key is one int64 where the TPU kept uint32 pairs: the wire key of an
edge has 2K <= 42 bits (sentinel 1 << 2K), the 3-bit key 3K <= 63.  The
3-bit stream holds the U + D real rows alone where the TPU padded it with
a sentinel row for every window that is not a distinct edge.  The TPU's
compact download buffers and the bucket sizes that bounded its recompiles
(``_bucket``, ``capd``, ``mcap``) have no counterpart; the rule that
refuses too many dummy sink or source nodes is kept (``capd_limit``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .._u32 import np_words, to_u64
from ..device import resolve_device
from ..kmer import packing as _packing
from ..query.device import wire_words_layout
from ..query.tile_pack import tile_pack2
from ..utils.timer import PhaseTimer
from .ops import extract_windows2, pack_kmers32, window_valid2

_P, _I, _L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64

T_WIRE = 256                     # windows a wire tile (device_build.py:358)
_CAPD_DEFAULT = 1 << 13          # device_build.py:125
_MAX_N = (1 << 31) - 1           # keys a kernel takes


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_1d(name: str, t: torch.Tensor, dtypes, dev=None):
    if t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                         f"{' or '.join(str(d) for d in dtypes)}")
    if dev is not None and t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def _check_cuda(dev: torch.device, n: int):
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n > _MAX_N:
        raise ValueError(f"{n} keys: the kernels take fewer than 2^31")


# --------------------------------------------------------------------------
# D2: the stable radix sort
# --------------------------------------------------------------------------

RADIX_DIGIT_BITS = 8             # D2's digit width (csrc/radix_sort.cu)
# below this many keys D2 runs every digit's pass (and sorts the sentinel
# keys along: they sort last all the same), with no host sync: a sync
# costs more than the passes it could skip
RADIX_SYNC_MIN = 1 << 17


def radix_digits(bits: int, digit_bits: int = RADIX_DIGIT_BITS):
    """The digits of an LSD sort over ``bits`` bits: [(shift, width)],
    lowest first, each ``digit_bits`` wide but the last."""
    return [(s, min(digit_bits, bits - s)) for s in range(0, bits,
                                                          digit_bits)]


def radix_plan(bits: int, single, digit_bits: int = RADIX_DIGIT_BITS,
               partition: bool = False):
    """D2's pass plan -> (digits [(shift, width)], the digits' indices to
    run, in order).  ``single[p]``: digit p has one bin that holds every
    key, so its stable pass moves nothing and is skipped.  ``partition``
    (sentinel keys to move last) runs the last digit where no pass would
    run otherwise: a pass puts the sentinels last."""
    digits = radix_digits(bits, digit_bits)
    if len(single) != len(digits):
        raise ValueError(f"{len(single)} single-bin flags for "
                         f"{len(digits)} digits")
    run = [p for p, one in enumerate(single) if not one]
    if partition and not run:
        run = [len(digits) - 1]
    return digits, run


def radix_plan_of(keys: torch.Tensor, bits: int, sentinel=None,
                  digit_bits: int = RADIX_DIGIT_BITS):
    """``radix_plan`` for these keys as kernel D2 runs it: every digit
    below ``RADIX_SYNC_MIN`` keys, else the single-bin flags found from
    them (the keys equal to ``sentinel`` left out) as its histogram finds
    them."""
    if len(keys) < RADIX_SYNC_MIN:
        return radix_plan(bits, [False] * len(radix_digits(bits, digit_bits)),
                          digit_bits)
    live = keys if sentinel is None else keys[keys != sentinel]
    single = []
    for shift, width in radix_digits(bits, digit_bits):
        d = (live >> shift) & ((1 << width) - 1)
        single.append(live.numel() == 0 or bool((d == d[0]).all()))
    return radix_plan(bits, single, digit_bits,
                      partition=live.numel() < keys.numel())


def radix_sort(keys: torch.Tensor, bits: int,
               payload: torch.Tensor | None = None, *, sentinel=None):
    """(n,) int64 keys -> (keys, payload) sorted stably by the keys' low
    ``bits`` bits (1..64) as unsigned integers; ``payload`` (int32 or
    int64, or None) moves with its key.  Callers give keys below 2^bits
    where the order of the whole key matters.  ``sentinel``: a value the
    caller promises is the largest key under ``bits`` (no payload then):
    the other keys are sorted alone and the sentinels placed last, the
    same tensors as without it.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/radix_sort.cu`` or raises: one memset and one histogram kernel,
    the host reads the histograms back (one sync; not below
    ``RADIX_SYNC_MIN`` keys), then one kernel a pass of ``radix_plan_of``
    that runs."""
    dev = keys.device
    _check_1d("keys", keys, (torch.int64,))
    if payload is not None:
        _check_1d("payload", payload, (torch.int32, torch.int64), dev)
        if payload.shape != keys.shape:
            raise ValueError("payload and keys differ in length")
        if sentinel is not None:
            raise ValueError("sentinel= takes no payload")
    if not 1 <= bits <= 64:
        raise ValueError(f"bits must be 1..64, not {bits}")
    if dev.type == "cpu":
        return radix_sort_plain(keys, bits, payload, sentinel=sentinel)
    n = keys.shape[0]
    _check_cuda(dev, n)
    if n == 0:
        return keys.clone(), None if payload is None else payload.clone()
    if sentinel is not None and not -2 ** 63 <= int(sentinel) < 2 ** 63:
        raise ValueError(f"sentinel {sentinel} is no int64")
    drop = sentinel is not None and n >= RADIX_SYNC_MIN
    sent = int(sentinel) if drop else 0
    scratch = torch.empty(
        _build.function("radix_sort", "mg_radix_scratch", [_L],
                        ctypes.c_int64)(n),
        dtype=torch.int64, device=dev)
    hist_fn = _build.function("radix_sort", "mg_radix_hist",
                              [_P, _L, _I, _I, _L, _P, _P])
    stream = _stream(dev)
    _build.check(hist_fn(keys.data_ptr(), n, bits, int(drop), sent,
                         scratch.data_ptr(), stream), "radix_sort")
    _build.count(radix_sort, 2)                # the memset and the kernel
    digits = radix_digits(bits)
    m = n                                      # the keys sorted
    if n < RADIX_SYNC_MIN:
        run = list(range(len(digits)))
    else:                                      # one host sync a sort
        R = 1 << RADIX_DIGIT_BITS              # 8 rows of R bins, then
        hist = scratch.view(torch.int32)[: 8 * R + 1].cpu().numpy()  # drops
        m = n - int(hist[8 * R])
        single = [int(hist[p * R: (p + 1) * R].max()) == m
                  for p in range(len(digits))]
        _, run = radix_plan(bits, single, partition=m < n)
    if not run:
        return keys.clone(), None if payload is None else payload.clone()
    kbuf = [torch.empty_like(keys) for _ in range(min(2, len(run)))]
    pbuf = [None, None] if payload is None else \
        [torch.empty_like(payload) for _ in range(min(2, len(run)))]

    def ptr(t):
        return None if t is None else t.data_ptr()

    pass_fn = _build.function("radix_sort", "mg_radix_passes",
                              [_P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I,
                               _L, _P, _I, _P, _P])
    _build.check(pass_fn(
        keys.data_ptr(), kbuf[0].data_ptr(), ptr(kbuf[-1]), ptr(payload),
        ptr(pbuf[0]), ptr(pbuf[-1]),
        0 if payload is None else payload.element_size(), n, m, bits,
        int(drop), sent, (ctypes.c_int * len(run))(*run),
        len(run), scratch.data_ptr(), stream), "radix_sort")
    _build.count(radix_sort, len(run))
    last = (len(run) - 1) % 2
    return kbuf[last], pbuf[last]


radix_sort.launches = 0


def radix_sort_plain(keys: torch.Tensor, bits: int,
                     payload: torch.Tensor | None = None, *, sentinel=None):
    """Plain version of kernel D2: a stable ``torch.sort`` of the keys' low
    ``bits`` bits in unsigned order; with ``sentinel``, of the other keys,
    the sentinels appended."""
    if sentinel is not None:
        if payload is not None:
            raise ValueError("sentinel= takes no payload")
        live = keys != sentinel
        out, _ = radix_sort_plain(keys[live], bits)
        return torch.cat([out, keys.new_full((len(keys) - len(out),),
                                             sentinel)]), None
    if bits == 64:
        k = keys ^ torch.iinfo(torch.int64).min      # unsigned order
    else:
        k = keys & ((1 << bits) - 1)
    order = torch.sort(k, stable=True).indices
    return keys[order], None if payload is None else payload[order]


# --------------------------------------------------------------------------
# the multiword sort helpers (device_build.py:25-102)
# --------------------------------------------------------------------------

def sort_kmers_device(keys: torch.Tensor):
    """(N, W) uint32 keys (int32 bit patterns) -> (sorted keys, unique
    mask): rows in lexicographic word order (BOSS order for BOSS-packed
    keys), mask[i] iff row i differs from row i-1 (row 0 always).  A
    stable 32-bit D2 sort a word, the last word first."""
    N, W = keys.shape
    dev = keys.device
    perm = torch.arange(N, dtype=torch.int64, device=dev)
    for w in range(W - 1, -1, -1):
        col = to_u64(keys[:, w]).index_select(0, perm)
        _, perm = radix_sort(col, 32, perm)
    s = keys.index_select(0, perm)
    new = torch.ones(N, dtype=torch.bool, device=dev)
    if N > 1:
        new[1:] = (s[1:] != s[:-1]).any(dim=1)
    return s, new


def sort_kmers_device_with_counts(keys: torch.Tensor):
    """Also -> per-group multiplicities: counts[g] = the rows of group g
    (the g-th distinct key), 0 past the last group."""
    s, new = sort_kmers_device(keys)
    idx = torch.cumsum(new.to(torch.int64), 0) - 1
    counts = torch.bincount(idx, minlength=len(s)).to(torch.int32)
    return s, new, counts


def _pad_pow2(keys: np.ndarray) -> np.ndarray:
    """Pad rows to the next power of two with all-ones sentinel rows, which
    sort last and are dropped."""
    n = len(keys)
    target = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
    if target == n:
        return keys
    pad = np.full((target - n, keys.shape[1]), 0xFFFFFFFF, dtype=keys.dtype)
    return np.concatenate([keys, pad])


def device_sort_unique(keys: np.ndarray, with_counts: bool = False,
                       device=None):
    """(N, W) uint32 keys -> the sorted distinct keys (and their counts),
    sentinel rows (all 0xFFFFFFFF: padding, invalid windows) dropped: the
    sort and dedupe on the device, the compaction on the host."""
    if len(keys) == 0:
        return (keys, None) if with_counts else keys
    dev = resolve_device(device)
    keys = _pad_pow2(keys)
    d = np_words(keys).to(dev)
    if with_counts:
        s, new, counts = sort_kmers_device_with_counts(d)
        counts = counts.cpu().numpy()
    else:
        s, new = sort_kmers_device(d)
    s = s.cpu().numpy().view(np.uint32)
    new = new.cpu().numpy()
    valid = ~np.all(s == np.uint32(0xFFFFFFFF), axis=1)
    keep = new & valid
    if not with_counts:
        return s[keep]
    group_counts = counts[: int(new.sum())]
    gids = (np.cumsum(new) - 1)[keep]
    return s[keep], group_counts[gids]


def build_kmer_set_device(codes: np.ndarray, k: int, device=None):
    """Codes (with separators: a code above 4 breaks a window) -> sorted
    unique BOSS-packed k-mers (4-bit codes in uint32 words)."""
    wins = np.lib.stride_tricks.sliding_window_view(codes, k)
    bad = np.concatenate([[0], np.cumsum(codes > 4)])
    valid = (bad[k:] - bad[:-k]) == 0
    keys = np.full((len(wins), (k + 7) // 8), 0xFFFFFFFF, dtype=np.uint32)
    keys[valid] = pack_kmers32(wins[valid])
    return device_sort_unique(keys, device=device)


# --------------------------------------------------------------------------
# D1: window keys
# --------------------------------------------------------------------------

def _sent2(K: int) -> int:
    return 1 << (2 * K)


def _check_scope(K: int):
    if not 3 <= K <= 21:
        raise ValueError(f"the device construction takes 3 <= k <= 21, "
                         f"not {K}")


def build_windows(words: torch.Tensor, vwords: torch.Tensor, K: int,
                  T: int = T_WIRE, strands: int = 1) -> torch.Tensor:
    """(N, NW) wire words and (N, NV) valid words (int32 bit patterns of
    ``wire_words_layout``'s uint32 words) -> (strands * N * T,) int64
    window keys: window j of tile n is bits [2j, 2j + 2K) of its stream
    where its K characters are valid, else the sentinel 1 << 2K; with
    ``strands`` 2, the keys of the windows' reverse complements follow
    (``rc_keys_plain``), the sentinel where the window is invalid.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/build_windows.cu`` or raises."""
    dev = words.device
    for name, t in (("words", words), ("vwords", vwords)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    _check_scope(K)
    if strands not in (1, 2):
        raise ValueError(f"strands must be 1 or 2, not {strands}")
    N, NW = words.shape
    if T % 32 or T < 32 or NW < T // 16 + 2 or vwords.shape[0] != N \
            or vwords.shape[1] * 32 < T + K - 1:
        raise ValueError(f"bad tile layout: T={T} words {tuple(words.shape)}"
                         f" vwords {tuple(vwords.shape)}")
    if dev.type == "cpu":
        return build_windows_plain(words, vwords, K, T, strands=strands)
    _check_cuda(dev, strands * N * T)
    out = torch.empty(strands * N * T, dtype=torch.int64, device=dev)
    if N == 0:
        return out
    fn = _build.function("build_windows", "mg_build_windows",
                         [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P])
    _build.check(fn(words.data_ptr(), vwords.data_ptr(), out.data_ptr(), N,
                    NW, vwords.shape[1], K, T, strands, _stream(dev)),
                 "build_windows")
    _build.count(build_windows)
    return out


build_windows.launches = 0


def rc_keys_plain(keys: torch.Tensor, K: int) -> torch.Tensor:
    """2-bit keys of K characters (character i at bits 2i) -> the keys of
    their reverse complements (character i = 3 - character K-1-i); the
    sentinel 1 << 2K stays."""
    rc = torch.zeros_like(keys)
    for i in range(K):
        rc |= (3 - ((keys >> (2 * i)) & 3)) << (2 * (K - 1 - i))
    return torch.where(keys == _sent2(K), keys, rc)


def build_windows_plain(words: torch.Tensor, vwords: torch.Tensor, K: int,
                        T: int = T_WIRE, chunk: int = 1 << 14,
                        strands: int = 1):
    """Plain version of kernel D1: ``extract_windows2`` and
    ``window_valid2``, ``chunk`` tiles at a time, then (``strands`` 2)
    ``rc_keys_plain`` of them."""
    out = []
    for lo in range(0, words.shape[0], chunk):
        kw = extract_windows2(to_u64(words[lo: lo + chunk]), K, T)
        valid = window_valid2(to_u64(vwords[lo: lo + chunk]), K, T)
        key = kw[..., 0] | (kw[..., 1] << 32)
        out.append(torch.where(valid, key, _sent2(K)).reshape(-1))
    keys = torch.cat(out) if out else \
        torch.zeros(0, dtype=torch.int64, device=words.device)
    return torch.cat([keys, rc_keys_plain(keys, K)]) if strands == 2 \
        else keys


# --------------------------------------------------------------------------
# D3: dedupe and the sort-join
# --------------------------------------------------------------------------

def build_join(skeys: torch.Tensor, K: int):
    """(n,) sorted wire keys (sentinels last) -> (uniq (n,) bool, the join
    entries J (2n,) int64, U): uniq where a key is no sentinel and differs
    from the one before it; U their count; J[i] = the source node of row i
    << 2 (tag 0), J[n + i] = its target node << 2 | 1, both the sentinel
    1 << 2K for a row that is not unique.

    A CPU tensor takes the plain version; a CUDA tensor launches the first
    kernel of ``csrc/build_join.cu`` or raises."""
    dev = skeys.device
    _check_1d("skeys", skeys, (torch.int64,))
    _check_scope(K)
    if dev.type == "cpu":
        return build_join_plain(skeys, K)
    n = skeys.shape[0]
    _check_cuda(dev, 2 * n)
    uniq = torch.empty(n, dtype=torch.bool, device=dev)    # 0/1 bytes
    J = torch.empty(2 * n, dtype=torch.int64, device=dev)
    U = torch.zeros(1, dtype=torch.int64, device=dev)
    if n:
        fn = _build.function("build_join", "mg_join_entries",
                             [_P, _L, _I, _P, _P, _P, _P])
        _build.check(fn(skeys.data_ptr(), n, K, uniq.data_ptr(),
                        J.data_ptr(), U.data_ptr(), _stream(dev)),
                     "build_join")
        _build.count(build_join)
    return uniq, J, int(U.item())


build_join.launches = 0


def build_join_plain(skeys: torch.Tensor, K: int):
    """Plain version of D3's first kernel."""
    sent = _sent2(K)
    prev = torch.cat([skeys.new_full((1,), -1), skeys[:-1]])
    uniq = (skeys != sent) & (skeys != prev)
    node_mask = (1 << (2 * (K - 1))) - 1
    J = torch.cat([torch.where(uniq, (skeys & node_mask) << 2, sent),
                   torch.where(uniq, ((skeys >> 2) << 2) | 1, sent)])
    return uniq, J, int(uniq.sum())


def join_nodes(J: torch.Tensor, K: int, cap: int):
    """(m,) sorted join entries -> (sink, src1, n_sink, n_src1): the dummy
    sink nodes (a run of one node's entries that starts with a target
    entry: no outgoing edge) and level-1 dummy source nodes (a run that
    ends with a source entry: no incoming edge) as 2(K-1)-bit node keys,
    the first ``cap`` of each in no set order (the plain version: in
    stream order), with their exact counts.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    second kernel of ``csrc/build_join.cu`` (counted on ``build_join``) or
    raises."""
    dev = J.device
    _check_1d("J", J, (torch.int64,))
    _check_scope(K)
    if dev.type == "cpu":
        return join_nodes_plain(J, K, cap)
    m = J.shape[0]
    _check_cuda(dev, m)
    cap = max(0, min(cap, m // 2))     # a node list holds at most U = m / 2
    sink = torch.empty(cap, dtype=torch.int64, device=dev)
    src1 = torch.empty(cap, dtype=torch.int64, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    if m:
        fn = _build.function("build_join", "mg_join_nodes",
                             [_P, _L, _I, _L, _P, _P, _P, _P])
        _build.check(fn(J.data_ptr(), m, K, cap, sink.data_ptr(),
                        src1.data_ptr(), counts.data_ptr(), _stream(dev)),
                     "build_join")
        _build.count(build_join)
    n_sink, n_src1 = (int(x) for x in counts.tolist())
    return sink[: min(n_sink, cap)], src1[: min(n_src1, cap)], n_sink, n_src1


def join_nodes_plain(J: torch.Tensor, K: int, cap: int):
    """Plain version of D3's second kernel."""
    real = J != _sent2(K)
    node, tag = J >> 2, J & 3
    starts = torch.ones_like(real)
    ends = torch.ones_like(real)
    if len(J) > 1:
        starts[1:] = node[1:] != node[:-1]
        ends[:-1] = node[:-1] != node[1:]
    sink = node[real & (tag == 1) & starts]
    src1 = node[real & (tag == 0) & ends]
    return sink[:cap], src1[:cap], len(sink), len(src1)


# --------------------------------------------------------------------------
# D4: BOSS keys and emission
# --------------------------------------------------------------------------

def emit_keys(skeys: torch.Tensor, uniq: torch.Tensor, U: int,
              dkeys3: torch.Tensor, K: int) -> torch.Tensor:
    """Sorted wire keys, their uniq flags (``U`` of them set: D3's count)
    and the dummy rows' 3-bit keys (D,) -> the (U + D,) unsorted edge
    stream as 3-bit keys (the label at bits 0..2, character j <= K-2 at
    bits 3(j+1)): the unique rows in the order of ``skeys``, then the
    dummy rows.  No row stands for a key that is not unique.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``mg_emit_keys`` of ``csrc/build_emit.cu`` (a memset and the
    compaction kernel, counted on ``build_emit``) or raises.  Either
    raises ValueError where ``U`` is not the count of set flags (the
    kernel's count is read back: one sync)."""
    dev = skeys.device
    _check_1d("skeys", skeys, (torch.int64,))
    _check_1d("uniq", uniq, (torch.bool,), dev)
    _check_1d("dkeys3", dkeys3, (torch.int64,), dev)
    _check_scope(K)
    if uniq.shape != skeys.shape:
        raise ValueError("uniq and skeys differ in length")
    n, D = skeys.shape[0], dkeys3.shape[0]
    if not 0 <= U <= n:
        raise ValueError(f"U={U} unique rows of {n}")
    if dev.type == "cpu":
        return emit_keys_plain(skeys, uniq, U, dkeys3, K)
    _check_cuda(dev, n)
    _check_cuda(dev, U + D)
    k3 = torch.empty(U + D, dtype=torch.int64, device=dev)
    if n + D:
        scratch = torch.empty(
            _build.function("build_emit", "mg_emit_keys_scratch", [_L],
                            ctypes.c_int64)(n),
            dtype=torch.int64, device=dev)
        fn = _build.function("build_emit", "mg_emit_keys",
                             [_P, _P, _L, _P, _L, _L, _I, _P, _P, _P])
        _build.check(fn(skeys.data_ptr(), uniq.data_ptr(), n,
                        dkeys3.data_ptr(), D, U, K, k3.data_ptr(),
                        scratch.data_ptr(), _stream(dev)), "build_emit")
        _build.count(build_emit, 2)            # the memset and the kernel
        n_set = int(scratch[1].item())
        if n_set != U:
            raise ValueError(f"U={U}, but {n_set} rows are unique")
    return k3


def key3_plain(keys2: torch.Tensor, K: int) -> torch.Tensor:
    """Wire keys -> 3-bit BOSS keys (``_key3_from_key2``, :136)."""
    out = ((keys2 >> (2 * (K - 1))) & 3) + 1
    for j in range(K - 1):
        out = out | ((((keys2 >> (2 * j)) & 3) + 1) << (3 * (j + 1)))
    return out


def emit_keys_plain(skeys, uniq, U: int, dkeys3, K: int) -> torch.Tensor:
    """Plain version of ``mg_emit_keys``."""
    keys = skeys[uniq]
    if len(keys) != U:
        raise ValueError(f"U={U}, but {len(keys)} rows are unique")
    return torch.cat([key3_plain(keys, K), dkeys3])


def build_emit(S: torch.Tensor, M: int, K: int, alph_size: int = 5):
    """The sorted 3-bit edge stream, its first ``M`` rows real -> (W, last,
    valid (1 + kept,) uint8, F (alph_size,) int64): the kept rows' flags in
    stream order behind the zero row 0 (construct.emit_boss semantics).

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``mg_build_emit`` of ``csrc/build_emit.cu`` (a memset and one kernel)
    or raises."""
    dev = S.device
    _check_1d("S", S, (torch.int64,))
    _check_scope(K)
    if not 0 <= M <= S.shape[0]:
        raise ValueError(f"M={M} rows of a stream of {S.shape[0]}")
    if not 2 <= alph_size <= 8:
        raise ValueError(f"alph_size must be 2..8, not {alph_size}")
    if dev.type == "cpu":
        return build_emit_plain(S, M, K, alph_size)
    _check_cuda(dev, M)
    if not M:
        zero = torch.zeros(1, dtype=torch.uint8, device=dev)
        return zero, zero.clone(), zero.clone(), torch.zeros(
            alph_size, dtype=torch.int64, device=dev)
    out = torch.empty((3, M + 1), dtype=torch.uint8, device=dev)
    scratch = torch.empty(   # F (8 words), the kept total, then look-back
        _build.function("build_emit", "mg_emit_rows_scratch", [_L],
                        ctypes.c_int64)(M),
        dtype=torch.int64, device=dev)
    fn = _build.function("build_emit", "mg_build_emit",
                         [_P, _L, _I, _I, _P, _P, _P, _P, _P])
    _build.check(fn(S.data_ptr(), M, K, alph_size, out[0].data_ptr(),
                    out[1].data_ptr(), out[2].data_ptr(), scratch.data_ptr(),
                    _stream(dev)), "build_emit")
    _build.count(build_emit, 2)                # the memset and the kernel
    n = 1 + int(scratch[8].item())
    return out[0, :n], out[1, :n], out[2, :n], scratch[:alph_size]


build_emit.launches = 0


def build_emit_plain(S: torch.Tensor, M: int, K: int, alph_size: int = 5):
    """Plain version of ``mg_build_emit``, with the minus flags as
    device_build.py:285-298 finds them: a stable sort of the rows by
    label, adjacent equal targets, scattered back."""
    S = S[:M]
    label = S & 7
    node_last = (S >> (3 * (K - 1))) & 7
    first = (S >> 3) & 7
    node = S >> 3
    same_next = torch.zeros(M, dtype=torch.bool, device=S.device)
    if M > 1:
        same_next[:-1] = node[:-1] == node[1:]
    keep = ~(same_next & (label == 0) & (node_last > 0))
    target = (S >> 6) | (label << (3 * (K - 2)))
    order = torch.sort(label, stable=True).indices
    lb, tg = label[order], target[order]
    minus_s = torch.zeros(M, dtype=torch.bool, device=S.device)
    if M > 1:
        minus_s[1:] = (lb[1:] == lb[:-1]) & (tg[1:] == tg[:-1])
    minus_s &= (lb > 0) & (lb < alph_size)
    minus = torch.empty_like(minus_s)
    minus[order] = minus_s
    W = label + torch.where(minus, alph_size, 0)
    valid = (label > 0) & (label < alph_size) & (first > 0)
    F = torch.stack([(keep & (node_last < c)).sum()
                     for c in range(alph_size)]).to(torch.int64)
    zero = S.new_zeros(1)

    def rows(x):
        return torch.cat([zero, x[keep].to(torch.int64)]).to(torch.uint8)

    return rows(W), rows((~same_next).to(torch.int64)), rows(valid), F


# --------------------------------------------------------------------------
# the two device stages
# --------------------------------------------------------------------------

@dataclass
class P1:
    """``build_p1``'s results: the sorted wire keys and their uniq flags
    (kept on the device for ``build_p2``), U, and the sink and level-1
    source node keys, sorted (the first ``cap`` of each), with their
    counts."""

    skeys: torch.Tensor
    uniq: torch.Tensor
    U: int
    sink: torch.Tensor
    src1: torch.Tensor
    n_sink: int
    n_src1: int


def build_p1(words: torch.Tensor, vwords: torch.Tensor, K: int,
             T: int = T_WIRE, cap: int = 1 << 31, strands: int = 1) -> P1:
    """Wire tiles -> P1 (device_build.py::_build_p1): D1 (of ``strands``
    strands), the edge sort
    (D2 over 2K + 1 bits: the sentinel sorts last), D3's dedupe and join
    entries, the join sort (D2, 2K + 1 bits, over the entries that are
    not the sentinel), D3's sink and source nodes, each list sorted by D2
    over 2(K-1) bits."""
    keys = build_windows(words, vwords, K, T, strands)
    skeys, _ = radix_sort(keys, 2 * K + 1)
    del keys
    uniq, J, U = build_join(skeys, K)
    J, _ = radix_sort(J, 2 * K + 1, sentinel=_sent2(K))
    sink, src1, n_sink, n_src1 = join_nodes(J, K, cap)
    del J
    sink, _ = radix_sort(sink, 2 * (K - 1))
    src1, _ = radix_sort(src1, 2 * (K - 1))
    return P1(skeys, uniq, U, sink, src1, n_sink, n_src1)


def build_p2(skeys: torch.Tensor, uniq: torch.Tensor, U: int,
             dkeys3: torch.Tensor, K: int, alph_size: int = 5):
    """P1's keys and the dummy rows' 3-bit keys -> (W, last, valid, F) of
    the BOSS table (device_build.py::_build_p2): D4's compaction into the
    U + D rows' 3-bit keys, the stream sort (D2 over 3K bits), D4's
    emission."""
    k3 = emit_keys(skeys, uniq, U, dkeys3, K)
    S, _ = radix_sort(k3, 3 * K)
    del k3
    return build_emit(S, S.shape[0], K, alph_size)


# --------------------------------------------------------------------------
# host steps
# --------------------------------------------------------------------------

def host_key3(rows: np.ndarray, K: int) -> np.ndarray:
    """(D, K) code rows -> (D,) int64 3-bit keys, the device layout
    (``_host_key3``, :324)."""
    out = np.zeros(len(rows), np.int64)
    for j in range(K):
        p = 3 * (j + 1) if j < K - 1 else 0
        out |= rows[:, j].astype(np.int64) << np.int64(p)
    return out


def unpack_node_keys(keys: np.ndarray, K: int) -> np.ndarray:
    """(n,) 2-bit node keys -> (n, K-1) uint8 codes 1..4
    (``_unpack_node_keys``, :334)."""
    keys = np.asarray(keys, dtype=np.int64)
    out = np.empty((len(keys), K - 1), np.uint8)
    for j in range(K - 1):
        out[:, j] = ((keys >> np.int64(2 * j)) & 3) + 1
    return out


def expand_dummies(sink_nodes: np.ndarray, src1_nodes: np.ndarray,
                   K: int) -> np.ndarray:
    """The dummy rows (device_build.py:385-403; ref
    boss_chunk_construct.cpp:380-397): the all-$ row, each sink node +
    '$', and the source chains '$' + node, '$$' + node[:-1], ... deduped by
    node at each level."""
    dummy_rows = [np.zeros((1, K), np.uint8)]
    if len(sink_nodes):
        dummy_rows.append(np.concatenate(
            [sink_nodes, np.zeros((len(sink_nodes), 1), np.uint8)], axis=1))
    level = np.concatenate(
        [np.zeros((len(src1_nodes), 1), np.uint8), src1_nodes], axis=1) \
        if len(src1_nodes) else np.zeros((0, K), np.uint8)
    if len(level):
        dummy_rows.append(level)
        for _ in range(2, K):
            nodes = level[:, : K - 1]
            keys = _packing.pack_codes(nodes,
                                       _packing.colex_priority_order(K - 1))
            _, first = np.unique(_packing._void_view(keys),
                                 return_index=True)
            nodes = nodes[np.sort(first)]
            level = np.concatenate(
                [np.zeros((len(nodes), 1), np.uint8), nodes], axis=1)
            dummy_rows.append(level)
    return np.concatenate(dummy_rows, axis=0)


def capd_limit(capd: int, max_capd: int) -> int:
    """The last compact-buffer size that the JAX package's regrowth reaches
    (``capd`` times 4 while that stays within ``max_capd``, :371-376): more
    dummy sink or source nodes than this raise there, and here."""
    while capd * 4 <= max_capd:
        capd *= 4
    return capd


def device_build_boss_arrays(sequences, k: int, alph_size: int = 5,
                             capd: int = _CAPD_DEFAULT,
                             _max_capd: int = 1 << 22, device=None,
                             strands: int = 1, bounded: bool = True):
    """The BOSS arrays of a DNA graph built on the device, equal to
    metagraph_tpu's ``device_build_boss_arrays`` (and so to its host
    ``construct.build_boss_arrays``): of the forward windows, or with
    ``strands`` 2 of both strands (its host construction's "both"
    collector, a canonical graph).  Returns None where that returns None:
    K out of 3..21, another alphabet, or no sequence as long as k.
    ``bounded`` (the JAX device construction's rule): raises RuntimeError
    past ``capd_limit(capd, _max_capd)`` dummy sink or source nodes, with
    the JAX package's message; unbounded (the builds that JAX sends to its
    host construction, which has no limit), the limit is the number of
    window slots, which no node count reaches."""
    from .construct import BossArrays
    K = k
    if not 3 <= K <= 21 or alph_size != 5:
        return None
    dev = resolve_device(device)
    with PhaseTimer("host packing"):
        tiles2, validb, _tile_seq, _nwins = tile_pack2(sequences, K, T_WIRE)
        if len(tiles2) == 0:
            return None
        words, vwords = wire_words_layout(tiles2, validb, K, T_WIRE,
                                          len(tiles2))
        del tiles2, validb
    limit = capd_limit(capd, _max_capd) if bounded \
        else strands * words.shape[0] * T_WIRE
    with PhaseTimer("build_p1 on the device"):
        p1 = build_p1(np_words(words).to(dev), np_words(vwords).to(dev), K,
                      T_WIRE, cap=limit, strands=strands)
        del words, vwords
        if p1.n_sink > limit or p1.n_src1 > limit:
            raise RuntimeError(
                f"device_build_boss_arrays: > {limit} dummy sink/source "
                "nodes; use the host pipeline")
        sink = p1.sink.cpu().numpy()
        src1 = p1.src1.cpu().numpy()
    with PhaseTimer("dummy expansion"):
        dummies = expand_dummies(unpack_node_keys(sink, K),
                                 unpack_node_keys(src1, K), K)
        dkeys3 = torch.from_numpy(host_key3(dummies, K)).to(dev)
    with PhaseTimer("build_p2 on the device"):
        W, last, valid, F = build_p2(p1.skeys, p1.uniq, p1.U, dkeys3, K,
                                     alph_size)
        del p1
        W, last, valid = (x.cpu().numpy() for x in (W, last, valid))
        F = F.cpu().numpy().astype(np.int64)
    return BossArrays(k=K - 1, alph_size=alph_size, W=W, last=last, F=F,
                      valid=valid)
