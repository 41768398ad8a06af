"""The device half of the annotated batch query, and kernels 2 and 3.

Own copies of metagraph_tpu/query/device.py's host helpers (``TILE``,
``wire_words_layout`` :463, ``untile_nodes`` :517, ``tile_layout`` :579)
and of ``_thresholds``
(query/pipeline.py:32-50), plain PyTorch versions of ``_tile_label_counts``
(:107), ``_fold_tiles`` (:152) and ``_pack_selection_mask`` (:168), and the
wrappers of the hand-written kernels that replace them:

* ``label_counts`` (``csrc/label_counts.cu``): node ids -> (S, L) counts and
  (S,) present, replacing ``gather_anno_rows`` + ``_tile_label_counts`` +
  ``_fold_tiles`` in one pass.  The fold is integer arithmetic: the JAX
  package's f32 matmul fold is exact only below 2^24.
* ``selection_mask`` (``csrc/selection_mask.cu``): the packed label mask.

Three epochs chain the kernels, each with the return contract of
``query_epoch_wire_buf`` (mask, counts, present, and the per-window ids
where the epoch finds them).  Each counts on the index's device
annotation (``count_labels``): kernel 2 on a dense bitmap, kernels S1 and
S2 (``annotation/sparse_device.py``) in its place on a block-sparse one,
and on a BRWT or row-diff one W1 or W2 (``annotation/device_matrix.py``)
writing a chunk of windows' label words for kernel 2 to count
(``words_count_epoch``, the counterpart of ``make_tiled_count_epoch`` and
of ``_tile_label_counts`` with a ``words_fn``; the codes epoch takes none,
as in the JAX package):

* ``wire_epoch``: kernels 1, 2, 3, for DNA graphs with 2 <= k <= 31
  (canon 0, 1 and 2 of ``_wire_epoch_core``);
* ``codes_epoch``: kernels B, 2, 3, for basic DNA graphs with k >= 32
  (``query_epoch_codes2``);
* ``count_route``: kernels 2, 3 over host-tiled annotation rows, after the
  host mapped the windows with kernel A (``count_epoch_tiled`` +
  ``select_mask_epoch``); the values at the hits are a torch index of the
  counts, as ``gather_flat`` is outside any Pallas kernel.

The older epochs and the dedup epoch (``query_step`` :24,
``query_epoch`` :34, ``query_epoch_tiled`` :187, ``query_epoch_codes``
:224, ``count_epoch_tiled`` :534, ``select_mask_epoch`` :557,
``gather_flat`` :574, ``query_epoch_dedup`` :757 with the host
``dedup_batch`` :823, the host helpers ``pad_tile_rows`` :477,
``tile_codes_layout`` :489 and ``_rowmin_packed`` :606, and
``DeviceQueryPipeline`` :613-754) look up every key through kernel A
(``succinct/ops.hash_lookup``) and count through kernel 2; each takes and
gives int32 tensors (uint32 words as their bit patterns) and returns no
padding.  No CLI path takes them: they are the JAX package's benchmark
and entry-point workload (``entry.py``).

The TPU's fused upload buffer, chunk scan and geometric tile padding
served its host link and its recompiles and are not copied, but for
``pad_tile_rows``, kept for callers that size their batches by it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .._u32 import to_i32, to_u64
from ..annotation.device_matrix import WordsOnDevice, row_words
from ..annotation.ops import gather_anno_rows
from ..annotation.sparse_device import SparseOnDevice, sparse_count_epoch
from ..succinct.ops import (EMPTY_WORD, codes_lookup, device_pack_windows,
                            hash_lookup, wire_lookup)

TILE = 256   # windows per tile
WORDS_BYTES = 1 << 26    # label words of one chunk of words_count_epoch


def _thresholds(nk_list, discovery_fraction: float,
                presence_fraction: float):
    """Per-sequence selection thresholds with get_min_count semantics
    (float64 ceil on the host): dsel = max(ceil(df*nk), 1); selmin =
    max(dsel, max(ceil(pf*nk), 1)).  Rows with nk == 0 get INT32_MAX (never
    selected)."""
    nk = np.asarray(nk_list, dtype=np.int64)
    sentinel = np.iinfo(np.int32).max
    dmin = np.maximum(np.ceil(discovery_fraction * nk.astype(np.float64)),
                      1).astype(np.int64)
    pmin = np.maximum(np.ceil(presence_fraction * nk.astype(np.float64)),
                      1).astype(np.int64)
    ok = nk > 0
    dsel = np.where(ok, np.minimum(dmin, sentinel), sentinel)
    selmin = np.where(ok, np.minimum(np.maximum(dmin, pmin), sentinel),
                      sentinel)
    return dsel.astype(np.int32), selmin.astype(np.int32)


def wire_words_layout(packed2: np.ndarray, validb: np.ndarray, K: int,
                      T: int, npad: int):
    """tile_pack2 byte tiles -> zero-row-padded uint32 word views:
    ((npad, NW) words, (npad, NV) vwords)."""
    n, PB = packed2.shape
    NW = max(-(-PB // 4), -(-T // 16) + 2)
    NV = -(-validb.shape[1] // 4)
    wb = np.zeros((npad, NW * 4), np.uint8)
    wb[:n, :PB] = packed2
    vb = np.zeros((npad, NV * 4), np.uint8)
    vb[:n, :validb.shape[1]] = validb
    return wb.view(np.uint32), vb.view(np.uint32)


def untile_nodes(nodes_tiled: np.ndarray, nwins, tile: int = TILE):
    """(N, T) tiled node ids -> per-sequence flat int64 node arrays."""
    out = []
    base = 0
    for nwin in nwins:
        nt = -(-nwin // tile) if nwin else 0
        if nt:
            flat = nodes_tiled[base: base + nt].reshape(-1)[:nwin]
        else:
            flat = np.zeros(0, dtype=nodes_tiled.dtype)
        out.append(flat.astype(np.int64))
        base += nt
    return out


def tile_layout(queries: np.ndarray, seq_ids: np.ndarray, num_seqs: int,
                tile: int = TILE, fill=None):
    """Flat (Q, W) windows (or (Q,) row ids) with sorted ``seq_ids`` ->
    the (N, T, W) (or (N, T)) tiled layout, padded with ``fill`` (0 for
    ids, EMPTY_WORD for keys), and the (N,) owning sequence of each tile."""
    nwin = np.bincount(seq_ids, minlength=num_seqs) if len(seq_ids) \
        else np.zeros(num_seqs, dtype=np.int64)
    ntiles = -(-nwin // tile)
    tile_base = np.concatenate([[0], np.cumsum(ntiles)])
    N = int(tile_base[-1])
    if queries.ndim == 1:
        shape = (N * tile,)
        fill = 0 if fill is None else fill
    else:
        shape = (N * tile, queries.shape[1])
        fill = np.iinfo(np.uint32).max if fill is None else fill
    out = np.full(shape, fill, dtype=queries.dtype)
    if len(seq_ids):
        seq_start = np.concatenate([[0], np.cumsum(nwin)])
        idx = np.arange(len(seq_ids)) - seq_start[seq_ids]
        flat = (tile_base[seq_ids] + idx // tile) * tile + idx % tile
        out[flat] = queries
    tile_seq = np.repeat(np.arange(num_seqs, dtype=np.int32),
                         ntiles.astype(np.int64))
    return out.reshape((N, tile) + shape[1:]), tile_seq


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _tile_label_counts(bitmap: torch.Tensor, nodes_ct: torch.Tensor,
                       num_labels: int):
    """(C, T) node ids (0 = miss) -> ((C, L) tile label counts, (C,) tile
    hits), both int64."""
    hit = nodes_ct > 0
    rows = torch.where(hit, nodes_ct - 1, 0).long()
    words = to_u64(gather_anno_rows(bitmap, rows)) * hit[..., None]
    shifts = torch.arange(32, device=bitmap.device)
    bits = (words[..., None] >> shifts) & 1               # (C, T, Lw, 32)
    tc = bits.sum(dim=1).reshape(nodes_ct.shape[0], -1)
    return tc[:, :num_labels], hit.sum(dim=1)


def _fold_tiles(tc: torch.Tensor, th: torch.Tensor, tile_seq: torch.Tensor,
                num_seqs: int):
    """Tile sums -> per-sequence (S, L) counts and (S,) present, as exact
    integer segment sums."""
    counts = torch.zeros((num_seqs, tc.shape[1]), dtype=torch.int64,
                         device=tc.device)
    present = torch.zeros(num_seqs, dtype=torch.int64, device=tc.device)
    idx = tile_seq.long()
    return counts.index_add_(0, idx, tc), present.index_add_(0, idx, th)


def label_counts_plain(nodes: torch.Tensor, bitmap: torch.Tensor,
                       tile_seq: torch.Tensor, num_seqs: int,
                       num_labels: int, chunk: int = 64, offset: int = 0):
    """Plain version of kernel 2, ``chunk`` tiles at a time.  With an
    ``offset`` (canon 2), ids above it fold back to their base node before
    the row gather."""
    if offset:
        nodes = torch.where(nodes > offset, nodes - offset, nodes)
    counts = torch.zeros((num_seqs, num_labels), dtype=torch.int64,
                         device=nodes.device)
    present = torch.zeros(num_seqs, dtype=torch.int64, device=nodes.device)
    for lo in range(0, nodes.shape[0], chunk):
        tc, th = _tile_label_counts(bitmap, nodes[lo: lo + chunk],
                                    num_labels)
        c, p = _fold_tiles(tc, th, tile_seq[lo: lo + chunk], num_seqs)
        counts += c
        present += p
    return counts.to(torch.int32), present.to(torch.int32)


def selection_mask_plain(counts: torch.Tensor, present: torch.Tensor,
                         dsel: torch.Tensor, selmin: torch.Tensor):
    """Plain version of kernel 3 (``_pack_selection_mask``)."""
    S, L = counts.shape
    sel = (counts >= dsel[:, None]) & (present >= selmin)[:, None]
    pad = (-L) % 32
    if pad or L == 0:
        sel = torch.nn.functional.pad(sel, (0, pad if L else 32))
    weights = torch.ones(32, dtype=torch.int64, device=counts.device) \
        << torch.arange(32, device=counts.device)
    return to_i32((sel.reshape(S, -1, 32).long() * weights).sum(dim=2))


# --------------------------------------------------------------------------
# kernels 2 and 3
# --------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _require(device: torch.device, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def label_counts(nodes: torch.Tensor, bitmap: torch.Tensor,
                 tile_seq: torch.Tensor, num_seqs: int, num_labels: int,
                 offset: int = 0, out=None):
    """(N, T) node ids, (R, Lw) bitmap (rows may be padded: its row stride
    is passed on), (N,) tile_seq -> ((S, L) int32 counts, (S,) int32
    present), added into ``out`` = (counts, present) when given, else into
    zeros.  ``offset`` > 0 folds ids above it to
    ``node - offset`` before the row gather (0 means no fold).  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/label_counts.cu`` or
    raise."""
    dev = nodes.device
    _require(dev, nodes=nodes, tile_seq=tile_seq)
    N, T = nodes.shape
    R, Lw = bitmap.shape
    if bitmap.dtype != torch.int32 or bitmap.device != dev \
            or bitmap.stride(1) != 1 or bitmap.stride(0) < Lw:
        raise ValueError("bitmap must be an int32 tensor on the nodes' "
                         "device with rows of contiguous words")
    if Lw != max((num_labels + 31) // 32, 1) or T % 32 \
            or tile_seq.shape != (N,):
        raise ValueError(f"bad shapes: nodes {tuple(nodes.shape)} bitmap "
                         f"{tuple(bitmap.shape)} for {num_labels} labels")
    if not 0 <= offset < 2 ** 31:
        raise ValueError(f"offset {offset} out of range")
    if out is None:
        out = (torch.zeros((num_seqs, num_labels), dtype=torch.int32,
                           device=dev),
               torch.zeros(num_seqs, dtype=torch.int32, device=dev))
    counts, present = out
    _require(dev, counts=counts, present=present)
    if counts.shape != (num_seqs, num_labels) or present.shape != (num_seqs,):
        raise ValueError(f"out must be ({num_seqs}, {num_labels}) counts and "
                         f"({num_seqs},) present")
    if dev.type == "cpu":
        c, p = label_counts_plain(nodes, bitmap, tile_seq, num_seqs,
                                  num_labels, offset=offset)
        counts += c
        present += p
        return counts, present
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if N == 0:
        return counts, present
    stride = bitmap.stride(0)
    # 16-byte row copies need aligned rows, readable up to a multiple of 4
    # words (DeviceAnnotation pads its rows so)
    end = (bitmap.storage_offset() + (R - 1) * stride + (Lw + 3) // 4 * 4) * 4
    vec16 = stride % 4 == 0 and bitmap.data_ptr() % 16 == 0 \
        and end <= bitmap.untyped_storage().nbytes()
    fn = _build.function("label_counts", "mg_label_counts",
                         [_P, _P, _P, _P, _P, _L, _I, _L, _L, _I, _I, _I, _I,
                          _P])
    _build.check(fn(nodes.data_ptr(), bitmap.data_ptr(), tile_seq.data_ptr(),
                    counts.data_ptr(), present.data_ptr(), N, T, R, stride,
                    Lw, num_labels, offset, int(vec16),
                    torch.cuda.current_stream(dev).cuda_stream),
                 "label_counts")
    _build.count(label_counts)
    return counts, present


label_counts.launches = 0


SELECT_WARPS = 8      # warps a block of csrc/selection_mask.cu


def selection_plan(S: int, L: int, counts_ptr: int, n_sms: int,
                   blocks_per_sm: int):
    """Launch plan of kernel 3 over S rows of L counts at address
    ``counts_ptr``: (V, grid).  V = 4 (16-byte loads) when every row starts
    16-byte aligned (L % 4 == 0 and an aligned base), else V = 1 (4-byte
    loads).  The grid is persistent: at most ``blocks_per_sm`` blocks on
    each of ``n_sms`` SMs, and no more blocks than S rows fill (a warp a
    row, SELECT_WARPS warps a block)."""
    if S < 1 or L < 0 or n_sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"bad plan: S {S}, L {L}, {n_sms} SMs, "
                         f"{blocks_per_sm} blocks an SM")
    return (_select_variant(L, counts_ptr),
            min(n_sms * blocks_per_sm, -(-S // SELECT_WARPS)))


def _select_variant(L: int, counts_ptr: int) -> int:
    return 4 if L % 4 == 0 and counts_ptr % 16 == 0 else 1


@functools.lru_cache(maxsize=8)
def _select_blocks_per_sm(vec: int, device_index: int) -> int:
    fn = _build.function("selection_mask", "mg_selection_mask_occupancy",
                         [_I, ctypes.POINTER(ctypes.c_int32)])
    blocks = ctypes.c_int32(0)
    with torch.cuda.device(device_index):
        _build.check(fn(vec, ctypes.byref(blocks)),
                     "mg_selection_mask_occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"selection_mask V = {vec} fits no block on an SM")
    return blocks.value


def selection_launch_plan(S: int, L: int, counts: torch.Tensor):
    """selection_plan on the card that holds ``counts``: -> (V, grid,
    blocks an SM)."""
    dev = counts.device
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    n_sms = torch.cuda.get_device_properties(index).multi_processor_count
    bps = _select_blocks_per_sm(_select_variant(L, counts.data_ptr()),
                                index)
    return (*selection_plan(S, L, counts.data_ptr(), n_sms, bps), bps)


def selection_mask(counts: torch.Tensor, present: torch.Tensor,
                   dsel: torch.Tensor, selmin: torch.Tensor) -> torch.Tensor:
    """(S, L) counts, (S,) present/dsel/selmin -> (S, ceil(L/32)) int32
    bit patterns of the uint32 selection words.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/selection_mask.cu`` or raise."""
    dev = counts.device
    _require(dev, counts=counts, present=present, dsel=dsel, selmin=selmin)
    S, L = counts.shape
    if present.shape != (S,) or dsel.shape != (S,) or selmin.shape != (S,):
        raise ValueError("present, dsel and selmin must have shape (S,)")
    if dev.type == "cpu":
        return selection_mask_plain(counts, present, dsel, selmin)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if L >= 2 ** 31 - 1024:
        raise ValueError(f"selection_mask takes L < 2^31 - 1024, got {L}")
    Lw = max((L + 31) // 32, 1)
    mask = torch.empty((S, Lw), dtype=torch.int32, device=dev)
    if S == 0:
        return mask
    vec, grid, _ = selection_launch_plan(S, L, counts)
    fn = _build.function("selection_mask", "mg_selection_mask",
                         [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P])
    _build.check(fn(counts.data_ptr(), present.data_ptr(), dsel.data_ptr(),
                    selmin.data_ptr(), mask.data_ptr(), S, L, Lw, vec, grid,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "selection_mask")
    _build.count(selection_mask)
    return mask


selection_mask.launches = 0


def words_count_epoch(anno, nodes: torch.Tensor, tile_seq: torch.Tensor,
                      num_seqs: int, offset: int = 0):
    """(N, T) node ids (or rows + 1), (N,) tile_seq -> ((S, L) int32
    counts, (S,) int32 present) on a BRWT or row-diff device annotation
    (``make_tiled_count_epoch``): a chunk of whole tiles at a time, W1 or
    W2 writes the windows' label words (of at most WORDS_BYTES, rows padded
    to a multiple of 4 words as DeviceAnnotation pads them, so that kernel
    2 keeps its 16-byte copies), then kernel 2 counts them as a bitmap
    whose row i + 1 is the chunk's window i, adding into one (S, L)
    buffer."""
    dev = nodes.device
    N, T = nodes.shape
    L = anno.num_labels
    Lw = max((L + 31) // 32, 1)
    ld = -(-Lw // 4) * 4
    counts = torch.zeros((num_seqs, L), dtype=torch.int32, device=dev)
    present = torch.zeros(num_seqs, dtype=torch.int32, device=dev)
    step = max(1, WORDS_BYTES // (T * ld * 4))      # tiles a chunk
    n = min(step, N) * T
    if not n:
        return counts, present
    buf = torch.zeros((n, ld), dtype=torch.int32, device=dev)
    place = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    for t0 in range(0, N, step):
        chunk = nodes[t0: t0 + step]
        m = chunk.numel()
        words = row_words(anno, chunk.reshape(-1), offset, buf[:m, :Lw])
        ids = torch.where(chunk > 0, place[:m].view(chunk.shape), 0)
        label_counts(ids, words, tile_seq[t0: t0 + step], num_seqs, L,
                     out=(counts, present))
    return counts, present


def count_labels(anno, nodes: torch.Tensor, tile_seq: torch.Tensor,
                 num_seqs: int, num_labels: int, offset: int = 0):
    """(N, T) node ids (or rows + 1) -> ((S, L) counts, (S,) present) on a
    device annotation: kernel 2 on an (R, Lw) bitmap tensor, S1 and S2 on
    a ``SparseOnDevice``, W1 or W2 then kernel 2 on a BRWT or row-diff
    one."""
    if isinstance(anno, SparseOnDevice):
        return sparse_count_epoch(anno, nodes, tile_seq, num_seqs, offset)
    if isinstance(anno, WordsOnDevice):
        return words_count_epoch(anno, nodes, tile_seq, num_seqs, offset)
    return label_counts(nodes, anno, tile_seq, num_seqs, num_labels, offset)


def wire_epoch(table: torch.Tensor, anno, words: torch.Tensor,
               vwords: torch.Tensor,
               tile_seq: torch.Tensor, dsel: torch.Tensor,
               selmin: torch.Tensor, num_seqs: int, num_labels: int, K: int,
               T: int = TILE, canon: int = 0, offset: int = 0):
    """The wire epoch: (N, NW) wire words, (N, NV) valid words, (N,)
    tile_seq and (S,) thresholds -> (mask (S, Lw), counts (S, L), present
    (S,), nodes (N, T)), the contract of query_epoch_wire_buf without its
    padding.  canon 0 = basic graph, 1 = canonical graph, 2 = primary graph
    through CanonicalDBG: ``nodes`` then carries reverse-complement hits as
    base id + ``offset``, and the label counts use the base rows.  ``anno``
    is the dense bitmap or a ``SparseOnDevice`` (``count_labels``)."""
    nodes = wire_lookup(words, vwords, table, K, T, canon, offset)
    # wire_lookup takes an offset with canon 2 only
    counts, present = count_labels(anno, nodes, tile_seq, num_seqs,
                                   num_labels, offset)
    mask = selection_mask(counts, present, dsel, selmin)
    return mask, counts, present, nodes


def codes_epoch(table: torch.Tensor, anno, packed2: torch.Tensor,
                validb: torch.Tensor, tile_seq: torch.Tensor,
                dsel: torch.Tensor, selmin: torch.Tensor, num_seqs: int,
                num_labels: int, K: int, T: int = TILE):
    """The codes epoch of a basic DNA graph at any K: (N, TKp/4) uint8
    2-bit code tiles, (N, ceil(TK/8)) uint8 valid bits (``tile_pack2``),
    (N,) tile_seq and (S,) thresholds -> (mask (S, Lw), counts (S, L),
    present (S,), nodes (N, T)), the contract of query_epoch_codes2 without
    its padding.  It takes no BRWT or row-diff annotation: the JAX package
    sends those to execute_batch (the map route)."""
    if isinstance(anno, WordsOnDevice):
        raise ValueError("the codes epoch counts on a bitmap or a "
                         "block-sparse annotation, not on a words one")
    nodes = codes_lookup(packed2, validb, table, K, T)
    counts, present = count_labels(anno, nodes, tile_seq, num_seqs,
                                   num_labels)
    mask = selection_mask(counts, present, dsel, selmin)
    return mask, counts, present, nodes


def count_route(anno, rows1: torch.Tensor, tile_seq: torch.Tensor,
                dsel: torch.Tensor, selmin: torch.Tensor, num_seqs: int,
                num_labels: int):
    """(N, T) tiled annotation rows + 1 (0 = miss; count_epoch_tiled's
    input), (N,) tile_seq and (S,) thresholds -> (mask (S, Lw), counts (S,
    L), present (S,)).  ``selmin`` is max(dmin, pmin), so the mask is
    _hits' ``counts >= dmin`` on the rows whose presence passes."""
    counts, present = count_labels(anno, rows1, tile_seq, num_seqs,
                                   num_labels)
    mask = selection_mask(counts, present, dsel, selmin)
    return mask, counts, present


# --------------------------------------------------------------------------
# the older epochs and the dedup epoch (query/device.py:24-188, 224-260,
# 477-606, 613-839)
# --------------------------------------------------------------------------

CODES_CHUNK = 1 << 22     # windows a pass of query_epoch_codes packs


def query_step(table: torch.Tensor, bitmap: torch.Tensor,
               queries: torch.Tensor, seq_ids: torch.Tensor, num_seqs: int,
               num_labels: int):
    """(Q, W) int32 packed windows (all-EMPTY_WORD rows pad) and (Q,)
    sequence ids -> ((S, L) int32 counts, (S,) int32 present, (Q,) int32
    nodes): the hash lookup (kernel A, ``hash_lookup``), then
    ``count_labels`` (kernel 2)."""
    from ..annotation.ops import count_labels
    nodes = hash_lookup(table, queries)
    counts, present = count_labels(bitmap, nodes, seq_ids, num_seqs,
                                   num_labels)
    return counts, present, nodes


def query_epoch(table: torch.Tensor, bitmap: torch.Tensor,
                queries: torch.Tensor, seq_ids: torch.Tensor, num_seqs: int,
                num_labels: int, chunk: int = 1 << 17):
    """The whole batch, ``chunk`` windows a step: lookups, then
    ``count_labels_matmul``, summed -> ((S, L) int32 counts, (S,) int32
    present).  The JAX scan's sentinel padding adds nothing, so none is
    made."""
    from ..annotation.ops import count_labels_matmul
    counts = torch.zeros((num_seqs, num_labels), dtype=torch.int32,
                         device=queries.device)
    present = torch.zeros(num_seqs, dtype=torch.int32, device=queries.device)
    for lo in range(0, queries.shape[0], chunk):
        c, p = count_labels_matmul(
            bitmap, hash_lookup(table, queries[lo: lo + chunk]),
            seq_ids[lo: lo + chunk], num_seqs, num_labels)
        counts += c
        present += p
    return counts, present


def count_epoch_tiled(bitmap: torch.Tensor, nodes: torch.Tensor,
                      tile_seq: torch.Tensor, num_seqs: int,
                      num_labels: int):
    """(N, T) int32 annotation rows + 1 (0 = miss) and (N,) tile_seq ->
    ((S, L) int32 counts, (S,) int32 present): kernel 2, after zero
    columns widen T to a multiple of 32."""
    pad = -nodes.shape[1] % 32
    if pad:
        nodes = torch.nn.functional.pad(nodes, (0, pad))
    return label_counts(nodes.contiguous(), bitmap, tile_seq.contiguous(),
                        num_seqs, num_labels)


def query_epoch_tiled(table: torch.Tensor, bitmap: torch.Tensor,
                      queries: torch.Tensor, tile_seq: torch.Tensor,
                      num_seqs: int, num_labels: int):
    """(N, T, W) int32 tiled windows (all-EMPTY_WORD rows pad), (N,)
    tile_seq -> ((S, L) int32 counts, (S,) int32 present, (N, T) int32
    nodes): kernel A, then kernel 2."""
    N, T, W = queries.shape
    nodes = hash_lookup(table, queries.reshape(N * T, W)).view(N, T)
    counts, present = count_epoch_tiled(bitmap, nodes, tile_seq, num_seqs,
                                        num_labels)
    return counts, present, nodes


def query_epoch_codes(table: torch.Tensor, bitmap: torch.Tensor,
                      code_tiles: torch.Tensor, tile_seq: torch.Tensor,
                      num_seqs: int, num_labels: int, K: int):
    """(N, T + K - 1) uint8 code tiles (codes >= 5 invalid, 5 pads), (N,)
    tile_seq -> ((S, L) int32 counts, (S,) int32 present, (N, T) int32
    nodes): ``device_pack_windows`` on the device, kernel A on the packed
    windows (an invalid window's node 0), then kernel 2."""
    N, TK = code_tiles.shape
    T = TK - (K - 1)
    nodes = torch.zeros((N, T), dtype=torch.int32, device=code_tiles.device)
    step = max(1, CODES_CHUNK // max(T, 1))
    for lo in range(0, N, step):
        packed, valid = device_pack_windows(code_tiles[lo: lo + step], K)
        C = packed.shape[0]
        found = hash_lookup(table, to_i32(packed.reshape(C * T, -1)))
        nodes[lo: lo + C] = torch.where(valid, found.view(C, T), 0)
    counts, present = count_epoch_tiled(bitmap, nodes, tile_seq, num_seqs,
                                        num_labels)
    return counts, present, nodes


def select_mask_epoch(counts: torch.Tensor, dmin: torch.Tensor):
    """(S, L) int32 counts, (S,) int32 thresholds -> (S, ceil(L/32))
    int32 bit patterns of ``counts >= dmin`` (kernel 3 with every row's
    presence passing)."""
    zeros = torch.zeros(counts.shape[0], dtype=torch.int32,
                        device=counts.device)
    return selection_mask(counts, zeros, dmin.to(torch.int32).contiguous(),
                          zeros)


def gather_flat(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """counts.reshape(-1)[idx]: the values at the hits."""
    return counts.reshape(-1)[idx]


def pad_tile_rows(n: int, C: int, lo: int = 4) -> int:
    """Geometric tile-row padding: ceil(n/C) rounded up into a ~1.12x
    bucket series, times C."""
    nc = max(-(-n // C), 1)
    b = lo
    while b < nc:
        b = max(b + 1, int(b * 9) // 8)
    return b * C


def tile_codes_layout(codes_list, K: int, tile: int = TILE):
    """Per-sequence code arrays -> ((N, T+K-1) uint8 code tiles, positions
    past a sequence's end read as the invalid code 5; (N,) int32
    tile_seq; per-sequence window counts)."""
    TK = tile + K - 1
    lens = np.array([len(c) for c in codes_list], dtype=np.int64)
    nwins_arr = np.maximum(lens - K + 1, 0)
    nwins = nwins_arr.tolist()
    ntiles = -(-nwins_arr // tile)
    N = int(ntiles.sum())
    if N == 0:
        return (np.zeros((0, TK), np.uint8), np.zeros(0, np.int32), nwins)
    cat = np.concatenate(codes_list)
    seq_start = np.concatenate([[0], np.cumsum(lens)])
    tile_seq = np.repeat(np.arange(len(codes_list), dtype=np.int32), ntiles)
    tile_base = np.concatenate([[0], np.cumsum(ntiles)])
    t_in_seq = np.arange(N, dtype=np.int64) - tile_base[tile_seq]
    starts = seq_start[tile_seq] + t_in_seq * tile
    idx = starts[:, None] + np.arange(TK, dtype=np.int64)
    in_seq = idx < seq_start[tile_seq + 1][:, None]
    out = np.where(in_seq, cat[np.minimum(idx, len(cat) - 1)],
                   np.uint8(5)).astype(np.uint8)
    return out, tile_seq, nwins


def _rowmin_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rowwise lexicographic min of two (N, W) packed-word arrays."""
    from ..kmer.packing import rows_lex_lt
    return np.where(rows_lex_lt(a, b)[:, None], a, b)


def _rowmin_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_rowmin_packed`` of (N, W) int64 rows holding uint32 words."""
    lt = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(lt)
    for w in range(a.shape[1]):
        lt |= ~decided & (a[:, w] < b[:, w])
        decided |= a[:, w] != b[:, w]
    return torch.where(lt[:, None], a, b)


class DeviceQueryPipeline:
    """The annotated batch query of the JAX ``DeviceQueryPipeline``
    (query/device.py:613-754) on ``device`` (the card unless "cpu"): the
    hash index of the graph's valid edges, the annotation's bitmap, the
    host packing of a batch (``prepare_batch``: the JAX bytes) and
    ``query_labels`` through ``query_step`` (kernels A and 2)."""

    def __init__(self, graph, annotation, device=None):
        from ..annotation.ops import DeviceAnnotation
        from ..device import resolve_device
        from ..kmer.alphabets import ALPHABETS
        from ..kmer.packing import bits_for_alphabet
        from ..succinct.ops import DeviceHashIndex, pack_kmers32
        self.device = resolve_device(device)
        boss = graph.boss
        valid_edges = np.flatnonzero(boss.valid)
        self._bits = bits_for_alphabet(ALPHABETS[graph.alphabet].sigma)
        self.index_keys = pack_kmers32(boss.get_edge_seq(valid_edges),
                                       bits=self._bits)
        self.index_ids = valid_edges.astype(np.uint32)
        self.index = DeviceHashIndex.from_packed(
            self.index_keys, self.index_ids, device=self.device)
        self.annotation = DeviceAnnotation.from_column_annotation(
            annotation, graph.max_index(), self.device)
        self.graph = graph
        self.anno = annotation
        self.k = graph.k

    def _prepare(self, seqs):
        """-> ((Q, W) int32 keys, (Q,) int32 sequence ids) on the device
        and the per-sequence window counts."""
        from ..kmer.packing import boss_priority_order
        from ..succinct.ops import key_words
        k, dev = self.k, self.device
        ex = self.graph.extractor
        codes_list = [ex.encode(s) for s in seqs]
        num_kmers = [max(len(c) - k + 1, 0) for c in codes_list]
        W = key_words(k, self._bits)
        Q = sum(num_kmers)
        if Q == 0:
            return (torch.zeros((0, W), dtype=torch.int32, device=dev),
                    torch.zeros(0, dtype=torch.int32, device=dev), num_kmers)
        sigma = ex.alphabet.sigma
        cat = np.concatenate([np.append(c, np.uint8(sigma))
                              for c in codes_list])
        starts = np.cumsum([0] + [len(c) + 1 for c in codes_list[:-1]])
        n = np.array(num_kmers, dtype=np.int64)
        sid = np.repeat(np.arange(len(seqs), dtype=np.int32), n)
        at = np.repeat(starts, n) + np.arange(Q) - np.repeat(
            np.cumsum(n) - n, n)
        bad = np.concatenate([[0], np.cumsum(cat >= sigma)])
        valid = (bad[at + k] - bad[at]) == 0
        codes_t = torch.from_numpy(cat).to(dev)
        at_t = torch.from_numpy(at).to(dev)
        order = boss_priority_order(k)
        per, bits = 32 // self._bits, self._bits

        def pack(col):
            out = torch.zeros((Q, W), dtype=torch.int64, device=dev)
            for p, j in enumerate(order):
                w, slot = divmod(p, per)
                out[:, w] |= col(int(j)).long() << (32 - bits - bits * slot)
            return out

        keys = pack(lambda j: codes_t[at_t + j])
        if getattr(self.graph, "mode", None) == "canonical":
            comp = torch.from_numpy(ex.extended_complement_table()).to(dev)
            keys = _rowmin_rows(keys, pack(
                lambda j: comp[codes_t[at_t + (k - 1 - j)].long()]))
        keys[~torch.from_numpy(valid).to(dev)] = int(EMPTY_WORD)
        return to_i32(keys), torch.from_numpy(sid).to(dev), num_kmers

    def prepare_batch(self, seqs):
        """The host packing of a batch -> ((Q, W) uint32 windows in BOSS
        priority order, canonical graphs' as the lesser strand, invalid
        windows all EMPTY_WORD; (Q,) int32 sequence ids; per-sequence
        window counts): the JAX arrays."""
        keys, sid, num_kmers = self._prepare(seqs)
        return (keys.cpu().numpy().view(np.uint32), sid.cpu().numpy(),
                num_kmers)

    def query_labels(self, seqs, mode: str = "labels",
                     num_top_labels: int = 2 ** 63,
                     discovery_fraction: float = 0.7,
                     presence_fraction: float = 0.0):
        """LABELS or MATCHES for a batch: per sequence, its labels, or
        (label, count) pairs by count descending, then label code."""
        from ..annotation.annotated_dbg import get_min_count
        queries, seq_ids, num_kmers = self._prepare(seqs)
        S = len(seqs)
        counts, present, _ = query_step(
            self.index.table, self.annotation.bitmap, queries, seq_ids, S,
            self.annotation.num_labels)
        counts, present = counts.cpu().numpy(), present.cpu().numpy()
        labels = self.anno.labels
        out = []
        for i in range(S):
            nk = num_kmers[i]
            min_count = get_min_count(discovery_fraction, presence_fraction,
                                      nk, int(present[i])) if nk else 0
            if nk == 0 or present[i] < min_count:
                out.append([])
                continue
            sel = np.flatnonzero(counts[i] >= min_count)
            if mode == "labels":
                out.append([labels[c] for c in sel])
                continue
            pairs = sorted(((int(counts[i][c]), -int(c)) for c in sel),
                           reverse=True)[: num_top_labels]
            out.append([(labels[-negc], n) for n, negc in pairs])
        return out


def query_epoch_dedup(table: torch.Tensor, bitmap: torch.Tensor,
                      dkeys: torch.Tensor, did_tiles: torch.Tensor,
                      tile_seq: torch.Tensor, num_seqs: int,
                      num_labels: int):
    """The deduplicated epoch: (D + 1, W) int32 distinct keys (row 0 the
    all-EMPTY_WORD row), (N, T) int32 distinct ids of the windows (0 =
    invalid), (N,) tile_seq -> ((S, L) int32 counts, (S,) int32 present).
    Stage A: kernel A on the distinct keys, their annotation rows gathered
    once into a (D + 1, Lw) table; stage B: kernel 2 over that table, a
    window's node id ``where(hit[did], did + 1, 0)`` (table row did)."""
    Lw = bitmap.shape[1]
    ld = -(-Lw // 4) * 4                  # rows 16-byte aligned
    nodes_d = hash_lookup(table, dkeys)
    hit_d = nodes_d > 0
    rows = torch.where(hit_d, nodes_d - 1, 0).long()
    words = torch.zeros((dkeys.shape[0], ld), dtype=torch.int32,
                        device=dkeys.device)
    words[:, :Lw] = bitmap.index_select(0, rows) * hit_d[:, None]
    did = did_tiles.long()
    ids = torch.where(hit_d[did], did + 1, 0).to(torch.int32)
    return count_epoch_tiled(words[:, :Lw], ids, tile_seq, num_seqs,
                             num_labels)


def dedup_batch(queries: np.ndarray, seq_ids: np.ndarray, num_seqs: int,
                tile: int = TILE, device=None):
    """Host packed windows -> ((D + 1, W) uint32 distinct keys, row 0 the
    all-EMPTY_WORD row, then the valid ones in row order; (N, T) int32
    distinct-id tiles (``tile_layout``); (N,) int32 tile_seq; D): the
    JAX ``dedup_batch``, its distinct pass (``np.unique(axis=0)``) on
    ``device`` (the card unless "cpu"): the word pairs joined into 64-bit
    words, which keeps the row order, sorted stably by
    ``packing.lexsort_rows`` (kernel D2)."""
    from ..device import resolve_device
    from ..kmer import packing
    queries = np.asarray(queries, dtype=np.uint32)
    Q, W = queries.shape
    sent = np.full((1, W), EMPTY_WORD, np.uint32)
    dids = np.zeros(Q, np.int32)
    uniq = queries[:0]
    if Q:
        wide = np.zeros((Q, -(-W // 2) * 2), np.uint64)
        wide[:, :W] = queries
        joined = (wide[:, 0::2] << np.uint64(32)) | wide[:, 1::2]
        t = packing.to_device(joined, resolve_device(device))
        perm = packing.lexsort_rows(t)
        s = t.index_select(0, perm)
        new = packing.new_rows(s)
        grp = torch.empty_like(perm)
        grp[perm] = torch.cumsum(new.long(), 0) - 1
        u = packing.to_host(s[new])
        uniq = np.empty((len(u), 2 * u.shape[1]), np.uint32)
        uniq[:, 0::2] = (u >> np.uint64(32)).astype(np.uint32)
        uniq[:, 1::2] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        uniq = uniq[:, :W]
        # the all-EMPTY_WORD row sorts last; it is no distinct key
        D = len(uniq) - int((uniq[-1] == EMPTY_WORD).all())
        g = grp.cpu().numpy()
        dids = np.where(g < D, g + 1, 0).astype(np.int32)
        uniq = uniq[:D]
    D = len(uniq)
    did_tiles, tile_seq = tile_layout(dids, seq_ids, num_seqs, tile=tile,
                                      fill=0)
    return np.concatenate([sent, uniq]), did_tiles, tile_seq, D
