"""The device half of the annotated batch query, and kernels 2 and 3.

Own copies of metagraph_tpu/query/device.py's host helpers (``TILE``,
``wire_words_layout`` :463, ``untile_nodes`` :517) and of ``_thresholds``
(query/pipeline.py:32-50), plain PyTorch versions of ``_tile_label_counts``
(:107), ``_fold_tiles`` (:152) and ``_pack_selection_mask`` (:168), and the
wrappers of the hand-written kernels that replace them:

* ``label_counts`` (``csrc/label_counts.cu``): node ids -> (S, L) counts and
  (S,) present, replacing ``gather_anno_rows`` + ``_tile_label_counts`` +
  ``_fold_tiles`` in one pass.  The fold is integer arithmetic: the JAX
  package's f32 matmul fold is exact only below 2^24.
* ``selection_mask`` (``csrc/selection_mask.cu``): the packed label mask.

``wire_epoch`` chains kernels 1 to 3 with the return contract of
``query_epoch_wire_buf``.  The TPU's fused upload buffer, chunk scan and
geometric tile padding served its host link and its recompiles and are not
copied.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .._u32 import to_i32, to_u64
from ..annotation.ops import gather_anno_rows
from ..succinct.ops import wire_lookup

TILE = 256   # windows per tile


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
                       num_labels: int, chunk: int = 64):
    """Plain version of kernel 2, ``chunk`` tiles at a time."""
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
                 tile_seq: torch.Tensor, num_seqs: int, num_labels: int):
    """(N, T) node ids, (R, Lw) bitmap, (N,) tile_seq -> ((S, L) int32
    counts, (S,) int32 present).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/label_counts.cu`` or raise."""
    dev = nodes.device
    _require(dev, nodes=nodes, bitmap=bitmap, tile_seq=tile_seq)
    N, T = nodes.shape
    R, Lw = bitmap.shape
    if Lw != max((num_labels + 31) // 32, 1) or T % 32 \
            or tile_seq.shape != (N,):
        raise ValueError(f"bad shapes: nodes {tuple(nodes.shape)} bitmap "
                         f"{tuple(bitmap.shape)} for {num_labels} labels")
    if dev.type == "cpu":
        return label_counts_plain(nodes, bitmap, tile_seq, num_seqs,
                                  num_labels)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    counts = torch.zeros((num_seqs, num_labels), dtype=torch.int32,
                         device=dev)
    present = torch.zeros(num_seqs, dtype=torch.int32, device=dev)
    if N == 0:
        return counts, present
    fn = _build.function("label_counts", "mg_label_counts",
                         [_P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _P])
    _build.check(fn(nodes.data_ptr(), bitmap.data_ptr(), tile_seq.data_ptr(),
                    counts.data_ptr(), present.data_ptr(), N, T, R, Lw,
                    num_labels, torch.cuda.current_stream(dev).cuda_stream),
                 "label_counts")
    label_counts.launches += 1
    return counts, present


label_counts.launches = 0


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
    Lw = max((L + 31) // 32, 1)
    mask = torch.empty((S, Lw), dtype=torch.int32, device=dev)
    if S == 0:
        return mask
    fn = _build.function("selection_mask", "mg_selection_mask",
                         [_P, _P, _P, _P, _P, _L, _I, _I, _P])
    _build.check(fn(counts.data_ptr(), present.data_ptr(), dsel.data_ptr(),
                    selmin.data_ptr(), mask.data_ptr(), S, L, Lw,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "selection_mask")
    selection_mask.launches += 1
    return mask


selection_mask.launches = 0


def wire_epoch(table: torch.Tensor, bitmap: torch.Tensor,
               words: torch.Tensor, vwords: torch.Tensor,
               tile_seq: torch.Tensor, dsel: torch.Tensor,
               selmin: torch.Tensor, num_seqs: int, num_labels: int, K: int,
               T: int = TILE):
    """The basic-graph wire epoch: (N, NW) wire words, (N, NV) valid words,
    (N,) tile_seq and (S,) thresholds -> (mask (S, Lw), counts (S, L),
    present (S,), nodes (N, T)), the contract of query_epoch_wire_buf
    without its padding."""
    nodes = wire_lookup(words, vwords, table, K, T)
    counts, present = label_counts(nodes, bitmap, tile_seq, num_seqs,
                                   num_labels)
    mask = selection_mask(counts, present, dsel, selmin)
    return mask, counts, present, nodes
