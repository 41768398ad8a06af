"""The wave DP, kernel B11, and the extender that runs on it.

``align_wave`` runs one wave of the flat engine (flat.py) in one launch
over its column store on the card: for each child row, its parent's hull
from the parent's store rows, the hull-masked recurrence of
metagraph_tpu/align/wave_extender.py (``compute_wave``, :24) against its
profile row, the pad past its job's WS, its S, E and F written into the
store row the engine gives it, and the row statistics (the numpy wave
path of metagraph_tpu/align/flat.py, :626-651, whose native form is
native/fastio.cpp::align_wave); ``csrc/wave_dp.cu``, replacing the XLA
program metagraph_tpu/align/batch.py::_compute_wave_device (:91).
``align_wave_plain`` is the same in plain PyTorch, built on
``wave_dp_plain``.

``compute_wave`` scores N banded DP columns of width W in one call, from
the wave's four (N, W) planes on the host: it uploads them, launches
``wave_dp`` (``csrc/wave_dp.cu``) once and reads S, E and F back; on the
CPU it runs ``wave_dp_plain``, the same recurrence in plain PyTorch
(``torch.cummax`` for E's running max).  The engine does not call it.

Everything is int32 with ``NINF = INT32_MIN + 100``, bit-equal to the JAX
``compute_wave`` on int32 arrays: int32 sums wrap as numpy's do, every
NINF operand is guarded (``== NINF``) before it is added to, E's clamp is
tested before its add (``run <= NINF - j ext``) so that it cannot wrap,
cells below a row's cutoff become NINF, and E outside the band survives
only where S does.
"""

from __future__ import annotations

import ctypes
import time
import numpy as np
import torch

from .. import _build
from .config import NINF

# the engine's waves, rows, cells and seconds on the device (its copies
# and align_wave launches: the jobs' tables up, each wave's vectors up and
# read-back down, branch rows up, finished tables down) and their bytes,
# which ``align -v`` prints, and the children that label pruning dropped
# before a wave; compute_wave counts its own calls here too
STATS = {"waves": 0, "rows": 0, "cells": 0, "seconds": 0.0, "bytes_up": 0,
         "bytes_down": 0, "bytes_tables": 0, "pruned": 0}
# where a list: the engine appends (rows, bytes up, bytes down) a wave
WAVE_LOG = None

# align_wave's per-child vectors: NPACK int32 a child, the float64
# ext_cut in the last two (low word first)
(PK_PARENT, PK_ROW, PK_PROF, PK_PSS, PK_SCORE, PK_DEL, PK_CUT, PK_WS,
 PK_WSIZE, PK_DIAG, PK_SLOT, PK_XCUT) = range(12)
NPACK = 13
# its statistics, NSTAT int32 a child
(ST_SMAX, ST_MP, ST_COLMIN, ST_HASEXT, ST_SLP, ST_PMP, ST_PLP, ST_SCMP,
 ST_LO, ST_HI) = range(10)
NSTAT = 10
_POS = 2 ** 31 - 1


def wave_dp_plain(SpM, SpF, Fp, prof, node_score, has_del, band_lo,
                  band_hi, cutoff, gap_open: int, gap_ext: int, out=None):
    """(N, W) int32 SpM, SpF, Fp, prof; (N,) int32 node_score, band_lo,
    band_hi, cutoff and bool has_del -> (S, E, F), each (N, W) int32 (the
    three planes of ``out``, a (3, N, W) int32 tensor, where given)."""
    N, W = SpM.shape
    dev = SpM.device
    i32 = torch.int32
    ninf = torch.tensor(NINF, dtype=i32, device=dev)
    ns = node_score[:, None]
    M = torch.full((N, W), NINF, dtype=i32, device=dev)
    # M[j] = Sp[j-1] + prof[j] + ns   (M[0] = NINF)
    M[:, 1:] = torch.where(SpM[:, :-1] == NINF, ninf,
                           SpM[:, :-1] + prof[:, 1:] + ns)
    # F[j] = max(Sp[j] + open, Fp[j] + ext) + ns, where offset > 1
    F = torch.maximum(torch.where(SpF == NINF, ninf, SpF + gap_open),
                      torch.where(Fp == NINF, ninf, Fp + gap_ext))
    F = torch.where(F == NINF, ninf, F + ns)
    F = torch.where(has_del[:, None], F, ninf)
    M = torch.maximum(M, F)
    # E[j] = max_{i<j} M[i] + open + (j-1-i) ext, through a running max
    E = torch.full((N, W), NINF, dtype=i32, device=dev)
    if W > 1:
        idx = torch.arange(W, dtype=i32, device=dev)
        run = torch.cummax(M + gap_open - (idx + 1)[None, :] * gap_ext,
                           dim=1).values
        jge = (idx[1:] * gap_ext)[None, :]
        E[:, 1:] = torch.where(run[:, :-1] <= NINF - jge, ninf,
                               run[:, :-1] + jge)
    S = torch.maximum(M, E)
    S = torch.where(S < cutoff[:, None], ninf, S)
    jj = torch.arange(W, device=dev)[None, :]
    in_band = (jj >= band_lo[:, None]) & (jj <= band_hi[:, None])
    E = torch.where(in_band | (S != NINF), E, ninf)
    if out is None:
        return S, E, F
    out[0], out[1], out[2] = S, E, F
    return out[0], out[1], out[2]


def _check_inputs(SpM, SpF, Fp, prof, node_score, has_del, band_lo,
                  band_hi, cutoff, out):
    dev = SpM.device
    if SpM.dim() != 2:
        raise ValueError("SpM must be 2-D")
    N, W = SpM.shape
    for name, t, shape, dtype in (
            ("SpM", SpM, (N, W), torch.int32),
            ("SpF", SpF, (N, W), torch.int32),
            ("Fp", Fp, (N, W), torch.int32),
            ("prof", prof, (N, W), torch.int32),
            ("node_score", node_score, (N,), torch.int32),
            ("has_del", has_del, (N,), torch.bool),
            ("band_lo", band_lo, (N,), torch.int32),
            ("band_hi", band_hi, (N,), torch.int32),
            ("cutoff", cutoff, (N,), torch.int32),
            ("out", out, (3, N, W), torch.int32)):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {shape}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")


def wave_dp(SpM, SpF, Fp, prof, node_score, has_del, band_lo, band_hi,
            cutoff, gap_open: int, gap_ext: int, out=None):
    """``wave_dp_plain``'s contract.  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/wave_dp.cu`` (none for an empty wave) or
    raise."""
    _check_inputs(SpM, SpF, Fp, prof, node_score, has_del, band_lo,
                  band_hi, cutoff, out)
    dev = SpM.device
    inputs = (SpM, SpF, Fp, prof, node_score, has_del, band_lo, band_hi,
              cutoff, int(gap_open), int(gap_ext))
    if dev.type == "cpu":
        return wave_dp_plain(*inputs, out)
    if dev.type == "cuda":
        return _launch(*inputs, out)
    raise ValueError(f"unsupported device {dev}")


def _launch(SpM, SpF, Fp, prof, node_score, has_del, band_lo, band_hi,
            cutoff, gap_open, gap_ext, out):
    N, W = SpM.shape
    dev = SpM.device
    if out is None:
        out = torch.empty((3, N, W), dtype=torch.int32, device=dev)
    if N == 0 or W == 0:
        return out[0], out[1], out[2]
    P, I = ctypes.c_void_p, ctypes.c_int32
    fn = _build.function("wave_dp", "mg_wave_dp",
                         [P, P, P, P, P, P, P, P, P, I, I, I, I, P, P])
    _build.check(fn(SpM.data_ptr(), SpF.data_ptr(), Fp.data_ptr(),
                    prof.data_ptr(), node_score.data_ptr(),
                    has_del.data_ptr(), band_lo.data_ptr(),
                    band_hi.data_ptr(), cutoff.data_ptr(), N, W, gap_open,
                    gap_ext, out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream), "wave_dp")
    _build.count(wave_dp)
    return out[0], out[1], out[2]


wave_dp.launches = 0


def wave_tensors(SpM, SpF, Fp, prof, node_score, has_del, band_lo,
                 band_hi, cutoff, device):
    """A wave's numpy rows as ``wave_dp``'s nine tensors on ``device``:
    one upload of the four (N, W) planes, one of the four int32 row
    vectors and one of ``has_del``."""
    N, W = SpM.shape
    dev = torch.device(device)
    mats = np.empty((4, N, W), dtype=np.int32)
    mats[0], mats[1], mats[2], mats[3] = SpM, SpF, Fp, prof
    rows = np.empty((4, N), dtype=np.int32)
    rows[0] = node_score
    rows[1] = band_lo
    rows[2] = band_hi
    rows[3] = cutoff
    m = torch.from_numpy(mats).to(dev)
    r = torch.from_numpy(rows).to(dev)
    hd = torch.from_numpy(np.ascontiguousarray(has_del, dtype=bool)).to(dev)
    return m[0], m[1], m[2], m[3], r[0], hd, r[1], r[2], r[3]


def compute_wave(SpM: np.ndarray, SpF: np.ndarray, Fp: np.ndarray,
                 prof: np.ndarray, node_score: np.ndarray,
                 has_del: np.ndarray, band_lo: np.ndarray,
                 band_hi: np.ndarray, cutoff, gap_open: int, gap_ext: int,
                 device):
    """The wave's (N, W) int32 numpy rows -> (S, E, F) int32 numpy arrays,
    computed on ``device`` by ``wave_dp``: one upload of the four matrices
    and the five row vectors (``wave_tensors``), one launch, one
    read-back."""
    t0 = time.perf_counter()
    N, W = SpM.shape
    inputs = wave_tensors(SpM, SpF, Fp, prof, node_score, has_del, band_lo,
                          band_hi, cutoff, device)
    out = torch.empty((3, N, W), dtype=torch.int32, device=inputs[0].device)
    wave_dp(*inputs, gap_open, gap_ext, out)
    res = out.cpu().numpy()
    STATS["waves"] += 1
    STATS["rows"] += N
    STATS["cells"] += N * W
    STATS["seconds"] += time.perf_counter() - t0
    return res[0], res[1], res[2]


def out_size(CH: int, W: int, slots: int) -> int:
    """int32 elements of ``align_wave``'s output: the statistics, S again
    and two rows (E, the parent's S) a branch slot."""
    return CH * (NSTAT + W) + slots * 2 * W


def out_views(out, CH: int, W: int):
    """-> (stats (CH, NSTAT), S (CH, W), branch rows (slots, 2, W)), views
    of ``out`` (a tensor or an array)."""
    a, b = CH * NSTAT, CH * (NSTAT + W)
    return (out[:a].reshape(CH, NSTAT), out[a:b].reshape(CH, W),
            out[b:].reshape(-1, 2, W))


def take_rows(t, idx):
    """Rows ``idx`` (an int64 tensor) of ``t``: ``index_select`` on the
    card; numpy's gather on the CPU, where torch's threaded gather of a
    few hundred rows stalls while other processes load the cores."""
    if t.device.type == "cpu":
        return torch.from_numpy(t.numpy()[idx.numpy()])
    return t.index_select(0, idx)


def put_rows(t, idx, rows):
    """``t[idx] = rows`` in place, as ``take_rows`` reads."""
    if t.device.type == "cpu":
        t.numpy()[idx.numpy()] = rows.numpy()
    else:
        t.index_copy_(0, idx, rows)


def wave_planes(store, tables, pack, W: int):
    """The wave's rows as ``wave_dp`` takes them, gathered from the store
    and the tables by the packed per-child vectors: (SpM, SpF, Fp, prof,
    node_score, has_del, band_lo, band_hi, cutoff) and the parents' S
    rows, each (N, W)."""
    p = pack.long()
    dev = store.device
    par = take_rows(store, p[:, PK_PARENT])
    Sp, Fq = par[:, 0, :W], par[:, 2, :W]
    cut = pack[:, PK_CUT].contiguous()
    jj = torch.arange(W, device=dev)
    inr = (Sp >= cut[:, None]).to(torch.int8)
    first = inr.argmax(dim=1)
    last = W - 1 - inr.flip(1).argmax(dim=1)
    band_hi = torch.minimum(last + 1, p[:, PK_WSIZE])
    hull_m = (jj >= (first - 1).clamp(min=0)[:, None]) \
        & (jj <= (band_hi - 1)[:, None])
    hull_f = (jj >= first[:, None]) & (jj <= band_hi[:, None])
    ninf = torch.tensor(NINF, dtype=torch.int32, device=dev)
    return (torch.where(hull_m, Sp, ninf), torch.where(hull_f, Sp, ninf),
            torch.where(hull_f, Fq, ninf),
            take_rows(tables, p[:, PK_PROF])[:, :W].contiguous(),
            pack[:, PK_SCORE].contiguous(), pack[:, PK_DEL] != 0,
            first.to(torch.int32), band_hi.to(torch.int32), cut), Sp


def align_wave_plain(store, tables, pack, W: int, gap_open: int,
                     gap_ext: int, out):
    """``align_wave`` in plain PyTorch: ``wave_planes``, ``wave_dp_plain``,
    the pad, the store rows written, the statistics -> out's views."""
    CH = pack.shape[0]
    stats, srows, brows = out_views(out, CH, W)
    if CH == 0:
        return stats, srows, brows
    dev = store.device
    p = pack.long()
    planes, Sp = wave_planes(store, tables, pack, W)
    S, E, F = wave_dp_plain(*planes, gap_open, gap_ext)
    ninf = torch.tensor(NINF, dtype=torch.int32, device=dev)
    pos = torch.tensor(_POS, dtype=torch.int32, device=dev)
    jj = torch.arange(W, device=dev)
    pad = jj[None, :] >= p[:, PK_WS][:, None]
    S, E, F = (torch.where(pad, ninf, x) for x in (S, E, F))
    rows = take_rows(store, p[:, PK_ROW])
    rows[:, 0, :W], rows[:, 1, :W], rows[:, 2, :W] = S, E, F
    put_rows(store, p[:, PK_ROW], rows)
    smax = S.amax(dim=1)
    dist = (jj.to(torch.int32)[None, :] - pack[:, PK_DIAG][:, None]).abs()
    dist = torch.where(pad, pos, dist)
    mp = torch.where(S == smax[:, None], dist, pos).argmin(dim=1)
    # S + pss in int32 two's complement, then against the float64 cut
    tot = S.long() + take_rows(tables, p[:, PK_PSS])[:, :W].long()
    tot = ((tot + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
    xcut = pack[:, PK_XCUT:PK_XCUT + 2].reshape(-1).clone() \
        .view(torch.float64)[:, None]
    wsize = p[:, PK_WSIZE][:, None]
    mp = mp[:, None]

    def at(x, j):
        return x.gather(1, j)[:, 0]

    stats[:, ST_SMAX] = smax
    stats[:, ST_MP] = mp[:, 0]
    stats[:, ST_COLMIN] = torch.where(S == NINF, pos, S).amin(dim=1)
    stats[:, ST_HASEXT] = (tot.double() >= xcut).any(dim=1)
    stats[:, ST_SLP] = at(S, wsize)
    stats[:, ST_PMP] = at(Sp, (mp - 1).clamp(min=0))
    stats[:, ST_PLP] = at(Sp, (wsize - 1).clamp(min=0))
    stats[:, ST_SCMP] = at(planes[3], mp)
    stats[:, ST_LO] = planes[6]
    stats[:, ST_HI] = planes[7]
    srows[:] = S
    later = torch.nonzero(p[:, PK_SLOT] >= 0)[:, 0]
    if len(later):
        put_rows(brows, p[:, PK_SLOT].index_select(0, later),
                 torch.stack((E.index_select(0, later),
                              Sp.index_select(0, later)), dim=1))
    return stats, srows, brows


def _check_wave(store, tables, pack, W, out):
    dev = store.device
    for name, t, dim in (("store", store, 3), ("tables", tables, 2),
                         ("pack", pack, 2), ("out", out, 1)):
        if t.dtype != torch.int32 or t.dim() != dim \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D int32 "
                             "tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    CH = pack.shape[0]
    Wp = store.shape[2]
    rest = out.numel() - CH * (NSTAT + W)
    if store.shape[1] != 3 or tables.shape[1] != Wp or not 0 < W <= Wp \
            or pack.shape[1] != NPACK or rest < 0 or rest % (2 * W):
        raise ValueError(f"align_wave: store {tuple(store.shape)}, tables "
                         f"{tuple(tables.shape)}, pack {tuple(pack.shape)}, "
                         f"out {out.numel()} do not fit W = {W}")


def align_wave(store, tables, pack, W: int, gap_open: int, gap_ext: int,
               out):
    """One wave over the column store ``store`` ((R, 3, Wp) int32: S, E, F
    a row), the profile and partial-sum rows ``tables`` ((Q, Wp) int32)
    and the packed per-child vectors ``pack`` ((CH, NPACK) int32): writes
    each child's S, E and F into its store row and fills ``out``
    (``out_size`` int32) -> ``out_views``.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/wave_dp.cu`` (none for an empty
    wave) or raise."""
    _check_wave(store, tables, pack, W, out)
    dev = store.device
    if dev.type == "cpu":
        return align_wave_plain(store, tables, pack, W, int(gap_open),
                                int(gap_ext), out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    CH = pack.shape[0]
    if CH:
        P, I = ctypes.c_void_p, ctypes.c_int32
        fn = _build.function("wave_dp", "mg_align_wave",
                             [P, P, P, I, I, I, I, I, P, P])
        _build.check(fn(store.data_ptr(), tables.data_ptr(),
                        pack.data_ptr(), CH, W, store.shape[2],
                        int(gap_open), int(gap_ext), out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream),
                     "align_wave")
        _build.count(align_wave)
    return out_views(out, CH, W)


align_wave.launches = 0


def run_wave(store, tables, pack_host, W: int, gap_open: int, gap_ext: int,
             out_host):
    """The engine's wave on the store's device: the packed vectors up in
    one copy, one ``align_wave``, its output down in one copy into
    ``out_host`` (pinned where the store is on the card) -> its views as
    numpy arrays; its seconds go to ``STATS``."""
    t0 = time.perf_counter()
    dev = store.device
    pack = pack_host.to(dev, non_blocking=True)
    out = out_host if dev.type == "cpu" else torch.empty(
        out_host.shape, dtype=torch.int32, device=dev)
    align_wave(store, tables, pack, W, gap_open, gap_ext, out)
    if out is not out_host:
        out_host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    STATS["seconds"] += time.perf_counter() - t0
    return out_views(out_host.numpy(), pack_host.shape[0], W)
