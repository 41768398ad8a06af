"""The wave DP, kernel B11 ``wave_dp``, and the extender that runs on it.

``compute_wave`` scores N banded DP columns of width W in one call: the
stacked column recurrence of metagraph_tpu/align/wave_extender.py
(``compute_wave``, :24) that the flat engine (flat.py) runs once per global
wave over every active extension's children, across all lockstep reads.
On the card it uploads the wave's rows, launches ``wave_dp``
(``csrc/wave_dp.cu``, replacing the XLA program
metagraph_tpu/align/batch.py::_compute_wave_device, :91) once and reads S,
E and F back; on the CPU it runs ``wave_dp_plain``, the same recurrence in
plain PyTorch (``torch.cummax`` for E's running max).

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

# compute_wave's waves, rows, cells and seconds (upload, DP, read-back),
# which ``align -v`` prints
STATS = {"waves": 0, "rows": 0, "cells": 0, "seconds": 0.0}


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
