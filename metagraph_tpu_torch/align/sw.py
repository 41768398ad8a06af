"""Batched affine-gap local alignment scores and kernel 4, ``sw_scores``.

``batch_local_align_scores`` has the signature and result of
metagraph_tpu/align/pallas_sw.py:100-132; ``sw_scores`` wraps the
hand-written kernel (``csrc/sw_scores.cu``) that replaces the Pallas kernel
``_sw_kernel`` (:35), and ``sw_scores_plain`` is the same recurrence in
plain PyTorch, a line-by-line translation of the Pallas kernel: int32 DP
rows, the query along the last axis, and E as a log-step max-plus prefix
scan of max(M, F) (valid because gap_open <= gap_ext).
``reference_local_align_score`` is the numpy oracle (pallas_sw.py:135-153).

The kernel walks E sequentially, E[j] = max(E[j-1] + ext, SF[j-1] + open),
which is the scan's prefix max unrolled by one term and holds for any
scores; its wavefront gives each lane ``positions_per_lane(LQ)`` query
positions (the template parameter it launches with).  A query of more than
1,024 positions runs in the query blocks of ``query_blocks``, one launch a
block, each carrying its last column's S and E to the next through B x LR
x 8 bytes of scratch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..device import resolve_device

NEG = -(2 ** 30)
BLOCK_QUERY = 1024    # positions a launch takes: 32 lanes x at most 32


def _shift_right(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """[x0..xn] -> [fill]*s + [x0..x(n-s)] along the last axis."""
    if s >= x.shape[1]:
        return torch.full_like(x, fill)
    return torch.cat([torch.full_like(x[:, :s], fill), x[:, :-s]], dim=1)


def sw_scores_plain(queries: torch.Tensor, refs: torch.Tensor, match: int,
                    mismatch: int, gap_open: int,
                    gap_ext: int) -> torch.Tensor:
    """(B, LQ), (B, LR) int32 codes -> (B,) int32 best local scores."""
    B, LQ = queries.shape
    dev = queries.device
    q = queries.to(torch.int32)
    jidx = torch.arange(LQ, dtype=torch.int32, device=dev)[None, :]
    s = torch.zeros((B, LQ), dtype=torch.int32, device=dev)
    f = torch.full((B, LQ), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(refs.shape[1]):
        r_i = refs[:, i: i + 1].to(torch.int32)
        sub = torch.where(q == r_i, match, mismatch).to(torch.int32)
        sub = torch.where((q < 0) | (r_i < 0), NEG, sub).to(torch.int32)
        m = _shift_right(s, 1, 0) + sub
        f = torch.maximum(s + gap_open, f + gap_ext)
        sf = torch.maximum(m, f)
        c = sf - jidx * gap_ext
        shift = 1
        while shift < LQ:
            c = torch.maximum(c, _shift_right(c, shift, NEG))
            shift *= 2
        e = _shift_right(c, 1, NEG) + gap_open + (jidx - 1) * gap_ext
        s = torch.clamp(torch.maximum(sf, e), min=0)
        best = torch.maximum(best, s.amax(dim=1) if LQ else best)
    return best


def query_blocks(LQ: int):
    """Kernel 4's split of a query of LQ >= 1 positions: (P, blocks).  One
    block of P = ceil(LQ / 32) up to 1,024 positions; beyond, blocks of 32 P
    positions (the last one shorter), P = ceil(ceil(LQ / n0) / 32) with n0 =
    ceil(LQ / 1024), as csrc/sw_scores.cu splits them."""
    n0 = -(-LQ // BLOCK_QUERY)
    P = -(-(-(-LQ // n0)) // 32)
    return P, -(-LQ // (32 * P))


def positions_per_lane(LQ: int) -> int:
    """Query positions a lane of kernel 4 owns."""
    return query_blocks(LQ)[0]


def sw_scores(queries: torch.Tensor, refs: torch.Tensor, match: int = 2,
              mismatch: int = -3, gap_open: int = -6,
              gap_ext: int = -2) -> torch.Tensor:
    """(B, LQ), (B, LR) int32 -> (B,) int32.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/sw_scores.cu`` or raise."""
    dev = queries.device
    for name, t in (("queries", queries), ("refs", refs)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    B, LQ = queries.shape
    if refs.shape[0] != B:
        raise ValueError("queries and refs need the same batch size")
    if dev.type == "cpu":
        return sw_scores_plain(queries, refs, match, mismatch, gap_open,
                               gap_ext)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or LQ == 0:
        return out
    LR = refs.shape[1]
    _, blocks = query_blocks(LQ)
    # the boundary column's (S, E) of each pair and reference row
    carry = torch.empty((B, LR, 2), dtype=torch.int32, device=dev) \
        if blocks > 1 else None
    P, I = ctypes.c_void_p, ctypes.c_int32
    fn = _build.function("sw_scores", "mg_sw_scores",
                         [P, P, P, I, I, I, I, I, I, I, P, P])
    _build.check(fn(queries.data_ptr(), refs.data_ptr(), out.data_ptr(), B,
                    LQ, LR, match, mismatch, gap_open, gap_ext,
                    None if carry is None else carry.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream), "sw_scores")
    _build.count(sw_scores, blocks)
    return out


sw_scores.launches = 0


def batch_local_align_scores(queries: np.ndarray, refs: np.ndarray,
                             match: int = 2, mismatch: int = -3,
                             gap_open: int = -6, gap_ext: int = -2,
                             device=None) -> np.ndarray:
    """(B, LQ), (B, LR) int32 code arrays (negative = padding) -> (B,)
    scores, on ``device`` (default "cuda")."""
    dev = resolve_device(device)
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.int32))
    r = torch.from_numpy(np.ascontiguousarray(refs, dtype=np.int32))
    return sw_scores(q.to(dev), r.to(dev), int(match), int(mismatch),
                     int(gap_open), int(gap_ext)).cpu().numpy()


def reference_local_align_score(q, r, match=2, mismatch=-3, gap_open=-6,
                                gap_ext=-2) -> int:
    """numpy oracle (plain O(LQ*LR) Gotoh local alignment)."""
    LQ, LR = len(q), len(r)
    S = np.zeros(LQ + 1, dtype=np.int64)
    F = np.full(LQ + 1, NEG, dtype=np.int64)
    best = 0
    for i in range(LR):
        S_new = np.zeros(LQ + 1, dtype=np.int64)
        E = NEG
        for j in range(1, LQ + 1):
            sub = match if q[j - 1] == r[i] and q[j - 1] >= 0 and r[i] >= 0 \
                else (NEG if q[j - 1] < 0 or r[i] < 0 else mismatch)
            F[j] = max(S[j] + gap_open, F[j] + gap_ext)
            E = max(S_new[j - 1] + gap_open, E + gap_ext)
            S_new[j] = max(0, S[j - 1] + sub, E, F[j])
            best = max(best, S_new[j])
        S = S_new
    return int(best)
