"""Gather micro-benchmark: how fast can a kernel sum rows gathered at random
from a table that fits the card's L2 cache?

    python -m metagraph_tpu_torch.scripts.exp_gather [--device cuda|cpu]
        [--q-log 22] [--rows-log 16 17] [--qb 1024]

Own copy of scripts/exp_pallas_gather.py.  Every form computes
``out[0, :] = sum_i tab[idx[i], :] mod 2^32`` over ``nblocks * QB``
indices (``nblocks = len(idx) // QB``; a ragged tail is left out), with rows
1-7 of the (8, W) output zero, and ``run(tab, idx)`` returns ``out[0, 0]``
as a 0-d int32 tensor:

* ``make_loop_kernel`` -> ``gather_loop`` (``csrc/gather_rows.cu``), which
  replaces the Pallas ``fori_loop`` kernel (``make_loop_kernel.run``): rows
  summed in registers, 16-byte loads of 8 rows in flight a lane, indices
  fetched a step ahead;
* ``make_take_kernel`` -> ``gather_take`` (same file), which replaces the
  Pallas ``jnp.take`` kernel (``make_take_kernel.run``): rows staged by a
  ring of 16-byte ``cp.async`` copies in shared memory, each stage reduced
  as it lands, indices copied into shared memory stages ahead;
* ``make_plain`` -> ``gather_rows_sum_plain``: ``index_select``, an int64
  sum, masking to 32 bits.

``tab`` holds uint32 words as int32 bit patterns (or is a numpy uint32
array); indices outside [0, n_rows) are clamped.  CPU tensors take the
plain version; CUDA tensors launch the kernel or raise.  Both kernels run
on a persistent grid (``gather_plan``): a few blocks an SM, each summing an
even share of the indices whatever QB is.  ``main`` runs the
JAX script's sweep (tables of 2^16 and 2^17 rows of 32 words, 2^22 random
indices in chunks of 1,024, seed 0) and prints ms and Mgather/s for each
form, "FAILED" for a form that raised.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time

import numpy as np
import torch

from .. import _build
from .._u32 import MASK32, np_words, to_i32
from ..device import resolve_device

OUT_ROWS = 8
SEED = 0                # the JAX script's seed; main's inputs come from it
_P, _I, _L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _check(tab: torch.Tensor, idx: torch.Tensor, QB: int):
    if tab.dtype != torch.int32 or tab.dim() != 2 or not tab.is_contiguous():
        raise ValueError("tab must be a contiguous 2-D int32 tensor")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous 1-D int32 tensor")
    if idx.device != tab.device:
        raise ValueError(f"idx is on {idx.device}, tab on {tab.device}")
    if QB < 1 or tab.shape[0] < 1:
        raise ValueError(f"QB {QB} and n_rows {tab.shape[0]} must be >= 1")


def gather_rows_sum_plain(tab: torch.Tensor, idx: torch.Tensor, QB: int,
                          chunk: int = 1 << 20) -> torch.Tensor:
    """Plain version of both kernels: (n_rows, W) int32 table, (Q,) int32
    indices -> (8, W) int32 bit patterns, row 0 the uint32 row sum."""
    _check(tab, idx, QB)
    n_rows, W = tab.shape
    n = idx.shape[0] // QB * QB
    total = torch.zeros(W, dtype=torch.int64, device=tab.device)
    for lo in range(0, n, chunk):
        rows = idx[lo: min(lo + chunk, n)].long().clamp(0, n_rows - 1)
        total += (tab.index_select(0, rows).long() & MASK32).sum(0)
    out = torch.zeros((OUT_ROWS, W), dtype=torch.int32, device=tab.device)
    out[0] = to_i32(total)
    return out


# Launch shapes, as in csrc/gather_rows.cu
WIDTHS = (4, 8, 16, 32, 64, 128, 256)   # W, a template parameter there
FORM_IDS = {"loop": 0, "take": 1}
WARPS = 8                               # of 32 threads a block
LOOP_ROWS_IN_FLIGHT = 8                 # per lane
STAGES, STAGE_WORDS = 4, 4096           # take: a ring of 16 KB stages
MAX_SMEM = 232_448                      # dynamic shared memory of a block


def _block_rows(form: str, W: int) -> int:
    """Rows one block takes at a time: a step of every warp (loop), a
    stage (take)."""
    if form == "loop":
        lanes_a_row = min(W // 4, 32)
        return WARPS * LOOP_ROWS_IN_FLIGHT * (32 // lanes_a_row)
    return STAGE_WORDS // W


def _shared_bytes(form: str, W: int) -> int:
    if form == "loop":
        return WARPS * W * 4                # the warps' sums
    # the ring, then 2 STAGES slots of a stage's indices
    return STAGES * STAGE_WORDS * 4 + 2 * STAGES * (STAGE_WORDS // W) * 4


@functools.lru_cache(maxsize=256)
def gather_plan(form: str, n: int, W: int, n_sms: int, blocks_per_sm: int):
    """Launch plan of a gather kernel over n indices: (grid, bounds, dynamic
    shared bytes), block b summing indices [bounds[b], bounds[b + 1]).

    The grid is persistent: at most ``blocks_per_sm`` blocks on each of
    ``n_sms`` SMs, and no more blocks than ``n`` has rows for one block
    step, so every share is non-empty; the shares are even, n b // grid,
    as the kernel computes them.  n = 0 plans no block."""
    if form not in FORM_IDS:
        raise ValueError(f"unknown gather form {form!r}")
    if W not in WIDTHS:
        raise ValueError(f"the gather kernels take W in {WIDTHS}, not {W}")
    if n < 0 or n_sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"bad plan: n {n}, {n_sms} SMs, {blocks_per_sm} "
                         "blocks an SM")
    unit = _block_rows(form, W)
    grid = min(n_sms * blocks_per_sm, -(-n // unit))
    bounds = tuple(n * b // grid for b in range(grid + 1)) if grid else (0,)
    return grid, bounds, _shared_bytes(form, W)


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(form: str, W: int, smem: int, device_index: int) -> int:
    fn = _build.function("gather_rows", "mg_gather_occupancy",
                         [_I, _I, _I, ctypes.POINTER(ctypes.c_int32)])
    blocks = ctypes.c_int32(0)
    with torch.cuda.device(device_index):
        _build.check(fn(FORM_IDS[form], W, smem, ctypes.byref(blocks)),
                     "mg_gather_occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"gather {form} at W = {W} fits no block on an SM")
    return blocks.value


def launch_plan(form: str, n: int, W: int, dev: torch.device):
    """gather_plan on card ``dev``: its SM count and the occupancy API's
    resident blocks -> (grid, bounds, dynamic shared bytes, blocks an
    SM)."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    n_sms = torch.cuda.get_device_properties(index).multi_processor_count
    smem = _shared_bytes(form, W)
    bps = _blocks_per_sm(form, W, smem, index)
    return (*gather_plan(form, n, W, n_sms, bps), bps)


def _gather(kernel, form: str, tab: torch.Tensor, idx: torch.Tensor,
            QB: int) -> torch.Tensor:
    _check(tab, idx, QB)
    dev = tab.device
    if dev.type == "cpu":
        return gather_rows_sum_plain(tab, idx, QB)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_rows, W = tab.shape
    if W not in WIDTHS or n_rows >= 2 ** 31 or tab.data_ptr() % 16:
        raise ValueError(f"the gather kernels take a 16-byte aligned table of "
                         f"< 2^31 rows of W = 4, 8, .., 256 words, not "
                         f"{tuple(tab.shape)}")
    out = torch.zeros((OUT_ROWS, W), dtype=torch.int32, device=dev)
    n = idx.shape[0] // QB * QB
    if n == 0:
        return out
    grid, _, smem, _ = launch_plan(form, n, W, dev)
    fn = _build.function("gather_rows", "mg_gather",
                         [_I, _P, _P, _P, _L, _I, _I, _I, _I, _P])
    _build.check(fn(FORM_IDS[form], tab.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), n, n_rows, W, grid, smem,
                    torch.cuda.current_stream(dev).cuda_stream),
                 f"gather_{form}")
    _build.count(kernel)
    return out


def gather_loop(tab: torch.Tensor, idx: torch.Tensor, QB: int
                ) -> torch.Tensor:
    """X1: rows summed in registers, 16-byte loads, a persistent grid."""
    return _gather(gather_loop, "loop", tab, idx, QB)


def gather_take(tab: torch.Tensor, idx: torch.Tensor, QB: int
                ) -> torch.Tensor:
    """X2: rows staged in shared memory by a cp.async ring, a persistent
    grid."""
    return _gather(gather_take, "take", tab, idx, QB)


gather_loop.launches = 0
gather_take.launches = 0


def _maker(fn, n_rows: int, W: int, QB: int, device):
    dev = resolve_device(device)

    def run(tab, idx) -> torch.Tensor:
        tab = (np_words(tab) if isinstance(tab, np.ndarray) else tab).to(dev)
        idx = torch.as_tensor(idx).to(dev)
        if tuple(tab.shape) != (n_rows, W):
            raise ValueError(f"table {tuple(tab.shape)} is not ({n_rows}, "
                             f"{W})")
        return fn(tab, idx, QB)[0, 0]
    return run


def make_loop_kernel(n_rows: int, W: int, QB: int, device=None):
    return _maker(gather_loop, n_rows, W, QB, device)


def make_take_kernel(n_rows: int, W: int, QB: int, device=None):
    return _maker(gather_take, n_rows, W, QB, device)


def make_plain(n_rows: int, W: int, QB: int, device=None):
    return _maker(gather_rows_sum_plain, n_rows, W, QB, device)


VARIANTS = (("loop", make_loop_kernel), ("take", make_take_kernel),
            ("plain", make_plain))


def make_inputs(rng, rows_log: int, Q: int, W: int = 32):
    """The JAX script's inputs: a random uint32 table, then Q indices."""
    n_rows = 1 << rows_log
    tab = rng.integers(0, 2 ** 32, (n_rows, W), dtype=np.uint32)
    idx = rng.integers(0, n_rows, Q).astype(np.int32)
    return tab, idx


def timeit(fn, *args, reps: int = 3, warm: int = 2) -> float:
    """Least seconds of ``reps`` calls after ``warm`` calls, each ended by
    reading the result back."""
    for _ in range(warm):
        r = fn(*args)
    int(r)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        int(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--q-log", type=int, default=22)
    ap.add_argument("--rows-log", type=int, nargs="+", default=[16, 17])
    ap.add_argument("--qb", type=int, default=1 << 10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")
    rng = np.random.default_rng(SEED)
    Q, W, QB = 1 << args.q_log, 32, args.qb
    for rows_log in args.rows_log:
        tab, idx = make_inputs(rng, rows_log, Q, W)
        n_rows = len(tab)
        tab_d, idx_d = np_words(tab).to(dev), torch.from_numpy(idx).to(dev)
        for vname, maker in VARIANTS:
            try:
                run = maker(n_rows, W, QB, device=dev)
                dt = timeit(run, tab_d, idx_d)
                print(f"{vname} rows=2^{rows_log} "
                      f"({n_rows * W * 4 / 1e6:5.1f} MB): {dt * 1e3:7.3f} ms "
                      f"{Q / dt / 1e6:7.1f} Mgather/s", flush=True)
            except Exception as e:
                print(f"{vname} rows=2^{rows_log}: FAILED "
                      f"{type(e).__name__}: {str(e)[:200]}", flush=True)


if __name__ == "__main__":
    main()
