"""Time kernels 3 and 4 (``selection_mask``, ``sw_scores``) of one tree of
the port on the card, each held exactly against its plain version.

    python metagraph_tpu_torch/scripts/kernel_times.py [--root DIR]

``--root`` names the tree whose ``metagraph_tpu_torch`` is imported (by
default the one this file lives in), so that two trees, say a commit
unpacked with ``git archive`` and the working tree, can be timed on one
card in turns: their wrappers take the same arguments.  The inputs come
from fixed seeds:

* ``sw_scores`` on 4,096 pairs of 150 x 300 and 1,024 pairs of 1,000 x
  1,000 (the two shapes of ``chip_smoke.py``'s SW phase: related pairs,
  ragged padding on both sides), default scores;
* ``selection_mask`` on (150,001, 1,000) int32 counts (the query
  deployments' shape) with every row's presence passing (selmin = 0) and
  with half of the rows failing it.

The last line of stdout is a JSON object of the times (CUDA events, mean of
``--reps`` launches after a warm-up) and the card.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SW_SHAPES = ((4096, 150, 300), (1024, 1000, 1000))
SELECT_SHAPE = (150_001, 1000)


def sw_pairs(rng, B, LQ, LR):
    """Pairs sharing a mutated segment, with ragged padding on both
    sides."""
    qs = rng.integers(0, 4, (B, LQ)).astype(np.int32)
    rs = rng.integers(0, 4, (B, LR)).astype(np.int32)
    for b in range(B):
        n = int(rng.integers(LQ // 3, LQ))
        at = int(rng.integers(0, LR - n))
        seg = qs[b, :n].copy()
        mut = rng.random(n) < 0.05
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        rs[b, at: at + n] = seg
        qs[b, int(rng.integers(LQ - LQ // 5, LQ + 1)):] = -1
        rs[b, int(rng.integers(LR - LR // 5, LR + 1)):] = -1
    return qs, rs


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def exact(torch, got, want, what):
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what} disagrees with its plain version")


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from metagraph_tpu_torch.align.sw import sw_scores, sw_scores_plain
    from metagraph_tpu_torch.query import device as qd
    dev = torch.device("cuda")
    times = {}
    rng = np.random.default_rng(0)
    for B, LQ, LR in SW_SHAPES:
        qs, rs = sw_pairs(rng, B, LQ, LR)
        q, r = torch.from_numpy(qs).to(dev), torch.from_numpy(rs).to(dev)
        exact(torch, sw_scores(q, r), sw_scores_plain(q, r, 2, -3, -6, -2),
              "sw_scores")
        key = f"sw_scores {B}x{LQ}x{LR}"
        times[key] = cuda_ms(torch, lambda: sw_scores(q, r), args.reps)
        print(f"{key}: {times[key]:.4f} ms", flush=True)
    S, L = SELECT_SHAPE
    counts = torch.from_numpy(rng.integers(0, 40, (S, L)).astype(np.int32))
    present = torch.from_numpy(rng.integers(0, 200, S).astype(np.int32))
    dsel = torch.from_numpy(rng.integers(1, 40, S).astype(np.int32))
    half = torch.where(torch.arange(S) % 2 == 0, 0, 2 ** 31 - 1)
    counts, present, dsel = counts.to(dev), present.to(dev), dsel.to(dev)
    for what, selmin in (("every row", torch.zeros_like(present)),
                         ("half the rows", half.to(dev, torch.int32))):
        exact(torch, qd.selection_mask(counts, present, dsel, selmin),
              qd.selection_mask_plain(counts, present, dsel, selmin),
              "selection_mask")
        key = f"selection_mask {S}x{L} {what}"
        times[key] = cuda_ms(torch, lambda: qd.selection_mask(
            counts, present, dsel, selmin), args.reps)
        print(f"{key}: {times[key]:.4f} ms", flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "ms": times,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
