"""Kernel 3, ``selection_mask``: a numpy model of the kernel's packing
(csrc/selection_mask.cu) against the plain version, and the launch plan.

tests/test_torch_device.py holds the plain version against the JAX
package's ``_pack_selection_mask``; tests/test_torch_gpu.py holds the CUDA
kernel against the plain version on the card.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu_torch._u32 import words_np
from metagraph_tpu_torch.query import device as tdev

I32MAX = np.iinfo(np.int32).max
LS = (1, 3, 4, 31, 32, 33, 100, 1000, 1001)


def _inputs(L, S=12, seed=0):
    """Rows of every kind: thresholds met and missed, present < selmin,
    selmin = INT32_MAX (no k-mers), counts at 0 and at INT32_MAX, and
    dsel = INT32_MAX met by INT32_MAX counts."""
    rng = np.random.default_rng(seed + L)
    counts = rng.integers(0, 20, (S, L)).astype(np.int32)
    counts[rng.random((S, L)) < 0.1] = 0
    counts[rng.random((S, L)) < 0.1] = I32MAX
    present = rng.integers(0, 30, S).astype(np.int32)
    dsel = rng.integers(1, 15, S).astype(np.int32)
    selmin = rng.integers(1, 25, S).astype(np.int32)
    selmin[0] = I32MAX                          # a sequence without k-mers
    present[1], selmin[1] = 5, 6                # presence just missed
    present[2], selmin[2] = 6, 6                # presence just met
    present[3], selmin[3], dsel[3] = I32MAX, 1, I32MAX
    counts[4] = I32MAX
    dsel[5] = 1
    return counts, present, dsel, selmin


def packed_model(counts, present, dsel, selmin, V):
    """The kernel's packing, lane by lane: a warp takes a row 1,024 labels
    (32 words) a step; V = 4: lane l compares labels 128 g + 4 l .. + 3 of
    group g into a nibble at bit 4 (l % 8), three xor-shuffles OR an 8-lane
    group into word 4 g + l // 8, and lane k takes word k from lane
    8 (k % 4) of group k // 4; V = 1: word g is the ballot of labels
    32 g + l, kept by lane g.  Rows whose presence fails stay 0."""
    S, L = counts.shape
    Lw = max(-(-L // 32), 1)
    lanes = np.arange(32)
    out = np.zeros((S, Lw), np.uint32)
    keep = present >= selmin
    c64, d = counts.astype(np.int64), dsel.astype(np.int64)[:, None]
    for base in range(0, L, 1024):
        word = np.zeros((S, 32), np.uint32)
        for g in range(8 if V == 4 else 32):
            if V == 4:
                lab = base + 128 * g + 4 * lanes
                nib = np.zeros((S, 32), np.uint32)
                for j in range(4):
                    c = c64[:, np.minimum(lab + j, L - 1)]
                    nib |= ((lab < L) & (c >= d)).astype(np.uint32) << j
                w = nib << (4 * (lanes & 7)).astype(np.uint32)
                for x in (1, 2, 4):
                    w = w | w[:, lanes ^ x]
                mine = w[:, (lanes & 3) * 8]
                word = np.where(lanes >> 2 == g, mine, word)
            else:
                lab = base + 32 * g + lanes
                bits = (lab < L) & (c64[:, np.minimum(lab, L - 1)] >= d)
                ballot = (bits.astype(np.uint64) << lanes.astype(np.uint64)
                          ).sum(axis=1).astype(np.uint32)
                word = np.where(lanes == g, ballot[:, None], word)
        w = base // 32 + lanes
        out[:, w[w < Lw]] = word[:, w < Lw]
    return np.where(keep[:, None], out, 0).astype(np.uint32)


@pytest.mark.parametrize("V,L", [(4, L) for L in LS if L % 4 == 0]
                         + [(1, L) for L in LS])
def test_packing_model_matches_plain(V, L):
    counts, present, dsel, selmin = _inputs(L, seed=V)
    want = tdev.selection_mask_plain(*(torch.from_numpy(a) for a in
                                       (counts, present, dsel, selmin)))
    np.testing.assert_array_equal(
        packed_model(counts, present, dsel, selmin, V), words_np(want))


# (S, L, counts address, SMs, blocks an SM) -> (V, grid)
PLANS = [((150_001, 1000, 1 << 20, 132, 8), (4, 1056)),
         ((150_001, 1001, 1 << 20, 132, 8), (1, 1056)),
         ((150_001, 1000, (1 << 20) + 4, 132, 8), (1, 1056)),
         ((1, 1000, 0, 132, 8), (4, 1)),
         ((8, 3, 0, 132, 8), (1, 1)),
         ((9, 4, 16, 132, 8), (4, 2)),
         ((1056 * 8 + 1, 32, 48, 132, 8), (4, 1056))]


@pytest.mark.parametrize("args,want", PLANS,
                         ids=["-".join(map(str, a)) for a, _ in PLANS])
def test_selection_plan(args, want):
    """V = 4 only for aligned rows; the grid fills the card, and no block
    starts without a row for its first warp."""
    vec, grid = tdev.selection_plan(*args)
    assert (vec, grid) == want
    S, _, _, n_sms, bps = args
    assert 1 <= grid <= n_sms * bps
    assert (grid - 1) * tdev.SELECT_WARPS < S


@pytest.mark.parametrize("args", [(0, 10, 0, 132, 8), (5, -1, 0, 132, 8),
                                  (5, 10, 0, 0, 8), (5, 10, 0, 132, 0)])
def test_selection_plan_refuses_bad_input(args):
    with pytest.raises(ValueError):
        tdev.selection_plan(*args)
