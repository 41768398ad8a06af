"""The port's batch_local_align_scores against the Pallas kernel
(metagraph_tpu/align/pallas_sw.py, interpret=True) and the numpy oracle.

On the CPU the port runs the plain PyTorch version of kernel 4
(tests/test_torch_gpu.py holds the CUDA kernel against it on the card).
A numpy model of the kernel's schedule, its query blocks and their carry
included, is held against both here.
"""

import numpy as np
import pytest

from metagraph_tpu.align.pallas_sw import \
    batch_local_align_scores as pallas_scores
from metagraph_tpu_torch.align.sw import (batch_local_align_scores,
                                          query_blocks,
                                          reference_local_align_score)


def _test_align_fixture():
    """tests/test_align.py::TestPallasSW's inputs."""
    rng = np.random.default_rng(0)
    B, LQ, LR = 12, 48, 64
    qs = rng.integers(0, 4, size=(B, LQ)).astype(np.int32)
    rs = rng.integers(0, 4, size=(B, LR)).astype(np.int32)
    for b in range(0, B, 3):
        rs[b, 5:35] = qs[b, 2:32]
    qs[1, 40:] = -1
    return qs, rs


def _ragged(seed, B, LQ, LR):
    """Related pairs with ragged padding on both sides; LQ not a power of
    two."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, size=(B, LQ)).astype(np.int32)
    rs = rng.integers(0, 4, size=(B, LR)).astype(np.int32)
    for b in range(B):
        n = int(rng.integers(5, min(LQ, LR - 1)))
        at = int(rng.integers(0, LR - n))
        rs[b, at: at + n] = qs[b, :n]
        mut = rng.random(n) < 0.1
        rs[b, at: at + n][mut] = rng.integers(0, 4, int(mut.sum()))
        qs[b, int(rng.integers(LQ // 2, LQ + 1)):] = -1
        rs[b, int(rng.integers(LR // 2, LR + 1)):] = -1
    return qs, rs


CASES = {"test_align": _test_align_fixture,
         "ragged_37x50": lambda: _ragged(1, 9, 37, 50),
         "ragged_70x41": lambda: _ragged(2, 6, 70, 41)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scores_match_pallas_and_oracle(case):
    qs, rs = CASES[case]()
    got = batch_local_align_scores(qs, rs, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(qs),)
    np.testing.assert_array_equal(got, pallas_scores(qs, rs, interpret=True))
    want = [reference_local_align_score(q, r) for q, r in zip(qs, rs)]
    np.testing.assert_array_equal(got, want)
    assert got.max() > 20


def test_scoring_parameters_pass_through():
    qs, rs = _ragged(3, 5, 24, 30)
    kw = dict(match=3, mismatch=-2, gap_open=-5, gap_ext=-1)
    got = batch_local_align_scores(qs, rs, device="cpu", **kw)
    np.testing.assert_array_equal(
        got, pallas_scores(qs, rs, interpret=True, **kw))
    np.testing.assert_array_equal(
        got, [reference_local_align_score(q, r, **kw) for q, r in zip(qs, rs)])


# --------------------------------------------------------------------------
# kernel 4's schedule (csrc/sw_scores.cu), modelled in numpy
# --------------------------------------------------------------------------

NEG = -(2 ** 30)
SCORES = {"default": dict(match=2, mismatch=-3, gap_open=-6, gap_ext=-2),
          "open_gt_ext": dict(match=2, mismatch=-3, gap_open=-1, gap_ext=-3),
          # a gap that scores: positions past LQ could beat the best, so
          # the kernel's per-position mask matters
          "gap_scores": dict(match=2, mismatch=-3, gap_open=1, gap_ext=0)}


def _i32(x, act):
    """The kernel's int32 arithmetic: every value a working lane forms
    fits."""
    live = x[:, act]
    assert live.min(initial=0) >= -2 ** 31 and live.max(initial=0) < 2 ** 31
    return x


def _wavefront_block(qs, rs, P, carry, match, mismatch, gap_open, gap_ext):
    """One launch of the kernel's wavefront, step by step: lane p owns
    query positions p P .. p P + P - 1 of the block and works on reference
    row t - p at step t; E entering a lane's first position, the S of its
    last position and the reference code come from lane p - 1's previous
    step; E runs E[j] = max(E[j-1] + ext, SF[j-1] + open) inside the lane.
    Padded query positions and positions past the block get code -2 and
    mismatch NEG, a padded row adds NEG, and one best a position is masked
    to the block's positions at the end.  With a ``carry`` (B, LR, 2) of
    the previous block, lane 0 takes row t's S and E from it (and row t -
    1's S as its diagonal) instead of 0 and NEG.  -> ((B,) best, the
    carry lane 31 writes: row i's S of its last position and the E after
    it, at step i + 31)."""
    B, LQ = qs.shape
    LR = rs.shape[1]
    lanes = np.arange(32)
    pos = lanes[:, None] * P + np.arange(P)
    valid = pos < LQ
    q = np.where(valid, qs[:, np.minimum(pos, LQ - 1)], -1).astype(np.int64)
    qv, qx = np.where(q < 0, -2, q), np.where(q < 0, NEG, mismatch)
    s = np.zeros((B, 32, P), np.int64)
    f = np.full((B, 32, P), NEG, np.int64)
    bk = np.zeros((B, 32, P), np.int64)
    s_out, sleft, rcode = (np.zeros((B, 32), np.int64) for _ in range(3))
    e_out = np.full((B, 32), NEG, np.int64)
    out = np.zeros((B, LR, 2), np.int64)
    first = lanes == 0

    def up(x):                  # __shfl_up_sync by 1: lane 0 keeps its own
        return np.concatenate([x[:, :1], x[:, :-1]], axis=1)

    for t in range(LR + (LQ - 1) // P):
        e_in, s_in, r_up = up(e_out), up(s_out), up(rcode)
        r_new = rs[:, t] if t < LR else np.zeros(B, np.int64)
        c_s, c_e = (carry[:, t, 0], carry[:, t, 1]) \
            if carry is not None and t < LR else (0, NEG)
        diag = sleft if carry is not None else np.where(first, 0, sleft)
        sleft = np.where(first, np.reshape(c_s, (-1, 1)), s_in)
        rcode = np.where(first, r_new[:, None], r_up)
        act = (t - lanes >= 0) & (t - lanes < LR)
        ri = np.where(rcode < 0, -1, rcode)
        rb = np.where(rcode < 0, NEG, 0)
        e = np.where(first, np.reshape(c_e, (-1, 1)), e_in)
        for k in range(P):
            sub = np.where(qv[..., k] == ri, match, qx[..., k])
            m = _i32(diag + sub + rb, act)
            diag = s[..., k].copy()
            fk = np.maximum(s[..., k] + gap_open,
                            _i32(f[..., k] + gap_ext, act))
            sf = np.maximum(m, fk)
            sk = np.maximum(np.maximum(sf, e), 0)
            e = np.maximum(sf + gap_open, _i32(e + gap_ext, act))
            f[..., k] = np.where(act, fk, f[..., k])
            s[..., k] = np.where(act, sk, s[..., k])
            bk[..., k] = np.where(act, np.maximum(bk[..., k], sk),
                                  bk[..., k])
        s_out = np.where(act, s[..., P - 1], s_out)
        e_out = np.where(act, e, e_out)
        if 0 <= t - 31 < LR:
            out[:, t - 31] = np.stack([s_out[:, 31], e_out[:, 31]], axis=1)
    return np.where(valid, bk, 0).max(axis=(1, 2)), out


def wavefront_scores(qs, rs, match, mismatch, gap_open, gap_ext):
    """The kernel's launches over the query blocks of ``query_blocks``,
    each block's carry feeding the next; the best over all blocks.  ->
    (B,) scores."""
    B, LQ = qs.shape
    P, blocks = query_blocks(LQ)
    best, carry = np.zeros(B, np.int64), None
    for b in range(blocks):
        bb, carry = _wavefront_block(qs[:, b * 32 * P: (b + 1) * 32 * P], rs,
                                     P, carry, match, mismatch, gap_open,
                                     gap_ext)
        best = np.maximum(best, bb)
    return best


def _padded(seed, B, LQ, LR):
    """Pairs sharing a mutated segment where both are long enough, padding
    (-1) at the end of queries and references of random length, and a few
    padded positions inside both."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, size=(B, LQ)).astype(np.int32)
    rs = rng.integers(0, 4, size=(B, LR)).astype(np.int32)
    for b in range(B):
        n = int(rng.integers(1, min(LQ, LR) + 1))
        at = int(rng.integers(0, LR - n + 1))
        rs[b, at: at + n] = qs[b, :n]
        qs[b, int(rng.integers(LQ // 2, LQ + 1)):] = -1
        rs[b, int(rng.integers(LR // 2, LR + 1)):] = -1
    qs[rng.random(qs.shape) < 0.02] = -1
    rs[rng.random(rs.shape) < 0.02] = -1
    return qs, rs


@pytest.mark.parametrize("scores", sorted(SCORES))
@pytest.mark.parametrize("lr", ("1", "LQ", "2LQ"))
@pytest.mark.parametrize("LQ", (1, 31, 32, 33, 150, 160))
def test_wavefront_model_matches_pallas_and_plain(LQ, lr, scores):
    """Kernel 4's schedule against the Pallas kernel (interpret mode) and the
    port's plain version, with a query of every P-boundary kind (one lane,
    32 lanes of one, 17 lanes of two, partly filled last lanes), with
    gap_open above gap_ext, where the identity still holds, and with gaps
    that score."""
    LR = {"1": 1, "LQ": LQ, "2LQ": 2 * LQ}[lr]
    qs, rs = _padded(LQ * 7 + LR, 4, LQ, LR)
    kw = SCORES[scores]
    want = pallas_scores(qs, rs, interpret=True, **kw)
    np.testing.assert_array_equal(
        batch_local_align_scores(qs, rs, device="cpu", **kw), want)
    np.testing.assert_array_equal(wavefront_scores(qs, rs, **kw), want)
    if LQ >= 31 and LR >= LQ:
        assert want.max() > 0


def test_query_blocks_cover_the_query():
    """One block up to 1,024 positions; beyond, full blocks of 32 P
    positions with 17 <= P <= 32 and a last block of 1 .. 32 P."""
    for LQ in range(1, 40_000):
        P, blocks = query_blocks(LQ)
        if LQ <= 1024:
            assert (P, blocks) == (-(-LQ // 32), 1)
        else:
            assert 17 <= P <= 32 and blocks >= 2
            assert 0 < LQ - (blocks - 1) * 32 * P <= 32 * P


@pytest.mark.parametrize("scores", sorted(SCORES))
@pytest.mark.parametrize("LQ", (1025, 1500, 2048, 2049))
def test_blocked_model_matches_pallas_and_plain(LQ, scores):
    """Queries of more than 1,024 positions: the kernel's query blocks and
    their carry, modelled, against the Pallas kernel (interpret mode) and
    the port's plain version, with alignments that cross the blocks'
    boundaries."""
    LR = 48
    qs, rs = _padded(LQ + 11, 3, LQ, LR)
    P, _ = query_blocks(LQ)
    for b, at in enumerate((32 * P - 20, 32 * P - 1, LQ - LR)):
        qs[b, at: at + LR] = rs[b]                  # across a boundary
        qs[b, at + 5] = (qs[b, at + 5] + 1) % 4
    qs[1, 32 * P + 3: 32 * P + 6] = -1
    kw = SCORES[scores]
    want = pallas_scores(qs, rs, interpret=True, **kw)
    np.testing.assert_array_equal(
        batch_local_align_scores(qs, rs, device="cpu", **kw), want)
    np.testing.assert_array_equal(wavefront_scores(qs, rs, **kw), want)
    assert want.max() > 0
