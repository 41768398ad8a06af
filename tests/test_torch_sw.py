"""The port's batch_local_align_scores against the Pallas kernel
(metagraph_tpu/align/pallas_sw.py, interpret=True) and the numpy oracle.

On the CPU the port runs the plain PyTorch version of kernel 4
(tests/test_torch_gpu.py holds the CUDA kernel against it on the card).
"""

import numpy as np
import pytest

from metagraph_tpu.align.pallas_sw import \
    batch_local_align_scores as pallas_scores
from metagraph_tpu_torch.align.sw import (batch_local_align_scores,
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
