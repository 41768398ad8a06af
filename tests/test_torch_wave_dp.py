"""Kernel B11's plain version, ``wave_dp_plain``, against the JAX wave DP.

The same seeded numpy waves go through metagraph_tpu/align/wave_extender.py
``compute_wave`` on int32 arrays (the form the JAX flat engine runs) and
through the port's ``wave_dp_plain`` and ``compute_wave`` on the CPU: S, E
and F must be bit-equal on every wave (200 random waves and the edge
cases: NINF cells, band edges, has_del false, N = 1, W = 1, W = 2,049,
per-row cutoffs, sums that wrap int32).  Where the values stay far inside
-2^29, the port is also held to metagraph_tpu/align/batch.py's
``_compute_wave_device`` (jit on the CPU), whose int32 form shifts NINF to
-2^29.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu.align.batch import _compute_wave_device
from metagraph_tpu.align.wave_extender import compute_wave as jax_wave
from metagraph_tpu_torch.align.config import NINF
from metagraph_tpu_torch.align.wave_extender import (compute_wave, wave_dp,
                                                     wave_dp_plain)

GAPS = ((-6, -2), (-5, -1), (-3, -3), (-11, -1))


def random_wave(rng, N, W, ninf_share=0.3, big=False):
    """One wave as the flat engine forms it: parent S masked to a hull
    (NINF outside, some NINF inside), profile scores, node scores of 0 or a
    gap penalty, has_del, a band inside [0, W - 1] and a cutoff a row
    (some NINF + 1, the engine's lowest)."""
    lo_v, hi_v = (-2 ** 31 + 101, 2 ** 31 - 1) if big else (-400, 600)

    def mat(lo, hi):
        m = rng.integers(lo, hi, (N, W), dtype=np.int64).astype(np.int32)
        hull_lo = rng.integers(0, W, N)
        hull_hi = np.minimum(hull_lo + rng.integers(0, W + 1, N), W - 1)
        j = np.arange(W)[None, :]
        out = (j < hull_lo[:, None]) | (j > hull_hi[:, None]) \
            | (rng.random((N, W)) < ninf_share)
        m[out] = NINF
        return m

    SpM, SpF, Fp = mat(lo_v, hi_v), mat(lo_v, hi_v), mat(lo_v, hi_v)
    prof = rng.integers(-4 if not big else lo_v, 12 if not big else hi_v,
                        (N, W), dtype=np.int64).astype(np.int32)
    prof[:, 0] = NINF
    ns = rng.choice(np.array([0, 0, 0, -6, -2], np.int32), N)
    has_del = rng.random(N) < 0.7
    band_lo = rng.integers(0, W, N).astype(np.int32)
    band_hi = np.minimum(band_lo + rng.integers(0, W, N), W - 1) \
        .astype(np.int32)
    cut = rng.integers(-60, 80, N).astype(np.int32)
    cut[rng.random(N) < 0.2] = NINF + 1
    return SpM, SpF, Fp, prof, ns, has_del, band_lo, band_hi, cut


def jax_result(wave, go, ge):
    SpM, SpF, Fp, prof, ns, has_del, band_lo, band_hi, cut = wave
    return jax_wave(SpM, SpF, Fp, prof, ns, has_del, band_lo.astype(np.int64),
                    band_hi.astype(np.int64), cut, go, ge)


def plain_result(wave, go, ge):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in wave]
    out = wave_dp_plain(*t, go, ge)
    return [o.numpy() for o in out]


def assert_bit_equal(got, want):
    for name, g, w in zip("SEF", got, want):
        assert g.dtype == np.int32 and w.dtype == np.int32, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("seed", range(25))
def test_random_waves_bit_equal(seed):
    """Eight random waves a seed (200 in all) of 1-300 rows and 2-300
    columns, each gap pair: wave_dp_plain and compute_wave equal JAX's."""
    rng = np.random.default_rng(seed)
    for t in range(8):
        go, ge = GAPS[(seed + t) % len(GAPS)]
        wave = random_wave(rng, int(rng.integers(1, 300)),
                           int(rng.integers(2, 300)),
                           ninf_share=float(rng.choice([0.0, 0.3, 0.9])))
        want = jax_result(wave, go, ge)
        assert_bit_equal(plain_result(wave, go, ge), want)
        assert_bit_equal(compute_wave(*wave, go, ge, device="cpu"), want)


@pytest.mark.parametrize("shape", ((1, 1), (1, 2), (1, 151), (7, 1),
                                   (3, 2049), (64, 33)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_edge_shapes_bit_equal(shape):
    """N = 1, W = 1, W = 2,049 (a read past 1,024 bp) and widths around a
    warp's 32 columns."""
    rng = np.random.default_rng(shape[0] * 10_000 + shape[1])
    for go, ge in GAPS:
        wave = random_wave(rng, *shape)
        assert_bit_equal(plain_result(wave, go, ge),
                         jax_result(wave, go, ge))


@pytest.mark.parametrize("case", ("all_ninf", "no_del", "full_band",
                                  "empty_band", "cut_above", "cut_lowest"))
def test_guards_and_masks_bit_equal(case):
    """The NINF guards, has_del false, band edges and per-row cutoffs
    taken one at a time to their limits."""
    rng = np.random.default_rng(len(case))
    wave = list(random_wave(rng, 40, 97))
    N, W = wave[0].shape
    if case == "all_ninf":
        for i in range(3):
            wave[i][:] = NINF
    elif case == "no_del":
        wave[5][:] = False
    elif case == "full_band":
        wave[6][:], wave[7][:] = 0, W - 1
    elif case == "empty_band":
        wave[6][:], wave[7][:] = W - 1, 0
    elif case == "cut_above":
        wave[8][:] = 10_000
    elif case == "cut_lowest":
        wave[8][:] = NINF + 1
    for go, ge in GAPS:
        assert_bit_equal(plain_result(wave, go, ge), jax_result(wave, go, ge))


@pytest.mark.parametrize("seed", range(4))
def test_wrapping_sums_bit_equal(seed):
    """Scores near the ends of int32: every sum wraps in two's complement
    in both, and the E clamp is tested before its add."""
    rng = np.random.default_rng(100 + seed)
    for go, ge in GAPS + ((-200, 3), (7, -9)):
        wave = random_wave(rng, 30, 70, big=True)
        with np.errstate(over="ignore"):
            want = jax_result(wave, go, ge)
        assert_bit_equal(plain_result(wave, go, ge), want)


@pytest.mark.parametrize("seed", range(6))
def test_matches_jax_device_wave(seed):
    """Against the JAX device wave (jit on the CPU), whose NINF is -2^29:
    equal wherever the inputs stay far inside that range."""
    rng = np.random.default_rng(200 + seed)
    go, ge = GAPS[seed % len(GAPS)]
    wave = random_wave(rng, int(rng.integers(1, 70)),
                       int(rng.integers(2, 180)))
    SpM, SpF, Fp, prof, ns, has_del, band_lo, band_hi, cut = wave
    want = _compute_wave_device(SpM.astype(np.int64), SpF.astype(np.int64),
                                Fp.astype(np.int64), prof.astype(np.int64),
                                ns, has_del, band_lo, band_hi, cut, go, ge)
    got = plain_result(wave, go, ge)
    for name, g, w in zip("SEF", got, want):
        assert np.array_equal(g.astype(np.int64), w), name


def test_wrapper_checks_and_cpu_route():
    """The wrapper refuses a wrong dtype or shape, and a CPU tensor takes
    the plain version without counting a launch."""
    rng = np.random.default_rng(7)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in random_wave(rng, 5, 9)]
    before = wave_dp.launches
    got = wave_dp(*t, -6, -2)
    want = wave_dp_plain(*t, -6, -2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert wave_dp.launches == before
    with pytest.raises(ValueError):
        wave_dp(t[0].long(), *t[1:], -6, -2)
    with pytest.raises(ValueError):
        wave_dp(t[0], t[1][:, :4].contiguous(), *t[2:], -6, -2)
