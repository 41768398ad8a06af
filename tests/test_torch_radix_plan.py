"""Kernel D2's pass plan (``succinct/device_build.py``) on the CPU.

* ``radix_plan`` over every ``bits`` 1..64 and both digit widths (the
  kernel runs 8-bit digits; 11-bit ones were measured slower): the
  digits cover each bit below ``bits`` once, lowest first; only the
  single-bin digits are skipped; a partition with nothing to run runs one
  pass; below ``RADIX_SYNC_MIN`` keys every pass runs;
* the plan's passes, run as stable LSD passes over numpy keys (each pass
  a stable sort by its digit, as one pass of the kernel orders), give the
  plain version's tensors, with and without a sentinel;
* ``radix_sort`` and ``radix_sort_plain`` with ``sentinel=`` give the same
  tensors as without it.

The kernel itself is held against the plain version on the card
(tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

from metagraph_tpu_torch.succinct import device_build as db

BITS = range(1, 65)
WIDTHS = (8, 11)


@pytest.mark.parametrize("digit_bits", WIDTHS)
@pytest.mark.parametrize("bits", BITS)
def test_radix_plan_covers_each_bit_once(bits, digit_bits):
    rng = np.random.default_rng([bits, digit_bits])
    digits = db.radix_digits(bits, digit_bits)
    assert len(digits) == -(-bits // digit_bits)
    covered = []
    for shift, width in digits:
        assert 1 <= width <= digit_bits
        covered.extend(range(shift, shift + width))
    assert covered == list(range(bits))
    # no digit single: every pass runs, in order
    got, run = db.radix_plan(bits, [False] * len(digits), digit_bits)
    assert got == digits and run == list(range(len(digits)))
    # only the single-bin digits are skipped, the others run in order
    for _ in range(4):
        single = [bool(x) for x in rng.integers(0, 2, len(digits))]
        _, run = db.radix_plan(bits, single, digit_bits)
        assert run == [p for p, one in enumerate(single) if not one]
        _, run_p = db.radix_plan(bits, single, digit_bits, partition=True)
        assert run_p == (run or [len(digits) - 1])
    _, run = db.radix_plan(bits, [True] * len(digits), digit_bits)
    assert run == []
    with pytest.raises(ValueError):
        db.radix_plan(bits, [False] * (len(digits) + 1), digit_bits)


def _keys(rng, n, bits, digit_bits, sentinel=None):
    """n keys below 2^bits (any int64 at 64) in which each digit is, at
    random, one value for every key or random, so that the plan skips
    some passes; a third of them the sentinel where one is given."""
    keys = np.zeros(n, np.uint64)
    for shift, width in db.radix_digits(bits, digit_bits):
        if rng.random() < 0.5:
            d = np.full(n, rng.integers(0, 2 ** width), np.uint64)
        else:
            d = rng.integers(0, 2 ** width, n, dtype=np.uint64)
        keys |= d << np.uint64(shift)
    keys = keys.view(np.int64)
    if sentinel is not None:
        keys[rng.random(n) < 1 / 3] = sentinel
    return keys


def _lsd(keys: np.ndarray, bits, digit_bits, sentinel=None):
    """The plan's passes as stable LSD passes: the keys that are not the
    sentinel sorted by each digit that runs, the sentinels after them."""
    digits, run = db.radix_plan_of(torch.from_numpy(keys), bits, sentinel,
                                   digit_bits)
    live = keys if sentinel is None else keys[keys != sentinel]
    u = live.view(np.uint64)
    for p in run:
        shift, width = digits[p]
        d = (u >> np.uint64(shift)) & np.uint64((1 << width) - 1)
        order = np.argsort(d, kind="stable")
        live, u = live[order], u[order]
    return np.concatenate([live, np.full(len(keys) - len(live), sentinel,
                                         np.int64)]) \
        if sentinel is not None else live


@pytest.mark.parametrize("digit_bits", WIDTHS)
@pytest.mark.parametrize("bits", BITS)
def test_plan_passes_sort_like_plain(bits, digit_bits, monkeypatch):
    # the plan from the keys' histograms at any n (the kernel's plan below
    # RADIX_SYNC_MIN keys runs every pass)
    monkeypatch.setattr(db, "RADIX_SYNC_MIN", 0)
    rng = np.random.default_rng([bits, digit_bits, 1])
    keys = _keys(rng, 700, bits, digit_bits)
    want = db.radix_sort_plain(torch.from_numpy(keys), bits)[0].numpy()
    np.testing.assert_array_equal(_lsd(keys, bits, digit_bits), want)
    if bits < 64:
        sent = (1 << bits) - 1               # the largest key under bits
        keys = _keys(rng, 700, bits, digit_bits, sent)
        want = db.radix_sort_plain(torch.from_numpy(keys), bits)[0].numpy()
        np.testing.assert_array_equal(_lsd(keys, bits, digit_bits, sent),
                                      want)


@pytest.mark.parametrize("digit_bits", WIDTHS)
def test_plan_of_equal_keys_runs_nothing(digit_bits):
    # below RADIX_SYNC_MIN keys the histograms are not read: every pass
    keys = torch.full((db.RADIX_SYNC_MIN - 1,), 12345, dtype=torch.int64)
    digits, run = db.radix_plan_of(keys, 43, 12345, digit_bits)
    assert run == list(range(len(digits)))
    keys = torch.full((db.RADIX_SYNC_MIN,), 12345, dtype=torch.int64)
    _, run = db.radix_plan_of(keys, 43, digit_bits=digit_bits)
    assert run == []
    # one digit that every key shares: only that pass is skipped
    keys = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2 ** 43, db.RADIX_SYNC_MIN)) \
        & ~(((1 << digit_bits) - 1) << digit_bits)
    digits, run = db.radix_plan_of(keys, 43, digit_bits=digit_bits)
    assert run == [p for p in range(len(digits)) if p != 1]
    # sentinels alone still need a pass that moves them last
    keys[::3] = (1 << 43) - 1
    keys[1::3] = keys[2::3] = 7
    _, run = db.radix_plan_of(keys, 43, (1 << 43) - 1, digit_bits)
    assert run == [len(digits) - 1]


@pytest.mark.parametrize("bits", (1, 3, 8, 11, 22, 33, 40, 42, 43, 44, 63))
def test_sentinel_gives_the_same_tensors(bits):
    """J-like keys, two thirds of them the sentinel (the largest key under
    ``bits``): the wrapper and the plain version with ``sentinel=`` give
    what they give without it."""
    rng = np.random.default_rng(bits)
    sent = 1 << (bits - 1) if bits > 1 else 1
    keys = rng.integers(0, sent, 3000).astype(np.int64)
    keys[rng.random(3000) < 2 / 3] = sent
    t = torch.from_numpy(keys)
    want, _ = db.radix_sort_plain(t, bits)
    for fn in (db.radix_sort, db.radix_sort_plain):
        got, pay = fn(t, bits, sentinel=sent)
        assert pay is None and torch.equal(got, want)
    assert torch.equal(want[-int((keys == sent).sum()):],
                       torch.full((int((keys == sent).sum()),), sent))


def test_sentinel_takes_no_payload():
    keys = torch.arange(10, dtype=torch.int64)
    for fn in (db.radix_sort, db.radix_sort_plain):
        with pytest.raises(ValueError, match="payload"):
            fn(keys, 8, torch.arange(10), sentinel=255)
