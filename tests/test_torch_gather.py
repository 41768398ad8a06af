"""The gather micro-benchmark of the port against numpy and against the two
Pallas kernels of scripts/exp_pallas_gather.py (X1 ``make_loop_kernel``, X2
``make_take_kernel``), run in interpret mode on the CPU.

The JAX script is loaded with importlib and its ``pl.pallas_call`` is
patched to ``interpret=True`` for the test; nothing in scripts/ changes.
Integer arithmetic mod 2^32: every comparison is exact.  On the CPU the
port's kernel wrappers run the plain version (tests/test_torch_gpu.py holds
the CUDA kernels against it on the card).
"""

import contextlib
import functools
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from metagraph_tpu_torch._u32 import np_words, words_np
from metagraph_tpu_torch.scripts import exp_gather as eg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(64, 32, 16, 64), (100, 8, 10, 95), (37, 4, 7, 50),
          (300, 64, 33, 200), (1000, 32, 1024, 4000)]
FORMS = {"loop": (eg.make_loop_kernel, eg.gather_loop),
         "take": (eg.make_take_kernel, eg.gather_take),
         "plain": (eg.make_plain, eg.gather_rows_sum_plain)}


def _inputs(n_rows, W, Q, seed):
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 2 ** 32, (n_rows, W), dtype=np.uint32)
    idx = rng.integers(0, n_rows, Q).astype(np.int32)
    return tab, idx


def _numpy_sum(tab, idx, QB):
    n = len(idx) // QB * QB
    out = np.zeros((eg.OUT_ROWS, tab.shape[1]), np.uint32)
    out[0] = (tab[idx[:n]].astype(np.uint64).sum(0) & 0xFFFFFFFF)
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_forms_match_numpy(form, shape):
    n_rows, W, QB, Q = shape
    tab, idx = _inputs(n_rows, W, Q, sum(shape))
    want = _numpy_sum(tab, idx, QB)
    maker, kernel = FORMS[form]
    out = kernel(np_words(tab), torch.from_numpy(idx), QB)
    assert out.dtype == torch.int32 and out.shape == (eg.OUT_ROWS, W)
    np.testing.assert_array_equal(words_np(out), want)
    got = maker(n_rows, W, QB, device="cpu")(tab, idx)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want[0, 0].view(np.int32))
    assert eg.gather_loop.launches == eg.gather_take.launches == 0


def test_indices_clamp_and_tail_is_left_out():
    tab, idx = _inputs(50, 8, 40, 9)
    idx[::3] = -7
    idx[1::3] = 500
    out = eg.gather_rows_sum_plain(np_words(tab), torch.from_numpy(idx), 16)
    np.testing.assert_array_equal(
        words_np(out), _numpy_sum(tab, np.clip(idx, 0, 49), 16))
    empty = eg.gather_rows_sum_plain(np_words(tab), torch.from_numpy(idx), 41)
    assert not empty.any()


def _pallas_script(monkeypatch):
    """scripts/exp_pallas_gather.py with its pallas_call in interpret mode."""
    path = os.path.join(REPO, "scripts", "exp_pallas_gather.py")
    spec = importlib.util.spec_from_file_location("_exp_pallas_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


@pytest.mark.parametrize("form", ("loop", "take"))
@pytest.mark.parametrize("shape", [(64, 32, 16, 64), (128, 32, 32, 100)],
                         ids=lambda s: "-".join(map(str, s)))
def test_run_matches_pallas(monkeypatch, form, shape):
    import jax.numpy as jnp
    mod = _pallas_script(monkeypatch)
    n_rows, W, QB, Q = shape
    tab, idx = _inputs(n_rows, W, Q, 77 + Q)
    jax_maker = {"loop": mod.make_loop_kernel,
                 "take": mod.make_take_kernel}[form]
    want = int(jax_maker(n_rows, W, QB)(jnp.asarray(tab), jnp.asarray(idx)))
    got = FORMS[form][0](n_rows, W, QB, device="cpu")(tab, idx)
    assert int(got) == want == int(_numpy_sum(tab, idx, QB)[0, 0]
                                   .view(np.int32))


def test_main_sweep_prints_every_form(monkeypatch):
    def broken(n_rows, W, QB, device=None):
        raise RuntimeError("no such kernel")
    monkeypatch.setattr(eg, "VARIANTS", eg.VARIANTS + (("broken", broken),))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eg.main(["--device", "cpu", "--q-log", "10", "--rows-log", "6", "7",
                 "--qb", "64"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "device: cpu"
    for rows_log in (6, 7):
        for form in ("loop", "take", "plain"):
            assert any(ln.startswith(f"{form} rows=2^{rows_log} ")
                       and ln.endswith("Mgather/s") for ln in lines), lines
        assert f"broken rows=2^{rows_log}: FAILED RuntimeError: no such " \
               "kernel" in lines


def test_makers_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for maker, _ in FORMS.values():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            maker(64, 32, 16)


PLAN_CASES = [(0, 132, 4), (1, 132, 4), (255, 132, 2), (3000, 132, 4),
              (99_999, 132, 3), (1 << 22, 132, 4), (1 << 22, 1, 1),
              (12_347, 7, 5)]


@pytest.mark.parametrize("W", eg.WIDTHS)
@pytest.mark.parametrize("form", ("loop", "take"))
@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_gather_plan_covers_every_index_once(form, W, case):
    """The persistent grid's even shares cover [0, n) exactly once, every
    block gets work, and the grid stays within the card and the work."""
    n, n_sms, bps = case
    grid, bounds, smem = eg.gather_plan(form, n, W, n_sms, bps)
    assert 0 <= grid <= n_sms * bps
    assert len(bounds) == grid + 1 and bounds[0] == 0 and bounds[-1] == n
    sizes = np.diff(bounds)
    assert (sizes >= 1).all() and sizes.sum() == n
    if grid:
        assert sizes.max() - sizes.min() <= 1          # even shares
        unit = eg._block_rows(form, W)
        assert grid <= -(-n // unit)                    # no more than work
        assert grid == n_sms * bps or grid == -(-n // unit)
    # the kernel's split, n b / grid in int64
    assert bounds == tuple(n * b // max(grid, 1) for b in range(grid + 1))
    assert 0 < smem <= eg.MAX_SMEM


@pytest.mark.parametrize("form", ("loop", "take"))
def test_gather_plan_shared_memory(form):
    """Dynamic shared memory: within a block's 232,448 B at every W; the
    staged ring leaves room for two blocks an SM."""
    for W in eg.WIDTHS:
        smem = eg.gather_plan(form, 1 << 20, W, 132, 4)[2]
        assert smem <= eg.MAX_SMEM
        if form == "take":
            assert 2 * smem <= eg.MAX_SMEM
            assert smem >= eg.STAGES * eg.STAGE_WORDS * 4


@pytest.mark.parametrize("W", (0, 2, 3, 12, 48, 512, 1024))
def test_gather_plan_refuses_other_widths(W):
    for form in ("loop", "take"):
        with pytest.raises(ValueError, match="W in"):
            eg.gather_plan(form, 1000, W, 132, 4)
    with pytest.raises(ValueError, match="unknown gather form"):
        eg.gather_plan("scan", 1000, 32, 132, 4)
