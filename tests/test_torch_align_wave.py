"""Kernel B11 as ``align_wave``: its plain version, ``align_wave_plain``,
against the JAX package's wave path, and the port's flat engine over its
column store against the JAX numpy engine.

A wave is made from numpy seeds as the flat engine forms it: a column store
of S, E and F rows (the port's rows padded to a multiple of 4 int32), parents
with 1-4 children each, per-parent cutoffs and window sizes (WS below W,
so that rows are padded, and equal to it), profile and partial-sum rows,
node scores, has_del, diagonals and float64 extension cutoffs.  The JAX
numpy wave path (metagraph_tpu/align/flat.py, :626-660: the hulls from the
store, the masked planes, ``compute_wave``, the pad, the statistics and
the candidates' inputs) is restated here over the same arrays, and
``align_wave_plain`` must equal it bit for bit: every written store row,
S again, the later siblings' E and parent S rows and every statistic, on
waves with hulls at both edges and none at all, W = 1 and W > 1,024, sums
that wrap int32, and partial sums whose sum with NINF wraps (has_ext then
holds in numpy's int32, and must in the port).  Where nothing can wrap,
it must also equal native/fastio.cpp::align_wave, called through
metagraph_tpu.native.
"""

import ctypes

import numpy as np
import pytest
import torch

import metagraph_tpu.align.batch as jax_batch
import metagraph_tpu.align.flat as jax_flat
from metagraph_tpu.align.aligner import DBGAligner as JaxAligner
from metagraph_tpu.align.config import AlignerConfig as JaxConfig
from metagraph_tpu.align.wave_extender import compute_wave as jax_wave
from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu_torch.align import batch as port_batch
from metagraph_tpu_torch.align import flat as port_flat
from metagraph_tpu_torch.align import wave_extender as wx
from metagraph_tpu_torch.align.aligner import DBGAligner
from metagraph_tpu_torch.align.config import NINF, AlignerConfig
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct as TorchDBG
from test_torch_canonical import native_lib

POS = 2 ** 31 - 1
GAPS = ((-6, -2), (-5, -1), (-11, -1), (-3, -3))
C = 6                                   # profile rows a job (DNA's ACGT$N)


def random_wave(rng, J, W, big=False, neg_pss=False, edges=False,
                ws_full=None):
    """A wave of J parents, 1-4 children each, over a store of random rows
    -> dict of the JAX engine's arrays (store rows of width W)."""
    lo_v, hi_v = (-2 ** 31 + 101, 2 ** 31 - 1) if big else (-400, 600)
    nch = rng.integers(1, 5, J)
    CH = int(nch.sum())
    n_jobs = J + int(rng.integers(0, 4))
    R = J + CH + int(rng.integers(0, 5))
    rows = rng.permutation(R)
    g_cur, out_rows = rows[:J].astype(np.int64), rows[J: J + CH]

    def plane():
        m = rng.integers(lo_v, hi_v, (R, W), dtype=np.int64).astype(np.int32)
        h0 = rng.integers(0, W, R)
        h1 = np.minimum(h0 + rng.integers(0, W + 1, R), W - 1)
        if edges:               # hulls that touch column 0 and column W - 1
            h0[rng.random(R) < 0.5] = 0
            h1[rng.random(R) < 0.5] = W - 1
        j = np.arange(W)[None, :]
        m[(j < h0[:, None]) | (j > h1[:, None])
          | (rng.random((R, W)) < 0.3)] = NINF
        return m

    gS, gE, gF = plane(), plane(), plane()
    cutc = rng.integers(-60, 80, J).astype(np.int32)
    cutc[rng.random(J) < 0.2] = NINF + 1
    cutc[rng.random(J) < 0.1] = 2 ** 31 - 1        # no cell in the hull
    wsize_pj = rng.integers(0, W, J).astype(np.int64)
    if ws_full is not None:
        wsize_pj[rng.random(J) < ws_full] = W - 1   # WS = W: no pad
    job = rng.permutation(n_jobs)[:J]
    ch_rows = np.repeat(np.arange(J), nch).astype(np.int64)
    jid = job[ch_rows].astype(np.int64)
    P2 = rng.integers(-4 if not big else lo_v, 12 if not big else hi_v,
                      (n_jobs * C, W), dtype=np.int64).astype(np.int32)
    if neg_pss:
        pss = rng.integers(-400, -100, (n_jobs, W)).astype(np.int32)
    else:
        pss = rng.integers(0, 400, (n_jobs, W)).astype(np.int32)
    prof_rows = jid * C + rng.integers(0, C, CH)
    ext_cut = rng.uniform(-100, 700, CH).round(rng.choice([0, 3]))
    if neg_pss:             # past every sum that does not wrap
        ext_cut[:] = 10 ** 6 + 0.5
    return dict(
        gS=gS, gE=gE, gF=gF, g_cur=g_cur, cutc=cutc, wsize_pj=wsize_pj,
        ch_rows=ch_rows, out_rows=out_rows, jid=jid, P2=P2, pss=pss,
        prof_rows=prof_rows,
        ch_score=rng.choice(np.array([0, 0, -6, -2], np.int32), CH),
        has_del=rng.random(CH) < 0.7, ccut=cutc[ch_rows],
        ws=wsize_pj[ch_rows] + 1,
        diag=rng.integers(-5, W + 5, CH).astype(np.int32),
        ext_cut=ext_cut.astype(np.float64))


def jax_numpy_wave(w, go, ge):
    """metagraph_tpu/align/flat.py's numpy wave path (:626-660) over the
    wave's arrays: (S, E, F, Smax, mp, col_min, has_ext, s_lp, p_mp, p_lp,
    sc_mp, band_lo, band_hi, parent S rows), a child a row."""
    gS, gF, P2 = w["gS"], w["gF"], w["P2"]
    W = gS.shape[1]
    jj = np.arange(W, dtype=np.int64)
    jj32 = jj.astype(np.int32)
    ch_rows = w["ch_rows"]
    S_act = gS[w["g_cur"]]
    F_act = gF[w["g_cur"]]
    inr = S_act >= w["cutc"][:, None]
    first = np.argmax(inr, axis=1)
    last = W - 1 - np.argmax(inr[:, ::-1], axis=1)
    band_lo = first
    band_hi = np.minimum(last + 1, w["wsize_pj"])
    blo = band_lo[ch_rows]
    bhi = band_hi[ch_rows]
    hullM = (jj[None, :] >= np.maximum(first - 1, 0)[:, None]) \
        & (jj[None, :] <= (band_hi - 1)[:, None])
    hullF = (jj[None, :] >= first[:, None]) \
        & (jj[None, :] <= band_hi[:, None])
    SpM = np.where(hullM[ch_rows], S_act[ch_rows], NINF)
    SpF = np.where(hullF[ch_rows], S_act[ch_rows], NINF)
    Fp = np.where(hullF[ch_rows], F_act[ch_rows], NINF)
    prof = P2[w["prof_rows"]]
    with np.errstate(over="ignore"):
        S, E, F = jax_wave(SpM, SpF, Fp, prof, w["ch_score"], w["has_del"],
                           blo, bhi, w["ccut"], go, ge)
        if w["ws"].min() < W:
            pad = jj[None, :] >= w["ws"][:, None]
            S = np.where(pad, NINF, S)
            E = np.where(pad, NINF, E)
            F = np.where(pad, NINF, F)
        else:
            pad = None
        Smax = S.max(axis=1)
        dist = np.abs(jj32[None, :] - w["diag"][:, None])
        if pad is not None:
            dist = np.where(pad, POS, dist)
        mp = np.argmin(np.where(S == Smax[:, None], dist, POS), axis=1)
        fin = np.where(S == NINF, POS, S)
        col_min = fin.min(axis=1)
        has_ext = ((S + w["pss"][w["jid"]]) >= w["ext_cut"][:, None]) \
            .any(axis=1)
    kws = w["wsize_pj"][ch_rows]
    ar = np.arange(len(ch_rows))
    return (S, E, F, Smax, mp, col_min, has_ext, S[ar, kws],
            S_act[ch_rows, np.maximum(mp - 1, 0)],
            S_act[ch_rows, np.maximum(kws - 1, 0)],
            P2[w["prof_rows"], mp], blo, bhi, S_act[ch_rows])


def port_inputs(w, W):
    """The wave as align_wave takes it: the store (rows of Wp = W rounded
    up to 4, S E F), the tables (profile rows, then a partial-sum row a
    job) and the packed vectors; later siblings get read-back slots."""
    R = w["gS"].shape[0]
    Wp = -(-W // 4) * 4
    store = np.full((R, 3, Wp), 12345, dtype=np.int32)
    store[:, 0, :W], store[:, 1, :W], store[:, 2, :W] = \
        w["gS"], w["gE"], w["gF"]
    n_prof = len(w["P2"])
    tables = np.full((n_prof + len(w["pss"]), Wp), -777, dtype=np.int32)
    tables[:n_prof, :W] = w["P2"]
    tables[n_prof:, :W] = w["pss"]
    ch_rows = w["ch_rows"]
    CH = len(ch_rows)
    later = np.flatnonzero(np.r_[False, ch_rows[1:] == ch_rows[:-1]])
    slot = np.full(CH, -1)
    slot[later] = np.arange(len(later))
    pack = np.zeros((CH, wx.NPACK), dtype=np.int32)
    pack[:, wx.PK_PARENT] = w["g_cur"][ch_rows]
    pack[:, wx.PK_ROW] = w["out_rows"]
    pack[:, wx.PK_PROF] = w["prof_rows"]
    pack[:, wx.PK_PSS] = n_prof + w["jid"]
    pack[:, wx.PK_SCORE] = w["ch_score"]
    pack[:, wx.PK_DEL] = w["has_del"]
    pack[:, wx.PK_CUT] = w["ccut"]
    pack[:, wx.PK_WS] = w["ws"]
    pack[:, wx.PK_WSIZE] = w["wsize_pj"][ch_rows]
    pack[:, wx.PK_DIAG] = w["diag"]
    pack[:, wx.PK_SLOT] = slot
    pack[:, wx.PK_XCUT:] = w["ext_cut"].view(np.int32).reshape(CH, 2)
    return store, tables, pack, later


def run_plain(w, go, ge):
    W = w["gS"].shape[1]
    store, tables, pack, later = port_inputs(w, W)
    st = torch.from_numpy(store.copy())
    out = torch.full((wx.out_size(len(pack), W, len(later)),), 999,
                     dtype=torch.int32)
    before = wx.align_wave.launches
    stats, srows, brows = wx.align_wave(st, torch.from_numpy(tables),
                                        torch.from_numpy(pack), W, go, ge,
                                        out)
    assert wx.align_wave.launches == before      # the CPU: no launch
    return store, st.numpy(), stats.numpy(), srows.numpy(), brows.numpy(), \
        later


def assert_equal_to_jax(w, go, ge):
    W = w["gS"].shape[1]
    want = jax_numpy_wave(w, go, ge)
    S, E, F, Smax, mp, col_min, has_ext = want[:7]
    store0, store, stats, srows, brows, later = run_plain(w, go, ge)
    rows = w["out_rows"]
    for name, plane, ref in (("S", 0, S), ("E", 1, E), ("F", 2, F)):
        got = store[rows, plane, :W]
        assert got.dtype == ref.dtype == np.int32, name
        assert np.array_equal(got, ref), name
    others = np.setdiff1d(np.arange(len(store)), rows)
    assert np.array_equal(store[others], store0[others])
    assert np.array_equal(store[rows, :, W:], store0[rows, :, W:])
    assert np.array_equal(srows, S)
    names = ("smax", "mp", "col_min", "has_ext", "s_lp", "p_mp", "p_lp",
             "sc_mp", "band_lo", "band_hi")
    for f, name in enumerate(names):
        assert np.array_equal(stats[:, f],
                              np.asarray(want[3 + f]).astype(np.int64)), name
    assert np.array_equal(brows[:, 0], E[later])
    assert np.array_equal(brows[:, 1], want[13][later])
    return want


@pytest.mark.parametrize("seed", range(12))
def test_random_waves_equal_jax_numpy_path(seed):
    """Random stores and waves (1-60 parents, 2-300 columns, WS below W
    and equal to it), each gap pair."""
    rng = np.random.default_rng(seed)
    for t in range(4):
        go, ge = GAPS[(seed + t) % len(GAPS)]
        w = random_wave(rng, int(rng.integers(1, 60)),
                        int(rng.integers(2, 300)), edges=t % 2 == 1,
                        ws_full=0.3 if t % 2 else None)
        assert_equal_to_jax(w, go, ge)


@pytest.mark.parametrize("W", (1, 2, 31, 32, 33, 151, 1025, 2049))
def test_edge_widths_equal_jax_numpy_path(W):
    """W = 1 (every window empty), around a warp's 32 columns, and reads
    past 1,024 bp; hulls at both edges."""
    rng = np.random.default_rng(W)
    for go, ge in GAPS[:2]:
        assert_equal_to_jax(random_wave(rng, 9, W, edges=True, ws_full=0.5),
                            go, ge)


@pytest.mark.parametrize("seed", range(4))
def test_wrapping_sums_equal_jax_numpy_path(seed):
    """Scores near the ends of int32: the recurrence's sums and S + pss
    wrap in two's complement, in numpy and in the port alike."""
    rng = np.random.default_rng(100 + seed)
    for go, ge in GAPS + ((-200, 3), (7, -9)):
        assert_equal_to_jax(random_wave(rng, 12, 70, big=True, edges=True),
                            go, ge)


def test_has_ext_follows_int32_wrap():
    """A negative partial sum added to an NINF cell wraps past INT32_MIN
    to a large positive int32, which numpy's has_ext compares with the
    float64 cut: every child with an NINF cell has an extension, and the
    port agrees (an int64 sum would find none)."""
    rng = np.random.default_rng(5)
    w = random_wave(rng, 20, 90, neg_pss=True)
    want = assert_equal_to_jax(w, -6, -2)
    S, has_ext = want[0], want[6]
    with_ninf = (S == NINF).any(axis=1)
    assert with_ninf.any() and np.array_equal(has_ext, with_ninf)
    wide = S.astype(np.int64) + w["pss"][w["jid"]]
    assert not (wide >= w["ext_cut"][:, None]).any()


def native_wave(w, go, ge):
    """native/fastio.cpp::align_wave on the wave's arrays, as
    metagraph_tpu/align/flat.py calls it."""
    lib = native_lib()
    assert lib is not None, "the JAX native library does not load"
    W = w["gS"].shape[1]
    J, CH = len(w["g_cur"]), len(w["ch_rows"])
    S = np.empty((CH, W), np.int32)
    E = np.empty((CH, W), np.int32)
    F = np.empty((CH, W), np.int32)
    Smax, mp, col_min = (np.empty(CH, np.int32) for _ in range(3))
    hx = np.empty(CH, np.uint8)
    a = dict(gS=np.ascontiguousarray(w["gS"]),
             gF=np.ascontiguousarray(w["gF"]),
             g_cur=np.ascontiguousarray(w["g_cur"], np.int64),
             cutc=np.ascontiguousarray(w["cutc"], np.int32),
             wsize=np.ascontiguousarray(w["wsize_pj"], np.int64),
             ch_rows=np.ascontiguousarray(w["ch_rows"], np.int64),
             P2=np.ascontiguousarray(w["P2"]),
             prof_rows=np.ascontiguousarray(w["prof_rows"], np.int64),
             ch_score=np.ascontiguousarray(w["ch_score"], np.int32),
             has_del=np.ascontiguousarray(w["has_del"], np.uint8),
             ccut=np.ascontiguousarray(w["ccut"], np.int32),
             ws=np.ascontiguousarray(w["ws"], np.int64),
             diag=np.ascontiguousarray(w["diag"], np.int32),
             pss=np.ascontiguousarray(w["pss"]),
             jid=np.ascontiguousarray(w["jid"], np.int64),
             ext_cut=np.ascontiguousarray(w["ext_cut"], np.float64))
    lib.align_wave(
        a["gS"].ctypes.data, a["gF"].ctypes.data, a["g_cur"].ctypes.data,
        a["cutc"].ctypes.data, a["wsize"].ctypes.data, J, W,
        a["ch_rows"].ctypes.data, a["P2"].ctypes.data,
        a["prof_rows"].ctypes.data, a["ch_score"].ctypes.data,
        a["has_del"].ctypes.data, a["ccut"].ctypes.data, a["ws"].ctypes.data,
        a["diag"].ctypes.data, a["pss"].ctypes.data, a["jid"].ctypes.data,
        a["ext_cut"].ctypes.data, CH, go, ge, int(NINF),
        S.ctypes.data, E.ctypes.data, F.ctypes.data, Smax.ctypes.data,
        mp.ctypes.data, col_min.ctypes.data, hx.ctypes.data)
    return S, E, F, Smax, mp, col_min, hx != 0


@pytest.mark.parametrize("seed", range(6))
def test_equals_native_align_wave(seed):
    """Where no sum can wrap (scores inside +-1,000, partial sums >= 0),
    the native wave's int64 arithmetic gives the int32 results: S, E, F,
    Smax, mp, col_min and has_ext equal."""
    assert ctypes.sizeof(ctypes.c_void_p) == 8
    rng = np.random.default_rng(300 + seed)
    go, ge = GAPS[seed % len(GAPS)]
    w = random_wave(rng, int(rng.integers(1, 40)),
                    int(rng.integers(1, 200)), edges=seed % 2 == 0,
                    ws_full=0.4 if seed % 3 else None)
    W = w["gS"].shape[1]
    _, store, stats, *_ = run_plain(w, go, ge)
    want = native_wave(w, go, ge)
    rows = w["out_rows"]
    for p, name in enumerate("SEF"):
        assert np.array_equal(store[rows, p, :W], want[p]), name
    for f, name in enumerate(("smax", "mp", "col_min", "has_ext")):
        assert np.array_equal(stats[:, f], want[3 + f].astype(np.int64)), \
            name


def test_wrapper_checks_and_empty_wave():
    """The wrapper refuses wrong dtypes and shapes; an empty wave writes
    nothing and gives empty views."""
    rng = np.random.default_rng(11)
    w = random_wave(rng, 3, 17)
    store, tables, pack, later = port_inputs(w, 17)
    st, tb, pk = (torch.from_numpy(a) for a in (store, tables, pack))
    out = torch.empty(wx.out_size(len(pack), 17, len(later)),
                      dtype=torch.int32)
    with pytest.raises(ValueError):
        wx.align_wave(st.long(), tb, pk, 17, -6, -2, out)
    with pytest.raises(ValueError):
        wx.align_wave(st, tb[:, :8].contiguous(), pk, 17, -6, -2, out)
    with pytest.raises(ValueError):
        wx.align_wave(st, tb, pk, 17, -6, -2, out[:-1])
    before = st.clone()
    stats, srows, brows = wx.align_wave(
        st, tb, pk[:0], 17, -6, -2, torch.empty(0, dtype=torch.int32))
    assert stats.shape == (0, wx.NSTAT) and srows.shape == (0, 17)
    assert brows.shape == (0, 2, 17) and torch.equal(st, before)


# --------------------------------------------------------------------------
# the port's FlatEngine against the JAX numpy FlatEngine
# --------------------------------------------------------------------------

COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """A DNA graph of random references with forks and joins (so that
    pops branch), built by the JAX package and loaded by both."""
    assert native_lib() is not None, "the JAX native library does not load"
    rng = np.random.default_rng(20)
    refs = ["".join(rng.choice(list("ACGT"), int(rng.integers(300, 500))))
            for _ in range(4)]
    refs += [refs[0][100:220] + refs[1][50:200],
             refs[2][:90] + "ACGTTGCA" + refs[2][90:260]]
    g = JaxDBG.build(refs, 13)
    path = tmp_path_factory.mktemp("wave") / "g"
    g.save(str(path))
    reads = []
    for i in range(24):
        r = refs[i % len(refs)]
        a = int(rng.integers(0, len(r) - 80))
        s = list(r[a: a + int(rng.integers(45, 80))])
        for p in rng.choice(len(s), int(rng.integers(0, 3)), replace=False):
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        s = "".join(s)
        reads.append((s[::-1].translate(COMP) if i % 3 == 1 else s).encode())
    reads.append(b"N" * 40 + refs[0][:30].encode())     # partial sums < 0
    return g, TorchDBG.load(str(path) + ".dbg.npz"), reads


@pytest.mark.parametrize("kw", ({}, dict(xdrop=12, gap_opening_penalty=-5,
                                         num_alternative_paths=2)),
                         ids=("default", "branchy"))
def test_flat_engine_equals_jax_numpy_engine(graphs, kw, monkeypatch):
    """The JAX FlatEngine on its numpy wave path (no native engine, no
    native wave) and the port's FlatEngine on CPU tensors: equal
    alignments; the port's store a CPU tensor, one align_wave a wave,
    branch pops among its waves."""
    jg, tg, reads = graphs
    monkeypatch.setattr(jax_flat, "_nlib", False)
    made = []

    def make_engine(*a, **k):
        eng = jax_flat.make_engine(*a, **k)
        made.append(type(eng))
        return eng

    monkeypatch.setattr(jax_batch, "make_engine", make_engine)
    want = JaxAligner(jg, JaxConfig(**kw)).align_batch(reads)
    assert made and all(t is jax_flat.FlatEngine for t in made)

    waves = []
    run_wave = wx.run_wave

    def spy(store, tables, pack, *a):
        waves.append((store.device.type, int((pack[:, wx.PK_SLOT] >= 0)
                                             .sum())))
        return run_wave(store, tables, pack, *a)

    monkeypatch.setattr(wx, "run_wave", spy)
    engines = []

    class Engine(port_flat.FlatEngine):
        def __init__(self, *a):
            super().__init__(*a)
            engines.append(self)

    monkeypatch.setattr(port_batch, "FlatEngine", Engine)
    before = dict(wx.STATS)
    got = DBGAligner(tg, AlignerConfig(**kw), device="cpu") \
        .align_batch(reads)

    def key(r):
        return [(a.query, list(map(int, a.nodes)), a.sequence, int(a.score),
                 a.cigar.to_string(), bool(a.orientation), int(a.offset))
                for a in r]

    assert [key(r) for r in got] == [key(r) for r in want]
    assert sum(len(r) for r in want) > 0
    assert waves and {d for d, _ in waves} == {"cpu"}
    assert sum(n for _, n in waves) > 0          # later siblings read back
    assert wx.STATS["waves"] - before["waves"] == len(waves)
    assert wx.STATS["bytes_tables"] > before["bytes_tables"]
    # the profile rows and partial sums built on the device, as on the host
    assert engines
    for eng in engines:
        n, C, W = eng.flushed, eng.C, eng.W
        assert n == len(eng.jobs) and eng.G.device.type == "cpu"
        assert np.array_equal(eng.T[:n, :C, :W].numpy(), eng.P[:n])
        assert np.array_equal(eng.T[:n, C, :W].numpy(), eng.pss[:n])
