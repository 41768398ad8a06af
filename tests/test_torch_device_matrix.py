"""The port's BRWT and row-diff words route against the JAX package's
``annotation/device_matrix.py``, on the CPU.

The same trees and routings, made from numpy seeds, go through the JAX
programs (``dyn_brwt_words_fn``, ``DeviceBRWT``'s ``brwt_row_words``,
``rowdiff_dyn_brwt_words_fn``, ``rowdiff_dense_words_fn``,
``make_tiled_count_epoch``) and through the plain versions of kernels W1
and W2 and the port's ``words_count_epoch``; the port's host objects are
the JAX ones read back through the port's annotation unpickler.  Every
comparison is exact.
"""

import io
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagraph_tpu.annotation import device_matrix as jdm
from metagraph_tpu.annotation.matrix import (BRWT as JBRWT,
                                             RowDiff as JRowDiff,
                                             RowFlat as JRowFlat)
from metagraph_tpu.annotation.ops import DeviceAnnotation as JDeviceAnno

from metagraph_tpu_torch import convert
from metagraph_tpu_torch._u32 import words_np
from metagraph_tpu_torch.annotation import device_matrix as dm
from metagraph_tpu_torch.annotation.matrix import (BRWT, _AnnotationUnpickler)
from metagraph_tpu_torch.query import device as qd

CPU = torch.device("cpu")


def _port(obj):
    """A JAX host matrix -> the port's copy, through the port's
    unpickler."""
    return _AnnotationUnpickler(io.BytesIO(pickle.dumps(obj))).load()


def _columns(rng, R, L, shared=(3, 5)):
    """Random sorted label columns over R rows, and a few rows that carry
    many labels (so that linkage has structure to find)."""
    cols = []
    hot = rng.choice(R, 12, replace=False)
    for c in range(L):
        rows = rng.choice(R, int(rng.integers(0, R // 3)), replace=False)
        if c % shared[0] < shared[1]:
            rows = np.concatenate([rows, hot])
        cols.append(np.unique(rows).astype(np.int64))
    return cols


def _mask_words(mask):
    """(Q, L) bool -> (Q, Lw) uint32 words."""
    Q, L = mask.shape
    Lw = max((L + 31) // 32, 1)
    pad = np.zeros((Q, Lw * 32), bool)
    pad[:, :L] = mask
    return np.packbits(pad.reshape(Q, Lw, 32), axis=2,
                       bitorder="little").view(np.uint32)[:, :, 0]


def _rows(rng, R, n=200):
    """Row queries with misses (-1), every row at least once."""
    rows = np.concatenate([np.arange(R), rng.integers(-1, R, n)])
    rows[rng.random(len(rows)) < 0.1] = -1
    return rows.astype(np.int32)


def _w1(port_brwt, rows, offset=0):
    """W1's plain version on rows (-1 = miss) -> (Q, Lw) uint32."""
    dev = dm.BRWTOnDevice.from_host(dm.FlatBRWT.from_brwt(port_brwt), CPU)
    ids = torch.from_numpy(np.where(rows >= 0, rows + 1, 0)
                           .astype(np.int32))
    if offset:                 # canon 2: every other hit through the rc id
        ids = torch.where((ids > 0) & (torch.arange(len(ids)) % 2 == 1),
                          ids + offset, ids)
    return words_np(dm.brwt_row_words(dev, ids, offset))


TREES = [(linkage, arity) for linkage in (True, False)
         for arity in (2, 3, 5)]


@pytest.mark.parametrize("linkage,arity", TREES)
@pytest.mark.parametrize("L", (1, 7, 45))
def test_w1_plain_matches_jax_descents(L, linkage, arity):
    """W1's plain version equals the JAX dynamic descent, the static one
    (small trees: its program grows with the tree) and the host
    get_rows_mask; an offset (canon 2) folds as the wire epoch folds it."""
    rng = np.random.default_rng(L * 10 + arity + linkage)
    R = 300
    jb = JBRWT.from_columns(_columns(rng, R, L), R, L, arity=arity,
                            linkage=linkage)
    pb = _port(jb)
    rows = _rows(rng, R)
    got = _w1(pb, rows)
    want = np.asarray(jdm.dyn_brwt_words_fn(jdm.DynDeviceBRWT.from_host(jb),
                                            jnp.asarray(rows)))
    assert np.array_equal(got, want)
    host = _mask_words(jb.get_rows_mask(np.maximum(rows, 0)))
    assert np.array_equal(got, np.where((rows >= 0)[:, None], host, 0))
    if L <= 7:
        static = np.asarray(jdm.brwt_row_words(jdm.DeviceBRWT.from_host(jb),
                                               jnp.asarray(rows)))
        assert np.array_equal(got, static)
    assert np.array_equal(_w1(pb, rows, offset=R), got)


@pytest.mark.parametrize("linkage,arity", TREES[:3])
def test_flatten_brwt_matches_jax(linkage, arity):
    """The port's flatten_brwt gives the JAX function's arrays."""
    rng = np.random.default_rng(7 + arity)
    R, L = 200, 23
    jb = JBRWT.from_columns(_columns(rng, R, L), R, L, arity=arity,
                            linkage=linkage)
    jflat, jll, jln = jdm.flatten_brwt(jb)
    flat, ll, ln = dm.flatten_brwt(_port(jb))
    assert np.array_equal(ll, jll) and np.array_equal(ln, jln)
    assert len(flat) == len(jflat)
    for mine, theirs in zip(flat, jflat):
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_w1_stack_bound_holds_on_wide_trees():
    """Arity above 32 (a run popped 32 children at a time) and a row with
    every label set: the plain descent sees every leaf, and the stack
    bound the kernel sizes its shared memory by covers the tree."""
    R, L = 64, 100
    cols = [np.arange(R) if c % 9 == 0 else np.arange(c % 7, R, 5)
            for c in range(L)]
    jb = JBRWT.from_columns(cols, R, L, arity=40, linkage=False)
    pb = _port(jb)
    flat = dm.FlatBRWT.from_brwt(pb)
    assert flat.stack_cap >= 1 + min(32, 3)
    rows = np.arange(R, dtype=np.int32)
    want = np.asarray(jdm.dyn_brwt_words_fn(jdm.DynDeviceBRWT.from_host(jb),
                                            jnp.asarray(rows)))
    assert np.array_equal(_w1(pb, rows), want)


def test_brwt_label_without_leaf():
    """BRWT.from_columns leaves a label without a leaf only when given
    fewer columns than labels (linkage: the tree covers the columns);
    transform_anno gives one column a label.  The JAX DynDeviceBRWT's
    stable argsort then sorts the leafless label (level -1) first and takes
    its node -1 for a level-0 label, so its words shift labels; the port
    gives the leafless label no bits and every other label its own, as the
    host get_rows_mask does."""
    rng = np.random.default_rng(5)
    R, L = 120, 6
    cols = _columns(rng, R, L - 1)
    jb = JBRWT.from_columns(cols, R, L, linkage=True)
    _, jll, _ = jdm.flatten_brwt(jb)
    assert jll[L - 1] == -1 and (jll[:L - 1] >= 0).all()
    rows = np.arange(R, dtype=np.int32)
    host = _mask_words(jb.get_rows_mask(rows))
    got = _w1(_port(jb), rows)
    assert np.array_equal(got, host)
    jax_words = np.asarray(jdm.dyn_brwt_words_fn(
        jdm.DynDeviceBRWT.from_host(jb), jnp.asarray(rows)))
    assert not np.array_equal(jax_words, host)


def _routing(rng, R, anchor_share=0.1):
    """A random acyclic routing: each row's successor comes later in a
    random order (or none), anchors at random and where no successor."""
    order = rng.permutation(R)
    succ = np.full(R, -1, np.int64)
    for i in range(R - 1):
        if rng.random() < 0.85:
            succ[order[i]] = order[i + 1]
    anchors = (rng.random(R) < anchor_share) | (succ < 0)
    return succ, anchors


def _rowdiff_pair(rng, R, L, inner):
    """A JAX RowDiff over a BRWT or a RowFlat inner, and the port's copy."""
    cols = _columns(rng, R, L)
    succ, anchors = _routing(rng, R)
    inner_type = JBRWT if inner == "brwt" else JRowFlat
    jrd = JRowDiff.from_annotation(cols, R, L, None, inner_type=inner_type,
                                   routing=(succ, anchors))
    return cols, jrd, _port(jrd)


def _jax_rowdiff(jrd, inner):
    from metagraph_tpu.query.pipeline import QueryEngine
    if inner == "brwt":
        dev = jdm.DeviceRowDiff.from_host(
            jrd, jdm.DynDeviceBRWT.from_host(jrd.inner))
        return dev, jdm.rowdiff_dyn_brwt_words_fn
    bitmap = QueryEngine._pack_matrix_bitmap(jrd.inner)
    dev = jdm.DeviceRowDiff.from_host(
        jrd, JDeviceAnno.from_bitmap(bitmap, jrd.num_labels))
    return dev, jdm.rowdiff_dense_words_fn


def _port_rowdiff(prd, inner):
    inner_f = dm.FlatBRWT.from_brwt(prd.inner) if inner == "brwt" else \
        convert.pack_matrix_bitmap(prd.inner, prd.inner.num_rows)
    return dm.FlatRowDiff.from_row_diff(prd, inner_f)


@pytest.mark.parametrize("inner", ("brwt", "flat"))
@pytest.mark.parametrize("L", (5, 40))
def test_w2_plain_matches_jax(inner, L):
    """W2's plain version equals rowdiff_dyn_brwt_words_fn or
    rowdiff_dense_words_fn, and the host rows; max_depth is the JAX
    fixpoint's."""
    rng = np.random.default_rng(31 + L)
    R = 400
    cols, jrd, prd = _rowdiff_pair(rng, R, L, inner)
    jdev, fn = _jax_rowdiff(jrd, inner)
    flat = _port_rowdiff(prd, inner)
    assert flat.max_depth == jdev.max_depth > 2
    rows = _rows(rng, R)
    want = np.asarray(fn(jdev, jnp.asarray(rows)))
    dev = dm.RowDiffOnDevice.from_host(flat, CPU)
    ids = torch.from_numpy(np.where(rows >= 0, rows + 1, 0).astype(np.int32))
    got = words_np(dm.rowdiff_row_words(dev, ids))
    assert np.array_equal(got, want)
    truth = np.zeros((R, L), bool)
    for c, col in enumerate(cols):
        truth[col, c] = True
    host = _mask_words(truth[np.maximum(rows, 0)])
    assert np.array_equal(got, np.where((rows >= 0)[:, None], host, 0))
    # canon 2: ids above the offset fold back first
    rc = torch.where((ids > 0) & (torch.arange(len(ids)) % 3 == 0),
                     ids + R, ids)
    assert np.array_equal(words_np(dm.rowdiff_row_words(dev, rc, R)), got)


def test_w2_walk_stops_at_max_depth():
    """A chain longer than a truncated max_depth: both packages stop after
    max_depth steps, with the same partial XOR."""
    R, L = 50, 3
    succ = np.arange(1, R + 1, dtype=np.int64)
    succ[-1] = -1
    anchors = np.zeros(R, bool)
    anchors[-1] = True
    cols = [np.arange(0, R, 2), np.arange(0, R, 3), np.array([R - 1])]
    jrd = JRowDiff.from_annotation(cols, R, L, None, inner_type=JBRWT,
                                   routing=(succ, anchors))
    jdev = jdm.DeviceRowDiff.from_host(
        jrd, jdm.DynDeviceBRWT.from_host(jrd.inner))
    flat = _port_rowdiff(_port(jrd), "brwt")
    assert flat.max_depth == jdev.max_depth == R
    jdev.max_depth = flat.max_depth = 7
    rows = np.arange(R, dtype=np.int32)
    want = np.asarray(jdm.rowdiff_dyn_brwt_words_fn(jdev, jnp.asarray(rows)))
    got = words_np(dm.rowdiff_row_words(
        dm.RowDiffOnDevice.from_host(flat, CPU),
        torch.from_numpy(rows + 1)))
    assert np.array_equal(got, want)


def test_cyclic_routing_raises_in_both():
    R, L = 30, 2
    succ = np.arange(1, R + 1, dtype=np.int64) % R       # one cycle
    anchors = np.zeros(R, bool)
    cols = [np.arange(0, R, 2), np.arange(1, R, 4)]
    jrd = JRowDiff.from_annotation(cols, R, L, None, inner_type=JBRWT,
                                   routing=(succ, anchors))
    with pytest.raises(ValueError, match="does not terminate"):
        jdm.DeviceRowDiff.from_host(jrd, None)
    with pytest.raises(ValueError, match="does not terminate"):
        dm.FlatRowDiff.from_row_diff(_port(jrd), None)


@pytest.mark.parametrize("inner", ("brwt", "flat"))
def test_rowdiff_from_annotation_matches_jax(inner):
    """The port's RowDiff.from_annotation, given the JAX one's routing,
    holds the same diff columns: equal inner rows and equal rows (the
    port's inner a BRWT, as the call asks)."""
    from metagraph_tpu_torch.annotation.matrix import RowDiff
    rng = np.random.default_rng(3)
    R, L = 250, 12
    cols = _columns(rng, R, L)
    succ, anchors = _routing(rng, R)
    jrd = JRowDiff.from_annotation(cols, R, L, None,
                                   inner_type=JBRWT if inner == "brwt"
                                   else JRowFlat, routing=(succ, anchors))
    prd = RowDiff.from_annotation(cols, R, L, (succ, anchors),
                                  inner_type=BRWT)
    assert isinstance(prd.inner, BRWT)
    rows = np.arange(R)
    assert np.array_equal(prd.inner.get_rows_mask(rows),
                          jrd.inner.get_rows_mask(rows))
    assert np.array_equal(prd.get_rows_mask(rows), jrd.get_rows_mask(rows))


def _tiles(rng, R, S, T=64):
    """(N, T) rows + 1 (0 = miss) of S sequences, sorted tile owners."""
    nwin = rng.integers(0, 3 * T, S)
    nwin[1] = 0
    tiles, owner = [], []
    for s, n in enumerate(nwin):
        nt = -(-int(n) // T)
        t = np.zeros((nt, T), np.int32)
        flat = rng.integers(0, R + 1, int(n)).astype(np.int32)
        flat[rng.random(int(n)) < 0.15] = 0
        t.reshape(-1)[:int(n)] = flat
        tiles.append(t)
        owner += [s] * nt
    return np.concatenate(tiles), np.array(owner, np.int32)


WORDS_FNS = ("brwt", "rowdiff_brwt", "rowdiff_dense")


@pytest.mark.parametrize("small_chunks", (False, True))
@pytest.mark.parametrize("fn", WORDS_FNS)
def test_words_count_epoch_matches_tiled_count_epoch(fn, small_chunks,
                                                     monkeypatch):
    """count_labels on a words annotation equals make_tiled_count_epoch
    with the same words fn, several sequences a batch (one chunk, or a
    chunk a few tiles)."""
    if small_chunks:
        monkeypatch.setattr(qd, "WORDS_BYTES", 3 * 64 * 8 * 4)
    rng = np.random.default_rng(11)
    R, L, S = 300, 37, 9
    if fn == "brwt":
        jb = JBRWT.from_columns(_columns(rng, R, L), R, L, linkage=False)
        jdev, wfn = jdm.DynDeviceBRWT.from_host(jb), jdm.dyn_brwt_words_fn
        port = dm.FlatBRWT.from_brwt(_port(jb))
    else:
        inner = "brwt" if fn == "rowdiff_brwt" else "flat"
        _, jrd, prd = _rowdiff_pair(rng, R, L, inner)
        jdev, wfn = _jax_rowdiff(jrd, inner)
        port = _port_rowdiff(prd, inner)
    tiles, owner = _tiles(rng, R, S)
    want_c, want_p = jdm.make_tiled_count_epoch(wfn)(
        jdev, jnp.asarray(tiles), jnp.asarray(owner), 16, L)
    anno = dm.device_words(port, CPU)
    counts, present = qd.count_labels(anno, torch.from_numpy(tiles),
                                      torch.from_numpy(owner), S, L)
    assert np.array_equal(counts.numpy(), np.asarray(want_c)[:S])
    assert np.array_equal(present.numpy(), np.asarray(want_p)[:S])


def test_from_jax_device_matrix():
    """The JAX classes' state -> the port's forms, which compute the JAX
    words: a DynDeviceBRWT, a DeviceRowDiff over one, and one over a dense
    DeviceAnnotation."""
    rng = np.random.default_rng(17)
    R, L = 260, 33
    jb = JBRWT.from_columns(_columns(rng, R, L), R, L, arity=3)
    jdev = jdm.DynDeviceBRWT.from_host(jb)
    flat = convert.from_jax_device_matrix(jdev)
    mine = dm.FlatBRWT.from_brwt(_port(jb))
    assert np.array_equal(flat.nodes, mine.nodes)
    assert np.array_equal(flat.words, mine.words)
    assert flat.stack_cap == mine.stack_cap
    rows = _rows(rng, R)
    ids = torch.from_numpy(np.where(rows >= 0, rows + 1, 0).astype(np.int32))
    got = words_np(dm.brwt_row_words(dm.BRWTOnDevice.from_host(flat, CPU),
                                     ids))
    assert np.array_equal(got, np.asarray(jdm.dyn_brwt_words_fn(
        jdev, jnp.asarray(rows))))
    for inner in ("brwt", "flat"):
        _, jrd, _ = _rowdiff_pair(rng, R, L, inner)
        jrdev, wfn = _jax_rowdiff(jrd, inner)
        frd = convert.from_jax_device_matrix(jrdev)
        assert frd.max_depth == jrdev.max_depth
        got = words_np(dm.rowdiff_row_words(
            dm.RowDiffOnDevice.from_host(frd, CPU), ids))
        assert np.array_equal(got, np.asarray(wfn(jrdev,
                                                  jnp.asarray(rows))))


def test_query_index_checks_words_ranges():
    """QueryIndex refuses a words annotation whose indices leave its
    arrays, which W1 and W2 index with."""
    rng = np.random.default_rng(2)
    R, L = 100, 9
    pb = BRWT.from_columns(_columns(rng, R, L), R, L, linkage=False)
    good = dm.FlatBRWT.from_brwt(pb)
    table = convert.DeviceHashIndex.build_table(
        np.arange(1, R + 1, dtype=np.uint32)[:, None] * 7,
        np.arange(1, R + 1, dtype=np.uint32))
    labels = [f"l{c}" for c in range(L)]
    convert.QueryIndex(8, table, good, labels)
    bad = []
    for col, val in ((0, len(good.words)), (1, L), (2, len(good.nodes)),
                     (3, len(good.nodes))):
        nodes = good.nodes.copy()
        at = int(np.flatnonzero(nodes[:, 3] > 0)[0]) if col >= 2 else \
            int(np.flatnonzero(nodes[:, 1] >= 0)[0])
        nodes[at, col] = val
        bad.append(dm.FlatBRWT(nodes, good.words, R, L, good.stack_cap))
    nxt = np.full(R, -1, np.int32)
    nxt[3] = R
    bad.append(dm.FlatRowDiff(nxt, 2, good, L))
    bad.append(dm.FlatRowDiff(np.full(R, -1, np.int32), 2,
                              np.zeros((R, 2), np.uint32), L))
    for b in bad:
        with pytest.raises(ValueError):
            convert.QueryIndex(8, table, b, labels)


def test_route_of_words_annotation():
    """A basic DNA graph with k >= 32 takes the codes route on a bitmap
    and the map route on a words annotation, as the JAX package sends it
    to execute_batch; the codes epoch refuses a words annotation."""
    from metagraph_tpu_torch.query.pipeline import route_of
    from metagraph_tpu_torch.succinct.ops import DeviceHashIndex
    rng = np.random.default_rng(4)
    R, L, k = 50, 4, 41
    pb = BRWT.from_columns(_columns(rng, R, L), R, L, linkage=False)
    W = 6
    keys = rng.integers(0, 2 ** 32, (R, W), dtype=np.uint64).astype(np.uint32)
    table = DeviceHashIndex.build_table(keys, np.arange(1, R + 1,
                                                        dtype=np.uint32))
    labels = [f"l{c}" for c in range(L)]
    words = convert.QueryIndex(k, table, dm.FlatBRWT.from_brwt(pb), labels)
    dense = convert.QueryIndex(k, table, np.zeros((R, 1), np.uint32), labels)
    assert route_of(dense) == "codes" and route_of(words) == "map"
    assert route_of(convert.QueryIndex(16, convert.DeviceHashIndex
                                       .build_table(keys[:, :2],
                                                    np.arange(
                                                        1, R + 1,
                                                        dtype=np.uint32)),
                                       dm.FlatBRWT.from_brwt(pb),
                                       labels)) == "wire"
    anno = dm.device_words(dm.FlatBRWT.from_brwt(pb), CPU)
    z = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="words"):
        qd.codes_epoch(torch.zeros((4, 28), dtype=torch.int32), anno, z, z,
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32), 1, L, k)
