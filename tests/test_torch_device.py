"""The port's wire epoch (kernels 1-3) against metagraph_tpu/query/device.py.

The state is carried from the JAX engine by ``convert.from_jax_arrays``;
every comparison is exact.  On the CPU the port runs the plain PyTorch
versions of its kernels (tests/test_torch_gpu.py holds the CUDA kernels
against them on the card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagraph_tpu_torch import convert
from metagraph_tpu_torch._u32 import np_words, words_np
from metagraph_tpu_torch.query import device as tdev

K = 17


@pytest.fixture(scope="module")
def wire_case():
    """tests/test_device_ops.py's wire-epoch fixture: random ACGTN reads,
    K = 17, one label per read."""
    from metagraph_tpu import native
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu.query.device import TILE, wire_words_layout
    from metagraph_tpu.query.pipeline import QueryEngine, _thresholds
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGTN"), size=int(n))).encode()
            for n in rng.integers(10, 700, size=16)]
    g = DBGSuccinct.build([s for s in seqs if len(s) >= K], K)
    anno = ColumnMajorAnnotation(g.max_index())
    ag = AnnotatedDBG(g, anno)
    for i, s in enumerate(seqs):
        if len(s) >= K:
            ag.annotate_sequence(s, [f"s{i}"])
    eng = QueryEngine(ag, use_device=True)
    eng._build_device_index()
    danno = eng._build_device_annotation()
    S, L = len(seqs), anno.num_labels
    t2, vb, tile_seq, nwins = native.tile_pack2(seqs, K, TILE)
    dsel, selmin = _thresholds(nwins, 0.7, 0.1, S)
    words, vwords = wire_words_layout(t2, vb, K, TILE, len(t2))
    table = np.asarray(eng._device_index.table)
    index = convert.from_jax_arrays(
        table, danno.unpacked(),
        [anno.encoder.decode(c) for c in range(L)], K, g.max_index())
    return dict(eng=eng, danno=danno, table=table, index=index, S=S, L=L,
                words=words, vwords=vwords, tile_seq=tile_seq, dsel=dsel,
                selmin=selmin)


def test_wire_epoch_matches_jax(wire_case):
    from metagraph_tpu.query.device import (TILE, query_epoch_wire_buf,
                                            wire_epoch_buffer)
    c = wire_case
    buf = wire_epoch_buffer(c["words"], c["vwords"], c["tile_seq"],
                            c["dsel"], c["selmin"])
    want = query_epoch_wire_buf(
        jnp.asarray(c["table"]), c["danno"].bitmap, jnp.asarray(buf),
        len(c["words"]), c["words"].shape[1], c["vwords"].shape[1],
        c["S"], c["L"], K, TILE)
    idx = c["index"]
    mask, counts, present, nodes = tdev.wire_epoch(
        np_words(idx.table), np_words(idx.device_anno), np_words(c["words"]),
        np_words(c["vwords"]), torch.from_numpy(c["tile_seq"]),
        torch.from_numpy(c["dsel"]), torch.from_numpy(c["selmin"]),
        c["S"], c["L"], K, TILE)
    n = len(c["words"])
    np.testing.assert_array_equal(words_np(mask), np.asarray(want[0]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(present.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(want[3])[:n])
    assert (nodes.numpy() > 0).sum() > 50 and counts.numpy().sum() > 50


def _random_nodes(rng, n_tiles, T, R, p_hit=0.6):
    nodes = rng.integers(1, R + 1, (n_tiles, T)).astype(np.int32)
    return np.where(rng.random((n_tiles, T)) < p_hit, nodes, 0) \
        .astype(np.int32)


@pytest.mark.parametrize("L", (1, 40, 64, 100))
def test_label_counts_plain_matches_jax(L):
    """The plain label_counts = _tile_label_counts + _fold_tiles."""
    from metagraph_tpu.query.device import _fold_tiles, _tile_label_counts
    rng = np.random.default_rng(L)
    R, T, N, S = 300, 64, 12, 5
    Lw = (L + 31) // 32
    bitmap = rng.integers(0, 2 ** 32, (R, Lw), dtype=np.uint64) \
        .astype(np.uint32)
    if L % 32:
        bitmap[:, -1] &= np.uint32((1 << (L % 32)) - 1)
    nodes = _random_nodes(rng, N, T, R)
    tile_seq = np.sort(rng.integers(0, S, N)).astype(np.int32)
    tc, th = _tile_label_counts(jnp.asarray(bitmap), jnp.asarray(nodes), L)
    want_c, want_p = _fold_tiles(tc, th, jnp.asarray(tile_seq), S)
    counts, present = tdev.label_counts(
        torch.from_numpy(nodes), np_words(bitmap),
        torch.from_numpy(tile_seq), S, L)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(present.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("L", (1, 3, 4, 31, 32, 33, 70, 100, 1000, 1001))
def test_selection_mask_plain_matches_jax(L):
    """With rows whose presence just fails and just passes, a row without
    k-mers (selmin INT32_MAX), and counts and dsel at 0 and INT32_MAX."""
    from metagraph_tpu.query.device import _pack_selection_mask
    rng = np.random.default_rng(1000 + L)
    S, top = 9, np.iinfo(np.int32).max
    counts = rng.integers(0, 20, (S, L)).astype(np.int32)
    counts[rng.random((S, L)) < 0.1] = 0
    counts[rng.random((S, L)) < 0.1] = top
    present = rng.integers(0, 30, S).astype(np.int32)
    dsel = rng.integers(1, 15, S).astype(np.int32)
    selmin = rng.integers(1, 25, S).astype(np.int32)
    selmin[0] = top
    present[1], selmin[1] = 5, 6
    present[2], selmin[2] = 6, 6
    present[3], selmin[3], dsel[3] = top, 1, top
    want = _pack_selection_mask(jnp.asarray(counts), jnp.asarray(present),
                                jnp.asarray(dsel), jnp.asarray(selmin))
    got = tdev.selection_mask(*(torch.from_numpy(a) for a in
                                (counts, present, dsel, selmin)))
    np.testing.assert_array_equal(words_np(got), np.asarray(want))


def test_host_layout_helpers_match(wire_case):
    from metagraph_tpu.query import device as jdev
    from metagraph_tpu.query.pipeline import _thresholds
    rng = np.random.default_rng(5)
    nk = rng.integers(0, 400, 50)
    for df, pf in ((0.7, 0.0), (0.33, 0.9), (1.0, 1.0)):
        for a, b in zip(tdev._thresholds(nk, df, pf),
                        _thresholds(nk, df, pf, len(nk))):
            np.testing.assert_array_equal(a, b)
    nwins = [0, 300, 5, 256, 1000]
    nt = sum(-(-n // 256) for n in nwins)
    tiled = rng.integers(0, 9, (nt, 256)).astype(np.int32)
    for a, b in zip(tdev.untile_nodes(tiled, nwins),
                    jdev.untile_nodes(tiled, None, nwins)):
        np.testing.assert_array_equal(a, b)
