"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither jax nor metagraph_tpu, so it runs on a machine that has only
PyTorch; tests/conftest.py imports jax, so run it there without conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Inputs come from numpy seeds; every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metagraph_tpu_torch import convert
from metagraph_tpu_torch._u32 import np_words
from metagraph_tpu_torch.align.sw import (positions_per_lane, query_blocks,
                                          sw_scores)
from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
from metagraph_tpu_torch.annotation import device_matrix as dm
from metagraph_tpu_torch.annotation import sparse_device as sd
from metagraph_tpu_torch.annotation.matrix import BRWT, RowDiff
from metagraph_tpu_torch.annotation.ops import (DeviceAnnotation,
                                               pack_annotation_bitmap)
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
from metagraph_tpu_torch.query import device as qd
from metagraph_tpu_torch.query.pipeline import QueryEngine
from metagraph_tpu_torch.query.tile_pack import tile_pack2
from metagraph_tpu_torch.scripts import exp_gather as eg
from metagraph_tpu_torch.succinct import device_build as db
from metagraph_tpu_torch.succinct import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _index(K, seed, n_refs=6, ref_len=700, rc_share=0.0, read_max=150,
           n_rate=0.02):
    """A port-built index over random references (one label each, every
    other reference also labelled 'all') and reads of K - 3 to
    ``read_max`` bp cut from them, a ``rc_share`` of them
    reverse-complemented, an ``n_rate`` of their bases N."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (n_refs, ref_len)).astype(np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(refs, K, axis=1)
    chars, inv = np.unique(win.reshape(-1, K) + 1, axis=0,
                           return_inverse=True)
    ref_of = np.repeat(np.arange(n_refs), ref_len - K + 1)
    L = n_refs + 1
    cols = [np.unique(inv.reshape(-1)[ref_of == c]) for c in range(n_refs)]
    cols.append(np.unique(inv.reshape(-1)[ref_of % 2 == 0]))
    labels = [f"s{c}" for c in range(n_refs)] + ["all"]
    anno = ColumnMajorAnnotation(len(chars), labels, cols)
    index = convert.from_kmers(
        ops.pack_kmers32(chars), np.arange(1, len(chars) + 1,
                                           dtype=np.uint32),
        pack_annotation_bitmap(anno), labels, K, anno)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seqs = []
    for i in range(40):
        r = refs[i % n_refs]
        a = int(rng.integers(0, ref_len - read_max))
        read = r[a: a + int(rng.integers(K - 3, read_max))].copy()
        if rng.random() < rc_share:
            read = 3 - read[::-1]
        read[rng.random(len(read)) < n_rate] = 4
        seqs.append(letters[read].tobytes())
    seqs.append(letters[np.tile(refs[0], 3)].tobytes())
    return index, seqs


def _wire_inputs(index, seqs, dev):
    K = index.k
    tiles2, validb, tile_seq, nwins = tile_pack2(seqs, K, qd.TILE)
    words, vwords = qd.wire_words_layout(tiles2, validb, K, qd.TILE,
                                         len(tiles2))
    dsel, selmin = qd._thresholds(nwins, 0.6, 0.1)
    t = [np_words(index.table), np_words(index.device_anno), np_words(words),
         np_words(vwords)] + [torch.from_numpy(a)
                              for a in (tile_seq, dsel, selmin)]
    return [a.to(dev) for a in t]


@pytest.mark.parametrize("K", (2, 15, 16, 17, 31))
def test_wire_epoch_kernels_match_plain(cuda, K):
    index, seqs = _index(K, K)
    args = _wire_inputs(index, seqs, "cpu")
    L = len(index.labels)
    want = qd.wire_epoch(*args, len(seqs), L, K)
    got = qd.wire_epoch(*[a.to(cuda) for a in args], len(seqs), L, K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert (want[3] > 0).sum() > 100


@pytest.mark.parametrize("canon", (1, 2))
@pytest.mark.parametrize("K", (2, 15, 16, 17, 31))
def test_canonical_wire_epoch_kernels_match_plain(cuda, K, canon):
    """canon 1 (one probe of the BOSS-order canonical strand) and canon 2
    (rc probe where the forward probe missed, ids + offset, folded for the
    label counts) against the plain versions."""
    index, seqs = _index(K, 100 + K, rc_share=0.5)
    args = _wire_inputs(index, seqs, "cpu")
    L, R = len(index.labels), index.num_rows
    offset = R if canon == 2 else 0
    want = qd.wire_epoch(*args, len(seqs), L, K, canon=canon, offset=offset)
    got = qd.wire_epoch(*[a.to(cuda) for a in args], len(seqs), L, K,
                        canon=canon, offset=offset)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert (want[3] > 0).sum() > 100
    if canon == 2 and K > 2:    # at K = 2 every 2-mer is a forward hit
        assert (want[3] > offset).sum() > 100


FILLS = (0, 1, 3, 4, 5, 15, 16, 16)     # keys per bucket


def table_with_fills(K, seed, fills=FILLS):
    """A hash table whose bucket b holds fills[b] keys, chosen by their
    hash, in random order: -> (table, key chars, ids, chars of absent
    k-mers hashing to every bucket).  Full buckets hold a key in slot 15."""
    rng = np.random.default_rng(seed)
    nb = len(fills)
    pool = np.unique(rng.integers(1, 5, (64 * nb, K)).astype(np.uint8),
                     axis=0)
    b = ops._hash_words(ops.pack_kmers32(pool), nb, 1)
    take, absent = [], []
    for bucket, n in enumerate(fills):
        mine = np.flatnonzero(b == bucket)
        take.append(mine[:n])
        absent.append(mine[n: n + 3])
    chars = pool[rng.permutation(np.concatenate(take))]
    ids = rng.permutation(len(chars)).astype(np.uint32) + 1
    table = ops.DeviceHashIndex._build(ops.pack_kmers32(chars), ids, nb)
    return (table.reshape(nb, -1), chars, ids,
            pool[np.concatenate(absent)])


@pytest.mark.parametrize("traffic", ("keys", "rc", "mixed"))
@pytest.mark.parametrize("canon", (0, 1, 2))
@pytest.mark.parametrize("K", (15, 16, 17, 31))
def test_wire_lookup_stop_rule_matches_plain(cuda, K, canon, traffic):
    """Hits and misses in buckets of 0, 1, 3, 4, 5, 15 and 16 keys (a key
    in slot 15 included); one window per sequence.  With canon 2, "keys"
    hits every window forward (pass 2 gets an empty list) and "rc" misses
    every window forward (pass 2 gets them all)."""
    table, chars, ids, absent = table_with_fills(K, 7000 + K)
    letters = np.frombuffer(b"ACGT", np.uint8)
    rc = 5 - chars[:, ::-1]
    kmers = {"keys": chars, "rc": rc,
             "mixed": np.concatenate([chars, rc, absent])}[traffic]
    seqs = [letters[c - 1].tobytes() for c in kmers]
    tiles2, validb, _, _ = tile_pack2(seqs, K, qd.TILE)
    words, vwords = qd.wire_words_layout(tiles2, validb, K, qd.TILE,
                                         len(tiles2))
    args = [np_words(a) for a in (words, vwords, table)]
    offset = 1000 if canon == 2 else 0
    want = ops.wire_lookup(*args, K, qd.TILE, canon, offset)
    before = ops.wire_lookup.launches
    got = ops.wire_lookup(*[a.to(cuda) for a in args], K, qd.TILE, canon,
                          offset)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert ops.wire_lookup.launches == before + (2 if canon == 2 else 1)
    first = want[:, 0].numpy()
    if canon == 0 and traffic == "keys":
        np.testing.assert_array_equal(first, ids)   # slot 15 included
    if canon == 2 and traffic != "mixed":
        fwd = traffic == "keys"
        assert ((first > 0) & (first <= offset)).all() == fwd
        assert (first > offset).all() != fwd


def _bitmap(rng, R, L):
    """Rows of every density: empty, one bit per word, every bit, 5%."""
    Lw = (L + 31) // 32
    bits = np.zeros((R, Lw * 32), bool)
    kind = np.arange(R) % 4
    one = np.flatnonzero(kind == 1)[:, None]
    bits[one, rng.integers(0, 32, (len(one), Lw)) + 32 * np.arange(Lw)] = True
    bits[kind == 2] = True
    bits[kind == 3] = rng.random(((kind == 3).sum(), Lw * 32)) < 0.05
    bits[:, L:] = False
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


@pytest.mark.parametrize("layout", ("contiguous", "padded"))
@pytest.mark.parametrize("L", (1, 100, 1000, 9000))
def test_label_counts_row_kinds_match_plain(cuda, L, layout):
    """Rows with 0, 1 and 32 bits per word and random ones; half of the
    tiles have all 256 windows on one row; a contiguous bitmap (4-byte row
    copies when Lw % 4 != 0) and DeviceAnnotation's padded rows."""
    rng = np.random.default_rng(4000 + L)
    R, T, N, S = 400, qd.TILE, 40, 6
    bitmap = _bitmap(rng, R, L)
    nodes = np.where(rng.random((N, T)) < 0.9,
                     rng.integers(1, R + 1, (N, T)), 0)
    nodes[::2] = rng.integers(1, R + 1, (N // 2, 1))    # one row per tile
    nodes = torch.from_numpy(nodes.astype(np.int32))
    tile_seq = torch.from_numpy(np.sort(rng.integers(0, S, N))
                                .astype(np.int32))
    want = qd.label_counts(nodes, np_words(bitmap), tile_seq, S, L)
    dev_bitmap = np_words(bitmap).to(cuda) if layout == "contiguous" else \
        DeviceAnnotation.from_bitmap(bitmap, L, cuda).bitmap
    got = qd.label_counts(nodes.to(cuda), dev_bitmap, tile_seq.to(cuda), S,
                          L)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert want[0].sum() > 0


@pytest.mark.parametrize("L", (1, 100, 9000))
def test_label_counts_offset_fold_matches_plain(cuda, L):
    """Ids above the offset fold to their base row; with the offset at R
    every id lies in 1..2R."""
    rng = np.random.default_rng(3000 + L)
    R, T, N, S = 500, 256, 40, 7
    Lw = (L + 31) // 32
    bits = np.zeros((R, Lw * 32), bool)
    bits[:, :L] = rng.random((R, L)) < 0.05
    bitmap = np_words(np.packbits(bits, axis=1, bitorder="little")
                      .view(np.uint32))
    nodes = rng.integers(1, 2 * R + 1, (N, T)).astype(np.int32)
    nodes = torch.from_numpy(np.where(rng.random((N, T)) < 0.6, nodes, 0)
                             .astype(np.int32))
    tile_seq = torch.from_numpy(np.sort(rng.integers(0, S, N))
                                .astype(np.int32))
    want = qd.label_counts(nodes, bitmap, tile_seq, S, L, offset=R)
    got = qd.label_counts(nodes.to(cuda), bitmap.to(cuda), tile_seq.to(cuda),
                          S, L, offset=R)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert want[0].sum() > 0


# (n_rows, W, QB, Q, indices outside [0, n_rows) too)
GATHER_SHAPES = [(1 << 16, 32, 1024, 1 << 18, False),
                 (1 << 17, 32, 1024, (1 << 16) + 700, False),
                 (1000, 4, 1000, 9999, False),
                 (4096, 64, 33, 5000, False),
                 (300, 256, 7, 100, False),
                 (64, 8, 100, 99, False)]
GATHER_SHAPES += [(2048, W, 512, 100_003, False) for W in eg.WIDTHS]
GATHER_SHAPES += [(5000, 32, 3000, 3000, False),     # one chunk: a small grid
                  (100, 32, 1000, 999, False),       # nblocks == 0: no launch
                  (1, 16, 64, 1000, False),          # n_rows == 1
                  (3001, 128, 1, 12_347, False),     # shares of odd lengths
                  (777, 8, 100, 54_321, True),
                  (777, 256, 37, 54_321, True)]


@pytest.mark.parametrize("form", ("loop", "take"))
@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=lambda s: "-".join(map(str, s[:4]))
                         + ("-clamped" if s[4] else ""))
def test_gather_kernels_match_plain(cuda, form, shape):
    """X1 and X2 on the full (8, W) output, at every template width W, with
    a ragged tail of indices (left out), chunks that are not a multiple of
    the warp or stage, grids smaller than the card holds, no chunk at all,
    one row, and indices clamped from below and above."""
    n_rows, W, QB, Q, outside = shape
    rng = np.random.default_rng(sum(shape))
    tab = np_words(rng.integers(0, 2 ** 32, (n_rows, W), dtype=np.uint32))
    lo, hi = (-50, n_rows + 50) if outside else (0, n_rows)
    idx = torch.from_numpy(rng.integers(lo, hi, Q).astype(np.int32))
    want = eg.gather_rows_sum_plain(tab, idx, QB)
    kernel = eg.gather_loop if form == "loop" else eg.gather_take
    before = kernel.launches
    got = kernel(tab.to(cuda), idx.to(cuda), QB)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert kernel.launches == before + (Q >= QB)
    if Q < QB:
        assert not want.any()
    run = (eg.make_loop_kernel if form == "loop" else eg.make_take_kernel)(
        n_rows, W, QB)
    assert int(run(tab.to(cuda), idx.to(cuda))) == int(want[0, 0])


@pytest.mark.parametrize("L", (1, 100, 9000))
def test_count_and_select_kernels_match_plain(cuda, L):
    rng = np.random.default_rng(2000 + L)
    R, T, N, S = 500, 256, 40, 7
    Lw = (L + 31) // 32
    bits = np.zeros((R, Lw * 32), bool)
    bits[:, :L] = rng.random((R, L)) < 0.05
    bitmap = np_words(np.packbits(bits, axis=1, bitorder="little")
                      .view(np.uint32))
    nodes = rng.integers(1, R + 1, (N, T)).astype(np.int32)
    nodes = torch.from_numpy(np.where(rng.random((N, T)) < 0.6, nodes, 0)
                             .astype(np.int32))
    tile_seq = torch.from_numpy(np.sort(rng.integers(0, S, N))
                                .astype(np.int32))
    want = qd.label_counts(nodes, bitmap, tile_seq, S, L)
    got = qd.label_counts(nodes.to(cuda), bitmap.to(cuda), tile_seq.to(cuda),
                          S, L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    dsel = torch.from_numpy(rng.integers(1, 60, S).astype(np.int32))
    selmin = torch.from_numpy(rng.integers(1, 300, S).astype(np.int32))
    want_m = qd.selection_mask(want[0], want[1], dsel, selmin)
    got_m = qd.selection_mask(got[0], got[1], dsel.to(cuda), selmin.to(cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got_m.cpu().numpy(), want_m.numpy())


SW_SCORES = {"default": (2, -3, -6, -2), "open_gt_ext": (2, -3, -1, -3),
             "gap_scores": (2, -3, 1, 0)}


@pytest.mark.parametrize("scores", sorted(SW_SCORES))
@pytest.mark.parametrize("LQ", (1, 5, 31, 32, 33, 48, 150, 333, 1000, 1024),
                         ids=lambda LQ: f"LQ{LQ}-P{positions_per_lane(LQ)}")
def test_sw_kernel_matches_plain(cuda, LQ, scores):
    """Every kind of lane block (P = 1, 2, 5, 11, 32; a last lane partly
    filled), 67 pairs (no multiple of the 4 a block holds), padding on both
    sides and inside, gap_open above gap_ext and gaps that score."""
    rng = np.random.default_rng(LQ)
    B, LR = 67, LQ + 37
    qs = rng.integers(0, 4, (B, LQ)).astype(np.int32)
    rs = rng.integers(0, 4, (B, LR)).astype(np.int32)
    for b in range(B):
        n = int(rng.integers(1, LQ + 1))
        rs[b, :n] = qs[b, :n]
        qs[b, int(rng.integers(LQ // 2, LQ + 1)):] = -1
        rs[b, int(rng.integers(LR // 2, LR + 1)):] = -1
    qs[rng.random(qs.shape) < 0.01] = -1
    q, r = torch.from_numpy(qs), torch.from_numpy(rs)
    want = sw_scores(q, r, *SW_SCORES[scores])
    before = sw_scores.launches
    got = sw_scores(q.to(cuda), r.to(cuda), *SW_SCORES[scores])
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert sw_scores.launches == before + 1


def _select_inputs(rng, S, L, dev, offset):
    """Counts around the thresholds, a third of the rows failing presence,
    one row without k-mers; ``offset`` places the counts one int32 past a
    16-byte boundary, so the 4-byte variant runs."""
    buf = torch.from_numpy(rng.integers(0, 12, S * L + 1).astype(np.int32))
    buf = buf.to(dev)
    counts = buf[1:] if offset else buf[:-1]
    counts = counts.view(S, L)
    present = rng.integers(0, 30, S).astype(np.int32)
    selmin = np.where(rng.random(S) < 0.33, present + 1, present)
    selmin[0] = np.iinfo(np.int32).max
    dsel = rng.integers(1, 12, S).astype(np.int32)
    return [counts] + [torch.from_numpy(a.astype(np.int32)).to(dev)
                       for a in (present, dsel, selmin)]


@pytest.mark.parametrize("layout", ("aligned", "offset"))
@pytest.mark.parametrize("L", (1, 3, 4, 31, 32, 33, 100, 1000, 1001, 9000))
def test_selection_mask_kernel_matches_plain(cuda, L, layout):
    rng = np.random.default_rng(6000 + L)
    args = _select_inputs(rng, 300, L, cuda, layout == "offset")
    vec, _, _ = qd.selection_launch_plan(300, L, args[0])
    assert vec == (4 if L % 4 == 0 and layout == "aligned" else 1)
    want = qd.selection_mask_plain(*args)
    before = qd.selection_mask.launches
    got = qd.selection_mask(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert qd.selection_mask.launches == before + 1
    assert want.any()


@pytest.mark.parametrize("layout", ("aligned", "offset"))
@pytest.mark.parametrize("rows", ("one", "grid", "more"))
def test_selection_mask_kernel_row_counts(cuda, rows, layout):
    """One row, exactly as many rows as the persistent grid has warps, and
    more rows than that (warps stride over rows), in both variants."""
    L = 100
    probe = torch.zeros(4, dtype=torch.int32, device=cuda)
    _, grid, _ = qd.selection_launch_plan(1 << 30, L, probe)
    S = {"one": 1, "grid": grid * qd.SELECT_WARPS,
         "more": 3 * grid * qd.SELECT_WARPS + 5}[rows]
    rng = np.random.default_rng(S)
    args = _select_inputs(rng, S, L, cuda, layout == "offset")
    want = qd.selection_mask_plain(*args)
    got = qd.selection_mask(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("mode", ("labels", "matches", "counts",
                                  "signature"))
def test_query_engine_cuda_matches_cpu(cuda, mode):
    index, seqs = _index(31, 5)
    want = QueryEngine(index, device="cpu").query_batch_fused(
        seqs, mode, 3, 0.6, 0.1)
    got = QueryEngine(index, device=cuda).query_batch_fused(
        seqs, mode, 3, 0.6, 0.1)
    assert str(got) == str(want)
    assert any(want)


@pytest.mark.parametrize("canon", (1, 2))
@pytest.mark.parametrize("mode", ("labels", "counts"))
def test_canonical_query_engine_cuda_matches_cpu(cuda, mode, canon):
    # the index holds forward k-mers only: with canon 1 about half of the
    # windows (those whose forward strand comes first) hit
    index, seqs = _index(31, 7, rc_share=0.5)
    index = dataclasses.replace(index, canon=canon)
    want = QueryEngine(index, device="cpu").query_batch_fused(
        seqs, mode, 3, 0.3, 0.1)
    got = QueryEngine(index, device=cuda).query_batch_fused(
        seqs, mode, 3, 0.3, 0.1)
    assert str(got) == str(want)
    assert sum(bool(p) for p in want) > 10


# --------------------------------------------------------------------------
# kernels A and B
# --------------------------------------------------------------------------

def _fills_table(K, bits, seed, fills=FILLS):
    """table_with_fills for keys of ``bits`` bits a code: codes 1 .. 14
    (4 bits) or 1 .. 27 (8 bits, the Protein range)."""
    rng = np.random.default_rng(seed)
    nb = len(fills)
    top = 15 if bits == 4 else 28
    pool = np.unique(rng.integers(1, top, (64 * nb, K)).astype(np.uint8),
                     axis=0)
    b = ops._hash_words(ops.pack_kmers32(pool, bits), nb, 1)
    take, absent = [], []
    for bucket, n in enumerate(fills):
        mine = np.flatnonzero(b == bucket)
        take.append(mine[:n])
        absent.append(mine[n: n + 3])
    chars = pool[rng.permutation(np.concatenate(take))]
    ids = rng.permutation(len(chars)).astype(np.uint32) + 1
    table = ops.DeviceHashIndex._build(ops.pack_kmers32(chars, bits), ids, nb)
    return (table.reshape(nb, -1), chars, ids,
            pool[np.concatenate(absent)])


# kernel A's widths: every W of its block form, then its warp form (any W
# past ops.STATIC_KEY_WORDS) at widths of one, two and several warp rounds
KEY_WIDTHS = (*range(1, ops.STATIC_KEY_WORDS + 2), 20, 32, 33, 64, 125, 250)


@pytest.mark.parametrize("traffic", ("hits", "misses", "mixed"))
@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("W", KEY_WIDTHS)
def test_key_lookup_matches_plain(cuda, W, bits, traffic):
    """Kernel A at every W of its block form and at widths of its warp
    form, 4-bit and 8-bit keys, in buckets of 0, 1, 3, 4, 5, 15 and 16 keys
    (a key in slot 15 included)."""
    K = W * 32 // bits - 1
    table, chars, ids, absent = _fills_table(K, bits, 9000 + 10 * W + bits)
    kmers = {"hits": chars, "misses": absent,
             "mixed": np.concatenate([absent, chars, absent])}[traffic]
    keys = np_words(ops.pack_kmers32(kmers, bits))
    tab = np_words(table)
    want = ops.key_lookup(keys, tab)
    before = ops.key_lookup.launches
    got = ops.key_lookup(keys.to(cuda), tab.to(cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert ops.key_lookup.launches == before + 1
    if traffic == "hits":
        np.testing.assert_array_equal(want.numpy(), ids)
    if traffic == "misses":
        assert not want.any()


# kernel B's K: its thread-a-window form up to 64, then with a key a word
# at a time up to 136, its warp form past it
CODES_KS = (32, 33, 41, 64, 65, 70, 100, 128, 136, 137, 200)


@pytest.mark.parametrize("K", CODES_KS)
def test_codes_lookup_matches_plain(cuda, K):
    """Kernel B on reads with N runs and tails (reads shorter than a tile,
    shorter than K), and the codes epoch (kernels B, 2, 3) whole."""
    index, seqs = _index(K, 300 + K, read_max=max(150, K + 50),
                         n_rate=0.02 if K <= 64 else 0.004)
    tiles2, validb, tile_seq, nwins = tile_pack2(seqs, K, qd.TILE)
    dsel, selmin = qd._thresholds(nwins, 0.6, 0.1)
    args = [np_words(index.table), np_words(index.device_anno)] + [
        torch.from_numpy(a) for a in (tiles2, validb, tile_seq, dsel, selmin)]
    L = len(index.labels)
    want = qd.codes_epoch(*args, len(seqs), L, K)
    before = ops.codes_lookup.launches
    got = qd.codes_epoch(*[a.to(cuda) for a in args], len(seqs), L, K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert ops.codes_lookup.launches == before + 1
    assert (want[3] > 0).sum() > 100 and (want[3] == 0).sum() > 100


@pytest.mark.parametrize("K", (19, 79), ids=("W5", "W20"))
@pytest.mark.parametrize("Q", (1, 7, 31, 127, 129, 1000, 3 * 128 + 1))
def test_key_lookup_ragged_batches_match_plain(cuda, Q, K):
    """Kernel A where Q is not a multiple of the block's 128 keys, and
    where Q < 32: the last block stages and probes its first Q mod 128
    keys only (W = 5); the warp form's last block holds Q mod 4 keys
    (W = 20)."""
    table, chars, _, absent = _fills_table(K, 8, 9500 + Q)
    rng = np.random.default_rng(Q)
    pool = np.concatenate([chars, absent])
    keys = np_words(ops.pack_kmers32(pool[rng.integers(0, len(pool), Q)],
                                     8))
    tab = np_words(table)
    want = ops.key_lookup(keys, tab)
    before = ops.key_lookup.launches
    got = ops.key_lookup(keys.to(cuda), tab.to(cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert ops.key_lookup.launches == before + 1
    assert got.shape == (Q,) and (Q < 7 or want.any())


@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("W", (9, 17, 18, 33, 125))
def test_key_lookup_near_misses_match_plain(cuda, W, bits):
    """Kernel A on two buckets of keys that differ from one key in one code
    each, at every word of it, probed with all of them (half are in the
    table) and with that key (absent): a mismatch in any one word misses."""
    K = W * 32 // bits - 1
    rng = np.random.default_rng(700 + W + bits)
    top = 15 if bits == 4 else 28
    base = rng.integers(1, top, K).astype(np.uint8)
    pos = rng.permutation(K)[:40]
    var = np.repeat(base[None], len(pos), 0)
    var[np.arange(len(pos)), pos] = var[np.arange(len(pos)), pos] \
        % (top - 1) + 1
    keys = ops.pack_kmers32(var, bits)
    b = ops._hash_words(keys, 2, 1)
    put = np.concatenate([np.flatnonzero(b == 0)[:10],
                          np.flatnonzero(b == 1)[:10]])
    table = ops.DeviceHashIndex._build(
        keys[put], np.arange(1, len(put) + 1, dtype=np.uint32), 2)
    q = np_words(np.concatenate([keys, ops.pack_kmers32(base[None], bits)]))
    tab = np_words(table.reshape(2, -1))
    want = ops.key_lookup(q, tab)
    got = ops.key_lookup(q.to(cuda), tab.to(cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert sorted(want.numpy()[put]) == list(range(1, len(put) + 1))
    assert int((want > 0).sum()) == len(put)


@pytest.mark.parametrize("traffic", ("hits", "misses", "mixed"))
@pytest.mark.parametrize("K", CODES_KS + (300,))
def test_codes_lookup_stop_rule_matches_plain(cuda, K, traffic):
    """Kernel B in buckets of 0, 1, 3, 4, 5, 15 and 16 keys (a key in slot
    15 included), with hits, misses and mixed traffic.  Each k-mer follows
    a prefix of 0 .. 299 random characters, so that its window starts at
    every 2-bit offset of a tile's words, crosses every word boundary and
    lies in a first or a second tile; the prefix's windows add misses."""
    table, chars, ids, absent = table_with_fills(K, 8000 + K)
    kmers, kid = {"hits": (chars, ids),
                  "misses": (absent, np.zeros(len(absent), np.uint32)),
                  "mixed": (np.concatenate([chars, absent]), np.concatenate(
                      [ids, np.zeros(len(absent), np.uint32)]))}[traffic]
    rng = np.random.default_rng(K)
    letters = np.frombuffer(b"ACGT", np.uint8)
    pre = [(37 * i) % 300 for i in range(len(kmers))]
    seqs = [letters[np.concatenate([rng.integers(0, 4, p), c - 1])]
            .tobytes() for p, c in zip(pre, kmers)]
    tiles2, validb, _, nwins = tile_pack2(seqs, K, qd.TILE)
    args = [torch.from_numpy(tiles2), torch.from_numpy(validb),
            np_words(table)]
    want = ops.codes_lookup(*args, K, qd.TILE)
    before = ops.codes_lookup.launches
    got = ops.codes_lookup(*[a.to(cuda) for a in args], K, qd.TILE)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert ops.codes_lookup.launches == before + 1
    # each k-mer's own window: window p of its sequence's first tile
    first = np.cumsum(-(-np.array(nwins) // qd.TILE)) \
        - -(-np.array(nwins) // qd.TILE)
    p = np.array(pre)
    np.testing.assert_array_equal(
        want.numpy()[first + p // qd.TILE, p % qd.TILE].view(np.uint32), kid)


@pytest.mark.parametrize("shift", ((0, 0), (1, 3), (3, 2)),
                         ids=lambda s: f"codes+{s[0]}-valid+{s[1]}")
@pytest.mark.parametrize("T", (32, 96, 288, 1024))
@pytest.mark.parametrize("K", (41, 100, 200))
def test_codes_lookup_tile_layouts_match_plain(cuda, K, T, shift):
    """Kernel B on tiles narrower and wider than its 128-thread block (one
    round with idle threads, several rounds, a partial last round; the
    K > 136 form's 4 warps) with the tile rows starting at every byte
    offset of a word."""
    index, seqs = _index(K, 400 + T, read_max=max(150, K + 50),
                         n_rate=0.02 if K <= 64 else 0.004)
    tiles2, validb, _, _ = tile_pack2(seqs, K, T)
    table = np_words(index.table)
    want = ops.codes_lookup(torch.from_numpy(tiles2),
                            torch.from_numpy(validb), table, K, T)

    def placed(a, at):
        buf = torch.zeros(a.size + 8, dtype=torch.uint8, device=cuda)
        buf[at: at + a.size] = torch.from_numpy(a.reshape(-1)).to(cuda)
        return buf[at: at + a.size].view(a.shape)
    p2, vb = placed(tiles2, shift[0]), placed(validb, shift[1])
    assert (p2.data_ptr() % 4, vb.data_ptr() % 4) == shift
    got = ops.codes_lookup(p2, vb, table.to(cuda), K, T)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want > 0).sum() > 100


@pytest.mark.parametrize("mode", ("labels", "matches", "counts-sum",
                                  "counts"))
@pytest.mark.parametrize("route", ("codes", "map"))
@pytest.mark.parametrize("K", (41, 70))
def test_query_engine_routes_cuda_matches_cpu(cuda, K, route, mode):
    """The codes route (basic, k = 41 and 70) and the map route (the same
    k-mers as a primary graph: kernel A, then kernels 2 and 3)."""
    index, seqs = _index(K, 11, rc_share=0.3, read_max=K + 109,
                         n_rate=0.02 if K == 41 else 0.004)
    if route == "map":
        index = dataclasses.replace(index, canon=2)
    want = QueryEngine(index, device="cpu").query_batch(
        seqs, mode, 3, 0.5, 0.1)
    engine = QueryEngine(index, device=cuda)
    assert engine.route == route
    got = engine.query_batch(seqs, mode, 3, 0.5, 0.1)
    assert str(got) == str(want)
    assert sum(bool(p) for p in want) > 10


@pytest.mark.parametrize("scores", sorted(SW_SCORES))
@pytest.mark.parametrize("LQ", (1025, 1100, 1500, 2048, 2049))
def test_sw_kernel_query_blocks_match_plain(cuda, LQ, scores):
    """Queries of more than 1,024 positions: two or three query blocks,
    the carry between them, alignments across their boundaries."""
    rng = np.random.default_rng(LQ)
    B, LR = 67, 300
    qs = rng.integers(0, 4, (B, LQ)).astype(np.int32)
    rs = rng.integers(0, 4, (B, LR)).astype(np.int32)
    P, blocks = query_blocks(LQ)
    for b in range(B):
        at = int(rng.integers(0, LQ - LR)) if b % 2 else \
            max(32 * P - int(rng.integers(1, LR)), 0)
        qs[b, at: at + LR] = rs[b]
        qs[b, int(rng.integers(LQ // 2, LQ + 1)):] = -1
        rs[b, int(rng.integers(LR // 2, LR + 1)):] = -1
    qs[rng.random(qs.shape) < 0.01] = -1
    q, r = torch.from_numpy(qs), torch.from_numpy(rs)
    want = sw_scores(q, r, *SW_SCORES[scores])
    before = sw_scores.launches
    got = sw_scores(q.to(cuda), r.to(cuda), *SW_SCORES[scores])
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert sw_scores.launches == before + blocks and blocks > 1


# --------------------------------------------------------------------------
# kernels S1 and S2 (block-sparse annotation)
# --------------------------------------------------------------------------

def _sparse(rng, R, L, tau, n_patterns=4, pattern_rows=60):
    """A block-sparse annotation: rows of 0-3 labels, and ``pattern_rows``
    rows of one of ``n_patterns`` patterns of 20-40 labels."""
    rows = [np.repeat(np.arange(R), 3), rng.choice(R, pattern_rows, False)]
    labs = rng.integers(0, L, 3 * R)
    keep = (rng.random(3 * R) < 0.5) & ~np.isin(rows[0], rows[1])
    pats = [rng.choice(L, int(rng.integers(20, min(41, L))), replace=False)
            for _ in range(n_patterns)]
    pr = np.repeat(rows[1], [len(pats[i % n_patterns])
                             for i in range(pattern_rows)])
    pl = np.concatenate([pats[i % n_patterns] for i in range(pattern_rows)])
    r = np.concatenate([rows[0][keep], pr])
    c = np.concatenate([labs[keep], pl])
    cols = [np.unique(r[c == j]) for j in range(L)]
    sp = sd.DeviceBlockSparseAnno.from_columns(cols, R, L, tau)
    assert sp.dense8.shape[0] == n_patterns + 1
    return sp


def _sparse_tiles(rng, R, S, offset, max_win=900):
    nwins = rng.integers(0, max_win, S)
    n = int(nwins.sum())
    ids = rng.integers(1, R + 1, n).astype(np.int32)
    ids[rng.random(n) < 0.1] = 0
    if offset:
        rc = (ids > 0) & (rng.random(n) < 0.4)
        ids[rc] += offset
    nodes, tile_seq = qd.tile_layout(
        ids, np.repeat(np.arange(S, dtype=np.int32), nwins), S, fill=0)
    return nodes, tile_seq


def _s1_s2_vs_plain(anno, nodes, tile_seq, S, offset, dev):
    """S1 and S2 on the card and their plain versions on the same inputs
    -> the card's (counts, present, mult)."""
    L, P = anno.num_labels, anno.dense8.shape[0]
    out = {}
    for name, s1, s2 in (("kernel", sd.sparse_label_counts,
                          sd.overflow_counts),
                         ("plain", sd.sparse_label_counts_plain,
                          sd.overflow_counts_plain)):
        c = torch.zeros((S, L), dtype=torch.int32, device=dev)
        p = torch.zeros(S, dtype=torch.int32, device=dev)
        m = torch.zeros((S, P), dtype=torch.int32, device=dev)
        s1(nodes, tile_seq, anno.entries, anno.dmap, c, p, m, 0, offset)
        before = c.clone()
        s2(c, m, anno.dense8)
        out[name] = (before, p, m, c)
    torch.cuda.synchronize()
    for g, w in zip(out["kernel"], out["plain"]):
        assert torch.equal(g, w)
    return out["kernel"]


@pytest.mark.parametrize("canon", (0, 2))
@pytest.mark.parametrize("L", (33, 100, 4096))
@pytest.mark.parametrize("tau", (4, 16))
def test_sparse_count_kernels_match_plain(cuda, tau, L, canon):
    rng = np.random.default_rng(tau * 1000 + L + canon)
    R, S = 5000, 97
    anno = sd.SparseOnDevice.from_host(_sparse(rng, R, L, tau), cuda)
    offset = R if canon == 2 else 0
    nodes, tile_seq = _sparse_tiles(rng, R, S, offset)
    nodes, tile_seq = (torch.from_numpy(a).to(cuda)
                       for a in (nodes, tile_seq))
    n1, n2 = sd.sparse_label_counts.launches, sd.overflow_counts.launches
    _, _, mult, counts = _s1_s2_vs_plain(anno, nodes, tile_seq, S, offset,
                                         cuda)
    assert sd.sparse_label_counts.launches == n1 + 1
    assert sd.overflow_counts.launches == n2 + 1
    assert int(mult.sum()) > 0 and int(counts.max()) > 0
    got = sd.sparse_count_epoch(anno, nodes, tile_seq, S, offset)
    want = sd.sparse_counts_plain(anno, nodes, tile_seq, S, offset)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_sparse_counts_past_2_24_match_plain(cuda):
    """A sequence of 2^24 + 1 windows on one overflow pattern: counts that
    float32 cannot hold, exact."""
    rng = np.random.default_rng(77)
    R, L = 3000, 300
    sp = _sparse(rng, R, L, 4, n_patterns=1)
    row = int(np.flatnonzero(sp.dmap > 0)[0])
    n = (1 << 24) + 1
    nodes = np.zeros((-(-n // qd.TILE) + 2, qd.TILE), np.int32)
    nodes[2:].reshape(-1)[:n] = row
    nodes[:2] = rng.integers(0, R + 1, (2, qd.TILE))
    tile_seq = np.array([0, 1] + [2] * (len(nodes) - 2), np.int32)
    anno = sd.SparseOnDevice.from_host(sp, cuda)
    nodes, tile_seq = (torch.from_numpy(a).to(cuda)
                       for a in (nodes, tile_seq))
    _, present, mult, counts = _s1_s2_vs_plain(anno, nodes, tile_seq, 3, 0,
                                               cuda)
    labels = np.flatnonzero(sp.dense8[sp.dmap[row]])
    assert int(present[2]) == n and int(mult[2].max()) == n
    assert (counts[2, torch.from_numpy(labels).to(cuda)] == n).all()
    assert int(np.float32(n)) != n


def test_sparse_label_counts_drops_out_of_range_windows(cuda):
    """S1 with a mult buffer for sequences 5-14 of 20, and some ids past
    the table or negative: the windows of other sequences are dropped and
    the bad ids count as misses, so the counts equal the plain version's
    on the windows in range; the rows around counts and mult stay zero."""
    rng = np.random.default_rng(79)
    R, L, S, lo, rows = 3000, 100, 20, 5, 10
    sp = _sparse(rng, R, L, 4)
    nodes, tile_seq = _sparse_tiles(rng, R, S, 0, max_win=300)
    bad = rng.random(nodes.shape) < 0.02
    nodes[bad] = rng.choice([-3, R + 1, R + 77, 2 ** 31 - 1], int(bad.sum()))
    keep = (tile_seq >= lo) & (tile_seq < lo + rows)
    clean = np.where(bad, 0, nodes)[keep]
    P = sp.dense8.shape[0]
    out = {}
    for name, fn, n, ts in (
            ("kernel", sd.sparse_label_counts, nodes, tile_seq),
            ("plain", sd.sparse_label_counts_plain, clean, tile_seq[keep])):
        anno = sd.SparseOnDevice.from_host(sp, cuda)
        cbuf = torch.zeros((S + 2, L), dtype=torch.int32, device=cuda)
        pbuf = torch.zeros(S + 2, dtype=torch.int32, device=cuda)
        mbuf = torch.zeros((rows + 2, P), dtype=torch.int32, device=cuda)
        fn(torch.from_numpy(np.ascontiguousarray(n)).to(cuda),
           torch.from_numpy(np.ascontiguousarray(ts)).to(cuda),
           anno.entries, anno.dmap, cbuf[1: S + 1], pbuf[1: S + 1],
           mbuf[1: rows + 1], lo)
        out[name] = (cbuf, pbuf, mbuf)
    torch.cuda.synchronize()
    for g, w in zip(out["kernel"], out["plain"]):
        assert torch.equal(g, w)
        assert not g[0].any() and not g[-1].any()
    assert int(out["kernel"][0].sum()) > 0 and bad.any()


def test_sparse_epoch_chunks_match_plain(cuda, monkeypatch):
    rng = np.random.default_rng(78)
    R, L, S = 4000, 500, 301
    anno = sd.SparseOnDevice.from_host(_sparse(rng, R, L, 8), cuda)
    nodes, tile_seq = _sparse_tiles(rng, R, S, R, max_win=400)
    nodes, tile_seq = (torch.from_numpy(a).to(cuda)
                       for a in (nodes, tile_seq))
    want = sd.sparse_counts_plain(anno, nodes, tile_seq, S, R)
    monkeypatch.setattr(sd, "MULT_BYTES", 40 * 4 * anno.dense8.shape[0])
    got = sd.sparse_count_epoch(anno, nodes, tile_seq, S, R)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("canon", (0, 2))
@pytest.mark.parametrize("mode", ("labels", "matches"))
def test_sparse_query_engine_cuda_matches_cpu(cuda, mode, canon):
    """The wire route with kernels S1 and S2 in kernel 2's place: a
    block-sparse index (the column annotation's columns, and two rows
    patterns of every label) on the card against the CPU."""
    index, seqs = _index(31, 13, rc_share=0.4 if canon else 0.0)
    L, R = len(index.labels), index.num_rows
    cols = [np.unique(np.concatenate([index.annotation.column_rows(c),
                                      np.arange(0, R, 7)]))
            for c in range(L)]
    index = dataclasses.replace(
        index, annotation=None, canon=canon,
        device_anno=sd.DeviceBlockSparseAnno.from_columns(cols, R, L, 4))
    assert index.device_anno.dense8.shape[0] > 1
    want = QueryEngine(index, device="cpu").query_batch(
        seqs, mode, 3, 0.3, 0.1)
    engine = QueryEngine(index, device=cuda)
    n = sd.sparse_label_counts.launches
    got = engine.query_batch(seqs, mode, 3, 0.3, 0.1)
    assert sd.sparse_label_counts.launches > n
    assert str(got) == str(want)
    assert sum(bool(p) for p in want) > 10


def _sparse_rows(rng, R, L, tau, n_patterns, pattern_rows=60):
    """A block-sparse annotation made directly (any L, quickly): each row
    0..tau distinct random labels (a tenth of the rows exactly tau), and
    ``pattern_rows`` rows on one of ``n_patterns`` patterns of 20-40
    labels."""
    entries = np.full((R + 1, tau), L, np.uint32)
    n = rng.integers(0, tau + 1, R)
    n[rng.random(R) < 0.1] = tau
    for r in np.flatnonzero(n):
        entries[r + 1, :n[r]] = np.sort(rng.choice(L, n[r], replace=False))
    dmap = np.zeros(R + 1, np.int32)
    prow = rng.choice(np.arange(1, R + 1), pattern_rows, replace=False)
    entries[prow] = L
    dmap[prow] = rng.integers(1, n_patterns + 1, pattern_rows)
    dense8 = np.zeros((n_patterns + 1, L), np.int8)
    for d in range(1, n_patterns + 1):
        dense8[d, rng.choice(L, int(rng.integers(20, min(41, L))),
                             replace=False)] = 1
    sp = sd.DeviceBlockSparseAnno(entries, dmap, dense8, tau, L)
    sd.check_block_sparse(sp, L)
    return sp


# (L, tau, T, canon, sequences, the most windows a sequence, patterns)
SPARSE_PATHS = {
    "hashed L=70000 tau=16": (70_000, 16, 256, 0, 60, 900, 4),
    "hashed canon 2": (70_000, 16, 256, 2, 60, 900, 4),
    "tau=5": (4096, 5, 256, 0, 97, 900, 4),
    "tau=7 canon 2": (4096, 7, 256, 2, 97, 900, 4),
    "T=32": (500, 4, 32, 0, 97, 300, 4),
    "T=32 hashed canon 2": (9000, 6, 32, 2, 40, 300, 4),
    "T=512": (4096, 4, 512, 0, 97, 2000, 4),
    "T=512 hashed": (20_000, 4, 512, 0, 50, 2000, 4),
    "P=300": (1000, 4, 256, 0, 97, 900, 299),
    "P=300 hashed canon 2": (9000, 4, 256, 2, 60, 900, 299),
}


@pytest.mark.parametrize("path", sorted(SPARSE_PATHS))
def test_sparse_count_kernel_paths_match_plain(cuda, path):
    """S1's dense and hashed tallies, any tau, tiles narrower and wider than
    a block, and S2's row loop past 256 patterns, against the plain
    versions, exactly."""
    L, tau, T, canon, S, max_win, n_pat = SPARSE_PATHS[path]
    rng = np.random.default_rng(sum(map(ord, path)))
    R = 4000
    sp = _sparse_rows(rng, R, L, tau, n_pat, pattern_rows=600)
    P = sp.dense8.shape[0]
    plan = sd.label_count_plan(min(T, 256), tau, L, P)
    assert plan.hashed == ("hashed" in path)
    anno = sd.SparseOnDevice.from_host(sp, cuda)
    offset = R if canon == 2 else 0
    nwins = rng.integers(0, max_win, S)
    ids = rng.integers(1, R + 1, int(nwins.sum())).astype(np.int32)
    ids[rng.random(ids.size) < 0.1] = 0
    if offset:
        ids[(ids > 0) & (rng.random(ids.size) < 0.4)] += offset
    nodes, tile_seq = qd.tile_layout(
        ids, np.repeat(np.arange(S, dtype=np.int32), nwins), S, tile=T,
        fill=0)
    nodes, tile_seq = (torch.from_numpy(a).to(cuda) for a in (nodes, tile_seq))
    _, _, mult, counts = _s1_s2_vs_plain(anno, nodes, tile_seq, S, offset,
                                         cuda)
    assert int((mult[:, 1:] > 0).sum()) > S // 2 and int(counts.max()) > 0
    if n_pat > 256:
        assert int((mult[:, 256:] > 0).sum()) > 0
    with pytest.raises(ValueError, match="row records"):
        sd.sparse_label_counts(nodes, tile_seq, anno.entries.contiguous(),
                               anno.dmap.contiguous(), counts,
                               torch.zeros_like(counts[:, 0]), mult)


def test_overflow_counts_all_zero_rows(cuda):
    """S2 on multiplicities that are all zero leaves the counts as they
    were, on both of its load paths (L % 16 == 0 and not)."""
    rng = np.random.default_rng(81)
    for L in (4096, 4099):
        sp = _sparse_rows(rng, 500, L, 4, 5)
        counts = torch.from_numpy(rng.integers(0, 9, (300, L)).astype(
            np.int32)).to(cuda)
        before = counts.clone()
        mult = torch.zeros((300, 6), dtype=torch.int32, device=cuda)
        n = sd.overflow_counts.launches
        sd.overflow_counts(counts, mult, torch.from_numpy(sp.dense8).to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(counts, before)
        assert sd.overflow_counts.launches == n + 1


@pytest.mark.parametrize("canon", (0, 2))
def test_sparse_long_sequence_over_many_blocks(cuda, canon):
    """One sequence over more tiles than 132 x 8 blocks, between short
    ones: every block's run of its tiles flushes into the same rows."""
    rng = np.random.default_rng(82 + canon)
    R, L = 3000, 4096
    sp = _sparse_rows(rng, R, L, 4, 3, pattern_rows=300)
    anno = sd.SparseOnDevice.from_host(sp, cuda)
    offset = R if canon == 2 else 0
    nwins = np.array([700, 3000 * qd.TILE + 17, 5, 900])
    ids = rng.integers(0, R + 1, int(nwins.sum())).astype(np.int32)
    if offset:
        ids[(ids > 0) & (rng.random(ids.size) < 0.4)] += offset
    nodes, tile_seq = qd.tile_layout(
        ids, np.repeat(np.arange(4, dtype=np.int32), nwins), 4, fill=0)
    assert int((tile_seq == 1).sum()) > 132 * 8
    nodes, tile_seq = (torch.from_numpy(a).to(cuda) for a in (nodes, tile_seq))
    _, present, mult, _ = _s1_s2_vs_plain(anno, nodes, tile_seq, 4, offset,
                                          cuda)
    assert int(present[1]) > 3000 * qd.TILE // 2 and int(mult[1].sum()) > 0


# --------------------------------------------------------------------------
# kernels W1 and W2 (BRWT and row-diff device annotations)
# --------------------------------------------------------------------------

def _words_columns(rng, R, L, hot_rows=40):
    """Label columns over R rows: 0-3 random labels a row, and ``hot_rows``
    rows that carry most labels."""
    hot = rng.choice(R, hot_rows, replace=False)
    r = np.concatenate([rng.integers(0, R, 2 * R), np.repeat(hot, L // 2)])
    c = np.concatenate([rng.integers(0, L, 2 * R),
                        rng.integers(0, L, hot_rows * (L // 2))])
    return [np.unique(r[c == j]) for j in range(L)]


def _chain_routing(R, length):
    """Chains of ``length`` rows in row order (the last row of each an
    anchor), so that walks reach max_depth = length."""
    succ = np.arange(1, R + 1, dtype=np.int64)
    ends = (np.arange(R) % length == length - 1) | (succ >= R)
    succ[ends] = -1
    return succ, ends.copy()


def _word_ids(rng, R, Q, offset):
    ids = rng.integers(0, R + 1, Q).astype(np.int32)
    ids[rng.random(Q) < 0.1] = 0
    if offset:
        rc = (ids > 0) & (rng.random(Q) < 0.4)
        ids[rc] += offset
    return ids


def _words_vs_plain(fn, plain, anno, ids, offset, dev):
    before = fn.launches
    got = fn(anno, ids.to(dev), offset)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(anno, ids.to(dev), offset)
    assert torch.equal(got, want)
    return got


W1_TREES = [(7, 2, True), (100, 3, True), (100, 40, False),
            (4096, 2, False)]


@pytest.mark.parametrize("canon", (0, 2))
@pytest.mark.parametrize("L,arity,linkage", W1_TREES)
def test_brwt_row_words_matches_plain(cuda, L, arity, linkage, canon):
    rng = np.random.default_rng(L + arity + canon)
    R = 3000
    brwt = BRWT.from_columns(_words_columns(rng, R, L), R, L, arity=arity,
                             linkage=linkage)
    anno = dm.BRWTOnDevice.from_host(dm.FlatBRWT.from_brwt(brwt), cuda)
    offset = R if canon == 2 else 0
    ids = torch.from_numpy(_word_ids(rng, R, 20_000, offset))
    got = _words_vs_plain(dm.brwt_row_words, dm.brwt_row_words_plain, anno,
                          ids, offset, cuda)
    assert int((got != 0).sum()) > 0


@pytest.mark.parametrize("canon", (0, 2))
@pytest.mark.parametrize("inner", ("brwt", "dense"))
@pytest.mark.parametrize("L", (9, 300))
def test_rowdiff_row_words_matches_plain(cuda, L, inner, canon):
    """Chains of 37 rows (walks that reach max_depth), misses, a canon 2
    offset, on both inner sources."""
    rng = np.random.default_rng(L * 3 + canon + (inner == "brwt"))
    R = 2500
    rd = RowDiff.from_annotation(_words_columns(rng, R, L), R, L,
                                 _chain_routing(R, 37))
    inner_f = dm.FlatBRWT.from_brwt(rd.inner) if inner == "brwt" else \
        convert.pack_matrix_bitmap(rd.inner, R)
    flat = dm.FlatRowDiff.from_row_diff(rd, inner_f)
    assert flat.max_depth == 37
    anno = dm.RowDiffOnDevice.from_host(flat, cuda)
    offset = R if canon == 2 else 0
    ids = torch.from_numpy(_word_ids(rng, R, 12_000, offset))
    got = _words_vs_plain(dm.rowdiff_row_words, dm.rowdiff_row_words_plain,
                          anno, ids, offset, cuda)
    base = ids.long()
    base = torch.where(base > offset, base - offset, base) if offset else base
    rows = np.flatnonzero(base.numpy() > 0)[:500]
    truth = rd.get_rows_words(base.numpy()[rows] - 1)
    assert np.array_equal(got.cpu().numpy()[rows].view(np.uint32), truth)


@pytest.mark.parametrize("inner", ("brwt", "dense", None))
def test_words_count_epoch_cuda_matches_cpu(cuda, inner, monkeypatch):
    """W1 or W2 then kernel 2, a few tiles a chunk, against the CPU's plain
    versions."""
    monkeypatch.setattr(qd, "WORDS_BYTES", 7 * qd.TILE * 4 * 4)
    rng = np.random.default_rng(5)
    R, L, S = 4000, 97, 61
    cols = _words_columns(rng, R, L)
    if inner is None:
        flat = dm.FlatBRWT.from_brwt(BRWT.from_columns(cols, R, L,
                                                       linkage=False))
    else:
        rd = RowDiff.from_annotation(cols, R, L, _chain_routing(R, 20))
        flat = dm.FlatRowDiff.from_row_diff(
            rd, dm.FlatBRWT.from_brwt(rd.inner) if inner == "brwt"
            else convert.pack_matrix_bitmap(rd.inner, R))
    nodes, tile_seq = _sparse_tiles(rng, R, S, R)
    got = qd.count_labels(dm.device_words(flat, cuda),
                          torch.from_numpy(nodes).to(cuda),
                          torch.from_numpy(tile_seq).to(cuda), S, L, R)
    want = qd.count_labels(dm.device_words(flat, torch.device("cpu")),
                           torch.from_numpy(nodes),
                           torch.from_numpy(tile_seq), S, L, R)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(got[0].sum()) > 0


def _read_ids(rng, R, Q, offset=0, backward=0.2):
    """ids laid out as reads along _chain_routing chains: each tile holds a
    read of consecutive rows (forward links, broken at each chain's end),
    shorter than the tile; misses (0) and substitutions (a random row)
    break links inside it, some of its windows take canon 2's offset, and
    a share of the reads run backward (against the successors)."""
    ids = np.zeros(Q, np.int32)
    for t0 in range(0, Q, qd.TILE):
        n = min(qd.TILE, Q - t0) - int(rng.integers(0, 40))
        if n <= 0:
            continue
        rows = int(rng.integers(0, R - n)) + np.arange(n)
        if rng.random() < backward:
            rows = rows[::-1]
        w = rows + 1
        w[rng.random(n) < 0.02] = 0
        sub = rng.random(n) < 0.02
        w[sub] = rng.integers(1, R + 1, int(sub.sum()))
        if offset:
            rc = (w > 0) & (rng.random(n) < 0.3)
            w[rc] += offset
        ids[t0: t0 + n] = w
    return ids


def _rowdiff_anno(rng, R, L, inner, length, dev):
    rd = RowDiff.from_annotation(_words_columns(rng, R, L), R, L,
                                 _chain_routing(R, length))
    inner_f = dm.FlatBRWT.from_brwt(rd.inner) if inner == "brwt" else \
        convert.pack_matrix_bitmap(rd.inner, R)
    return dm.RowDiffOnDevice.from_host(
        dm.FlatRowDiff.from_row_diff(rd, inner_f), dev)


@pytest.mark.parametrize("canon", (0, 2))
@pytest.mark.parametrize("inner", ("brwt", "dense"))
def test_rowdiff_row_words_shared_walks_match_plain(cuda, inner, canon):
    """W2 on windows laid out as reads (each linked run's chain walked
    once): forward and backward runs, misses, substitutions and canon 2
    offsets inside runs, calls that cut runs at their ends (a chunk
    boundary), and max_depth cut to 7, 1 and 0; then isolated hits whose
    chains pass the list (walked a warp a window)."""
    rng = np.random.default_rng(91 + canon + 2 * (inner == "brwt"))
    R, L = 6000, 300
    anno = _rowdiff_anno(rng, R, L, inner, 37, cuda)
    assert anno.max_depth == 37
    offset = R if canon == 2 else 0
    ids = torch.from_numpy(_read_ids(rng, R, 40 * qd.TILE, offset))
    r = torch.where(ids > offset, ids - offset, ids) if offset else ids
    nxt = anno.next_row.cpu()
    link = (r[:-1] > 0) & (r[1:] > 0) & (nxt[(r[:-1] - 1).clamp(min=0)]
                                         == r[1:] - 1)
    assert int(link.sum()) > ids.numel() // 2
    for lo, hi in ((0, ids.numel()), (1000, 7001), (5, 6)):
        _words_vs_plain(dm.rowdiff_row_words, dm.rowdiff_row_words_plain,
                        anno, ids[lo:hi].contiguous(), offset, cuda)
    for depth in (7, 1, 0):
        got = _words_vs_plain(dm.rowdiff_row_words,
                              dm.rowdiff_row_words_plain,
                              dataclasses.replace(anno, max_depth=depth),
                              ids, offset, cuda)
        assert (int((got != 0).sum()) > 0) == (depth > 0)
    lone = np.zeros(8 * qd.TILE, np.int32)
    lone[::2] = rng.integers(1, R + 1, lone.size // 2)
    _words_vs_plain(dm.rowdiff_row_words, dm.rowdiff_row_words_plain, anno,
                    torch.from_numpy(lone), 0, cuda)


@pytest.mark.parametrize("inner", ("brwt", "dense"))
def test_words_count_epoch_chunks_cut_runs(cuda, inner, monkeypatch):
    """W2 then kernel 2 on reads whose runs cross the epoch's chunks (3
    tiles a chunk), against the CPU's plain versions."""
    monkeypatch.setattr(qd, "WORDS_BYTES", 3 * qd.TILE * 12 * 4)
    rng = np.random.default_rng(93)
    R, L, S = 5000, 365, 7
    anno = _rowdiff_anno(rng, R, L, inner, 50, torch.device("cpu"))
    nodes = _read_ids(rng, R, 20 * qd.TILE, backward=0.1).reshape(-1,
                                                                 qd.TILE)
    # a read over several tiles, as a long sequence spans them
    nodes[4:8] = (np.arange(4 * qd.TILE) + 300).reshape(4, qd.TILE)
    tile_seq = np.sort(rng.integers(0, S, nodes.shape[0])).astype(np.int32)
    want = qd.count_labels(anno, torch.from_numpy(nodes),
                           torch.from_numpy(tile_seq), S, L)
    got = qd.count_labels(dm.RowDiffOnDevice(
        anno.next_row.to(cuda), anno.max_depth,
        anno.inner.to(cuda) if inner == "dense" else dm.BRWTOnDevice(
            anno.inner.nodes.to(cuda), anno.inner.words.to(cuda),
            anno.inner.num_rows, anno.inner.num_labels,
            anno.inner.stack_cap), L),
        torch.from_numpy(nodes).to(cuda), torch.from_numpy(tile_seq).to(cuda),
        S, L)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(got[0].sum()) > 0


def test_brwt_row_words_windows_share_warps(cuda):
    """W1 with several windows a warp: tiles of one row repeated, of a few
    rows alternating and of every row in turn, on an arity-2 tree and on
    the wide tree of test_w1_stack_bound_holds_on_wide_trees (arity 40, a
    row with every label), against the plain descent."""
    rng = np.random.default_rng(95)
    R, L = 3000, 4096
    narrow = BRWT.from_columns(_words_columns(rng, R, L), R, L, arity=2,
                               linkage=False)
    Rw, Lw = 64, 100
    wide = BRWT.from_columns(
        [np.arange(Rw) if c % 9 == 0 else np.arange(c % 7, Rw, 5)
         for c in range(Lw)], Rw, Lw, arity=40, linkage=False)
    for brwt, rows in ((narrow, R), (wide, Rw)):
        anno = dm.BRWTOnDevice.from_host(dm.FlatBRWT.from_brwt(brwt), cuda)
        ids = np.concatenate([
            np.full(qd.TILE, 1 + int(rng.integers(0, rows)), np.int32),
            np.tile(rng.integers(1, rows + 1, 3), qd.TILE)[:qd.TILE],
            np.arange(qd.TILE) % rows + 1,
            _word_ids(rng, rows, 2 * qd.TILE + 13, 0)]).astype(np.int32)
        for lo in (0, 1, 7):
            got = _words_vs_plain(dm.brwt_row_words, dm.brwt_row_words_plain,
                                  anno, torch.from_numpy(ids[lo:]), 0, cuda)
            assert int((got != 0).sum()) > 0


def _seqs_index(K, seed, n_refs=6, ref_len=700):
    """A port-built index of random references whose annotation holds each
    k-mer's positions in its reference (one label a reference), a
    CoordToHeader that splits each label into 3 headers of consecutive
    k-mers, and reads cut from the references."""
    from metagraph_tpu_torch.annotation.coord_to_header import CoordToHeader
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (n_refs, ref_len)).astype(np.uint8)
    refs[1, 300:400] = refs[0, 100:200]          # k-mers of two references
    win = np.lib.stride_tricks.sliding_window_view(refs, K, axis=1) + 1
    n = win.shape[1]
    chars, inv = np.unique(win.reshape(-1, K), axis=0, return_inverse=True)
    rows = inv.reshape(n_refs, n)
    cols, crd = [], []
    for c in range(n_refs):
        order = np.lexsort((np.arange(n), rows[c]))
        cols.append(np.unique(rows[c]))
        crd.append(np.stack([rows[c][order], order], 1))
    labels = [f"s{c}" for c in range(n_refs)]
    anno = ColumnMajorAnnotation(len(chars), labels, cols, coords=crd,
                                 has_coords=True)
    index = convert.from_kmers(
        ops.pack_kmers32(chars), np.arange(1, len(chars) + 1,
                                           dtype=np.uint32),
        pack_annotation_bitmap(anno), labels, K, anno)
    cth = CoordToHeader([[f"s{c}h{i}" for i in range(3)]
                         for c in range(n_refs)],
                        [[n // 3, n // 3, n - 2 * (n // 3)]] * n_refs)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seqs = []
    for i in range(60):
        a = int(rng.integers(0, ref_len - 150))
        read = refs[i % n_refs, a: a + int(rng.integers(K - 3, 150))].copy()
        read[rng.random(len(read)) < 0.01] = 4
        seqs.append(letters[read].tobytes())
    return index, seqs, cth


@pytest.mark.parametrize("mode", ("labels", "matches", "counts",
                                  "coords"))
@pytest.mark.parametrize("K", (31, 41, 70))
def test_seqs_query_engine_cuda_matches_cpu(cuda, K, mode):
    """With a .seqs mapping every batch maps through kernel A (k = 31 and
    41 too, whose usual routes are wire and codes) and aggregates per
    header on the host: the payloads of the CPU engine."""
    index, seqs, cth = _seqs_index(K, 90 + K)
    want = QueryEngine(index, device="cpu", coord_to_header=cth).query_batch(
        seqs, mode, 2, 0.5, 0.0)
    engine = QueryEngine(index, device=cuda, coord_to_header=cth)
    before = {f.__name__: f.launches for f in (
        ops.key_lookup, ops.wire_lookup, ops.codes_lookup, qd.label_counts)}
    got = engine.query_batch(seqs, mode, 2, 0.5, 0.0)
    assert str(got) == str(want)
    assert sum(bool(p) for p in want) > 20
    assert ops.key_lookup.launches == before["key_lookup"] + 1
    assert (ops.wire_lookup.launches, ops.codes_lookup.launches,
            qd.label_counts.launches) == (
        before["wire_lookup"], before["codes_lookup"],
        before["label_counts"])


@pytest.mark.parametrize("route", ("wire", "codes", "map", "seqs"))
def test_parallel_query_records_cuda(cuda, route):
    """query_records with 4 batches in flight on the card: the sequential
    run's results, and exactly its launches of every kernel."""
    from metagraph_tpu_torch.seq_io.fasta import FastaRecord
    K = {"wire": 31, "codes": 41, "map": 41, "seqs": 41}[route]
    index, seqs, cth = _seqs_index(K, 7)
    if route == "map":
        index = dataclasses.replace(index, canon=2)
    engine = QueryEngine(index, device=cuda,
                         coord_to_header=cth if route == "seqs" else None)
    assert engine.route == ("map" if route == "seqs" else route)
    recs = [FastaRecord(f"r{i}", s) for i, s in enumerate(seqs)]
    kernels = (ops.wire_lookup, ops.codes_lookup, ops.key_lookup,
               qd.label_counts, qd.selection_mask)
    runs = []
    for n_threads in (1, 4):
        for f in kernels:
            f.launches = 0
        res = list(engine.query_records(recs, "matches", batch_size_bp=500,
                                        n_threads=n_threads))
        runs.append(([str(r.payload) for r in res],
                     [f.launches for f in kernels]))
    assert runs[0] == runs[1]
    assert sum(runs[0][1]) >= 10      # one or more launches a batch


def _kmer_graph(gtype, mode, K, seed, n_refs=6, ref_len=700):
    """A port hash, bitmap or sshash graph rebuilt from the k-mers of
    random references (both strands in canonical mode, as the JAX build
    stores them), a column annotation of one label a reference (rows of
    the strand the map route probes: the first in BOSS order in
    canonical mode) and reads cut from the references, a third of them
    reverse-complemented."""
    from metagraph_tpu_torch.graph import GRAPH_CLASSES
    from metagraph_tpu_torch.kmer.extractor import (KmerExtractor,
                                                    _rows_greater)
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (n_refs, ref_len)).astype(np.uint8)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    ex = KmerExtractor()
    kmers = ex.distinct_kmers([letters[r].tobytes() for r in refs], K,
                              "both" if mode == "canonical" else "basic")
    graph = GRAPH_CLASSES[gtype].rebuild(
        kmers, np.arange(1, len(kmers) + 1), K, mode)
    chars, ids = graph.node_kmers_and_ids()
    id_of = {c.tobytes(): int(i) for c, i in zip(chars, ids)}
    cols = []
    for r in refs:
        sub = np.lib.stride_tricks.sliding_window_view(r + 1, K)
        if mode == "canonical":
            rc = 5 - sub[:, ::-1]
            sub = np.where(_rows_greater(ops.pack_kmers32(sub),
                                         ops.pack_kmers32(rc))[:, None],
                           rc, sub)
        cols.append(np.unique([id_of[w.tobytes()] - 1 for w in sub]))
    labels = [f"s{c}" for c in range(n_refs)]
    anno = ColumnMajorAnnotation(graph.max_index(), labels, cols)
    seqs = []
    for i in range(60):
        r = refs[i % n_refs]
        a = int(rng.integers(0, ref_len - 150))
        read = r[a: a + int(rng.integers(K - 3, 150))].copy()
        if i % 3 == 1:
            read = 3 - read[::-1]
        seqs.append(letters[read].tobytes())
    return graph, anno, seqs


KMER_GRAPHS = [("bitmap", "basic", 31), ("bitmap", "canonical", 31),
               ("bitmap", "primary", 31), ("hash", "basic", 41),
               ("hash", "canonical", 15), ("sshash", "basic", 31),
               ("sshash", "canonical", 21)]


@pytest.mark.parametrize("mode", ("labels", "matches", "signature"))
@pytest.mark.parametrize("gtype,gmode,K", KMER_GRAPHS)
def test_kmer_graph_map_route_cuda_matches_cpu(cuda, gtype, gmode, K, mode):
    """A graph without a BOSS takes the map route (kernel A, then kernels 2
    and 3) on the card: the CPU engine's payloads, one launch of kernel A
    a batch (two for a primary graph's reverse-complement pass) and no
    wire or codes launch; kernel A's ids against its plain version."""
    graph, anno, seqs = _kmer_graph(gtype, gmode, K, 300 + K)
    index = convert.from_graph(graph, anno)
    assert index.graph_type == gtype and index.canon == \
        {"basic": 0, "canonical": 1, "primary": 2}[gmode]
    want = QueryEngine(index, device="cpu").query_batch(seqs, mode, 3, 0.6,
                                                        0.0)
    engine = QueryEngine(index, device=cuda)
    assert engine.route == "map"
    before = [f.launches for f in (ops.key_lookup, ops.wire_lookup,
                                   ops.codes_lookup, qd.label_counts)]
    got = engine.query_batch(seqs, mode, 3, 0.6, 0.0)
    assert str(got) == str(want)
    assert sum(bool(p) for p in want) >= 30
    after = [f.launches for f in (ops.key_lookup, ops.wire_lookup,
                                  ops.codes_lookup, qd.label_counts)]
    assert after[0] - before[0] == (2 if gmode == "primary" else 1)
    assert after[1:3] == before[1:3] and after[3] == before[3] + 1
    chars, _ = graph.node_kmers_and_ids()
    keys = np_words(ops.pack_kmers32(chars[::3])).to(cuda)
    np.testing.assert_array_equal(
        ops.key_lookup(keys, engine.hash_index.table).cpu().numpy(),
        ops.key_lookup_plain(keys, engine.hash_index.table, 1000)
        .cpu().numpy())


def test_server_cuda_matches_cpu(cuda):
    """The port's MetaGraphServer on the card answers /search in every
    mode the annotation allows, /stats, /column_labels and /align (on this
    bitmap graph: 500 naming ROADMAP A13.3e) as the one on the CPU."""
    import json
    import urllib.error
    import urllib.request
    from metagraph_tpu_torch.server.server import MetaGraphServer
    graph, anno, seqs = _kmer_graph("bitmap", "basic", 31, 77)
    fasta = "".join(f">r{i}\n{s.decode()}\n" for i, s in enumerate(seqs))
    servers = [MetaGraphServer(graph, anno, device=d)
               for d in ("cpu", cuda)]
    for s in servers:
        s.serve("127.0.0.1", 0, background=True)

    def ask(port, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/{path}",
            data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as f:
                return f.status, json.loads(f.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    try:
        for path, body in (("search", {"FASTA": fasta}),
                           ("search", {"FASTA": fasta, "top_labels": 1,
                                       "discovery_fraction": 0.4}),
                           ("search", {"FASTA": fasta,
                                       "with_signature": True}),
                           ("search", {"FASTA": fasta,
                                       "query_counts": True}),
                           ("column_labels", None)):
            want, got = (ask(s.port, path, body) for s in servers)
            assert got == want
        code, body = ask(servers[1].port, "search", {"FASTA": fasta})
        assert code == 200 and sum(bool(r["results"]) for r in body) >= 30
        stats = [ask(s.port, "stats")[1] for s in servers]
        for s in stats:
            del s["process"]
        assert stats[0] == stats[1]
        want, got = (ask(s.port, "align", {"FASTA": fasta})
                     for s in servers)
        assert got == want
        assert got[0] == 500 and "A13.3e" in got[1]["error"]
    finally:
        for s in servers:
            s.shutdown()


# --------------------------------------------------------------------------
# the device construction: kernels D1-D4 (succinct/device_build.py)
# --------------------------------------------------------------------------

BUILD_KS = (3, 11, 16, 17, 20, 21)


def _sort_keys(rng, n, bits):
    """n keys with many repeats (a pool of about n / 3 values), below 2^bits
    (any int64 at 64 bits)."""
    if bits == 64:
        pool = rng.integers(-2 ** 63, 2 ** 63 - 1, n // 3 + 1, dtype=np.int64)
    else:
        pool = rng.integers(0, 2 ** bits, n // 3 + 1, dtype=np.uint64) \
            .astype(np.int64)
    return pool[rng.integers(0, len(pool), n)]


RADIX_BITS = (1, 3, 8, 11, 22, 33, 40, 42, 43, 44, 63, 64)
PAYLOADS = dict(argvalues=(None, torch.int32, torch.int64),
                ids=("keys", "int32", "int64"))


def _radix_check(keys, bits, payload=None, sentinel=None):
    """D2 on ``keys`` (on the card) twice: the launches that its pass plan
    gives, exactly; the same tensors both times; equal to the plain
    version and to ``torch.sort(stable=True)``'s order."""
    n = len(keys)
    pay = None if payload is None else \
        torch.arange(n, dtype=payload, device=keys.device)
    kw = {} if sentinel is None else {"sentinel": sentinel}
    before = db.radix_sort.launches
    got_k, got_p = db.radix_sort(keys, bits, pay, **kw)
    torch.cuda.synchronize()
    _, run = db.radix_plan_of(keys, bits, sentinel)
    assert db.radix_sort.launches - before == (2 + len(run) if n else 0)
    again = db.radix_sort(keys, bits, pay, **kw)
    assert torch.equal(again[0], got_k)
    want_k, want_p = db.radix_sort_plain(keys, bits, pay)
    assert torch.equal(got_k, want_k)
    if payload is not None:
        assert got_p.dtype == payload and torch.equal(got_p, want_p)
        assert torch.equal(again[1], got_p)
    # the library sort agrees (unsigned order: flip the sign bit at 64)
    k = keys ^ torch.iinfo(torch.int64).min if bits == 64 else keys
    lib = torch.sort(k, stable=True)
    assert torch.equal(keys[lib.indices], got_k)
    if payload is not None:
        assert torch.equal(lib.indices.to(payload), got_p)
    return run


@pytest.mark.parametrize("payload", **PAYLOADS)
@pytest.mark.parametrize("bits", RADIX_BITS)
@pytest.mark.parametrize("n", (0, 1, 255, 4095, 4096, 4097, 3 * 4096 + 5,
                               (1 << 17) - 1, (1 << 17) + 5, (1 << 20) + 7))
def test_radix_sort_matches_plain_and_torch_sort(cuda, n, bits, payload):
    """n at the 4,096-key tile's edges and on both sides of
    RADIX_SYNC_MIN."""
    rng = np.random.default_rng([n, bits])
    keys = torch.from_numpy(_sort_keys(rng, n, bits)).to(cuda)
    _radix_check(keys, bits, payload)


@pytest.mark.parametrize("payload", **PAYLOADS)
@pytest.mark.parametrize("bits", (11, 43, 63, 64))
def test_radix_sort_long_look_back(cuda, bits, payload):
    """2^24 + 7 keys: look-back across 4,097 tiles."""
    n = (1 << 24) + 7
    rng = np.random.default_rng([n, bits, 1])
    keys = torch.from_numpy(_sort_keys(rng, n, bits)).to(cuda)
    _radix_check(keys, bits, payload)


@pytest.mark.parametrize("payload", **PAYLOADS)
def test_radix_sort_skips_single_bin_passes(cuda, payload):
    """All keys equal: every pass skipped (2 launches, the input's order);
    one digit that every key shares: that pass alone skipped.  Below
    RADIX_SYNC_MIN keys every pass runs."""
    keys = torch.full((db.RADIX_SYNC_MIN - 1,), 0x2A5A5A5A5A5,
                      dtype=torch.int64, device=cuda)
    assert len(_radix_check(keys, 43, payload)) == 6
    n = db.RADIX_SYNC_MIN + 11
    keys = torch.full((n,), 0x2A5A5A5A5A5, dtype=torch.int64, device=cuda)
    assert _radix_check(keys, 43, payload) == []
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(_sort_keys(rng, n, 43)).to(cuda) & ~(0xFF << 8)
    assert _radix_check(keys, 43, payload) == [0, 2, 3, 4, 5]


@pytest.mark.parametrize("bits", (22, 43, 63))
@pytest.mark.parametrize("n", (4097, (1 << 17) - 1, 1 << 17, 3_000_001,
                               (1 << 24) + 7))
def test_radix_sort_sentinel(cuda, n, bits):
    """J-like keys, two thirds of them the sentinel (the largest key under
    ``bits``), sorted with and without ``sentinel=``; and keys that are
    all the sentinel but a few equal ones (one pass moves them)."""
    rng = np.random.default_rng([n, bits, 2])
    sent = (1 << bits) - 1 if bits == 63 else 1 << (bits - 1)
    keys = _sort_keys(rng, n, bits - 1)
    keys[rng.random(n) < 2 / 3] = sent
    keys = torch.from_numpy(keys).to(cuda)
    for s in (None, sent):
        _radix_check(keys, bits, None, s)
    keys = torch.where(torch.arange(n, device=cuda) % 5 == 0, 7, sent)
    run = _radix_check(keys, bits, None, sent)
    assert len(run) == (1 if n >= db.RADIX_SYNC_MIN else -(-bits // 8))


def test_radix_sort_low_bits_only(cuda):
    """Bits above ``bits`` take no part in the order, as in the plain
    version."""
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, 100_000,
                                         dtype=np.int64)).to(cuda)
    for bits in (5, 17, 40):
        assert torch.equal(db.radix_sort(keys, bits)[0],
                           db.radix_sort_plain(keys, bits)[0])


def _build_seqs(rng, n_seqs=60, max_len=2000, n_share=0.04):
    letters = np.array(list(b"ACGTNacgt"), np.uint8)
    p = np.array([.24, .24, .24, .24, n_share, 0, 0, 0, 0])
    p[5:] = [0.01] * 4
    p /= p.sum()
    return [letters[rng.choice(9, size=int(m), p=p)].tobytes()
            for m in rng.integers(1, max_len, size=n_seqs)]


def _build_words(seqs, K, dev):
    tiles2, validb, _, _ = tile_pack2(seqs, K, db.T_WIRE)
    words, vwords = qd.wire_words_layout(tiles2, validb, K, db.T_WIRE,
                                         len(tiles2))
    return np_words(words).to(dev), np_words(vwords).to(dev)


@pytest.mark.parametrize("K", BUILD_KS)
def test_build_kernels_match_plain(cuda, K):
    """D1, D3 and D4 against their plain versions on one build's inputs."""
    rng = np.random.default_rng(K)
    words, vwords = _build_words(_build_seqs(rng), K, cuda)
    keys = db.build_windows(words, vwords, K)
    assert torch.equal(keys, db.build_windows_plain(words, vwords, K))
    skeys, _ = db.radix_sort(keys, 2 * K + 1)
    uniq, J, U = db.build_join(skeys, K)
    puniq, pJ, pU = db.build_join_plain(skeys, K)
    assert torch.equal(uniq, puniq) and torch.equal(J, pJ) and U == pU > 0
    Js, _ = db.radix_sort(J, 2 * K + 1, sentinel=db._sent2(K))
    assert torch.equal(Js, db.radix_sort(J, 2 * K + 1)[0])
    J = Js
    got = db.join_nodes(J, K, 1 << 40)
    want = db.join_nodes_plain(J, K, 1 << 40)
    assert got[2:] == want[2:] and (K == 3 or min(got[2:]) > 3)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(torch.sort(g).values, w)
    # a cap below the counts keeps the exact counts
    capped = db.join_nodes(J, K, 3)
    assert capped[2:] == want[2:]
    assert [len(c) for c in capped[:2]] == [min(3, n) for n in want[2:]]
    sink = db.unpack_node_keys(db.radix_sort(got[0], 2 * K - 2)[0].cpu()
                               .numpy(), K)
    src1 = db.unpack_node_keys(db.radix_sort(got[1], 2 * K - 2)[0].cpu()
                               .numpy(), K)
    d3 = torch.from_numpy(db.host_key3(db.expand_dummies(sink, src1, K),
                                       K)).to(cuda)
    k3 = db.emit_keys(skeys, uniq, U, d3, K)
    assert torch.equal(k3, db.emit_keys_plain(skeys, uniq, U, d3, K))
    S, _ = db.radix_sort(k3, 3 * K)
    assert torch.equal(S, db.radix_sort_plain(k3, 3 * K)[0])
    M = U + len(d3)
    assert len(S) == M
    for g, w in zip(db.build_emit(S, M, K), db.build_emit_plain(S, M, K)):
        assert torch.equal(g, w)


def test_build_emit_drops_redundant_sinks(cuda):
    """Rows that emit_boss drops (a $-labelled row whose node ends in a
    real character and goes on) leave the kept rows in order, F counting
    only them."""
    rng = np.random.default_rng(11)
    K = 5
    rows = rng.integers(1, 5, (5000, K)).astype(np.uint8)
    rows[::3, K - 1] = 0                          # many $-labelled rows
    rows = np.concatenate([np.zeros((1, K), np.uint8), rows])
    keys = np.unique(db.host_key3(rows, K))
    S = torch.from_numpy(keys).to(cuda)
    got = db.build_emit(S, len(keys), K)
    want = db.build_emit_plain(S, len(keys), K)
    assert len(want[0]) < len(keys) + 1           # some rows were dropped
    for g, w in zip(got, want):
        assert torch.equal(g, w)


EMIT_TILE = 4096                  # rows a tile of csrc/build_emit.cu


def _emit_keys_check(skeys, uniq, d3, K):
    """emit_keys against its plain version, exactly, and run twice."""
    U = int(uniq.sum())
    got = db.emit_keys(skeys, uniq, U, d3, K)
    assert torch.equal(got, db.emit_keys_plain(skeys, uniq, U, d3, K))
    assert torch.equal(got, db.emit_keys(skeys, uniq, U, d3, K))
    return got


def _build_emit_check(S, K, alph_size=5):
    """build_emit against its plain version, exactly, and run twice."""
    M = len(S)
    got = db.build_emit(S, M, K, alph_size)
    want = db.build_emit_plain(S, M, K, alph_size)
    again = db.build_emit(S, M, K, alph_size)
    for g, w, a in zip(got, want, again):
        assert torch.equal(g, w) and torch.equal(g, a)
    return got


@pytest.mark.parametrize("K", (3, 11, 21))
@pytest.mark.parametrize("n", (1, EMIT_TILE - 1, EMIT_TILE, EMIT_TILE + 1,
                               3 * EMIT_TILE - 1, 3 * EMIT_TILE,
                               3 * EMIT_TILE + 1, 1_000_003))
def test_emit_keys_tile_edges_match_plain(cuda, n, K):
    """The compaction at n on and beside tile edges: random keys under 2K
    bits, flags set in runs (as D3's after duplicates) and at random,
    none set (U = 0), all set; D = 0 and dummy rows; an offset view whose
    flags start off a 16-byte boundary."""
    rng = np.random.default_rng([n, K])
    skeys = torch.from_numpy(rng.integers(0, 1 << (2 * K), n + 5,
                                          dtype=np.int64)).to(cuda)
    top = (1 << (3 * K)) - 1
    runs = np.repeat(rng.random(n // 5 + 2) < 0.5, 5)[: n + 5]
    flags = {"runs": runs, "random": rng.random(n + 5) < 0.35,
             "none": np.zeros(n + 5, bool), "all": np.ones(n + 5, bool)}
    for what, f in flags.items():
        uniq = torch.from_numpy(f).to(cuda)
        for D in (0, 1, 5000):
            d3 = torch.from_numpy(rng.integers(0, top, D,
                                               dtype=np.int64)).to(cuda)
            got = _emit_keys_check(skeys[:n], uniq[:n], d3, K)
            assert len(got) == int(f[:n].sum()) + D, what
        _emit_keys_check(skeys[3: n + 3], uniq[3: n + 3], d3, K)


def _group_rows(rng, K, n_groups, full=0.5):
    """3-bit rows (codes $=0..T=4) in minus-flag groups: each group one
    random node suffix (characters 1..K-2) under every first character
    and label, or a random part of them; $-labelled rows whose node goes
    on (dropped), and first characters $ (not valid)."""
    rest = rng.integers(0, 5, (n_groups, max(K - 2, 0)), dtype=np.uint8)
    rows = []
    for g in range(n_groups):
        pairs = [(f, lab) for f in range(5) for lab in range(5)]
        if rng.random() >= full:
            pick = rng.random(25) < 0.4
            pick[rng.integers(25)] = True
            pairs = [p for p, on in zip(pairs, pick) if on]
        for f, lab in pairs:
            rows.append([f, *rest[g], lab])
    return np.array(rows, np.uint8)


@pytest.mark.parametrize("K", (9, 11, 21))
@pytest.mark.parametrize("M", (1, 2, EMIT_TILE - 1, EMIT_TILE,
                               EMIT_TILE + 1, 3 * EMIT_TILE - 1,
                               3 * EMIT_TILE, 3 * EMIT_TILE + 1, 400_001))
def test_build_emit_tile_edges_match_plain(cuda, M, K):
    """The emission at M on and beside tile edges, on streams of whole and
    partial minus-flag groups (up to 25 rows, so groups and same-node
    runs straddle tile boundaries), $-labelled rows that are dropped and
    rows that are not valid; every output byte array starts at another
    16-byte offset as M changes."""
    rng = np.random.default_rng([M, K, 3])
    rows = _group_rows(rng, K, M // 10 + 3)
    keys = np.unique(db.host_key3(rows, K))
    while len(keys) < M:
        more = _group_rows(rng, K, M // 10 + 3)
        keys = np.unique(np.concatenate([keys, db.host_key3(more, K)]))
    at = int(rng.integers(0, len(keys) - M + 1))
    S = torch.from_numpy(keys[at: at + M]).to(cuda)
    W, last, valid, F = _build_emit_check(S, K)
    if M > 100:
        assert int((W > 5).sum()) > M // 10        # many minus flags
        assert len(W) - 1 < M                      # some rows dropped


def _rest_key(v, K):
    """Group number v -> characters 1..K-2 (base-5 digits, character 1
    the lowest) in their 3-bit fields above bit 5: keys grow with v."""
    key = 0
    for j in range(K - 2):
        key |= (v % 5) << (3 * j + 6)
        v //= 5
    return key


@pytest.mark.parametrize("K", (11, 21))
def test_build_emit_long_groups_past_the_halo(cuda, K):
    """A stream with repeated rows (no construction makes one): groups of
    42-62 rows starting 20 rows before a tile boundary, whose last row's
    minus flag needs a row more than 24 back (the scan goes on in global
    memory); whole 25-row groups between them."""
    keys, v = [], 0
    for t, dup in ((1, 40), (2, 50), (3, 60)):
        while len(keys) < t * EMIT_TILE - 20:
            pairs = [(f, lab) for f in range(5) for lab in range(5)]
            pairs = pairs[: t * EMIT_TILE - 20 - len(keys)]
            keys += [_rest_key(v, K) | f << 3 | lab for f, lab in pairs]
            v += 1
        g = _rest_key(v, K)
        keys += [g | 1 << 3 | 3] + [g | 2 << 3 | 1] * dup + [g | 2 << 3 | 3]
        v += 1
    keys += [_rest_key(v, K) | f << 3 | 1 for f in range(5)]
    S = torch.tensor(keys, dtype=torch.int64, device=cuda)
    assert bool((S[1:] >= S[:-1]).all())
    W, _, _, _ = _build_emit_check(S, K)
    at = [t * EMIT_TILE - 20 + dup + 1 for t, dup in ((1, 40), (2, 50),
                                                     (3, 60))]
    assert all(int(W[1 + i]) == 3 + 5 for i in at)   # no row is dropped


def test_d4_empty_and_single_rows(cuda):
    """U = 0 with and without dummy rows, n = 0, D = 0, M = 1 and M = 0."""
    K = 11
    empty = torch.zeros(0, dtype=torch.int64, device=cuda)
    skeys = torch.arange(10, dtype=torch.int64, device=cuda)
    none = torch.zeros(10, dtype=torch.bool, device=cuda)
    d3 = torch.tensor([5, 9, 17], dtype=torch.int64, device=cuda)
    assert torch.equal(db.emit_keys(skeys, none, 0, d3, K), d3)
    assert len(db.emit_keys(skeys, none, 0, empty, K)) == 0
    assert torch.equal(db.emit_keys(empty, none[:0], 0, d3, K), d3)
    assert len(db.emit_keys(empty, none[:0], 0, empty, K)) == 0
    for S in (torch.tensor([0], device=cuda), d3[:1], empty):
        _build_emit_check(S, K)


@pytest.mark.parametrize("n", (10, 3 * EMIT_TILE + 1))
def test_emit_keys_wrong_u_raises(cuda, n):
    """A U other than the count of set flags raises ValueError on the card
    as in the plain version, one below it and one above, the flags over
    one tile and over several."""
    K = 11
    rng = np.random.default_rng([n, 16])
    skeys = torch.from_numpy(rng.integers(0, 1 << (2 * K), n,
                                          dtype=np.int64)).to(cuda)
    uniq = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    uniq[0], uniq[-1] = True, False
    d3 = torch.tensor([5, 9], dtype=torch.int64, device=cuda)
    U = int(uniq.sum())
    for wrong in (U - 1, U + 1):
        for fn in (db.emit_keys, db.emit_keys_plain):
            with pytest.raises(ValueError, match=f"but {U} rows are unique"):
                fn(skeys, uniq, wrong, d3, K)


@pytest.mark.parametrize("K", (11, 21))
def test_d4_past_2_24_rows(cuda, K):
    """More than 2^24 rows: the look-back crosses over 4,000 tiles in both
    kernels (the compaction over 5,000)."""
    rng = np.random.default_rng([K, 24])
    n = 5 * (1 << 22) + 4099
    skeys = torch.from_numpy(rng.integers(0, 1 << (2 * K), n,
                                          dtype=np.int64)).to(cuda)
    uniq = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    d3 = torch.from_numpy(rng.integers(0, (1 << (3 * K)) - 1, 70_001,
                                       dtype=np.int64)).to(cuda)
    k3 = _emit_keys_check(skeys, uniq, d3, K)
    del skeys, uniq
    S = db.radix_sort(k3, 3 * K)[0]
    assert len(S) > 1 << 24
    _build_emit_check(S, K)


@pytest.mark.parametrize("K", BUILD_KS)
def test_device_build_cuda_matches_cpu(cuda, K, monkeypatch):
    rng = np.random.default_rng([K, 1])
    seqs = _build_seqs(rng, n_seqs=120)
    names = ("build_windows", "radix_sort", "build_join", "build_emit")
    for n in names:
        getattr(db, n).launches = 0
    got = db.device_build_boss_arrays(seqs, K, device=cuda)
    launches = {n: getattr(db, n).launches for n in names}
    # the CPU build, its sorts' keys recorded
    sorts, radix_sort = [], db.radix_sort

    def spy(keys, bits, payload=None, **kw):
        sorts.append((keys, bits, kw.get("sentinel")))
        return radix_sort(keys, bits, payload, **kw)
    monkeypatch.setattr(db, "radix_sort", spy)
    want = db.device_build_boss_arrays(seqs, K, device="cpu")
    monkeypatch.undo()
    for f in ("W", "last", "valid", "F"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    # launches per build: D1 once; D2's edge, join and 3-bit sorts and
    # the node lists that are not empty, each a memset, a histogram and
    # the passes of its plan; D3 twice; D4's compaction and emission, each
    # a memset and one kernel
    assert len(sorts) == 5
    d2 = sum(2 + len(db.radix_plan_of(k, b, s)[1])
             for k, b, s in sorts if len(k))
    assert launches == {"build_windows": 1, "radix_sort": d2,
                        "build_join": 2, "build_emit": 4}


def test_device_build_cuda_regrowth_and_limit(cuda):
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGT"), size=40)).encode()
            for _ in range(300)]
    got = db.device_build_boss_arrays(seqs, 20, capd=64, device=cuda)
    want = db.device_build_boss_arrays(seqs, 20, capd=64, device="cpu")
    for f in ("W", "last", "valid", "F"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(RuntimeError, match="> 256 dummy sink/source"):
        db.device_build_boss_arrays(seqs, 20, capd=64, _max_capd=1023,
                                    device=cuda)


def test_dbg_build_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(21)
    seqs = _build_seqs(rng, n_seqs=30)
    got = DBGSuccinct.build(seqs, 21, device=cuda)
    want = DBGSuccinct.build(seqs, 21, device="cpu")
    for f in ("W", "last", "valid", "F"):
        assert np.array_equal(getattr(got.boss, f), getattr(want.boss, f))
    assert got.num_nodes() == want.num_nodes() > 0


def test_sort_kmers_device_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2 ** 32, (5000, 3), dtype=np.uint64) \
        .astype(np.uint32)
    keys[1000:2000] = keys[:1000]
    got = db.device_sort_unique(keys, with_counts=True, device=cuda)
    want = db.device_sort_unique(keys, with_counts=True, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("K", BUILD_KS)
def test_join_nodes_on_adversarial_runs(cuda, K):
    """Runs of a node with 4 sources and 0 targets, 0 and 4, 4 and 4."""
    rng = np.random.default_rng(K)

    def node():
        return "".join(rng.choice(list("ACGT"), size=K - 1))
    X, Y, Z = node(), node(), node()
    seqs = [X + c for c in "ACGT"] + [c + Y for c in "ACGT"] \
        + [c + Z for c in "ACGT"] + [Z + c for c in "ACGT"]
    words, vwords = _build_words([s.encode() for s in seqs], K, cuda)
    skeys, _ = db.radix_sort(db.build_windows(words, vwords, K), 2 * K + 1)
    J, _ = db.radix_sort(db.build_join(skeys, K)[1], 2 * K + 1)
    got = db.join_nodes(J, K, 1 << 20)
    want = db.join_nodes_plain(J, K, 1 << 20)
    assert got[2:] == want[2:]
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(torch.sort(g).values, w)


# --------------------------------------------------------------------------
# D1's strand mode and the general route's sorts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", BUILD_KS)
def test_build_windows_strand_mode_matches_plain(cuda, K):
    rng = np.random.default_rng([K, 2])
    words, vwords = _build_words(_build_seqs(rng), K, cuda)
    two = db.build_windows(words, vwords, K, strands=2)
    assert torch.equal(two, db.build_windows_plain(words, vwords, K,
                                                   strands=2))
    one = db.build_windows(words, vwords, K)
    assert torch.equal(two[: len(one)], one)
    assert torch.equal(db.rc_keys_plain(two[len(one):], K), one)


def _word_rows(rng, n, W, distinct):
    pool = rng.integers(0, 2 ** 64, (distinct, W), dtype=np.uint64)
    pool[::3, -1] = 0                     # a padded last word
    pool[::5, 0] = np.uint64(2 ** 64 - 1)
    return pool[rng.integers(0, distinct, n)]


@pytest.mark.parametrize("n", (1, 4097, 200_000, 1 << 20))
@pytest.mark.parametrize("W", (1, 2, 3))
def test_lexsort_and_unique_rows_cuda_match_cpu(cuda, W, n):
    from metagraph_tpu_torch.kmer import packing
    rng = np.random.default_rng([W, n])
    x = _word_rows(rng, n, W, max(n // 4, 1))
    perm = packing.lexsort_rows(x, device=cuda)
    assert np.array_equal(perm, packing.lexsort_rows(x, device="cpu"))
    # weights whose sums wrap int64 and uint64
    c = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
    c[::7] = np.uint64(2 ** 64 - 1)
    for counts in (None, c):
        got = packing.unique_rows(x, counts, device=cuda)
        want = packing.unique_rows(x, counts, device="cpu")
        assert np.array_equal(got[0], want[0])
        if counts is not None:
            assert got[1].dtype == np.uint64
            assert np.array_equal(got[1], want[1])
    # the keys go through kernel D2: a 64-bit sort a word
    db.radix_sort.launches = 0
    packing.lexsort_rows(x, device=cuda)
    assert db.radix_sort.launches >= 3 * W


@pytest.mark.parametrize("case", ("canonical", "primary", "protein-k20",
                                  "dna5-k9", "k31-counts", "k2",
                                  "canonical-k31-weights", "disk"))
def test_dbg_build_routes_cuda_match_cpu(cuda, case, tmp_path):
    rng = np.random.default_rng(len(case))
    seqs = _build_seqs(rng, n_seqs=80)
    kw = {"canonical": dict(k=21, mode="canonical"),
          "primary": dict(k=15, mode="primary"),
          "protein-k20": dict(k=20, alphabet="Protein"),
          "dna5-k9": dict(k=9, alphabet="DNA5"),
          "k31-counts": dict(k=31, with_counts=True),
          "k2": dict(k=2),
          "canonical-k31-weights": dict(
              k=31, mode="canonical", with_counts=True, bits_per_count=16,
              window_weights=[rng.integers(0, 2 ** 64, max(len(s) - 30, 0),
                                           dtype=np.uint64) for s in seqs]),
          "disk": dict(k=25, with_counts=True, disk_swap=str(tmp_path),
                       mem_cap_bytes=1 << 16)}[case]
    if kw.get("alphabet") == "Protein":
        letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", np.uint8)
        seqs = [letters[rng.integers(0, 21, len(s))].tobytes() for s in seqs]
    for name in ("build_windows", "radix_sort"):
        getattr(db, name).launches = 0
    got = DBGSuccinct.build(seqs, device=cuda, **kw)
    launches = (db.build_windows.launches, db.radix_sort.launches)
    want = DBGSuccinct.build(seqs, device="cpu", **kw)
    for f in ("W", "last", "valid", "F", "weights"):
        g, w = getattr(got.boss, f), getattr(want.boss, f)
        assert (g is None) == (w is None), f
        assert g is None or (g.dtype == w.dtype and np.array_equal(g, w)), f
    assert got.num_nodes() == want.num_nodes() > 0
    route = "device" if case in ("canonical", "primary") else "general"
    assert launches[0] == (1 if route == "device" else 0)
    assert launches[1] > 0


# --------------------------------------------------------------------------
# A12.3: the graph builds' sorts; A10: the older epochs and the dedup epoch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rep", ("hash", "bitmap", "sshash"))
@pytest.mark.parametrize("mode", ("basic", "canonical"))
@pytest.mark.parametrize("k", (11, 31))
def test_graph_builds_cuda_match_cpu(cuda, rep, mode, k):
    """``build --graph``: the hash ids (first occurrences by a stable D2
    sort, the positions sorted again by D2), the bitmap's and sshash's
    sorted keys, on the card as on the CPU."""
    from metagraph_tpu_torch.graph import build_graph
    rng = np.random.default_rng([k, len(rep), len(mode)])
    seqs = _build_seqs(rng, n_seqs=60)
    db.radix_sort.launches = 0
    got = build_graph(rep, seqs, k, mode=mode, device=cuda)
    launches = db.radix_sort.launches
    want = build_graph(rep, seqs, k, mode=mode, device="cpu")
    for g, w in zip(got.node_kmers_and_ids(), want.node_kmers_and_ids()):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert want.num_nodes() > 1000 and launches > 0


def _epoch_setup(dev, seed=0, n_refs=12, ref_len=900, k=21, canonical=False):
    """A port-built graph of random references (label ``r<i>`` on
    reference i's nodes, ``all`` on every other one's), its pipeline on
    ``dev`` and reads cut from the references (some reverse-complemented,
    some with N)."""
    from metagraph_tpu_torch.query.device import DeviceQueryPipeline
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    refs = [letters[rng.integers(0, 4, ref_len)].tobytes()
            for _ in range(n_refs)]
    g = DBGSuccinct.build(refs, k, mode="canonical" if canonical else
                          "basic", device="cpu")
    edges = np.flatnonzero(g.boss.valid)
    keys = ops.pack_kmers32(g.boss.get_edge_seq(edges))
    node_of = {row.tobytes(): int(e) for row, e in zip(keys, edges)}
    ex = g.extractor
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rows = []
    for s in refs:
        both = [s, s.translate(comp)[::-1]] if canonical else [s]
        ids = [node_of.get(r.tobytes(), 0) for x in both for r in
               ops.pack_kmers32(np.lib.stride_tricks.sliding_window_view(
                   ex.encode(x), k))]
        rows.append(np.unique([i for i in ids if i]).astype(np.int64) - 1)
    rows.append(np.unique(np.concatenate(rows[::2])))
    anno = ColumnMajorAnnotation(g.max_index(), [f"r{i}" for i in
                                                 range(n_refs)] + ["all"],
                                 rows)
    reads = []
    for i in range(300):
        s = refs[i % n_refs]
        a = int(rng.integers(0, ref_len - 200))
        r = s[a: a + int(rng.integers(k - 3, 200))]
        if i % 3 == 1:
            r = r.translate(comp)[::-1]
        if i % 7 == 2:
            r = r[:10] + b"NN" + r[12:]
        reads.append(r)
    return DeviceQueryPipeline(g, anno, device=dev), reads


@pytest.mark.parametrize("canonical", (False, True))
def test_epochs_cuda_match_cpu(cuda, canonical):
    """Every A10 epoch on the card (each lookup through kernel A, each
    count through kernel 2) against the same call on the CPU."""
    from metagraph_tpu_torch.annotation import ops as anno_ops
    gpu, reads = _epoch_setup(cuda, canonical=canonical)
    cpu, _ = _epoch_setup("cpu", canonical=canonical)
    q, sid, nk = cpu.prepare_batch(reads)
    assert all(np.array_equal(a, b) for a, b in
               zip(gpu.prepare_batch(reads)[:2], (q, sid)))
    S, L = len(reads), cpu.annotation.num_labels

    def both(fn, *args, host=()):
        """fn on the card and on the CPU: the card's launches of kernels
        A and 2, and each output equal."""
        ops.key_lookup.launches = qd.label_counts.launches = 0
        got = fn(*[a.to(cuda) if isinstance(a, torch.Tensor) else a
                   for a in args])
        torch.cuda.synchronize()
        launched = (ops.key_lookup.launches, qd.label_counts.launches)
        want = fn(*args)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), fn.__name__
        return launched

    tab, bm = cpu.index.table, cpu.annotation.bitmap
    qt, st = torch.from_numpy(q.view(np.int32)), torch.from_numpy(sid)
    assert both(qd.query_step, tab, bm, qt, st, S, L) == (1, 1)
    assert both(qd.query_epoch, tab, bm, qt, st, S, L, 4096)[0] >= 2
    tiles, tile_seq = qd.tile_layout(q, sid, S)
    assert both(qd.query_epoch_tiled, tab, bm,
                torch.from_numpy(tiles.view(np.int32)),
                torch.from_numpy(tile_seq), S, L) == (1, 1)
    ct, ts, _ = qd.tile_codes_layout([cpu.graph.extractor.encode(r)
                                      for r in reads], cpu.k)
    assert both(qd.query_epoch_codes, tab, bm, torch.from_numpy(ct),
                torch.from_numpy(ts), S, L, cpu.k) == (1, 1)
    dk, dt, dts, D = qd.dedup_batch(q, sid, S, device=cuda)
    assert D < len(q)
    assert both(qd.query_epoch_dedup, tab, bm,
                torch.from_numpy(dk.view(np.int32)), torch.from_numpy(dt),
                torch.from_numpy(dts), S, L) == (1, 1)
    nodes = qd.query_step(tab, bm, qt, st, S, L)[2]
    perm = torch.from_numpy(np.random.default_rng(1).permutation(len(q)))
    for fn, s_ in ((anno_ops.count_labels, perm),
                   (anno_ops.count_labels_matmul, perm),
                   (anno_ops.count_labels_sorted, None)):
        n_, i_ = (nodes, st) if s_ is None else (nodes[s_], st[s_])
        assert both(fn, bm, n_, i_, S, L) == (0, 1)
    assert gpu.query_labels(reads, "matches", 3) \
        == cpu.query_labels(reads, "matches", 3)
    assert sum(map(len, cpu.query_labels(reads))) > 200


@pytest.mark.parametrize("W", (1, 2, 3, 4, 5))
def test_dedup_batch_cuda_matches_cpu(cuda, W):
    """``dedup_batch``'s distinct pass through D2 on joined 64-bit words:
    rows with all-ones words, the padding row and repeats."""
    rng = np.random.default_rng(W)
    pool = rng.integers(0, 2 ** 32, (5000, W), dtype=np.uint64).astype(
        np.uint32)
    pool[::9, 0] = 0xFFFFFFFF
    pool[::13] = 0xFFFFFFFF
    q = pool[rng.integers(0, len(pool), 200_000)]
    sid = np.sort(rng.integers(0, 3000, len(q))).astype(np.int32)
    db.radix_sort.launches = 0
    got = qd.dedup_batch(q, sid, 3000, device=cuda)
    assert db.radix_sort.launches >= (W + 1) // 2
    want = qd.dedup_batch(q, sid, 3000, device="cpu")
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3] < len(pool)


def test_hash_lookup_padding_rows_cuda(cuda):
    """The padding rows get the JAX probe's answer, the others kernel A's,
    on the card as on the CPU."""
    pipe, reads = _epoch_setup("cpu", seed=3)
    q, _, _ = pipe.prepare_batch(reads)
    assert (q == 0xFFFFFFFF).all(axis=1).any()
    keys = torch.from_numpy(q.view(np.int32))
    want = ops.hash_lookup(pipe.index.table, keys)
    got = ops.hash_lookup(pipe.index.table.to(cuda), keys.to(cuda))
    assert torch.equal(got.cpu(), want) and (want > 0).sum() > 1000


def test_entry_cuda_matches_cpu(cuda):
    from metagraph_tpu_torch.entry import entry
    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    got = fn(*args)
    cfn, cargs = entry(device="cpu")
    for g, w in zip(got, cfn(*cargs)):
        assert torch.equal(g.cpu(), w)


# --------------------------------------------------------------------------
# A13: kernel B11 (wave_dp, align_wave) and the align command on the card
# --------------------------------------------------------------------------

WAVE_NINF = -(2 ** 31) + 100


def _wave(rng, N, W, big=False):
    """A wave as the flat engine forms it (tests/test_torch_wave_dp.py's
    shapes): parent rows masked to a hull with NINF cells, profile scores,
    node scores, has_del, a band and a cutoff a row; ``big`` puts the
    scores near the ends of int32, so that sums wrap."""
    lo_v, hi_v = (-2 ** 31 + 101, 2 ** 31 - 1) if big else (-400, 600)

    def mat():
        m = rng.integers(lo_v, hi_v, (N, W), dtype=np.int64).astype(np.int32)
        h0 = rng.integers(0, W, N)
        h1 = np.minimum(h0 + rng.integers(0, W + 1, N), W - 1)
        j = np.arange(W)[None, :]
        m[(j < h0[:, None]) | (j > h1[:, None])
          | (rng.random((N, W)) < 0.3)] = WAVE_NINF
        return m

    prof = rng.integers(-4, 12, (N, W)).astype(np.int32)
    lo = rng.integers(0, W, N).astype(np.int32)
    cut = rng.integers(-60, 80, N).astype(np.int32)
    cut[rng.random(N) < 0.2] = WAVE_NINF + 1
    return [mat(), mat(), mat(), prof,
            rng.choice(np.array([0, 0, -6, -2], np.int32), N),
            rng.random(N) < 0.7, lo,
            np.minimum(lo + rng.integers(0, W, N), W - 1).astype(np.int32),
            cut]


@pytest.mark.parametrize("big", (False, True), ids=("scores", "wrapping"))
@pytest.mark.parametrize("shape", ((1, 1), (1, 2), (3, 31), (5, 32),
                                   (7, 33), (2000, 151), (64, 1025),
                                   (9, 2049)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_wave_dp_matches_plain(cuda, shape, big):
    from metagraph_tpu_torch.align.wave_extender import (wave_dp,
                                                         wave_dp_plain)
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    for go, ge in ((-6, -2), (-5, -1), (-11, -1), (-200, 3)):
        t = [torch.from_numpy(np.ascontiguousarray(a))
             for a in _wave(rng, *shape, big=big)]
        before = wave_dp.launches
        got = wave_dp(*[a.to(cuda) for a in t], go, ge)
        torch.cuda.synchronize()
        assert wave_dp.launches == before + 1
        want = wave_dp_plain(*t, go, ge)
        for name, g, w in zip("SEF", got, want):
            assert torch.equal(g.cpu(), w), name


def test_wave_dp_empty_wave_does_not_launch(cuda):
    from metagraph_tpu_torch.align.wave_extender import wave_dp
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
         for a in _wave(np.random.default_rng(1), 3, 8)]
    empty = [a[:0] for a in t]
    before = wave_dp.launches
    out = wave_dp(*empty, -6, -2)
    assert wave_dp.launches == before and out[0].shape == (0, 8)


def _align_graph(tmp_path, seed=5, k=21, forks=False):
    """A port-built graph of random references, saved, and reads from them
    (substitutions, an indel, both strands, random reads); with ``forks``,
    two more references join pieces of the others, so that the graph
    branches and so do the extensions' pops."""
    rng = np.random.default_rng(seed)
    refs = ["".join(rng.choice(list("ACGT"), 3000)) for _ in range(4)]
    if forks:
        refs += [refs[0][:1000] + refs[1][1500:2500],
                 refs[2][:1200] + "ACGTTGCA" + refs[2][1200:2400]]
    g = DBGSuccinct.build(refs, k, device="cpu")
    g.save(str(tmp_path / "g"))
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(120):
        r = refs[i % 4]
        a = int(rng.integers(0, len(r) - 150))
        s = list(r[a: a + 150])
        for p in rng.choice(150, int(rng.integers(0, 3)), replace=False):
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        if i % 10 == 3:
            del s[70: 72]
        s = "".join(s)
        reads.append(s[::-1].translate(comp) if i % 2 else s)
    reads += ["".join(rng.choice(list("ACGT"), 150)) for _ in range(6)]
    with open(tmp_path / "q.fa", "w") as f:
        f.writelines(f">q{i}\n{s}\n" for i, s in enumerate(reads))
    return tmp_path / "g.dbg.npz", tmp_path / "q.fa", reads


def test_wave_dp_on_recorded_align_batch(cuda, tmp_path):
    """Every wave of an align_batch run on the card, its planes formed
    from the engine's store on the card (``wave_planes``) and sent through
    ``compute_wave``'s own entry: ``wave_dp`` held whole against the plain
    version on the same inputs, one launch a wave; the engine itself
    launches no wave_dp."""
    from metagraph_tpu_torch.align import wave_extender as wx
    from metagraph_tpu_torch.align.aligner import DBGAligner
    gpath, _, reads = _align_graph(tmp_path)
    g = DBGSuccinct.load(str(gpath))
    planes = []
    run_wave = wx.run_wave

    def record(store, tables, pack, W, go, ge, out):
        p, _ = wx.wave_planes(store, tables, pack.to(cuda), W)
        planes.append(([a.cpu().numpy() for a in p], go, ge))
        return run_wave(store, tables, pack, W, go, ge, out)

    wx.run_wave = record
    try:
        wx.wave_dp.launches = 0
        DBGAligner(g, device=cuda).align_batch([r.encode() for r in reads])
    finally:
        wx.run_wave = run_wave
    assert planes and wx.wave_dp.launches == 0
    waves = []
    for p, go, ge in planes:
        got = wx.compute_wave(*p, go, ge, cuda)
        want = wx.wave_dp_plain(*wx.wave_tensors(*p, "cpu"), go, ge)
        waves.append(all(np.array_equal(a, b.numpy())
                         for a, b in zip(got, want)))
    assert all(waves) and wx.wave_dp.launches == len(planes)


def _store_wave(rng, J, W, big=False):
    """A wave over a column store as the flat engine forms it: R x 3 x Wp
    rows (S, E, F; NINF outside random hulls), profile and partial-sum
    rows, and J parents with 1-4 children each (later siblings with
    read-back slots) -> (store, tables, pack, slots)."""
    from metagraph_tpu_torch.align import wave_extender as wx
    lo_v, hi_v = (-2 ** 31 + 101, 2 ** 31 - 1) if big else (-400, 600)
    Wp = -(-W // 4) * 4
    nch = rng.integers(1, 5, J)
    nch[0] = max(nch[0], 2)
    CH = int(nch.sum())
    R = J + CH + 3
    store = rng.integers(lo_v, hi_v, (R, 3, Wp), dtype=np.int64) \
        .astype(np.int32)
    h0 = rng.integers(0, W, (R, 3, 1))
    h1 = np.minimum(h0 + rng.integers(0, W + 1, (R, 3, 1)), W - 1)
    j = np.arange(Wp)[None, None, :]
    store[(j < h0) | (j > h1) | (rng.random(store.shape) < 0.3)] = WAVE_NINF
    C1 = 7
    tables = rng.integers(-4 if not big else lo_v, 12 if not big else hi_v,
                          (J * C1, Wp), dtype=np.int64).astype(np.int32)
    tables[C1 - 1::C1] = rng.integers(-400, 400, (J, Wp))   # partial sums
    rows = rng.permutation(R)
    ch_rows = np.repeat(np.arange(J), nch)
    later = np.flatnonzero(np.r_[False, ch_rows[1:] == ch_rows[:-1]])
    slot = np.full(CH, -1)
    slot[later] = np.arange(len(later))
    wsize = rng.integers(0, W, J)
    cut = rng.integers(-60, 80, J)
    cut[rng.random(J) < 0.2] = WAVE_NINF + 1
    pack = np.zeros((CH, wx.NPACK), dtype=np.int32)
    pack[:, wx.PK_PARENT] = rows[:J][ch_rows]
    pack[:, wx.PK_ROW] = rows[J: J + CH]
    pack[:, wx.PK_PROF] = ch_rows * C1 + rng.integers(0, C1 - 1, CH)
    pack[:, wx.PK_PSS] = ch_rows * C1 + C1 - 1
    pack[:, wx.PK_SCORE] = rng.choice([0, 0, -6, -2], CH)
    pack[:, wx.PK_DEL] = rng.random(CH) < 0.7
    pack[:, wx.PK_CUT] = cut[ch_rows]
    pack[:, wx.PK_WSIZE] = wsize[ch_rows]
    pack[:, wx.PK_WS] = wsize[ch_rows] + 1
    pack[:, wx.PK_DIAG] = rng.integers(-5, W + 5, CH)
    pack[:, wx.PK_SLOT] = slot
    xcut = rng.uniform(-100, 700, CH).round(rng.choice([0, 3]))
    pack[:, wx.PK_XCUT:] = xcut.view(np.int32).reshape(CH, 2)
    return store, tables, pack, len(later)


@pytest.mark.parametrize("big", (False, True), ids=("scores", "wrapping"))
@pytest.mark.parametrize("shape", ((1, 1), (1, 2), (3, 31), (5, 32),
                                   (7, 33), (500, 151), (40, 1025),
                                   (6, 2049)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_align_wave_matches_plain(cuda, shape, big):
    """align_wave against align_wave_plain: the whole store and the whole
    output (statistics, S, the branch slots' rows) bit-equal; one launch
    a call."""
    from metagraph_tpu_torch.align import wave_extender as wx
    J, W = shape
    rng = np.random.default_rng(J * 7 + W)
    for go, ge in ((-6, -2), (-5, -1), (-11, -1), (-200, 3)):
        store, tables, pack, slots = _store_wave(rng, J, W, big)
        assert slots                        # a branch pop in every wave
        n = wx.out_size(len(pack), W, slots)
        got_store = torch.from_numpy(store).to(cuda)
        got = torch.full((n,), 7, dtype=torch.int32, device=cuda)
        before = wx.align_wave.launches
        wx.align_wave(got_store, torch.from_numpy(tables).to(cuda),
                      torch.from_numpy(pack).to(cuda), W, go, ge, got)
        torch.cuda.synchronize()
        assert wx.align_wave.launches == before + 1
        want_store = torch.from_numpy(store.copy())
        want = torch.full((n,), 7, dtype=torch.int32)
        wx.align_wave_plain(want_store, torch.from_numpy(tables),
                            torch.from_numpy(pack), W, go, ge, want)
        assert torch.equal(got_store.cpu(), want_store)
        assert torch.equal(got.cpu(), want)


def test_align_wave_empty_wave_does_not_launch(cuda):
    from metagraph_tpu_torch.align import wave_extender as wx
    store, tables, pack, _ = _store_wave(np.random.default_rng(2), 3, 40)
    st = torch.from_numpy(store).to(cuda)
    before = wx.align_wave.launches
    stats, srows, brows = wx.align_wave(
        st, torch.from_numpy(tables).to(cuda),
        torch.from_numpy(pack[:0]).to(cuda), 40, -6, -2,
        torch.empty(0, dtype=torch.int32, device=cuda))
    assert wx.align_wave.launches == before and stats.shape == (0, 10)
    assert torch.equal(st.cpu(), torch.from_numpy(store))


def test_align_wave_on_recorded_align_batch(cuda, tmp_path):
    """Every wave of an align_batch run on the card through align_wave,
    held against align_wave_plain on the card on the same store: the
    store after it and its output bit-equal; one launch a wave, no
    wave_dp; the alignments equal the CPU run's."""
    from metagraph_tpu_torch.align import wave_extender as wx
    from metagraph_tpu_torch.align.aligner import DBGAligner
    gpath, _, reads = _align_graph(tmp_path, seed=9, forks=True)
    g = DBGSuccinct.load(str(gpath))
    waves = []
    run_wave = wx.run_wave

    def check(store, tables, pack, W, go, ge, out):
        ref = store.clone()
        views = run_wave(store, tables, pack, W, go, ge, out)
        want = torch.empty(out.shape, dtype=torch.int32, device=cuda)
        wx.align_wave_plain(ref, tables, pack.to(cuda), W, go, ge, want)
        waves.append((torch.equal(store, ref)
                      and torch.equal(out, want.cpu()),
                      int((pack[:, wx.PK_SLOT] >= 0).sum())))
        return views

    wx.run_wave = check
    try:
        wx.align_wave.launches = wx.wave_dp.launches = 0
        got = DBGAligner(g, device=cuda).align_batch(
            [r.encode() for r in reads])
    finally:
        wx.run_wave = run_wave
    assert waves and all(ok for ok, _ in waves)
    assert sum(n for _, n in waves) > 0          # branch pops
    assert wx.align_wave.launches == len(waves) and not wx.wave_dp.launches
    want = DBGAligner(g, device="cpu").align_batch(
        [r.encode() for r in reads])
    assert [[(a.score, a.cigar.to_string(), a.nodes) for a in r]
            for r in got] == [[(a.score, a.cigar.to_string(), a.nodes)
                               for a in r] for r in want]


@pytest.mark.parametrize("flags", ((), ("--json", "--device"),
                                   ("-p", "2"),
                                   ("--align-min-seed-length", "11")),
                         ids=("tsv", "json", "p2", "suffix-seeds"))
def test_align_cli_cuda_matches_cpu(cuda, tmp_path, flags):
    import contextlib
    import io
    from metagraph_tpu_torch.cli import main
    gpath, qpath, _ = _align_graph(tmp_path, seed=len(flags))
    outs = []
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["align", "-i", str(gpath), *flags, str(qpath),
                  "--torch-device", dev])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") >= 126


# --------------------------------------------------------------------------
# query --align, --batch-align and the server's /align
# --------------------------------------------------------------------------

def _align_index(tmp_path, k):
    """``_align_graph``'s graph at k and a column annotation beside it
    (one label over every node, one over every other node), written as
    the JAX ``annotate`` writes it.  -> (graph path, annotation path,
    reads path, graph, reads)."""
    gpath, qpath, reads = _align_graph(tmp_path, seed=k, k=k, forks=True)
    g = DBGSuccinct.load(str(gpath))
    rows = np.flatnonzero(g.boss.valid).astype(np.int64) - 1
    cols = [rows, rows[::2]]
    arrays = {"labels": np.array(["all", "half"]),
              "num_rows": g.max_index(), "has_values": False,
              "has_coords": False}
    for c, r in enumerate(cols):
        arrays[f"rows_{c}"] = r
        arrays[f"vals_{c}"] = np.zeros(0, np.int64)
        arrays[f"coords_{c}"] = np.zeros((0, 2), np.int64)
    np.savez(tmp_path / "a.column.annodbg.npz", **arrays)
    return gpath, tmp_path / "a.column.annodbg", qpath, g, reads


def _launches():
    from metagraph_tpu_torch.align import wave_extender as wx
    fns = {"align_wave": wx.align_wave, "wave_dp": wx.wave_dp,
           "wire_lookup": ops.wire_lookup, "key_lookup": ops.key_lookup,
           "label_counts": qd.label_counts,
           "selection_mask": qd.selection_mask,
           **{n: getattr(db, n) for n in ("build_windows", "radix_sort",
                                          "build_join", "build_emit")}}
    return {n: f.launches for n, f in fns.items()}


@pytest.mark.parametrize("k", (21, 31))
@pytest.mark.parametrize("flags", (("--align",),
                                   ("--align", "--batch-align"),
                                   ("--align", "--batch-align", "--json",
                                    "-p", "2", "--batch-size", "6000")),
                         ids=("align", "batch-align", "batch-align-json-p2"))
def test_query_align_cli_cuda_matches_cpu(cuda, tmp_path, flags, k):
    """``query --align`` (and ``--batch-align``) on the card prints the
    bytes of the plain versions on the CPU; one align_wave a wave, no
    wave_dp; kernels A, 2 and 3 on the respelled batches (no wire
    route); every batch graph through D1-D4 at k = 21, through D2 alone
    at k = 31."""
    import contextlib
    import io
    from metagraph_tpu_torch.align.wave_extender import STATS
    from metagraph_tpu_torch.cli import main
    gpath, apath, qpath, *_ = _align_index(tmp_path, k)
    outs = []
    for dev in (cuda.type, "cpu"):
        buf = io.StringIO()
        before, waves0 = _launches(), STATS["waves"]
        with contextlib.redirect_stdout(buf):
            main(["query", "-i", str(gpath), "-a", str(apath), *flags,
                  str(qpath), "--torch-device", dev])
        outs.append(buf.getvalue())
        if len(outs) == 1:
            got = {n: v - before[n] for n, v in _launches().items()}
            waves = STATS["waves"] - waves0
    assert outs[0] == outs[1] and outs[0].count("\n") == 126
    assert got["align_wave"] == waves > 0 and not got["wave_dp"]
    assert not got["wire_lookup"]
    assert min(got["key_lookup"], got["label_counts"],
               got["selection_mask"]) >= 1
    if "--batch-align" in flags:
        assert got["radix_sort"] >= 1
        device_route = ("build_windows", "build_join", "build_emit")
        assert all((got[n] >= 1) == (k == 21) for n in device_route)
    else:
        assert not any(got[n] for n in ("build_windows", "radix_sort",
                                        "build_join", "build_emit"))


def test_server_align_cuda_matches_cpu(cuda, tmp_path):
    """/align on a succinct graph: the server on the card answers one
    request as the one on the CPU, and two requests in flight together
    as it answers each alone; one align_wave a wave."""
    import json
    import threading
    import urllib.request
    from metagraph_tpu_torch.align.wave_extender import STATS
    from metagraph_tpu_torch.annotation.matrix import load_annotation
    from metagraph_tpu_torch.server.server import MetaGraphServer
    _, apath, _, g, reads = _align_index(tmp_path, 31)
    servers = [MetaGraphServer(g, load_annotation(str(apath)), device=d)
               for d in ("cpu", cuda)]
    for s in servers:
        s.serve("127.0.0.1", 0, background=True)
    bodies = [{"FASTA": "".join(f">r{i}\n{r}\n"
                                for i, r in enumerate(reads[h::2]))}
              for h in range(2)]
    bodies[1]["max_alternative_alignments"] = 2

    def ask(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/align",
            data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as f:
            return f.status, json.loads(f.read())
    try:
        want = [ask(servers[0].port, b) for b in bodies]
        assert all(w[0] == 200 for w in want)
        assert sum(bool(e["alignments"]) for e in want[0][1]) >= 55
        got = [None, None]
        before, waves = _launches(), STATS["waves"]

        def client(h):
            got[h] = ask(servers[1].port, bodies[h])
        threads = [threading.Thread(target=client, args=(h,))
                   for h in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        launched = _launches()["align_wave"] - before["align_wave"]
        assert launched == STATS["waves"] - waves > 0
        assert got == want
        assert [ask(servers[1].port, b) for b in bodies] == want
    finally:
        for s in servers:
            s.shutdown()
