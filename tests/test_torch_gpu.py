"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither jax nor metagraph_tpu, so it runs on a machine that has only
PyTorch; tests/conftest.py imports jax, so run it there without conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Inputs come from numpy seeds; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu_torch import convert
from metagraph_tpu_torch._u32 import np_words
from metagraph_tpu_torch.align.sw import sw_scores
from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
from metagraph_tpu_torch.annotation.ops import pack_annotation_bitmap
from metagraph_tpu_torch.query import device as qd
from metagraph_tpu_torch.query.pipeline import QueryEngine
from metagraph_tpu_torch.query.tile_pack import tile_pack2
from metagraph_tpu_torch.succinct import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _index(K, seed, n_refs=6, ref_len=700):
    """A port-built index over random references (one label each, every
    other reference also labelled 'all') and reads cut from them."""
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
        a = int(rng.integers(0, ref_len - 150))
        read = r[a: a + int(rng.integers(K - 3, 150))].copy()
        read[rng.random(len(read)) < 0.02] = 4
        seqs.append(letters[read].tobytes())
    seqs.append(letters[np.tile(refs[0], 3)].tobytes())
    return index, seqs


def _wire_inputs(index, seqs, dev):
    K = index.k
    tiles2, validb, tile_seq, nwins = tile_pack2(seqs, K, qd.TILE)
    words, vwords = qd.wire_words_layout(tiles2, validb, K, qd.TILE,
                                         len(tiles2))
    dsel, selmin = qd._thresholds(nwins, 0.6, 0.1)
    t = [np_words(index.table), np_words(index.bitmap), np_words(words),
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


@pytest.mark.parametrize("LQ", (5, 48, 150, 333, 1024))
def test_sw_kernel_matches_plain(cuda, LQ):
    rng = np.random.default_rng(LQ)
    B, LR = 64, 2 * LQ
    qs = rng.integers(0, 4, (B, LQ)).astype(np.int32)
    rs = rng.integers(0, 4, (B, LR)).astype(np.int32)
    for b in range(B):
        n = int(rng.integers(1, LQ + 1))
        rs[b, :n] = qs[b, :n]
        qs[b, int(rng.integers(LQ // 2, LQ + 1)):] = -1
    q, r = torch.from_numpy(qs), torch.from_numpy(rs)
    want = sw_scores(q, r)
    got = sw_scores(q.to(cuda), r.to(cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


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
