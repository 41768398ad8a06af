"""The layouts the port's kernels 1 and 2 rely on, on the CPU.

Kernel 1 (csrc/wire_lookup.cu) stops a probe after the first group of 4
slots that holds its key or an empty slot.  That is exact because the
builders fill a bucket's slots from slot 0 with distinct keys:
``convert.QueryIndex`` refuses a table with a gap, and a numpy scan with
the stop rule equals the full-row lookup (``_hash_lookup_flat``) on tables
built by the port and by the JAX package.  ``ops.probe_groups``, with which
chip_smoke.py counts the kernel's bound, is held against a hand count.
Kernel 2 (csrc/label_counts.cu) reads ``DeviceAnnotation``'s rows padded
to a multiple of 4 words; the plain version reads the padded view alike.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu.succinct import ops as jops
from metagraph_tpu_torch import convert
from metagraph_tpu_torch._u32 import np_words, to_u64
from metagraph_tpu_torch.annotation.ops import DeviceAnnotation
from metagraph_tpu_torch.query import device as qd
from metagraph_tpu_torch.succinct import ops as tops
from test_torch_gpu import FILLS, _bitmap, table_with_fills

KS = (2, 15, 16, 17, 31)
# the port's and the JAX package's builders at every K, and hash-chosen
# keys filling buckets to 0, 1, 3, 4, 5, 15 and 16 keys (not at K = 2,
# which has 16 k-mers)
TABLES = [(K, b) for K in KS for b in ("port", "jax")] \
    + [(K, "fills") for K in KS[1:]]


def _table(K, builder):
    """-> (table, keys present, keys absent), keys as pack_kmers32 words."""
    if builder == "fills":
        table, chars, _, absent = table_with_fills(K, 8000 + K)
        return table, jops.pack_kmers32(chars), jops.pack_kmers32(absent)
    rng = np.random.default_rng(K)
    chars = np.unique(rng.integers(1, 5, (3000, K)).astype(np.uint8), axis=0)
    n = max(len(chars) // 2, 1)
    keys, ids = jops.pack_kmers32(chars[:n]), np.arange(1, n + 1) * 7
    ids = ids.astype(np.uint32)
    if builder == "port":
        table = tops.DeviceHashIndex.build_table(keys, ids)
    else:
        table = np.asarray(jops.DeviceHashIndex.from_packed(keys, ids).table)
    return table, keys, jops.pack_kmers32(chars[n:])


def _index(K, table):
    return convert.QueryIndex(K, table, np.zeros((3, 1), np.uint32), ["a"])


def _stop_rule_scan(table, queries, W):
    """Numpy lookup that reads a bucket row 4 slots at a time and stops
    after the group holding the key or an empty slot -> (ids, groups)."""
    b = jops._hash_words(queries, table.shape[0], 1)
    ids = np.zeros(len(queries), np.int64)
    groups = np.zeros(len(queries), np.int64)
    for i, q in enumerate(queries):
        row = table[b[i]].reshape(4, 4, W + 1)
        for g in range(4):
            groups[i] = g + 1
            eq = (row[g, :, :W] == q).all(axis=1)
            if eq.any():
                ids[i] = row[g, eq, W].max()
            if eq.any() or (row[g, :, 0] == tops.EMPTY_WORD).any():
                break
    return ids, groups


@pytest.mark.parametrize("K,builder", TABLES)
def test_slot_fill_check_accepts_built_tables(K, builder):
    table, _, _ = _table(K, builder)
    _index(K, table)


@pytest.mark.parametrize("slot", (0, 7, 14, 15))
def test_slot_fill_check_refuses_a_gap(slot):
    """Emptying slot 0, 7 or 14 of a full bucket leaves occupied slots
    after an empty one; emptying slot 15 does not."""
    table = table_with_fills(31, 8031)[0]
    rows = table.reshape(len(FILLS), 16, 5)
    rows[FILLS.index(16), slot] = tops.EMPTY_WORD
    if slot == 15:
        _index(31, table)
        return
    with pytest.raises(ValueError, match="occupied slot after an empty"):
        _index(31, table)


@pytest.mark.parametrize("K,builder", TABLES)
def test_stop_rule_scan_equals_full_row_lookup(K, builder):
    table, keys, absent = _table(K, builder)
    W = keys.shape[1]
    queries = np.concatenate([keys, absent])
    want = tops._hash_lookup_flat(np_words(table),
                                  to_u64(np_words(queries)), W)
    ids, groups = _stop_rule_scan(table, queries, W)
    np.testing.assert_array_equal(ids, want.numpy())
    assert (ids[:len(keys)] > 0).all() and not ids[len(keys):].any()
    _, got = tops.probe_groups(np_words(table), to_u64(np_words(queries)), W)
    np.testing.assert_array_equal(got.numpy(), groups)
    if builder == "fills":
        # keys in slot 15 and misses in full buckets read all 4 groups
        assert (groups[:len(keys)] == 4).any()
        assert (groups[len(keys):] == 4).any()


def test_probe_groups_and_bound_count_by_hand():
    """Buckets of 0, 1, 3, 4, 5, 15, 16 and 16 keys.  A key in slot s reads
    s // 4 + 1 groups; a miss reads up to its bucket's first empty slot:
    1, 1, 1, 2, 2, 4, 4 and 4 groups.  With every key and a miss per bucket
    probed, the bound counts each bucket's furthest group once: 19 groups
    of 80 bytes at K = 31."""
    table, chars, _, absent = table_with_fills(31, 8031)
    keys = jops.pack_kmers32(chars)
    rows = table.reshape(len(FILLS), 16, 5)
    slot_of = {tuple(rows[b, s, :4]): (b, s) for b in range(len(FILLS))
               for s in range(FILLS[b])}
    key_groups = [slot_of[tuple(k)][1] // 4 + 1 for k in keys]
    miss_groups = {0: 1, 1: 1, 3: 1, 4: 2, 5: 2, 15: 4, 16: 4}
    misses = jops.pack_kmers32(absent)
    miss_bucket = jops._hash_words(misses, len(FILLS), 1)
    queries = to_u64(np_words(np.concatenate([keys, misses])))
    b, g = tops.probe_groups(np_words(table), queries, 4)
    np.testing.assert_array_equal(
        g.numpy(), key_groups + [miss_groups[FILLS[m]] for m in miss_bucket])
    reach = torch.zeros(len(FILLS), dtype=torch.int64)
    reach.scatter_reduce_(0, b, g, reduce="amax")
    assert reach.tolist() == [1, 1, 1, 2, 2, 4, 4, 4]
    assert int(reach.sum()) * 16 * (4 + 1) == 19 * 80


@pytest.mark.parametrize("L", (1, 100, 1000, 9000))
def test_device_annotation_pads_rows(L):
    """Rows padded to a multiple of 4 words, seen as the (R, Lw) view; the
    plain label counts read the view as they read the unpadded rows."""
    rng = np.random.default_rng(L)
    R, N, S = 50, 6, 3
    bitmap = _bitmap(rng, R, L)
    view = DeviceAnnotation.from_bitmap(bitmap, L, "cpu").bitmap
    assert view.shape == bitmap.shape and view.stride(0) % 4 == 0
    np.testing.assert_array_equal(view.numpy().view(np.uint32), bitmap)
    nodes = torch.from_numpy(rng.integers(0, R + 1, (N, qd.TILE))
                             .astype(np.int32))
    tile_seq = torch.tensor([0, 0, 1, 1, 1, 2], dtype=torch.int32)
    want = qd.label_counts(nodes, np_words(bitmap), tile_seq, S, L)
    got = qd.label_counts(nodes, view, tile_seq, S, L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert want[0].sum() > 0
