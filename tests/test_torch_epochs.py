"""The older counting epochs and the dedup epoch (ROADMAP A10) against the
JAX package, on the CPU.

Three annotated graphs: DNA k = 11 basic and canonical (4-bit keys) and
Protein k = 6 (8-bit keys), each built and annotated by the JAX package
and loaded by the port from its files.  Every function of the port's
``succinct/ops.py`` (``DeviceHashIndex.from_packed``, ``lookup``),
``annotation/ops.py`` (``DeviceAnnotation.from_column_annotation``,
``count_labels``, ``count_labels_sorted``, ``count_labels_matmul``) and
``query/device.py`` (``query_step``, ``query_epoch``,
``query_epoch_tiled``, ``query_epoch_codes``, ``count_epoch_tiled``,
``select_mask_epoch``, ``gather_flat``, ``pad_tile_rows``,
``tile_codes_layout``, ``_rowmin_packed``, ``DeviceQueryPipeline``,
``query_epoch_dedup``, ``dedup_batch``) and ``entry.entry`` is held to
its JAX counterpart on the same inputs: the same arrays and values (the
JAX float32 counts of ``count_labels_matmul`` compared as integers, all
below 2^24; the JAX epochs' padding rows left out).  The JAX
``prepare_batch`` runs its native packer, so the JAX native library is
built first.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from metagraph_tpu.annotation import ops as jax_anno_ops
from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
from metagraph_tpu.annotation.column import ColumnMajorAnnotation as JaxCols
from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu.kmer.alphabets import ALPHABETS
from metagraph_tpu.query import device as jqd
from metagraph_tpu_torch.annotation import ops as anno_ops
from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
from metagraph_tpu_torch.query import device as qd
from metagraph_tpu_torch.succinct import ops

from test_torch_canonical import native_lib

CONFIGS = {"dna-basic": ("DNA", "basic", 11, "ACGT"),
           "dna-canonical": ("DNA", "canonical", 11, "ACGT"),
           "protein": ("Protein", "basic", 6, "ACDEFGHIKLMNPQRSTVWY")}
DNA_CONFIGS = ("dna-basic", "dna-canonical")


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).view(
        np.int32).copy())


def _np(t):
    return t.numpy()


_CASES = {}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request, tmp_path_factory):
    return _case(request.param, tmp_path_factory)


@pytest.fixture(scope="module", params=DNA_CONFIGS)
def dna_case(request, tmp_path_factory):
    return _case(request.param, tmp_path_factory)


def _case(name, tmp_path_factory):
    if name not in _CASES:
        _CASES[name] = _build_case(name, tmp_path_factory)
    return _CASES[name]


def _build_case(name, tmp_path_factory):
    assert native_lib() is not None, "the JAX native library does not load"
    alpha, mode, k, letters = CONFIGS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    refs = ["".join(rng.choice(list(letters), size=int(n))).encode()
            for n in rng.integers(150, 400, 9)]
    g = JaxDBG.build(refs, k, mode=mode, alphabet=ALPHABETS[alpha])
    anno = JaxCols(g.max_index())
    ag = AnnotatedDBG(g, anno)
    for i, s in enumerate(refs):
        ag.annotate_sequence(s, [f"L{i % 5}", f"R{i}"])
    anno.freeze()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i, s in enumerate(refs):
        a = int(rng.integers(0, len(s) - 120))
        r = s[a: a + int(rng.integers(40, 120))]
        if alpha == "DNA" and i % 3 == 1:
            r = r.translate(comp)[::-1]
        if i % 4 == 2:
            r = r[:15] + b"N" * 3 + r[18:]
        reads.append(r)
    reads += [refs[0][:5], refs[1][:k], refs[2] + refs[3][:40]]
    tmp = tmp_path_factory.mktemp(name)
    g.save(str(tmp / "g"))
    port_g = DBGSuccinct.load(str(tmp / "g.dbg"))
    L = anno.num_labels
    port_anno = ColumnMajorAnnotation(
        anno.num_rows, [anno.encoder.decode(i) for i in range(L)],
        [anno.column_rows(i) for i in range(L)])
    jpipe = jqd.DeviceQueryPipeline(g, anno)
    pipe = qd.DeviceQueryPipeline(port_g, port_anno, device="cpu")
    return dict(name=name, k=k, alpha=alpha, g=g, anno=anno, reads=reads,
                jpipe=jpipe, pipe=pipe, L=L, rng=rng)


def test_hash_index_and_bitmap(case):
    jp, p = case["jpipe"], case["pipe"]
    assert np.array_equal(p.index_keys, jp.index_keys)
    assert np.array_equal(p.index_ids, jp.index_ids)
    assert np.array_equal(p.index.table.numpy().view(np.uint32),
                          np.asarray(jp.index.table))
    assert p.index.W == jp.index.W
    again = ops.DeviceHashIndex.from_packed(jp.index_keys, jp.index_ids,
                                           device="cpu")
    assert torch.equal(again.table, p.index.table)
    R = case["g"].max_index()
    assert np.array_equal(p.annotation.bitmap.numpy().view(np.uint32),
                          jp.annotation.unpacked()[:R])
    assert p.annotation.num_labels == jp.annotation.num_labels == case["L"]


def test_lookup_of_padding_and_keys(case):
    """``lookup`` of every index key, of keys not in it and of the
    all-EMPTY_WORD padding row: the JAX ids (its -1 or 0 for the
    padding)."""
    jp, p = case["jpipe"], case["pipe"]
    rng = case["rng"]
    keys = jp.index_keys
    miss = keys[rng.integers(0, len(keys), 50)] ^ np.uint32(0x10000000)
    pad = np.full((3, keys.shape[1]), 0xFFFFFFFF, np.uint32)
    q = np.concatenate([keys, miss, pad])[rng.permutation(len(keys) + 53)]
    want = np.asarray(jp.index.lookup(jnp.asarray(q)))
    got = p.index.lookup(_i32(q))
    assert got.dtype == torch.int32 and np.array_equal(_np(got), want)
    # a table whose padding bucket is full answers 0 for the padding row
    assert ops.sentinel_answer(p.index.table) in (-1, 0)


@pytest.mark.parametrize("fn", ("count_labels", "count_labels_sorted",
                                "count_labels_matmul"))
def test_flat_counts(case, fn):
    rng = case["rng"]
    R, L = case["g"].max_index(), case["L"]
    bitmap_j = case["jpipe"].annotation.bitmap
    bitmap = case["pipe"].annotation.bitmap
    Q, S = 3000, 37
    nodes = rng.integers(-1, R + 1, Q).astype(np.int32)
    nodes[rng.random(Q) < 0.2] = 0
    sid = np.sort(rng.integers(0, S, Q)).astype(np.int32)
    if fn != "count_labels_sorted":
        sid = rng.permutation(sid)
    wc, wp = getattr(jax_anno_ops, fn)(bitmap_j, jnp.asarray(nodes),
                                       jnp.asarray(sid), S, L)
    gc, gp = getattr(anno_ops, fn)(bitmap, torch.from_numpy(nodes),
                                   torch.from_numpy(sid), S, L)
    assert gc.dtype == gp.dtype == torch.int32
    assert np.array_equal(_np(gc), np.asarray(wc).astype(np.int64))
    assert np.array_equal(_np(gp), np.asarray(wp).astype(np.int64))
    assert _np(gc).sum() > 100


def test_count_labels_drops_ids_outside_the_batch(case):
    """segment_sum drops sequence ids outside [0, S); so does the port."""
    rng = case["rng"]
    R, L = case["g"].max_index(), case["L"]
    nodes = rng.integers(1, R + 1, 500).astype(np.int32)
    sid = rng.integers(-3, 12, 500).astype(np.int32)
    wc, wp = jax_anno_ops.count_labels(case["jpipe"].annotation.bitmap,
                                       jnp.asarray(nodes), jnp.asarray(sid),
                                       9, L)
    gc, gp = anno_ops.count_labels(case["pipe"].annotation.bitmap,
                                   torch.from_numpy(nodes),
                                   torch.from_numpy(sid), 9, L)
    assert np.array_equal(_np(gc), np.asarray(wc))
    assert np.array_equal(_np(gp), np.asarray(wp))


def test_flat_tiles_lay_out_each_sequence(case):
    rng = case["rng"]
    nodes = rng.integers(0, 99, 2000).astype(np.int32)
    sid = np.sort(rng.integers(0, 30, 2000)).astype(np.int32)
    want, wseq = jqd.tile_layout(nodes, sid, 30, fill=0)
    got, gseq = anno_ops.flat_tiles(torch.from_numpy(nodes),
                                    torch.from_numpy(sid), 30, qd.TILE)
    assert np.array_equal(_np(got), want) and np.array_equal(_np(gseq), wseq)
    perm = rng.permutation(2000)
    mixed, mseq = anno_ops.flat_tiles(torch.from_numpy(nodes[perm]),
                                      torch.from_numpy(sid[perm]), 30,
                                      qd.TILE)
    assert np.array_equal(_np(mseq), wseq)
    for t in range(len(wseq)):            # each tile: the same multiset
        assert sorted(_np(mixed[t])) == sorted(want[t])


@pytest.fixture(scope="module")
def batch(case):
    """The JAX and the port's packing of the reads, and the JAX query_step
    on them."""
    jp, p = case["jpipe"], case["pipe"]
    reads = case["reads"]
    want = jp.prepare_batch(reads)
    got = p.prepare_batch(reads)
    return dict(want=want, got=got, S=len(reads))


def test_prepare_batch(case, batch):
    (wq, ws, wn), (gq, gs, gn) = batch["want"], batch["got"]
    assert gq.dtype == wq.dtype == np.uint32 and gs.dtype == ws.dtype
    assert np.array_equal(gq, wq) and np.array_equal(gs, ws) and gn == wn
    # DNA reads hold invalid windows (N); Protein maps N and any unknown
    # byte to a letter
    assert (gq == 0xFFFFFFFF).all(axis=1).any() \
        == (case["name"] in DNA_CONFIGS)


def test_query_step(case, batch):
    jp, p = case["jpipe"], case["pipe"]
    q, sid, _ = batch["want"]
    S, L = batch["S"], case["L"]
    wc, wp, wn = jqd.query_step(jp.index.table, jp.annotation.bitmap,
                                jnp.asarray(q), jnp.asarray(sid), S, L)
    gc, gp, gn = qd.query_step(p.index.table, p.annotation.bitmap, _i32(q),
                               torch.from_numpy(sid), S, L)
    for g, w in ((gc, wc), (gp, wp), (gn, wn)):
        assert g.dtype == torch.int32 and np.array_equal(_np(g), np.asarray(w))
    assert _np(gp).sum() > 50


def test_query_epoch(case, batch):
    jp, p = case["jpipe"], case["pipe"]
    q, sid, _ = batch["want"]
    S, L = batch["S"], case["L"]
    wc, wp = jqd.query_epoch(jp.index.table, jp.annotation.bitmap,
                             jnp.asarray(q), jnp.asarray(sid), S, L,
                             chunk=256)
    gc, gp = qd.query_epoch(p.index.table, p.annotation.bitmap, _i32(q),
                            torch.from_numpy(sid), S, L, chunk=256)
    assert np.array_equal(_np(gc), np.asarray(wc))
    assert np.array_equal(_np(gp), np.asarray(wp))


def test_query_epoch_tiled_and_count_epoch_tiled(case, batch):
    jp, p = case["jpipe"], case["pipe"]
    q, sid, _ = batch["want"]
    S, L = batch["S"], case["L"]
    tiles, tile_seq = jqd.tile_layout(q, sid, S, tile=64)
    N = len(tile_seq)
    wc, wp, wn = jqd.query_epoch_tiled(jp.index.table, jp.annotation.bitmap,
                                       jnp.asarray(tiles),
                                       jnp.asarray(tile_seq), S, L)
    gc, gp, gn = qd.query_epoch_tiled(
        p.index.table, p.annotation.bitmap, _i32(tiles),
        torch.from_numpy(tile_seq), S, L)
    assert np.array_equal(_np(gc), np.asarray(wc))
    assert np.array_equal(_np(gp), np.asarray(wp))
    assert np.array_equal(_np(gn), np.asarray(wn)[:N])
    rows = np.maximum(np.asarray(wn)[:N], 0).astype(np.int32)
    wc2, wp2 = jqd.count_epoch_tiled(jp.annotation.bitmap, jnp.asarray(rows),
                                     jnp.asarray(tile_seq), S, L)
    gc2, gp2 = qd.count_epoch_tiled(p.annotation.bitmap,
                                    torch.from_numpy(rows),
                                    torch.from_numpy(tile_seq), S, L)
    assert np.array_equal(_np(gc2), np.asarray(wc2))
    assert np.array_equal(_np(gp2), np.asarray(wp2))


@pytest.mark.parametrize("tile", (32, 256))
def test_query_epoch_codes(dna_case, tile):
    """Code tiles hold DNA codes (5 and above invalid)."""
    case = dna_case
    jp, p = case["jpipe"], case["pipe"]
    ex = case["g"].extractor
    codes = [ex.encode(r) for r in case["reads"]]
    k, S, L = case["k"], len(codes), case["L"]
    want_t = jqd.tile_codes_layout(codes, k, tile)
    got_t = qd.tile_codes_layout(codes, k, tile)
    assert np.array_equal(got_t[0], want_t[0])
    assert np.array_equal(got_t[1], want_t[1]) and got_t[2] == want_t[2]
    ct, ts, _ = want_t
    wc, wp, wn = jqd.query_epoch_codes(jp.index.table, jp.annotation.bitmap,
                                       jnp.asarray(ct), jnp.asarray(ts), S,
                                       L, k)
    gc, gp, gn = qd.query_epoch_codes(p.index.table, p.annotation.bitmap,
                                      torch.from_numpy(ct),
                                      torch.from_numpy(ts), S, L, k)
    assert np.array_equal(_np(gc), np.asarray(wc))
    assert np.array_equal(_np(gp), np.asarray(wp))
    assert np.array_equal(_np(gn), np.asarray(wn)[:len(ts)])


def test_select_mask_and_gather_flat(case):
    rng = case["rng"]
    counts = rng.integers(0, 9, (23, 70)).astype(np.int32)
    dmin = rng.integers(1, 9, 23).astype(np.int32)
    want = np.asarray(jqd.select_mask_epoch(jnp.asarray(counts),
                                            jnp.asarray(dmin)))
    got = qd.select_mask_epoch(torch.from_numpy(counts),
                               torch.from_numpy(dmin))
    assert np.array_equal(_np(got).view(np.uint32), want)
    idx = rng.integers(0, counts.size, 40).astype(np.int32)
    assert np.array_equal(
        _np(qd.gather_flat(torch.from_numpy(counts), torch.from_numpy(idx))),
        np.asarray(jqd.gather_flat(jnp.asarray(counts), jnp.asarray(idx))))


def test_host_helpers():
    for n in (0, 1, 5, 37, 1000, 123457):
        for C in (1, 64, 512):
            assert qd.pad_tile_rows(n, C) == jqd.pad_tile_rows(n, C)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, (200, 3)).astype(np.uint32)
    b = rng.integers(0, 4, (200, 3)).astype(np.uint32)
    assert np.array_equal(qd._rowmin_packed(a, b), jqd._rowmin_packed(a, b))
    assert np.array_equal(
        qd._rowmin_rows(torch.from_numpy(a.astype(np.int64)),
                        torch.from_numpy(b.astype(np.int64))).numpy(),
        jqd._rowmin_packed(a, b))
    assert qd.tile_codes_layout([], 11)[0].shape == (0, 266)


@pytest.mark.parametrize("mode", ("labels", "matches"))
def test_query_labels(case, mode):
    want = case["jpipe"].query_labels(case["reads"], mode, 2, 0.6, 0.1)
    got = case["pipe"].query_labels(case["reads"], mode, 2, 0.6, 0.1)
    assert got == want and sum(map(len, want)) > 5


def test_dedup_batch_and_epoch(case, batch):
    jp, p = case["jpipe"], case["pipe"]
    q, sid, _ = batch["want"]
    S, L = batch["S"], case["L"]
    # repeated reads, so that windows repeat across sequences
    q2 = np.concatenate([q, q[: len(q) // 2]])
    sid2 = np.concatenate([sid, sid[: len(sid) // 2] + S]).astype(np.int32)
    S2 = 2 * S
    want = jqd.dedup_batch(q2, sid2, S2, tile=64)
    got = qd.dedup_batch(q2, sid2, S2, tile=64, device="cpu")
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3] < len(q2)
    dk, dt, ts, _ = want
    wc, wp = jqd.query_epoch_dedup(jp.index.table, jp.annotation.bitmap,
                                   jnp.asarray(dk), jnp.asarray(dt),
                                   jnp.asarray(ts), S2, L)
    gc, gp = qd.query_epoch_dedup(p.index.table, p.annotation.bitmap,
                                  _i32(dk), torch.from_numpy(dt),
                                  torch.from_numpy(ts), S2, L)
    assert np.array_equal(_np(gc), np.asarray(wc))
    assert np.array_equal(_np(gp), np.asarray(wp))
    # the same counts as the per-window epoch
    tiles, tile_seq = jqd.tile_layout(q2, sid2, S2, tile=64)
    tc, tp, _ = qd.query_epoch_tiled(p.index.table, p.annotation.bitmap,
                                     _i32(tiles), torch.from_numpy(tile_seq),
                                     S2, L)
    assert torch.equal(tc, gc) and torch.equal(tp, gp)


def test_dedup_of_padding_only_and_empty():
    q = np.full((5, 2), 0xFFFFFFFF, np.uint32)
    sid = np.array([0, 0, 1, 1, 1], np.int32)
    for qq, ss in ((q, sid), (q[:0], sid[:0])):
        want = jqd.dedup_batch(qq, ss, 2)
        got = qd.dedup_batch(qq, ss, 2, device="cpu")
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g, w) and g.shape == w.shape
        assert got[3] == want[3] == 0


def test_entry_matches_the_graft_entry():
    import __graft_entry__ as graft
    from metagraph_tpu_torch.entry import entry
    jfn, jargs = graft.entry()
    fn, args = entry(device="cpu")
    # the table and the packed batch (the JAX bitmap is row-packed)
    for i in (0, 2):
        assert np.array_equal(_np(args[i]).view(np.uint32),
                              np.asarray(jargs[i]))
    assert np.array_equal(_np(args[3]), np.asarray(jargs[3]))
    for g, w in zip(fn(*args), jfn(*jargs)):
        assert np.array_equal(_np(g), np.asarray(w))


def test_new_entry_points_need_cuda(monkeypatch, tmp_path):
    """``entry``, ``DeviceQueryPipeline``, ``DeviceHashIndex.from_packed``,
    ``dedup_batch`` and ``build_graph`` run on the card unless asked for
    the CPU."""
    from metagraph_tpu_torch.entry import entry, tiny_annotated_graph
    from metagraph_tpu_torch.graph import build_graph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.array([[0x11111111]], dtype=np.uint32)
    q = np.full((2, 1), 0xFFFFFFFF, np.uint32)
    for call in (entry, lambda: tiny_annotated_graph(),
                 lambda: ops.DeviceHashIndex.from_packed(keys, [1]),
                 lambda: qd.dedup_batch(keys, np.zeros(1, np.int32), 1),
                 lambda: build_graph("hash", [b"ACGTACGT"], 5)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    g, anno, _ = tiny_annotated_graph(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qd.DeviceQueryPipeline(g, anno)
    assert qd.dedup_batch(q, np.zeros(2, np.int32), 1, device="cpu")[3] == 0
