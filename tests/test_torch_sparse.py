"""The port's block-sparse annotation and its counting against the JAX
package's.

``DeviceBlockSparseAnno.from_matrix``/``from_columns`` build the JAX
arrays, and a ``.devsparse.npz`` written by either package loads in the
other.  ``sparse_counts_plain`` (the plain versions of kernels S1 and S2)
equals JAX ``sparse_count_epoch`` on the CPU, exactly, at canon 0, 1 and 2
and with multiplicities past 2^11; past 2^24 it equals a numpy int64
oracle, where the JAX package's f32 product rounds (ROADMAP's watch-list:
that is the JAX package's inexactness, not a port fault).  The chunked
``sparse_count_epoch`` and the wrappers on CPU tensors equal the plain
version, and a QueryIndex made from a JAX engine's block-sparse state
gives the JAX engine's payloads.  A numpy model of the kernels' order of
work (S1's per-block tallies and flushes as ``label_count_plan`` lays them
out, then S2 row by row) equals JAX ``sparse_count_epoch`` over tau, L,
canon and tile widths, and the device row records hold the JAX package's
``entries`` and ``dmap``.
"""

import io
import pickle

import numpy as np
import pytest
import torch

from metagraph_tpu_torch import convert
from metagraph_tpu_torch.annotation import sparse_device as sd
from metagraph_tpu_torch.query.device import TILE, tile_layout


def random_columns(rng, R, L, n_patterns=3, pattern_rows=40):
    """Columns where most rows carry 0-3 labels and ``pattern_rows`` rows
    carry one of ``n_patterns`` patterns of 6-12 labels."""
    pairs = [(r, int(c)) for r in range(R)
             for c in rng.choice(L, int(rng.integers(0, 4)), replace=False)]
    pats = [rng.choice(L, int(rng.integers(6, 13)), replace=False)
            for _ in range(n_patterns)]
    for r in rng.choice(R, pattern_rows, replace=False):
        pairs += [(int(r), int(c)) for c in pats[int(rng.integers(
            n_patterns))]]
    rows = np.array([p[0] for p in pairs])
    labs = np.array([p[1] for p in pairs])
    return [np.unique(rows[labs == c]) for c in range(L)]


def port_copy(jax_matrix, L, name):
    """A JAX matrix -> the port's, through the port's pickle loader."""
    from metagraph_tpu.annotation.column import LabelEncoder
    from metagraph_tpu.annotation.matrix import StaticAnnotation
    from metagraph_tpu_torch.annotation.matrix import _AnnotationUnpickler
    b = pickle.dumps(StaticAnnotation(
        jax_matrix, LabelEncoder([f"l{c}" for c in range(L)]), name))
    return _AnnotationUnpickler(io.BytesIO(b)).load().matrix


def jax_matrix(kind, cols, R, L, rng):
    from metagraph_tpu.annotation import matrix as M
    if kind == "brwt":
        return M.BRWT.from_columns(cols, R, L)
    if kind == "flat":
        return M.RowFlat.from_columns(cols, R, L)
    # a row-diff over chains of 5 rows (every fifth row an anchor)
    succ = np.where(np.arange(R) % 5 == 4, -1, np.arange(1, R + 1))
    succ[-1] = -1
    anchors = succ < 0
    return M.RowDiff(M.RowFlat.from_columns(cols, R, L), succ, anchors, L)


def same_arrays(port, jax_sp):
    assert port.tau == jax_sp.tau and port.num_labels == jax_sp.num_labels
    for name in ("entries", "dmap", "dense8"):
        a, b = getattr(port, name), np.asarray(getattr(jax_sp, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("tau", (None, 4, 16))
@pytest.mark.parametrize("kind", ("brwt", "row_diff", "flat"))
def test_from_matrix_matches_jax(kind, tau):
    from metagraph_tpu.annotation.sparse_device import \
        DeviceBlockSparseAnno as JaxSparse
    rng = np.random.default_rng(11)
    R, L = 700, 45
    cols = random_columns(rng, R, L)
    jm = jax_matrix(kind, cols, R, L, rng)
    pm = port_copy(jm, L, kind)
    np.testing.assert_array_equal(pm.get_rows_mask(np.arange(R)),
                                  jm.get_rows_mask(np.arange(R)))
    want = JaxSparse.from_matrix(jm, R + 3, tau=tau, chunk=256)
    got = sd.DeviceBlockSparseAnno.from_matrix(pm, R + 3, tau=tau,
                                               chunk=256)
    same_arrays(got, want)
    if tau == 4:
        assert got.dense8.shape[0] > 1        # overflow patterns exist
        Rd = got.dense8.shape[0] - 1
        assert sd.DeviceBlockSparseAnno.from_matrix(
            pm, tau=4, max_dense_bytes=Rd * L - 1) is None
        assert JaxSparse.from_matrix(
            jm, tau=4, max_dense_bytes=Rd * L - 1) is None


@pytest.mark.parametrize("kind", ("brwt", "row_diff", "flat"))
def test_from_matrix_budget_matches_jax(kind):
    """tau from the first rows' sample, which is also the first chunk (not
    decoded again) and whose own overflow patterns may already pass the
    budget: None one byte under the patterns' bytes, as in JAX, and the
    JAX arrays at the budget itself, over several chunks."""
    from metagraph_tpu.annotation.sparse_device import \
        DeviceBlockSparseAnno as JaxSparse
    rng = np.random.default_rng(12)
    R, L = 1500, 45
    cols = random_columns(rng, R, L, n_patterns=5, pattern_rows=120)
    jm = jax_matrix(kind, cols, R, L, rng)
    pm = port_copy(jm, L, kind)
    full = sd.DeviceBlockSparseAnno.from_matrix(pm, chunk=256)
    Rd = full.dense8.shape[0] - 1
    assert Rd > 1
    for budget in (Rd * L - 1, (Rd - 1) * L):
        assert sd.DeviceBlockSparseAnno.from_matrix(
            pm, chunk=256, max_dense_bytes=budget) is None
        assert JaxSparse.from_matrix(
            jm, chunk=256, max_dense_bytes=budget) is None
    same_arrays(sd.DeviceBlockSparseAnno.from_matrix(
        pm, chunk=256, max_dense_bytes=Rd * L),
        JaxSparse.from_matrix(jm, chunk=256, max_dense_bytes=Rd * L))


@pytest.mark.parametrize("tau", (None, 4, 16))
def test_from_columns_matches_jax(tau):
    from metagraph_tpu.annotation.sparse_device import \
        DeviceBlockSparseAnno as JaxSparse
    rng = np.random.default_rng(12)
    R, L = 900, 70
    cols = random_columns(rng, R, L, n_patterns=5)
    same_arrays(sd.DeviceBlockSparseAnno.from_columns(cols, R, L, tau),
                JaxSparse.from_columns(cols, R, L, tau))


@pytest.mark.parametrize("tau", (4, 5, 7, 8, 16))
def test_row_records_hold_jax_entries_and_dmap(tmp_path, tau):
    """The device row records (SparseOnDevice.from_host) of a
    .devsparse.npz that the JAX package wrote hold its entries and dmap:
    the tau label ids, then the slot, in rows of 8 ceil((tau + 1) / 8)
    words; ``entries`` and ``dmap`` are views of them."""
    from metagraph_tpu.annotation.sparse_device import \
        DeviceBlockSparseAnno as JaxSparse
    rng = np.random.default_rng(14 + tau)
    R, L = 400, 33
    JaxSparse.from_columns(random_columns(rng, R, L), R, L, tau).save(
        str(tmp_path / "a.devsparse.npz"))
    jsp = JaxSparse.load(str(tmp_path / "a.devsparse.npz"))
    anno = sd.SparseOnDevice.from_host(
        sd.DeviceBlockSparseAnno.load(str(tmp_path / "a.devsparse.npz")),
        "cpu")
    rec = anno.record.numpy()
    assert rec.shape == (R + 1, 8 * -(-(tau + 1) // 8))
    np.testing.assert_array_equal(rec[:, :tau].view(np.uint32),
                                  np.asarray(jsp.entries))
    np.testing.assert_array_equal(rec[:, tau], np.asarray(jsp.dmap))
    assert not rec[:, tau + 1:].any()
    assert (rec[:, tau] > 0).any() == (tau < 12)    # patterns of 6-12
    assert sd._record_of(anno.entries, anno.dmap).data_ptr() \
        == anno.record.data_ptr()
    assert sd._record_of(anno.entries.contiguous(), anno.dmap) is None


def test_devsparse_files_load_in_both_packages(tmp_path):
    from metagraph_tpu.annotation.sparse_device import \
        DeviceBlockSparseAnno as JaxSparse
    rng = np.random.default_rng(13)
    R, L = 400, 33
    cols = random_columns(rng, R, L)
    jsp = JaxSparse.from_columns(cols, R, L)
    jsp.save(str(tmp_path / "jax.devsparse.npz"))
    same_arrays(sd.DeviceBlockSparseAnno.load(
        str(tmp_path / "jax.devsparse.npz")), jsp)
    sd.DeviceBlockSparseAnno.from_columns(cols, R, L).save(
        str(tmp_path / "port.devsparse.npz"))
    same_arrays(sd.DeviceBlockSparseAnno.load(
        str(tmp_path / "port.devsparse.npz")),
        JaxSparse.load(str(tmp_path / "port.devsparse.npz")))


def _brwt_index(rng, cols, R, L, cache):
    """A port QueryIndex over R random 15-mers and a port BRWT of
    ``cols``, with its block-sparse cache at ``cache``."""
    from metagraph_tpu_torch.annotation.column import LabelEncoder
    from metagraph_tpu_torch.annotation.matrix import BRWT, StaticAnnotation
    from metagraph_tpu_torch.succinct.ops import pack_kmers32
    anno = StaticAnnotation(BRWT.from_columns(cols, R, L),
                            LabelEncoder([f"l{c}" for c in range(L)]),
                            "brwt")
    chars = np.unique(rng.integers(1, 5, (2 * R, 15)), axis=0)
    chars = chars[rng.permutation(len(chars))[:R]].astype(np.uint8)
    return convert.from_annotation(pack_kmers32(chars),
                                   np.arange(1, R + 1, dtype=np.uint32),
                                   anno, 15, R, cache=cache)


@pytest.mark.parametrize("fault", ("label past L", "slot past dense8",
                                   "negative slot"))
def test_out_of_range_block_sparse_refused_and_cache_rebuilt(
        tmp_path, monkeypatch, fault):
    """Kernel S1 writes through the label ids of ``entries`` and the slots
    of ``dmap``: a QueryIndex refuses one out of range, and a
    ``.devsparse.npz`` cache that holds one is rebuilt from the matrix (and
    saved over), as an unreadable cache is."""
    import dataclasses
    rng = np.random.default_rng(15)
    R, L = 400, 33
    cols = random_columns(rng, R, L)
    # past this budget's R * ceil(L/32) * 4 = 3,200 bytes, within Rd * L
    monkeypatch.setenv("METAGRAPH_DENSE_ANNO_BUDGET", "1000")
    cache = str(tmp_path / "a.brwt.annodbg.devsparse.npz")
    index = _brwt_index(rng, cols, R, L, cache)
    good = index.device_anno
    assert isinstance(good, sd.DeviceBlockSparseAnno)
    assert good.dense8.shape[0] > 1
    bad = sd.DeviceBlockSparseAnno(good.entries.copy(), good.dmap.copy(),
                                   good.dense8, good.tau, L)
    if fault == "label past L":
        bad.entries[5, 0] = L + 1
    else:
        bad.dmap[7] = good.dense8.shape[0] if fault == "slot past dense8" \
            else -1
    with pytest.raises(ValueError, match="block-sparse"):
        sd.check_block_sparse(bad, L)
    with pytest.raises(ValueError, match="block-sparse"):
        dataclasses.replace(index, device_anno=bad)
    bad.save(cache)
    again = _brwt_index(np.random.default_rng(15), cols, R, L, cache)
    for got in (again.device_anno, sd.DeviceBlockSparseAnno.load(cache)):
        for name in ("entries", "dmap", "dense8"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(good, name), err_msg=name)


def sparse_pair(rng, R, L, n_patterns=3):
    """The same block-sparse annotation in both packages: (port host, port
    CPU tensors, JAX)."""
    from metagraph_tpu.annotation.sparse_device import \
        DeviceBlockSparseAnno as JaxSparse
    jsp = JaxSparse.from_columns(random_columns(rng, R, L, n_patterns), R, L,
                                 tau=4)
    sp = convert.from_jax_block_sparse(
        np.asarray(jsp.entries), np.asarray(jsp.dmap),
        np.asarray(jsp.dense8), jsp.tau, jsp.num_labels)
    return sp, sd.SparseOnDevice.from_host(sp, "cpu"), jsp


def tiled_ids(rng, R, nwins, canon, offset, overflow_rows=None, tile=TILE):
    """Per-sequence window rows (about 15% misses; from ``overflow_rows``
    only where given) -> the port's (N, ``tile``) node ids (canon 2: a
    third of the hits as reverse-complement ids, id + offset), the JAX
    package's folded rows + 1, and tile_seq."""
    S = len(nwins)
    n = int(sum(nwins))
    pool = np.arange(1, R + 1) if overflow_rows is None \
        else np.asarray(overflow_rows) + 1
    ids = pool[rng.integers(0, len(pool), n)].astype(np.int32)
    ids[rng.random(n) < 0.15] = 0
    seq_ids = np.repeat(np.arange(S, dtype=np.int32), nwins)
    rows1, tile_seq = tile_layout(ids, seq_ids, S, tile=tile, fill=0)
    nodes = rows1.copy()
    if canon == 2:
        rc = (nodes > 0) & (rng.random(nodes.shape) < 0.33)
        nodes[rc] += offset
    return nodes, rows1, tile_seq


def jax_counts(jsp, rows1, tile_seq, S):
    from metagraph_tpu.annotation.sparse_device import sparse_count_epoch
    import jax.numpy as jnp
    c, p = sparse_count_epoch(jsp, jnp.asarray(rows1), jnp.asarray(tile_seq),
                              S, jsp.num_labels)
    return np.asarray(c), np.asarray(p)


def oracle_counts(sp, rows1, tile_seq, S):
    """numpy int64 counts and present from folded rows + 1."""
    L, P = sp.num_labels, sp.dense8.shape[0]
    seq = np.repeat(tile_seq.astype(np.int64), rows1.shape[1])
    ids = rows1.reshape(-1).astype(np.int64)
    counts = np.zeros(S * (L + 1), np.int64)
    mult = np.zeros(S * P, np.int64)
    for lo in range(0, len(ids), 1 << 20):
        i, s = ids[lo: lo + (1 << 20)], seq[lo: lo + (1 << 20)]
        counts += np.bincount((s[:, None] * (L + 1) + sp.entries[i])
                              .reshape(-1), minlength=S * (L + 1))
        mult += np.bincount(s * P + sp.dmap[i], minlength=S * P)
    counts = counts.reshape(S, L + 1)[:, :L]
    mult = mult.reshape(S, P)
    mult[:, 0] = 0
    present = np.bincount(seq[ids > 0], minlength=S)
    return counts + mult @ sp.dense8.astype(np.int64), present


def port_counts(anno, nodes, tile_seq, S, offset):
    c, p = sd.sparse_counts_plain(anno, torch.from_numpy(nodes),
                                  torch.from_numpy(tile_seq), S, offset)
    return c.numpy(), p.numpy()


@pytest.mark.parametrize("L", (45, 64))
@pytest.mark.parametrize("canon", (0, 1, 2))
def test_plain_counts_match_jax_epoch(canon, L):
    rng = np.random.default_rng(20 + canon + L)
    R = 600
    sp, anno, jsp = sparse_pair(rng, R, L)
    nwins = rng.integers(0, 700, 37)
    nwins[5] = 0
    offset = R if canon == 2 else 0
    nodes, rows1, tile_seq = tiled_ids(rng, R, nwins, canon, offset)
    S = len(nwins)
    got = port_counts(anno, nodes, tile_seq, S, offset)
    want = jax_counts(jsp, rows1, tile_seq, S)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].max() > 0
    assert canon != 2 or (nodes > offset).any()


def test_multiplicities_past_2_11_match_jax_and_oracle():
    rng = np.random.default_rng(31)
    R, L = 500, 40
    sp, anno, jsp = sparse_pair(rng, R, L)
    over = np.flatnonzero(sp.dmap[1:] > 0)
    nwins = np.array([300, 5000, 40])
    nodes, rows1, tile_seq = tiled_ids(rng, R, nwins, 0, 0, over)
    got = port_counts(anno, nodes, tile_seq, 3, 0)
    for g, w, o in zip(got, jax_counts(jsp, rows1, tile_seq, 3),
                       oracle_counts(sp, rows1, tile_seq, 3)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)
    assert got[0][1].max() > 2 ** 11


def test_multiplicities_past_2_24_match_oracle():
    """One sequence of 2^24 + 1 windows, every one on the same overflow
    pattern: its labels count 2^24 + 1, which float32 cannot hold (the
    JAX package's f32 product gives 2^24 there)."""
    rng = np.random.default_rng(32)
    R, L = 300, 40
    sp, anno, _ = sparse_pair(rng, R, L, n_patterns=1)
    row = int(np.flatnonzero(sp.dmap > 0)[0])
    n = (1 << 24) + 1
    nodes = np.zeros((-(-n // TILE) + 1, TILE), np.int32)
    nodes[1:].reshape(-1)[:n] = row
    nodes[0, :7] = np.arange(1, 8)
    tile_seq = np.array([0] + [1] * (len(nodes) - 1), np.int32)
    got = port_counts(anno, nodes, tile_seq, 2, 0)
    want = oracle_counts(sp, nodes, tile_seq, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    labels = np.flatnonzero(sp.dense8[sp.dmap[row]])
    assert (got[0][1, labels] == n).all() and int(np.float32(n)) != n


def test_chunked_epoch_and_wrappers_equal_plain(monkeypatch):
    """sparse_count_epoch over chunks of sequences (a small MULT_BYTES), and
    S1 and S2 called alone on CPU tensors, give the plain version's
    counts."""
    rng = np.random.default_rng(33)
    R, L = 800, 50
    sp, anno, _ = sparse_pair(rng, R, L)
    nwins = rng.integers(0, 500, 29)
    nodes, _, tile_seq = tiled_ids(rng, R, nwins, 2, R)
    nt, ts = torch.from_numpy(nodes), torch.from_numpy(tile_seq)
    want = sd.sparse_counts_plain(anno, nt, ts, 29, R)
    monkeypatch.setattr(sd, "MULT_BYTES", 4 * anno.dense8.shape[0] * 4)
    for g, w in zip(sd.sparse_count_epoch(anno, nt, ts, 29, R), want):
        assert torch.equal(g, w)
    counts = torch.zeros((29, L), dtype=torch.int32)
    present = torch.zeros(29, dtype=torch.int32)
    mult = torch.zeros((29, anno.dense8.shape[0]), dtype=torch.int32)
    sd.sparse_label_counts(nt, ts, anno.entries, anno.dmap, counts, present,
                           mult, 0, R)
    assert int(mult.sum()) > 0
    sd.overflow_counts(counts, mult, anno.dense8)
    assert torch.equal(counts, want[0]) and torch.equal(present, want[1])
    with pytest.raises(ValueError, match="bad shapes"):
        sd.sparse_label_counts(nt[:, :100].contiguous(), ts, anno.entries,
                               anno.dmap, counts, present, mult)
    with pytest.raises(ValueError, match="int8"):
        sd.overflow_counts(counts, mult, anno.dense8.int())


@pytest.mark.parametrize("mode", ("labels", "matches", "signature"))
def test_engine_on_jax_block_sparse_state(mode, monkeypatch):
    """A QueryIndex made from a JAX engine's block-sparse state
    (from_jax_block_sparse, from_jax_arrays) gives the JAX engine's
    payloads, kernels S1 and S2 (their plain versions) counting."""
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu.annotation.matrix import BRWT, StaticAnnotation
    from metagraph_tpu.annotation.sparse_device import \
        DeviceBlockSparseAnno as JaxSparse
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu.query.pipeline import QueryEngine as JaxEngine
    from metagraph_tpu_torch.annotation.matrix import _AnnotationUnpickler
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    monkeypatch.setenv("METAGRAPH_DENSE_ANNO_BUDGET", "0")
    rng = np.random.default_rng(40)
    refs = ["".join(rng.choice(list("ACGT"), size=300)).encode()
            for _ in range(5)]
    g = DBGSuccinct.build(refs, 17)
    cols = ColumnMajorAnnotation(g.max_index())
    ag = AnnotatedDBG(g, cols)
    for i, s in enumerate(refs):
        ag.annotate_sequence(s, [f"s{i}"])
    cols.freeze()
    L = cols.num_labels
    anno = StaticAnnotation(BRWT.from_columns(
        [cols.column_rows(c) for c in range(L)], cols.num_rows, L),
        cols.encoder, "brwt")
    jax_engine = JaxEngine(AnnotatedDBG(g, anno), use_device=True)
    queries = [s[i * 9: i * 9 + 100] for i, s in enumerate(refs)] \
        + [refs[0][:40] + b"NN" + refs[1][:90], b"ACGT" * 30]
    assert jax_engine.query_batch_fused(queries, mode, 3, 0.6, 0.0) is None
    want = jax_engine.execute_batch(jax_engine.map_batch(queries), mode, 3,
                                    0.6, 0.0)
    jsp = jax_engine._build_device_annotation()
    assert isinstance(jsp, JaxSparse)
    jax_engine._build_device_index()
    sp = convert.from_jax_block_sparse(
        np.asarray(jsp.entries), np.asarray(jsp.dmap),
        np.asarray(jsp.dense8), jsp.tau, jsp.num_labels)
    port_anno = _AnnotationUnpickler(io.BytesIO(pickle.dumps(anno))).load()
    index = convert.from_jax_arrays(
        np.asarray(jax_engine._device_index.table), sp, port_anno.labels,
        17, g.max_index(), port_anno)
    engine = QueryEngine(index, device="cpu")
    assert isinstance(engine.annotation, sd.SparseOnDevice)
    got = engine.query_batch(queries, mode, 3, 0.6, 0.0)

    def norm(p):
        return [[(t[0], t[1], t[2].tolist()) if isinstance(t, tuple)
                 and len(t) == 3 else t for t in r] for r in p]
    assert norm(got) == norm(want) and any(got)


def direct_pair(rng, R, L, tau, n_patterns=3, pattern_rows=40):
    """The same block-sparse annotation in both packages, made directly
    from arrays (any L, quickly): each row 0..tau distinct random labels,
    ``pattern_rows`` rows on one of ``n_patterns`` patterns of 6-12 labels
    -> (port host, port CPU tensors, JAX)."""
    import jax.numpy as jnp
    from metagraph_tpu.annotation.sparse_device import \
        DeviceBlockSparseAnno as JaxSparse
    entries = np.full((R + 1, tau), L, np.uint32)
    n = rng.integers(0, tau + 1, R)
    for r in np.flatnonzero(n):
        entries[r + 1, :n[r]] = np.sort(rng.choice(L, n[r], replace=False))
    dmap = np.zeros(R + 1, np.int32)
    prow = rng.choice(np.arange(1, R + 1), pattern_rows, replace=False)
    entries[prow] = L
    dmap[prow] = rng.integers(1, n_patterns + 1, pattern_rows)
    dense8 = np.zeros((n_patterns + 1, L), np.int8)
    for d in range(1, n_patterns + 1):
        dense8[d, rng.choice(L, int(rng.integers(6, 13)), replace=False)] = 1
    sp = convert.from_jax_block_sparse(entries, dmap, dense8, tau, L)
    jsp = JaxSparse(jnp.asarray(entries), jnp.asarray(dmap),
                    jnp.asarray(dense8), tau, L)
    return sp, sd.SparseOnDevice.from_host(sp, "cpu"), jsp


def kernel_model(sp, nodes, tile_seq, S, offset, grid=5):
    """numpy model of the order of work of kernel S1, then S2.  Block b of
    ``grid`` walks the tiles [N b / grid, N (b+1) / grid) in steps of the
    plan's threads, tallies each step's keys (label l is key l, pattern d
    key L + d) and hits for the sequence it is on, and flushes them (one
    add a distinct key) when the sequence changes, before a step could take
    the hashed table past 3/4 full, and at the end of its range.  Then S2
    adds each row's non-zero multiplicities times their patterns, row by
    row.  Asserts that no flush holds more distinct keys than the plan's
    table takes."""
    L, P, tau = sp.num_labels, sp.dense8.shape[0], sp.tau
    N, T = nodes.shape
    plan = sd.label_count_plan(T, tau, L, P)
    cap = plan.slots // 4 * 3 if plan.hashed else plan.slots
    entries, dmap = sp.entries.astype(np.int64), sp.dmap.astype(np.int64)
    counts = np.zeros((S, L), np.int64)
    present = np.zeros(S, np.int64)
    mult = np.zeros((S, P), np.int64)
    flushes = []

    def flush(seq, keys, hits):
        k, c = np.unique(np.concatenate(keys or [np.zeros(0, np.int64)]),
                         return_counts=True)
        assert len(k) <= cap
        lab = k < L
        counts[seq, k[lab]] += c[lab]
        mult[seq, k[~lab] - L] += c[~lab]
        present[seq] += hits
        flushes.append(len(k))

    for b in range(grid):
        keys, hits, used, cur = [], 0, 0, None
        for t in range(N * b // grid, N * (b + 1) // grid):
            seq = int(tile_seq[t])
            if seq != cur:
                if cur is not None and 0 <= cur < S:
                    flush(cur, keys, hits)
                keys, hits, used, cur = [], 0, 0, seq
            if not 0 <= seq < S:
                continue
            for base in range(0, T, plan.threads):
                if plan.hashed and used + plan.step_keys > cap:
                    flush(seq, keys, hits)
                    keys, hits, used = [], 0, 0
                used += plan.step_keys
                ids = nodes[t, base: base + plan.threads].astype(np.int64)
                if offset:
                    ids = np.where(ids > offset, ids - offset, ids)
                ids = np.where((ids < 0) | (ids >= len(entries)), 0, ids)
                labs, d = entries[ids].reshape(-1), dmap[ids]
                keys += [labs[labs < L], L + d[(d > 0) & (d < P)]]
                hits += int((ids > 0).sum())
        if cur is not None and 0 <= cur < S:
            flush(cur, keys, hits)
    for s in range(S):
        for d in np.flatnonzero(mult[s, 1:]) + 1:
            counts[s] += mult[s, d] * sp.dense8[d].astype(np.int64)
    return counts, present, plan, flushes


@pytest.mark.parametrize("T", (32, 256))
@pytest.mark.parametrize("canon", (0, 2))
@pytest.mark.parametrize("L", (33, 4096, 70_000))
@pytest.mark.parametrize("tau", (4, 7, 16))
def test_kernel_order_model_and_plain_match_jax(tau, L, canon, T):
    """The model of S1's per-block tally and flushes and S2's rows, and the
    plain versions, against JAX ``sparse_count_epoch``, exactly; sequences
    span several tiles and the blocks' ranges split them."""
    rng = np.random.default_rng(tau * 100_003 + L + 7 * canon + T)
    R, S = 300, 23
    sp, anno, jsp = direct_pair(rng, R, L, tau)
    offset = R if canon == 2 else 0
    nwins = rng.integers(0, 3 * T, S)
    nwins[3], nwins[11] = 0, 9 * T + 5
    nodes, rows1, tile_seq = tiled_ids(rng, R, nwins, canon, offset, tile=T)
    want = jax_counts(jsp, rows1, tile_seq, S)
    counts, present, plan, flushes = kernel_model(sp, nodes, tile_seq, S,
                                                  offset)
    assert plan.hashed == (L == 70_000) and plan.threads == min(T, 256)
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(present, want[1])
    for g, w in zip(port_counts(anno, nodes, tile_seq, S, offset), want):
        np.testing.assert_array_equal(g, w)
    assert want[0].max() > 0 and len(flushes) >= S - 1


@pytest.mark.parametrize("T, tau, L, P, hashed, threads, slots", (
    (256, 4, 4096, 17, False, 256, 4113),
    (32, 16, 8000, 192, False, 32, 8192),
    (256, 4, 65_536, 17, True, 256, 2048),
    (256, 16, 70_000, 4, True, 256, 8192),
    (512, 7, 8192, 1, True, 256, 4096),
    (96, 40, 10_000, 9, True, 96, 8192),
    (256, 100, 10_000, 9, True, 96, 16384),
))
def test_label_count_plan(T, tau, L, P, hashed, threads, slots):
    """S1's plan: dense up to DENSE_BINS keys, else a power-of-two table
    that holds a step's keys at 3/4 load, with fewer threads where a
    block's table would pass S1_SMEM."""
    plan = sd.label_count_plan(T, tau, L, P)
    assert (plan.hashed, plan.threads, plan.slots) == (hashed, threads,
                                                       slots)
    assert plan.step_keys == threads * (tau + 1)
    assert plan.smem <= sd.S1_SMEM and plan.threads % 32 == 0
    if hashed:
        assert plan.step_keys <= plan.slots // 4 * 3 < plan.slots <= 65_536
    else:
        assert plan.slots == L + P <= sd.DENSE_BINS


@pytest.mark.parametrize("args", ((33, 4, 100, 2), (256, 0, 100, 2),
                                  (256, 2000, 70_000, 2)))
def test_label_count_plan_refuses(args):
    with pytest.raises(ValueError):
        sd.label_count_plan(*args)
