"""The port's sharded query (metagraph_tpu_torch/parallel) against
metagraph_tpu/parallel/sharding.py.

The JAX side runs in this process on conftest's eight virtual CPU devices;
the port's ranks run as fresh interpreters over gloo on the CPU
(``parallel/launch.launch``), one launch a mesh shape serving every step:
the dense annotated step (the host step on the host mesh), the sharded
lookup and the compressed step with and without row-diff.  Each rank
fails if it imported jax or metagraph_tpu.  Every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
from metagraph_tpu.annotation.column import ColumnMajorAnnotation
from metagraph_tpu.annotation.matrix import RowDiff as JRowDiff
from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
from metagraph_tpu.parallel import sharding as jsh
from metagraph_tpu.query.device import DeviceQueryPipeline
from metagraph_tpu.succinct import ops as jops
from metagraph_tpu_torch.annotation import device_matrix as dm
from metagraph_tpu_torch.parallel import sharding as tsh
from metagraph_tpu_torch.parallel.launch import launch
from metagraph_tpu_torch.parallel.mesh import assemble, collective_counts

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

L_COMPRESSED = 70      # labels of the compressed step (2 words a shard)
PROGRAM = "metagraph_tpu_torch.parallel.programs:sharded_query"


@pytest.fixture(scope="module", autouse=True)
def one_thread_ranks():
    """The ranks start from this environment: one thread each, so that
    four ranks beside other test workers do not oversubscribe the CPU."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if old is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = old


@pytest.fixture(scope="module")
def world():
    """The JAX test's tiny graph and annotation, the compressed columns,
    their row-diff routing and diff columns, and the query batch parts."""
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGT"), size=150 + 17 * i)).encode()
            for i in range(5)]
    g = DBGSuccinct.build(seqs, 11)
    anno = ColumnMajorAnnotation(g.max_index())
    ag = AnnotatedDBG(g, anno)
    for i, s in enumerate(seqs):
        ag.annotate_sequence(s, [f"s{i}"])
        ag.annotate_sequence(s[: 60 + i], [f"extra{i % 2}"])
    pipe = DeviceQueryPipeline(g, anno)
    R = g.max_index()
    crng = np.random.default_rng(11)
    columns = [np.flatnonzero(crng.random(R) < 0.05)
               for _ in range(L_COMPRESSED)]
    succ, anchors = JRowDiff.build_routing(g, max_length=10)
    dense = np.zeros((R, L_COMPRESSED), dtype=bool)
    for c, col in enumerate(columns):
        dense[col, c] = True
    shifted = np.zeros_like(dense)
    has = succ >= 0
    shifted[has] = dense[succ[has]]
    diff = np.where(anchors[:, None], dense, dense ^ shifted)
    diff_cols = [np.flatnonzero(diff[:, c]) for c in range(L_COMPRESSED)]
    depth = np.zeros(R, np.int64)
    for _ in range(R + 1):
        nd = np.where(anchors | (succ < 0), 0,
                      depth[np.maximum(succ, 0)] + 1)
        if np.array_equal(nd, depth):
            break
        depth = nd
    return dict(g=g, anno=anno, seqs=seqs, pipe=pipe, columns=columns,
                diff_cols=diff_cols, succ=succ.astype(np.int32),
                anchors=np.asarray(anchors, bool),
                rd_max_depth=int(depth.max()) + 1, dense=dense)


def _jmesh(shape):
    names = ("host", "data", "model")[-len(shape):]
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return JMesh(devs, names)


def _csr(cols):
    ptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    rows = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    return ptr.astype(np.int64), rows.astype(np.int64)


def _batch(w, data, width_of=lambda s: len(s)):
    """One sequence a data shard of uneven lengths, its windows padded to
    one width with all-ones keys (seq id 0, shard-local)."""
    g, pipe, seqs = w["g"], w["pipe"], w["seqs"]
    qseqs = [seqs[i % len(seqs)][: 40 + 13 * (i % 3)] for i in range(data)]
    width = max(len(s) - g.k + 1 for s in qseqs)
    qp, sp = [], []
    for s in qseqs:
        q, sid, _ = pipe.prepare_batch([s])
        qp.append(jsh.pad_rows(q, width, fill=np.iinfo(np.uint32).max))
        sp.append(jsh.pad_rows(sid, width, fill=0))
    return qseqs, np.concatenate(qp), np.concatenate(sp)


def _jax_dense(w, mesh, queries, seq_ids, host):
    table = np.asarray(w["pipe"].index.table)
    shard = jsh.shard_hash_table_host if host else jsh.shard_hash_table
    tsd, rows_per, nb = shard(table, mesh)
    bsd, Ls = jsh.shard_annotation(w["pipe"].annotation.unpacked(), mesh)
    data = mesh.shape["data"]
    q_d = jax.device_put(queries, NamedSharding(mesh, P("data", None)))
    s_d = jax.device_put(seq_ids, NamedSharding(mesh, P("data")))
    if host:
        step = jsh.sharded_annotated_query_fn_host(mesh, rows_per, Ls, data,
                                                   nb)
    else:
        step = jsh.sharded_annotated_query_fn(mesh, rows_per, Ls, data,
                                              n_buckets=nb)
    counts, present = step(tsd, bsd, q_d, s_d)
    return np.asarray(counts), np.asarray(present)


def _jax_compressed(w, mesh, queries, seq_ids, row_diff, rd_max_depth):
    g = w["g"]
    R = g.max_index()
    table = np.asarray(w["pipe"].index.table)
    tsd, rows_per, nb = jsh.shard_hash_table(table, mesh)
    cols = w["diff_cols"] if row_diff else w["columns"]
    sb = jsh.shard_brwt_annotation(cols, R, L_COMPRESSED, mesh)
    data = mesh.shape["data"]
    step = jsh.sharded_annotated_query_compressed_fn(
        mesh, rows_per, sb.labels_per_shard, data, nb, sb.depth,
        row_diff=row_diff, rd_max_depth=rd_max_depth)
    args = [tsd, *sb.device_arrays(mesh)]
    if row_diff:
        args += [jax.device_put(jnp.asarray(w["succ"])),
                 jax.device_put(jnp.asarray(w["anchors"]))]
    q_d = jax.device_put(queries, NamedSharding(mesh, P("data", None)))
    s_d = jax.device_put(seq_ids, NamedSharding(mesh, P("data")))
    counts, present = step(*args, q_d, s_d)
    return np.asarray(counts), np.asarray(present), sb


def _port(w, shape, queries, seq_ids, rd_max_depth, lookup=None,
          compressed=True):
    g = w["g"]
    inputs = dict(queries=queries, seq_ids=seq_ids,
                  num_seqs=shape["data"],
                  table=np.asarray(w["pipe"].index.table),
                  bitmap=np.asarray(w["pipe"].annotation.unpacked()))
    if lookup is not None:
        inputs.update(keys=lookup[0], ids=lookup[1],
                      lookup_queries=lookup[2])
    if compressed:
        cp, cr = _csr(w["columns"])
        dp, dr = _csr(w["diff_cols"])
        inputs.update(col_ptr=cp, col_rows=cr, diff_ptr=dp, diff_rows=dr,
                      succ=w["succ"], anchors=w["anchors"],
                      rd_max_depth=rd_max_depth, num_labels=L_COMPRESSED,
                      num_rows=g.max_index())
    out = launch(PROGRAM, shape, inputs, backend="gloo", device="cpu",
                 timeout=240)
    assert [o["rank"] for o in out] == list(range(len(out)))
    return out


def _host_counts(w, qseqs, counts):
    anno = w["anno"]
    ref = w["pipe"].query_labels(qseqs, "matches", 2 ** 63, 0.0, 0.0)
    for i, expected in enumerate(ref):
        got = {anno.encoder.decode(c): int(counts[i, c])
               for c in range(anno.num_labels) if counts[i, c] > 0}
        assert got == dict(expected), i


def _oracle_compressed(w, qseqs, counts):
    for i, s in enumerate(qseqs):
        nodes = w["g"].map_to_nodes(s)
        want = w["dense"][nodes[nodes > 0] - 1].sum(axis=0)
        assert np.array_equal(counts[i, :L_COMPRESSED], want), i


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharded_steps_match_jax(world, data, model):
    """One launch a mesh shape: dense counts and present equal JAX's
    sharded step and the single-device query_labels; the lookup equals
    _kmer_lookup; the compressed step with and without row-diff equals
    JAX's and the dense oracle; each step one all-reduce, over 'model'."""
    w = world
    mesh = _jmesh((data, model))
    qseqs, queries, seq_ids = _batch(w, data)
    boss = w["g"].boss
    ve = np.flatnonzero(boss.valid)
    keys = jops.pack_kmers32(boss.get_edge_seq(ve))
    lq = jsh.pad_rows(keys[::3], data, fill=np.iinfo(np.uint32).max)
    out = _port(w, {"data": data, "model": model}, queries, seq_ids,
                w["rd_max_depth"], lookup=(keys, ve.astype(np.int64), lq))
    r0 = out[0]
    jc, jp = _jax_dense(w, mesh, queries, seq_ids, host=False)
    np.testing.assert_array_equal(r0["dense"][0], jc)
    np.testing.assert_array_equal(r0["dense"][1], jp)
    _host_counts(w, qseqs, r0["dense"][0])
    # sharded lookup vs the JAX step and the single-device _kmer_lookup
    kd, idd = jsh.shard_kmer_index(keys, ve.astype(np.int64), mesh)
    q_d = jax.device_put(lq, NamedSharding(mesh, P("data", None)))
    jl = np.asarray(jsh.sharded_lookup_fn(mesh)(kd, idd, q_d))
    np.testing.assert_array_equal(r0["lookup"], jl)
    np.testing.assert_array_equal(r0["lookup"][: len(keys[::3])], ve[::3])
    single = np.asarray(jops._kmer_lookup(jnp.asarray(keys),
                                          jnp.asarray(ve, jnp.int32),
                                          jnp.asarray(lq)))
    np.testing.assert_array_equal(r0["lookup"], single)
    for row_diff in (False, True):
        jc, jp, _ = _jax_compressed(w, mesh, queries, seq_ids, row_diff,
                                    w["rd_max_depth"])
        got = r0["row_diff" if row_diff else "brwt"]
        np.testing.assert_array_equal(got[0], jc)
        np.testing.assert_array_equal(got[1], jp)
        _oracle_compressed(w, qseqs, got[0])
    for o in out:
        for step in ("dense", "lookup", "brwt", "row_diff"):
            assert o["collectives"][step] == collective_counts([])  \
                | {"all-reduce": 1}, (o["rank"], step)
        # the CPU runs the plain versions: no kernel launches
        assert o["launches"]["dense"] == {}


def test_host_mesh_step(world):
    """The ('host', 'data', 'model') = (2, 2, 1) mesh: the index over
    ('host', 'model'), counts equal JAX's host step and query_labels, and
    the step records exactly one all-reduce, spanning host and model."""
    w = world
    mesh = jsh.make_host_mesh(4, host_axis=2, data_axis=2)
    assert dict(mesh.shape) == {"host": 2, "data": 2, "model": 1}
    qseqs, queries, seq_ids = _batch(w, 2)
    out = _port(w, {"host": 2, "data": 2, "model": 1}, queries, seq_ids, 0,
                compressed=False)
    jc, jp = _jax_dense(w, mesh, queries, seq_ids, host=True)
    np.testing.assert_array_equal(out[0]["dense"][0], jc)
    np.testing.assert_array_equal(out[0]["dense"][1], jp)
    _host_counts(w, qseqs, out[0]["dense"][0])
    for o in out:
        assert o["collectives"]["dense"] == {
            "all-reduce": 1, "all-gather": 0, "all-to-all": 0,
            "collective-permute": 0, "reduce-scatter": 0}
        # the probe's 8 keys a window: every rank's (Q / data,) int32 hits
        assert o["collective_bytes"]["dense"] == 4 * len(queries) // 2


def test_row_diff_walk_cut(world):
    """rd_max_depth below the longest chain: the walk stops after that
    many steps, as JAX's fori_loop does, on a (1, 2) mesh."""
    w = world
    assert w["rd_max_depth"] > 2
    mesh = _jmesh((1, 2))
    _, queries, seq_ids = _batch(w, 1)
    out = _port(w, {"data": 1, "model": 2}, queries, seq_ids, 2)
    jc, jp, _ = _jax_compressed(w, mesh, queries, seq_ids, True, 2)
    np.testing.assert_array_equal(out[0]["row_diff"][0], jc)
    np.testing.assert_array_equal(out[0]["row_diff"][1], jp)


def test_shard_hash_table_preserves_modulus(world):
    """A tiny index (20 edges, few buckets) over a model axis of 8, which
    does not divide its bucket count: every real k-mer still hits (the
    JAX test_shard_hash_table_preserves_modulus), through the port's
    windowed probe on each shard, in process."""
    g = world["g"]
    ve = np.flatnonzero(g.boss.valid)[:20]
    keys = jops.pack_kmers32(g.boss.get_edge_seq(ve))
    table = np.asarray(jops.DeviceHashIndex.from_packed(
        keys, ve.astype(np.uint32)).table)
    m = 8
    padded = tsh.pad_rows(table, m, fill=np.uint32(0xFFFFFFFF))
    per, nb = padded.shape[0] // m, table.shape[0]
    assert nb % m, (nb, m)
    from metagraph_tpu_torch._u32 import np_words
    from metagraph_tpu_torch.succinct import ops as tops
    q = np_words(keys[:8])
    best = torch.zeros(8, dtype=torch.int32)
    for i in range(m):
        got = tops.key_lookup(q, np_words(padded[i * per: (i + 1) * per]),
                              n_hash=nb, row0=i * per)
        assert not bool(((got > 0) & (best > 0)).any())
        best = torch.maximum(best, got)
    np.testing.assert_array_equal(best.numpy(), ve[:8])


@pytest.mark.parametrize("model", [1, 2, 3])
def test_sharded_brwt_words(world, model):
    """Each shard's label words: the port's _sharded_brwt_words on JAX's
    stacked arrays equals JAX's; W1 (brwt_row_words, its plain version on
    the CPU) on the port's own shard forest equals them too."""
    w = world
    R = w["g"].max_index()
    jsb = jsh.shard_brwt_annotation(w["columns"], R, L_COMPRESSED,
                                    _jmesh((1, model)))
    tsb = tsh.shard_brwt_annotation(w["columns"], R, L_COMPRESSED, model)
    assert tsb.labels_per_shard == jsb.labels_per_shard
    rng = np.random.default_rng(model)
    rows = np.concatenate([[-1, 0, R - 1], rng.integers(-1, R, 300)])
    Ls = jsb.labels_per_shard
    for i in range(model):
        want = np.asarray(jsh._sharded_brwt_words(
            tuple(jnp.asarray(x[i]) for x in jsb.words),
            tuple(jnp.asarray(x[i]) for x in jsb.rdir),
            tuple(jnp.asarray(x[i]) for x in jsb.offs),
            tuple(jnp.asarray(x[i]) for x in jsb.parent),
            jnp.asarray(jsb.leaf_level[i]), jnp.asarray(jsb.leaf_node[i]),
            jnp.asarray(rows, jnp.int32), Ls))
        got = tsh._sharded_brwt_words(
            [x[i] for x in jsb.words], [x[i] for x in jsb.rdir],
            [x[i] for x in jsb.offs], [x[i] for x in jsb.parent],
            jsb.leaf_level[i], jsb.leaf_node[i], torch.from_numpy(rows), Ls)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        tree = dm.BRWTOnDevice.from_host(tsb.flat(i), "cpu")
        ids = torch.from_numpy(np.where(rows >= 0, rows + 1, 0)
                               .astype(np.int32))
        w1 = dm.brwt_row_words(tree, ids).numpy().view(np.uint32)
        np.testing.assert_array_equal(w1, want)


def test_make_mesh_in_ranks():
    """make_mesh and make_host_mesh over four launched ranks: JAX's shapes
    and row-major places (sharding.py:37, :160)."""
    out = launch("metagraph_tpu_torch.parallel.programs:mesh_layouts",
                 {"data": 4, "model": 1}, {}, device="cpu", timeout=120)
    want_flat = dict(jsh.make_mesh(4).shape)
    want_host = dict(jsh.make_host_mesh(4).shape)
    for r, o in enumerate(out):
        shape, coords = o["mesh"]
        assert shape == want_flat == {"data": 2, "model": 2}
        assert coords == {"data": r // 2, "model": r % 2}
        shape, coords = o["host_mesh"]
        assert shape == want_host == {"host": 2, "data": 2, "model": 1}
        assert coords == {"host": r // 2, "data": r % 2, "model": 0}


def test_assemble_and_pad():
    blocks = [np.full((2, 3), r) for r in range(4)]
    got = assemble(blocks, (2, 2), ("data", "model"), ("data", "model"))
    np.testing.assert_array_equal(got[:2, 3:], 1)
    np.testing.assert_array_equal(got[2:, :3], 2)
    pres = assemble([np.full(2, r) for r in range(4)], (2, 2),
                    ("data", "model"), ("data",))
    np.testing.assert_array_equal(pres, [0, 0, 2, 2])
    a = np.arange(5, dtype=np.uint32)
    np.testing.assert_array_equal(tsh.pad_rows(a, 4, fill=9),
                                  jsh.pad_rows(a, 4, fill=9))
    assert tsh.make_mesh_shape(8) == dict(jsh.make_mesh(8).shape)
    assert tsh.make_host_mesh_shape(8) == dict(jsh.make_host_mesh(8).shape)
    with pytest.raises(ValueError):
        tsh._check_batch(type("M", (), {"shape": {"data": 2}})(), 3)


def test_launch_runs_on_the_card_unless_asked():
    """Without a card, a launch that names no device fails in its ranks
    (they run on the card unless the caller asks for the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch("metagraph_tpu_torch.parallel.programs:mesh_layouts",
               {"data": 1, "model": 1}, {}, timeout=120)
