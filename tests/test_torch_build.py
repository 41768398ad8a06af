"""The device construction: the port against metagraph_tpu.

* ``build_p1``/``build_p2`` (plain versions on the CPU) against the JAX
  ``_build_p1``/``_build_p2`` on the same wire words: the sorted unique
  keys, U, the dummy sink and source node sets of ``dl1``, and the rows,
  F and kept count of ``dl2``;
* ``device_build_boss_arrays(..., device="cpu")`` against the JAX
  ``device_build_boss_arrays`` and the host ``construct.build_boss_arrays``
  at K = 3, 11, 16, 17, 20, 21, with the regrowth of the sink/source
  buffer, its limit's RuntimeError and the edge cases (one sequence, all
  N, N runs, lower case, sequences shorter than k, the zero row 0);
* ``sort_kmers_device*``, ``device_sort_unique`` and
  ``build_kmer_set_device``;
* ``DBGSuccinct.build`` and ``save`` against the JAX package's, each
  package loading the other's file (the builds outside the JAX device
  construction: tests/test_torch_build_host.py).

Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu.kmer.extractor import KmerExtractor
from metagraph_tpu.query.device import wire_words_layout as jax_layout
from metagraph_tpu.succinct import device_build as jdb
from metagraph_tpu.succinct.construct import build_boss_arrays
from metagraph_tpu_torch._u32 import np_words
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
from metagraph_tpu_torch.query.device import wire_words_layout
from metagraph_tpu_torch.query.tile_pack import tile_pack2
from metagraph_tpu_torch.succinct import construct
from metagraph_tpu_torch.succinct import device_build as db

from test_torch_canonical import native_lib

KS = (3, 11, 16, 17, 20, 21)
FIELDS = ("W", "last", "valid", "F")


@pytest.fixture(scope="module", autouse=True)
def _native():
    assert native_lib() is not None, "the JAX native library does not load"


def random_seqs(rng, n=40, max_len=900, letters="ACGTN",
                p=(.24, .24, .24, .24, .04)):
    return ["".join(rng.choice(list(letters), size=int(m), p=p)).encode()
            for m in rng.integers(1, max_len, size=n)]


def host_arrays(seqs, K):
    kmers, _ = KmerExtractor().extract(seqs, K, mode="basic")
    return build_boss_arrays(kmers)


def assert_same(got, want, what=""):
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)
    assert got.k == want.k and got.alph_size == want.alph_size


def _words(seqs, K, npad):
    tiles2, validb, _, _ = tile_pack2(seqs, K, db.T_WIRE)
    return wire_words_layout(tiles2, validb, K, db.T_WIRE, npad)


@pytest.mark.parametrize("K", KS)
def test_build_p1_p2_match_jax(K):
    rng = np.random.default_rng([K, 7])
    seqs = random_seqs(rng)
    packed = tile_pack2(seqs, K, db.T_WIRE)
    npad = jdb._bucket(len(packed[0]), lo=16)
    words, vwords = _words(seqs, K, npad)
    jw, jv = jax_layout(*packed[:2], K, db.T_WIRE, npad)
    assert np.array_equal(words, jw) and np.array_equal(vwords, jv)
    capd = 1 << 13
    slo, shi, juniq, dl1 = jdb._build_p1(jnp.asarray(jw), jnp.asarray(jv),
                                         K, db.T_WIRE, capd)
    dl1 = np.asarray(dl1)
    n_sink, n_src1, U = int(dl1[0]), int(dl1[1]), int(dl1[2])
    assert dl1[3] == 0
    p1 = db.build_p1(np_words(words), np_words(vwords), K)
    # the sorted keys (the sentinels differ: JAX's all ones, the port's
    # 1 << 2K; both sort last), the uniq flags, U
    jkeys = np.asarray(slo).astype(np.int64) \
        | (np.asarray(shi).astype(np.int64) << 32)
    jsent = (np.asarray(slo) == 0xFFFFFFFF) & (np.asarray(shi) == 0xFFFFFFFF)
    keys = p1.skeys.numpy()
    assert np.array_equal(np.where(jsent, 1 << (2 * K), jkeys), keys)
    assert np.array_equal(np.asarray(juniq), p1.uniq.numpy())
    assert p1.U == U > 0
    # the sink and level-1 source nodes, decoded from dl1
    out2 = dl1[4:].reshape(-1, 2).astype(np.int64)
    nodes = out2[:, 0] | (out2[:, 1] << 32)
    assert (p1.n_sink, p1.n_src1) == (n_sink, n_src1)
    assert np.array_equal(np.sort(nodes[:n_sink]), p1.sink.numpy())
    assert np.array_equal(np.sort(nodes[n_sink: n_sink + n_src1]),
                          p1.src1.numpy())
    # build_p2 on the same dummy rows
    dummies = db.expand_dummies(db.unpack_node_keys(p1.sink.numpy(), K),
                                db.unpack_node_keys(p1.src1.numpy(), K), K)
    d3 = db.host_key3(dummies, K)
    dlo3, dhi3 = jdb._host_key3(dummies, K)
    assert np.array_equal(d3, dlo3.astype(np.int64)
                          | (dhi3.astype(np.int64) << 32))
    M = U + len(dummies)
    mcap = jdb._bucket(M, lo=1 << 10)
    dl2 = np.asarray(jdb._build_p2(slo, shi, juniq, jnp.asarray(dlo3),
                                   jnp.asarray(dhi3), K, 5, mcap))
    W, last, valid, F = db.build_p2(p1.skeys, p1.uniq, p1.U,
                                    torch.from_numpy(d3), K)
    kept = int(dl2[5])
    assert np.array_equal(F.numpy(), dl2[:5].astype(np.int64))
    assert len(W) == kept + 1
    by = dl2[6:].view(np.uint8)[:kept]
    assert np.array_equal(W.numpy()[1:], by & 0xF)
    assert np.array_equal(last.numpy()[1:], (by >> 4) & 1)
    assert np.array_equal(valid.numpy()[1:], (by >> 5) & 1)


@pytest.mark.parametrize("K", KS)
def test_device_build_matches_jax_and_host(K):
    rng = np.random.default_rng(5 + K)
    seqs = random_seqs(rng)
    got = db.device_build_boss_arrays(seqs, K, device="cpu")
    assert_same(got, jdb.device_build_boss_arrays(seqs, K), "device")
    assert_same(got, host_arrays(seqs, K), "host")
    assert got.W[0] == got.last[0] == got.valid[0] == 0


@pytest.mark.parametrize("K", (3, 21))
@pytest.mark.parametrize("case", ("one", "n_runs", "lower", "all_n",
                                  "repeats"))
def test_device_build_edge_cases(case, K):
    rng = np.random.default_rng([K, len(case)])
    acgt = "".join(rng.choice(list("ACGT"), size=700))
    seqs = {"one": [acgt.encode()],
            "n_runs": [(acgt[:100] + "N" * 30 + acgt[130:400] + "NN"
                        + acgt[402:]).encode(), b"N" * 50 + acgt[:60].encode()],
            "lower": [acgt.lower().encode(), acgt[:300].encode()],
            "all_n": [b"N" * 300, b"NNNNNNNNNNNNNNNNNNNNNNNNNNNNNN"],
            "repeats": [(acgt[:40] * 20).encode(), b"A" * 500]}[case]
    got = db.device_build_boss_arrays(seqs, K, device="cpu")
    assert_same(got, jdb.device_build_boss_arrays(seqs, K), case)
    assert_same(got, host_arrays(seqs, K), case)


def test_device_build_out_of_scope_returns_none():
    seqs = [b"ACGTACGTACGTACGTACGTACGTACGT"]
    for k in (2, 22):
        assert db.device_build_boss_arrays(seqs, k, device="cpu") is None
        assert jdb.device_build_boss_arrays(seqs, k) is None
    # no sequence as long as k: no tiles
    for seqs in ([b"ACG", b"ACGTA"], []):
        assert db.device_build_boss_arrays(seqs, 6, device="cpu") is None
        assert jdb.device_build_boss_arrays(seqs, 6) is None


def test_device_build_regrows_the_node_buffer():
    # many disconnected reads: many dummy sink and source nodes
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGT"), size=40)).encode()
            for _ in range(300)]
    got = db.device_build_boss_arrays(seqs, 20, capd=64, device="cpu")
    assert_same(got, jdb.device_build_boss_arrays(seqs, 20, capd=64))
    assert_same(got, host_arrays(seqs, 20))


@pytest.mark.parametrize("max_capd", (1023, 255, 64))
def test_device_build_limit_raises_as_jax(max_capd):
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGT"), size=40)).encode()
            for _ in range(300)]
    with pytest.raises(RuntimeError) as want:
        jdb.device_build_boss_arrays(seqs, 20, capd=64, _max_capd=max_capd)
    with pytest.raises(RuntimeError) as got:
        db.device_build_boss_arrays(seqs, 20, capd=64, _max_capd=max_capd,
                                    device="cpu")
    assert str(got.value) == str(want.value)


def test_capd_limit_follows_the_jax_regrowth():
    assert db.capd_limit(1 << 13, 1 << 22) == 2_097_152
    assert db.capd_limit(64, 1023) == 256
    assert db.capd_limit(64, 64) == 64


@pytest.mark.parametrize("W", (1, 2, 3))
def test_sort_kmers_device_matches_jax(W):
    rng = np.random.default_rng(W)
    keys = rng.integers(0, 2 ** 32, (700, W), dtype=np.uint64) \
        .astype(np.uint32)
    keys[300:500] = keys[:200]
    keys[600:, 0] = keys[:100, 0]              # ties in the first word
    s, new = db.sort_kmers_device(np_words(keys))
    js, jnew = jdb.sort_kmers_device(jnp.asarray(keys))
    assert np.array_equal(s.numpy().view(np.uint32), np.asarray(js))
    assert np.array_equal(new.numpy(), np.asarray(jnew))
    s, new, counts = db.sort_kmers_device_with_counts(np_words(keys))
    js, jnew, jcounts = jdb.sort_kmers_device_with_counts(jnp.asarray(keys))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("with_counts", (False, True))
def test_device_sort_unique_matches_jax(with_counts):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2 ** 32, (1000, 2), dtype=np.uint64) \
        .astype(np.uint32)
    keys[500:] = keys[:500]
    keys[::7] = 0xFFFFFFFF
    got = db.device_sort_unique(keys, with_counts, device="cpu")
    want = jdb.device_sort_unique(keys, with_counts)
    for g, w in zip(got if with_counts else (got,),
                    want if with_counts else (want,)):
        assert np.array_equal(g, w)
    assert np.array_equal(db._pad_pow2(keys[:5]), jdb._pad_pow2(keys[:5]))


@pytest.mark.parametrize("k", (5, 9, 17))
def test_build_kmer_set_device_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(1, 5, 3000).astype(np.uint8)
    codes[::97] = 5                          # separators
    got = db.build_kmer_set_device(codes, k, device="cpu")
    assert np.array_equal(got, jdb.build_kmer_set_device(codes, k))


def test_empty_boss_arrays_is_the_host_table_of_nothing():
    for K in (3, 12, 21):
        want = build_boss_arrays(np.zeros((0, K), np.uint8))
        assert_same(construct.empty_boss_arrays(K), want)


@pytest.mark.parametrize("seqs", ([b"ACG", b"TTAC"], [b"N" * 40], []),
                         ids=("short", "all_n", "none"))
def test_dbg_build_without_windows_matches_jax(seqs):
    got = DBGSuccinct.build(seqs, 5, device="cpu")
    want = JaxDBG.build(seqs, 5, device=True)
    assert_same(construct.BossArrays.from_arrays(got.boss),
                construct.BossArrays.from_arrays(want.boss))
    assert got.num_nodes() == want.num_nodes() == 0


@pytest.mark.parametrize("mask", (True, False))
@pytest.mark.parametrize("K", (3, 11, 21))
def test_dbg_build_save_load_both_ways(tmp_path, K, mask):
    rng = np.random.default_rng(K)
    seqs = [s.decode() for s in random_seqs(rng, n=10)]
    g = DBGSuccinct.build(seqs, K, mask_dummy=mask, bits_per_count=12,
                          device="cpu")
    j = JaxDBG.build(seqs, K, mask_dummy=mask, bits_per_count=12, device=True)
    assert g.num_nodes() == j.num_nodes() and g.k == j.k == K
    assert g.boss.count_width == j.boss.count_width == 12
    for mmap in (False, True):
        g.boss.state = j.boss.state = "small"
        g.save(str(tmp_path / f"g{mmap}"), mmap_layout=mmap)
        j.save(str(tmp_path / f"j{mmap}"), mmap_layout=mmap)
        for path, other in ((f"g{mmap}.dbg", JaxDBG), (f"j{mmap}.dbg",
                                                       DBGSuccinct)):
            back = other.load(str(tmp_path / path), mmap=mmap)
            for f in FIELDS:
                assert np.array_equal(getattr(back.boss, f),
                                      getattr(j.boss, f))
            assert back.masked == mask and back.mode == "basic"
            assert back.boss.state == "small"
            assert back.boss.count_width == 12


def test_build_entry_points_need_cuda(monkeypatch):
    """The build runs on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = [b"ACGTACGTACGTAGCTAGCA"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DBGSuccinct.build(seqs, 11)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        db.device_build_boss_arrays(seqs, 11)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        db.device_sort_unique(np.zeros((3, 1), np.uint32))
    assert DBGSuccinct.build(seqs, 11, device="cpu").num_nodes() == 10


def test_from_graph_takes_a_built_graph(tmp_path):
    """``convert.from_graph`` takes a freshly built graph as it takes the
    same graph loaded from its file: the same table and annotation rows,
    so a built graph serves ``query`` with no file in between."""
    from metagraph_tpu_torch import convert
    from torch_parity import jax_cli, write_fasta
    rng = np.random.default_rng(2)
    seqs = [s.decode() for s in random_seqs(rng, n=12, letters="ACGT",
                                            p=None)]
    write_fasta(tmp_path / "in.fa", [(f"r{i}", s) for i, s in
                                      enumerate(seqs)])
    g = DBGSuccinct.build(seqs, 13, device="cpu")
    g.save(str(tmp_path / "g"))
    jax_cli("annotate", "-i", tmp_path / "g.dbg", "--anno-header", "-o",
            tmp_path / "a", tmp_path / "in.fa")
    anno = str(tmp_path / "a.column.annodbg")
    built = convert.from_graph(g, convert.load_annotation_for(
        str(tmp_path / "g.dbg"), anno))
    loaded = convert.load(str(tmp_path / "g.dbg"), anno)
    assert np.array_equal(built.table, loaded.table)
    assert np.array_equal(built.device_anno, loaded.device_anno)
    assert built.labels == loaded.labels and built.k == loaded.k == 13
    assert built.device_anno.any()


@pytest.mark.parametrize("n_buckets", (2, 4, 16, 32, 64, 1024))
def test_hash_table_one_sort_matches_jax_rounds(n_buckets):
    """The port places every key with one stable sort by bucket (the table
    that ``from_graph`` builds over a freshly built graph); the JAX
    package places them in rounds: the same bytes, and None (a bucket past
    16 keys) at the same sizes."""
    from metagraph_tpu.succinct import ops as jops
    from metagraph_tpu_torch.succinct import ops as tops
    rng = np.random.default_rng(n_buckets)
    chars = np.unique(rng.integers(1, 5, (300, 13)).astype(np.uint8), axis=0)
    keys = jops.pack_kmers32(chars)
    ids = rng.permutation(len(keys)).astype(np.uint32) + 1
    want = jops.DeviceHashIndex._build(keys, ids, n_buckets)
    got = tops.DeviceHashIndex._build(keys, ids, n_buckets)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.tobytes() == want.tobytes()
    for load in (0.45, 3.0):
        assert tops.DeviceHashIndex.build_table(keys, ids, load).tobytes() \
            == np.asarray(jops.DeviceHashIndex.from_packed(
                keys, ids, load).table).tobytes()


def adversarial_runs(K, rng):
    """Sequences whose join runs hold a node with 4 sources and 0 targets,
    0 and 4, 4 and 4 (and 1 and 1): node X (K - 1 characters) followed by
    each of A, C, G, T; node Y preceded by each; node Z both."""
    def node():
        return "".join(rng.choice(list("ACGT"), size=K - 1))
    X, Y, Z, V = node(), node(), node(), node()
    seqs = [X + c for c in "ACGT"] + [c + Y for c in "ACGT"]
    seqs += [c + Z for c in "ACGT"] + [Z + c for c in "ACGT"]
    seqs += ["A" + V + "C"]
    return [s.encode() for s in seqs]


@pytest.mark.parametrize("K", KS)
def test_join_on_adversarial_runs_matches_jax(K):
    seqs = adversarial_runs(K, np.random.default_rng(K))
    packed = tile_pack2(seqs, K, db.T_WIRE)
    npad = jdb._bucket(len(packed[0]), lo=16)
    words, vwords = _words(seqs, K, npad)
    _, _, _, dl1 = jdb._build_p1(jnp.asarray(words), jnp.asarray(vwords), K,
                                 db.T_WIRE, 1 << 13)
    dl1 = np.asarray(dl1)
    n_sink, n_src1 = int(dl1[0]), int(dl1[1])
    out2 = dl1[4:].reshape(-1, 2).astype(np.int64)
    nodes = out2[:, 0] | (out2[:, 1] << 32)
    p1 = db.build_p1(np_words(words), np_words(vwords), K)
    assert (p1.n_sink, p1.n_src1) == (n_sink, n_src1)
    # (at K = 3 the random nodes overlap each other's edges)
    assert K == 3 or n_sink >= 4 and n_src1 >= 4
    assert np.array_equal(np.sort(nodes[:n_sink]), p1.sink.numpy())
    assert np.array_equal(np.sort(nodes[n_sink: n_sink + n_src1]),
                          p1.src1.numpy())
    assert_same(db.device_build_boss_arrays(seqs, K, device="cpu"),
                jdb.device_build_boss_arrays(seqs, K))
