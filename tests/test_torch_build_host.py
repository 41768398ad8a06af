"""The host construction (the general route of ``DBGSuccinct.build``):
the port against metagraph_tpu, on the CPU.

* ``kmer/packing.py``: ``unpack_codes``, ``rows_lex_lt``/``rows_lex_gt``,
  ``lexsort_rows`` and ``sort_rows`` (kernel D2's plain version), with
  ties, ``unique_rows`` with count sums, ``searchsorted_rows``,
  ``rows_in``, ``rows_equal_adjacent``, ``reverse_complement``, and the
  tensor forms ``pack_rows``/``unpack_rows``/``rows_in_sorted``;
* ``kmer/extractor.py``: ``_packed_windows`` and ``extract`` in both
  modes with counts and window weights (the weights' alignment and the
  error of too few weights), ``extract_disk``;
* ``kmer/disk_sort.py``: ``SortedSetDisk`` with forced spills;
* ``succinct/construct.py``: ``generate_dummy_kmers``, ``emit_boss`` and
  ``build_boss_arrays``;
* ``seq_io/fasta.py``: ``parse_abundance`` and ``read_kmer_counts``;
* ``DBGSuccinct.build``: its route, and its arrays in every case that it
  refused before it had the host construction (other modes, alphabets
  and k, counts, weights, a disk swap, a memory cap), with the JAX
  errors where JAX raises; canonical and primary builds past the dummy
  limit, which JAX's host construction does not have.

Window weights are kept below 2^32 a window in the parity cases: the JAX
package sums counts in float64 (``np.concatenate`` of ``[0]`` with uint64
sums), exact while the running total stays below 2^53; the port's int64
sums are exact mod 2^64.  Every comparison is exact.  Past 2^53 the two
differ: ``test_count_sums_past_2_53_are_exact_where_jax_rounds`` pins
the port's sums against a numpy uint64 reference and JAX's rounded ones.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu.kmer import disk_sort as jds
from metagraph_tpu.kmer import packing as jpk
from metagraph_tpu.kmer.alphabets import ALPHABETS as JAX_ALPHABETS
from metagraph_tpu.kmer.extractor import KmerExtractor as JaxExtractor
from metagraph_tpu.seq_io import fasta as jfa
from metagraph_tpu.succinct import construct as jc
from metagraph_tpu_torch.graph import dbg_succinct as pdbg
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
from metagraph_tpu_torch.kmer import disk_sort as pds
from metagraph_tpu_torch.kmer import packing as ppk
from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
from metagraph_tpu_torch.kmer.extractor import KmerExtractor
from metagraph_tpu_torch.seq_io import fasta as pfa
from metagraph_tpu_torch.succinct import construct as pc
from metagraph_tpu_torch.succinct import device_build as db

from test_torch_canonical import native_lib

FIELDS = ("W", "last", "valid", "F", "weights")
LETTERS = {"DNA": "ACGTN", "DNA5": "ACGTNRY", "DNA_CASE": "ACGTacgtNn",
           "Protein": "ACDEFGHIKLMNPQRSTVWYXBZ*"}


@pytest.fixture(scope="module", autouse=True)
def _native():
    assert native_lib() is not None, "the JAX native library does not load"


def random_seqs(rng, letters, n=30, max_len=700):
    return ["".join(rng.choice(list(letters), size=int(m))).encode()
            for m in rng.integers(1, max_len, size=n)]


def weights_of(rng, seqs, K, short=False):
    """Per sequence, a weight a window below 2^32 (one fewer than its
    windows for the first long sequence where ``short``)."""
    out = [rng.integers(0, 1 << 32, max(len(s) - K + 1, 0)).astype(np.uint64)
           for s in seqs]
    if short:
        i = next(i for i, s in enumerate(seqs) if len(s) > K + 5)
        out[i] = out[i][:-1]
    return out


def same_arrays(got, want, what=""):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, (what, f)
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)
    assert got.k == want.k and got.alph_size == want.alph_size


def rows(rng, n, W, distinct=50):
    """(n, W) uint64 rows with ties and full 64-bit words."""
    pool = rng.integers(0, 2 ** 64, (distinct, W), dtype=np.uint64)
    pool[::7, 0] = 0
    pool[::5, -1] = np.uint64(2 ** 64 - 1)
    return pool[rng.integers(0, distinct, n)]


# --------------------------------------------------------------------------
# packing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", (0, 1, 2, 900, 40_000))
@pytest.mark.parametrize("W", (1, 2, 3))
def test_lexsort_and_unique_rows_match_jax(n, W):
    rng = np.random.default_rng(n * 10 + W)
    x = rows(rng, n, W, distinct=max(n // 3, 1))
    got = ppk.lexsort_rows(x, device="cpu")
    assert np.array_equal(got, jpk.lexsort_rows(x))
    assert np.array_equal(ppk.sort_rows(x, device="cpu"), jpk.sort_rows(x))
    c = rng.integers(0, 1 << 30, n).astype(np.uint64)
    for counts in (None, c):
        gu, gc = ppk.unique_rows(x, counts, device="cpu")
        wu, wc = jpk.unique_rows(x, counts)
        assert gu.dtype == np.uint64 and np.array_equal(gu, wu)
        if counts is None:
            assert gc is None and wc is None
        else:
            assert gc.dtype == np.uint64 and np.array_equal(gc, wc)


def test_unique_rows_sums_wrap_mod_2_64():
    x = np.array([[3], [1], [3], [3]], np.uint64)
    c = np.array([2 ** 63, 5, 2 ** 63, 7], np.uint64)
    u, s = ppk.unique_rows(x, c, device="cpu")
    assert u.ravel().tolist() == [1, 3] and s.tolist() == [5, 7]


def test_count_sums_past_2_53_are_exact_where_jax_rounds():
    """Summed weights past 2^53: the port's sums equal a numpy uint64
    reference (exact mod 2^64); the JAX package sums in float64 and rounds
    (ROADMAP §C).  Both answers are pinned here."""
    x = np.array([[3], [1], [1], [3]], np.uint64)
    c = np.array([1, 2 ** 53, 1, 2 ** 64 - 1], np.uint64)
    u, s = ppk.unique_rows(x, c, device="cpu")
    order = np.argsort(x[:, 0], kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(x[order, 0]) != 0])
    want = np.add.reduceat(c[order], starts)
    assert want.dtype == np.uint64 and want.tolist() == [2 ** 53 + 1, 0]
    assert u.ravel().tolist() == [1, 3] and s.dtype == np.uint64
    assert np.array_equal(s, want)
    ju, js = jpk.unique_rows(x, c)
    assert np.array_equal(ju, u) and js.dtype == np.float64
    assert js.tolist() == [2.0 ** 53, 0.0]
    # the same divergence through the extractor's window weights
    seqs, ww = [b"ACGTA", b"ACGTA"], [np.array([2 ** 53], np.uint64),
                                      np.array([1], np.uint64)]
    _, pc = KmerExtractor().extract(seqs, 5, with_counts=True,
                                    window_weights=ww, device="cpu")
    _, jcnt = JaxExtractor().extract(seqs, 5, with_counts=True,
                                     window_weights=ww)
    assert pc.tolist() == [2 ** 53 + 1] and jcnt.tolist() == [2.0 ** 53]


@pytest.mark.parametrize("bits,K", ((4, 3), (4, 16), (4, 31), (8, 8),
                                    (8, 20), (8, 41)))
def test_pack_and_unpack_match_jax(bits, K):
    rng = np.random.default_rng(K)
    hi = 15 if bits == 4 else 255
    chars = rng.integers(0, hi + 1, (500, K)).astype(np.uint8)
    for order in (None, jpk.boss_priority_order(K),
                  jpk.colex_priority_order(K)):
        packed = jpk.pack_codes(chars, order, bits)
        assert np.array_equal(ppk.pack_codes(chars, order, bits), packed)
        assert np.array_equal(ppk.unpack_codes(packed, K, order, bits),
                              jpk.unpack_codes(packed, K, order, bits))
        o = np.arange(K) if order is None else order
        t = torch.from_numpy(chars)
        words = ppk.pack_rows(lambda j: t[:, j], o, bits)
        assert np.array_equal(ppk.to_host(words), packed)
        assert np.array_equal(ppk.unpack_rows(words, K, o, bits).numpy(),
                              chars)


@pytest.mark.parametrize("W", (1, 2, 4))
def test_row_compares_and_search_match_jax(W):
    rng = np.random.default_rng(W)
    a = rows(rng, 400, W, distinct=60)
    b = rows(rng, 400, W, distinct=60)
    for f in ("rows_lex_lt", "rows_lex_gt"):
        assert np.array_equal(getattr(ppk, f)(a, b), getattr(jpk, f)(a, b))
        assert np.array_equal(getattr(ppk, f)(a, b[3]),
                              getattr(jpk, f)(a, b[3]))
    s = jpk.unique_rows(a)[0]
    for side in ("left", "right"):
        assert np.array_equal(ppk.searchsorted_rows(s, b, side),
                              jpk.searchsorted_rows(s, b, side))
    assert np.array_equal(ppk.rows_in(s, b), jpk.rows_in(s, b))
    assert np.array_equal(ppk.rows_in(s[:0], b), jpk.rows_in(s[:0], b))
    assert np.array_equal(ppk.rows_equal_adjacent(jpk.sort_rows(a)),
                          jpk.rows_equal_adjacent(jpk.sort_rows(a)))
    q = jpk.unique_rows(b)[0]
    got = ppk.rows_in_sorted(ppk.to_device(s, "cpu"), ppk.to_device(q, "cpu"))
    assert np.array_equal(got.numpy(), jpk.rows_in(s, q))
    chars = rng.integers(0, 5, (50, 9)).astype(np.uint8)
    comp = np.array([0, 4, 3, 2, 1, 5], np.uint8)
    assert np.array_equal(ppk.reverse_complement(chars, comp),
                          jpk.reverse_complement(chars, comp))


# --------------------------------------------------------------------------
# extractor and disk sort
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alphabet,K,mode", [
    (a, K, m) for a, K in (("DNA", 3), ("DNA", 31), ("DNA5", 22),
                           ("DNA_CASE", 9), ("Protein", 20))
    for m in ("basic", "both") if a != "Protein" or m == "basic"])
def test_extract_matches_jax(alphabet, K, mode):
    rng = np.random.default_rng(K)
    seqs = random_seqs(rng, LETTERS[alphabet])
    ww = weights_of(rng, seqs, K)
    jex, pex = JaxExtractor(JAX_ALPHABETS[alphabet]), \
        KmerExtractor(ALPHABETS[alphabet])
    jp, jw = jex._packed_windows(seqs, K, mode, ww)
    pp, pw = pex._packed_windows(seqs, K, mode, ww, device="cpu")
    assert np.array_equal(ppk.to_host(pp), jp)
    assert np.array_equal(ppk.to_host(pw), jw)
    for kw in (dict(), dict(with_counts=True),
               dict(with_counts=True, window_weights=ww),
               dict(window_weights=ww)):
        jk, jcnt = jex.extract(seqs, K, mode=mode, **kw)
        pk, pcnt = pex.extract(seqs, K, mode=mode, device="cpu", **kw)
        assert pk.dtype == np.uint8 and np.array_equal(pk, jk)
        if jcnt is None:
            assert pcnt is None
        else:
            assert np.array_equal(pcnt, jcnt.astype(np.uint64))
        dk, dcnt = pex.extract_disk(seqs, K, mode=mode, ram_cap_bytes=1 << 16,
                                    device="cpu", **kw)
        assert np.array_equal(dk, jk)
        assert (dcnt is None) == (jcnt is None)
        if jcnt is not None:
            assert np.array_equal(dcnt, jcnt.astype(np.uint64))


def test_extract_edge_cases_match_jax():
    jex, pex = JaxExtractor(), KmerExtractor()
    for seqs in ([], [b""], [b"ACG"], [b"NNNNNNNN"], [b"ACGTA", b"acgtN"]):
        for mode in ("basic", "both"):
            jk, jcnt = jex.extract(seqs, 5, mode=mode, with_counts=True)
            pk, pcnt = pex.extract(seqs, 5, mode=mode, with_counts=True,
                                   device="cpu")
            assert pk.shape == jk.shape and np.array_equal(pk, jk)
            assert np.array_equal(pcnt, jcnt)


def test_too_few_window_weights_raise_as_in_jax():
    rng = np.random.default_rng(3)
    seqs = random_seqs(rng, "ACGT", n=5, max_len=200)
    ww = weights_of(rng, seqs, 11, short=True)
    with pytest.raises(ValueError) as want:
        JaxExtractor()._packed_windows(seqs, 11, "basic", ww)
    with pytest.raises(ValueError) as got:
        KmerExtractor()._packed_windows(seqs, 11, "basic", ww, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("with_counts", (False, True))
@pytest.mark.parametrize("W", (1, 3))
def test_sorted_set_disk_spills_and_merges_as_jax(W, with_counts, tmp_path):
    rng = np.random.default_rng(W)
    batches = [rows(rng, int(n), W, distinct=3000)
               for n in rng.integers(100, 4000, 30)]
    counts = [rng.integers(1, 1000, len(b)).astype(np.uint64)
              for b in batches]
    sets = []
    for mod, kw in ((jds, {}), (pds, {"device": "cpu"})):
        s = mod.SortedSetDisk(ram_cap_bytes=1 << 16, tmp_dir=str(tmp_path),
                              with_counts=with_counts, **kw)
        for b, c in zip(batches, counts):
            s.insert(b, c if with_counts else None)
        blocks = list(s.merge(block_rows=500))
        for (k0, _), (k1, _) in zip(blocks, blocks[1:]):
            assert jpk.rows_lex_lt(k0[-1], k1[0])
        sets.append((s, blocks))
    (js, jblocks), (ps, pblocks) = sets
    assert ps.num_chunks >= 4 and ps.spilled_bytes > 0
    cat = [np.concatenate([b[i] for b in blk]) if with_counts or i == 0
           else None for blk in (jblocks, pblocks) for i in (0, 1)]
    assert np.array_equal(cat[2], cat[0])
    want = jpk.unique_rows(np.concatenate(batches),
                           np.concatenate(counts) if with_counts else None)
    assert np.array_equal(cat[2], want[0])
    if with_counts:
        assert np.array_equal(cat[3], cat[1].astype(np.uint64))
        assert np.array_equal(cat[3], want[1].astype(np.uint64))
    for s in (js, ps):
        s.cleanup()


def test_sorted_set_disk_missing_dir_raises_as_jax(tmp_path):
    missing = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError) as want:
        jds.SortedSetDisk(tmp_dir=missing)
    with pytest.raises(FileNotFoundError) as got:
        pds.SortedSetDisk(tmp_dir=missing)
    assert got.value.errno == want.value.errno
    assert got.value.filename.startswith(missing + "/mg_sortdisk_")
    assert want.value.filename.startswith(missing + "/mg_sortdisk_")


# --------------------------------------------------------------------------
# construct
# --------------------------------------------------------------------------

CONSTRUCT = (("DNA", 2), ("DNA", 3), ("DNA", 17), ("DNA", 31),
             ("DNA", 33), ("DNA5", 9), ("DNA_CASE", 22), ("Protein", 5),
             ("Protein", 20))


@pytest.mark.parametrize("alphabet,K", CONSTRUCT)
def test_construct_matches_jax(alphabet, K):
    rng = np.random.default_rng(K)
    seqs = random_seqs(rng, LETTERS[alphabet], n=25)
    # short sequences leave many sink and source nodes
    seqs += [s[: K + 3] for s in random_seqs(rng, LETTERS[alphabet], n=20)]
    alph = JAX_ALPHABETS[alphabet]
    bits = jpk.bits_for_alphabet(alph.sigma)
    kmers, counts = JaxExtractor(alph).extract(seqs, K, with_counts=True)
    counts = counts.astype(np.uint64)
    d_want = jc.generate_dummy_kmers(kmers, bits=bits)
    d_got = pc.generate_dummy_kmers(kmers, bits=bits, device="cpu")
    assert d_got.dtype == np.uint8 and np.array_equal(d_got, d_want)
    assert len(d_want) or K <= 3        # every 2- and 3-mer occurs
    for cnt, width in ((None, 8), (counts, 8), (counts, 4), (counts, 64)):
        same_arrays(pc.build_boss_arrays(kmers, alph.sigma, cnt, width,
                                         device="cpu"),
                    jc.build_boss_arrays(kmers, alph.sigma, cnt, width),
                    (alphabet, K, width))
    # emit_boss of the JAX stream
    stream = np.concatenate([np.zeros((1, K), np.uint8), kmers, d_want])
    order = jpk.lexsort_rows(jpk.pack_codes(stream,
                                            jpk.boss_priority_order(K), bits))
    sc = np.concatenate([[0], counts, np.zeros(len(d_want), np.uint64)]
                        ).astype(np.uint64)[order]
    same_arrays(pc.emit_boss(stream[order], alph.sigma, sc, 6, device="cpu"),
                jc.emit_boss(stream[order], alph.sigma, sc, 6))


def test_construct_of_no_kmers_matches_jax():
    for K in (2, 5, 21):
        empty = np.zeros((0, K), np.uint8)
        same_arrays(pc.build_boss_arrays(empty, device="cpu"),
                    jc.build_boss_arrays(empty))
        same_arrays(pc.build_boss_arrays(empty, device="cpu"),
                    pc.empty_boss_arrays(K))


# --------------------------------------------------------------------------
# count inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("text", ("ka:f:12.5", "km:f:0.2", "x ka:f:3e2 y",
                                  "ka:f:-2.5", "ka:f:abc", "kf:f:3", "",
                                  "ka:f:7.49999", "km:f:1e30"))
def test_parse_abundance_matches_jax(text):
    assert pfa.parse_abundance(text) == jfa.parse_abundance(text)


def test_read_kmer_counts_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    recs = [(f"r{i}", "".join(rng.choice(list("ACGT"), size=60)))
            for i in range(4)]
    counts = [rng.integers(1, 100, 50) for _ in recs]
    for name in ("a.fasta.gz", "b.fa", "c"):
        path = str(tmp_path / name)
        jfa.write_extended_fasta(path, recs, counts, 11)
        got, want = pfa.read_kmer_counts(path), jfa.read_kmer_counts(path)
        assert pfa._counts_sidecar(path) == jfa._counts_sidecar(path)
        assert len(got) == len(want) == 4
        assert all(np.array_equal(g, w) and g.dtype == w.dtype
                   for g, w in zip(got, want))
    assert pfa.read_kmer_counts(str(tmp_path / "none.fa")) is None


# --------------------------------------------------------------------------
# DBGSuccinct.build: routes and the builds it refused before
# --------------------------------------------------------------------------

# the refusal cases that this slice ports, each now a parity case
HOST_CASES = {"mode-canonical": dict(mode="canonical"),
              "mode-primary": dict(mode="primary"),
              "alphabet-DNA5": dict(alphabet="DNA5"),
              "alphabet-DNA_CASE": dict(alphabet="DNA_CASE"),
              "alphabet-Protein": dict(alphabet="Protein"),
              "k-2": dict(k=2), "k-22": dict(k=22), "k-31": dict(k=31),
              "with_counts": dict(with_counts=True),
              "count-width-4": dict(with_counts=True, bits_per_count=4),
              "disk_swap": dict(disk_swap="swap"),
              "mem_cap_bytes": dict(mem_cap_bytes=1 << 16),
              "window_weights": dict(window_weights="ok"),
              "canonical-k31-counts": dict(mode="canonical", k=31,
                                           with_counts=True),
              "protein-k20-disk": dict(alphabet="Protein", k=20,
                                       disk_swap="swap",
                                       mem_cap_bytes=1 << 16)}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_dbg_build_matches_jax(name, tmp_path):
    kw = {"k": 11, **HOST_CASES[name]}
    rng = np.random.default_rng(len(name))
    alphabet = kw.pop("alphabet", "DNA")
    seqs = random_seqs(rng, LETTERS[alphabet])
    if kw.get("window_weights") == "ok":
        kw.update(with_counts=True,
                  window_weights=weights_of(rng, seqs, kw["k"]))
    if kw.get("disk_swap") == "swap":
        kw["disk_swap"] = str(tmp_path)
    want = JaxDBG.build(seqs, alphabet=JAX_ALPHABETS[alphabet], **kw)
    got = DBGSuccinct.build(seqs, alphabet=alphabet, device="cpu", **kw)
    same_arrays(got.boss, want.boss, name)
    assert got.mode == want.mode and got.k == want.k
    assert got.alphabet == want.alphabet.name
    assert got.boss.count_width == want.boss.count_width
    assert got.num_nodes() == want.num_nodes()
    assert list(tmp_path.iterdir()) == []       # the spill dir is removed
    route = pdbg.build_route(kw["k"], kw.get("mode", "basic"), alphabet,
                             kw.get("with_counts", False),
                             kw.get("window_weights"), kw.get("disk_swap"),
                             kw.get("mem_cap_bytes"))
    assert route == ("device" if name in ("mode-canonical", "mode-primary")
                     else "general")


@pytest.mark.parametrize("kw,exc", ((dict(disk_swap="/nonexistent"),
                                     FileNotFoundError),
                                    (dict(window_weights=[None]), TypeError),
                                    (dict(window_weights="short"),
                                     ValueError)),
                         ids=("disk_swap-missing", "window_weights-None",
                              "window_weights-short"))
def test_dbg_build_raises_as_jax(kw, exc):
    seqs = [b"ACGTACGTACGTAGCTAGCA", b"ACGTTGCATTGCAGGCAT"]
    if kw.get("window_weights") == "short":
        kw = dict(with_counts=True, window_weights=[np.ones(10, np.uint64),
                                                    np.ones(3, np.uint64)])
    with pytest.raises(exc) as want:
        JaxDBG.build(seqs, 11, **kw)
    with pytest.raises(exc) as got:
        DBGSuccinct.build(seqs, 11, device="cpu", **kw)
    if exc is FileNotFoundError:            # mkdtemp's random suffix aside
        for e in (got.value, want.value):
            assert e.filename.startswith("/nonexistent/mg_sortdisk_")
        assert got.value.errno == want.value.errno
    else:
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ("basic", "canonical", "primary"))
def test_host_modes_have_no_dummy_limit(mode, monkeypatch):
    """Past the JAX device construction's dummy-node limit, basic mode
    raises its RuntimeError; canonical and primary, which JAX builds on
    its host construction, build."""
    rng = np.random.default_rng(9)
    seqs = random_seqs(rng, "ACGT", n=40, max_len=60)
    monkeypatch.setattr(db, "capd_limit", lambda capd, max_capd: 4)
    if mode == "basic":
        with pytest.raises(RuntimeError, match="dummy sink/source nodes"):
            DBGSuccinct.build(seqs, 11, mode=mode, device="cpu")
        return
    got = DBGSuccinct.build(seqs, 11, mode=mode, device="cpu")
    want = JaxDBG.build(seqs, 11, mode=mode)
    same_arrays(got.boss, want.boss, mode)


@pytest.mark.parametrize("K", (3, 11, 16, 17, 21))
def test_build_windows_strand_mode(K):
    """D1's second strand (plain version): each key's reverse complement,
    checked against the keys of the reverse-complemented windows."""
    from metagraph_tpu_torch._u32 import np_words
    from metagraph_tpu_torch.query.device import wire_words_layout
    from metagraph_tpu_torch.query.tile_pack import tile_pack2
    rng = np.random.default_rng(K)
    seqs = random_seqs(rng, "ACGTN", n=20, max_len=900)
    tiles2, validb, _, _ = tile_pack2(seqs, K, db.T_WIRE)
    words, vwords = wire_words_layout(tiles2, validb, K, db.T_WIRE,
                                      len(tiles2))
    words, vwords = np_words(words), np_words(vwords)
    one = db.build_windows(words, vwords, K)
    two = db.build_windows(words, vwords, K, strands=2)
    n = len(one)
    assert len(two) == 2 * n and torch.equal(two[:n], one)
    sent = 1 << (2 * K)
    assert torch.equal(two[n:] == sent, one == sent)
    fwd = one[one != sent]
    chars = [((fwd >> (2 * i)) & 3) for i in range(K)]
    rc = sum((3 - chars[K - 1 - i]) << (2 * i) for i in range(K))
    assert torch.equal(two[n:][one != sent], rc)
    assert torch.equal(db.rc_keys_plain(two[n:], K), one)


def test_route_line_under_verbose(capsys):
    from metagraph_tpu_torch.utils.timer import set_trace
    set_trace(True)
    try:
        DBGSuccinct.build([b"ACGTACGTAGCTAGCA"], 5, mode="canonical",
                          device="cpu")
        DBGSuccinct.build([b"ACGTACGTAGCTAGCA"], 5, with_counts=True,
                          device="cpu")
    finally:
        set_trace(False)
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if "build route" in ln]
    assert lines == ["[trace] build route: device (canonical mode, DNA, "
                     "k = 5)", "[trace] build route: general (basic mode, "
                     "DNA, k = 5)"]
