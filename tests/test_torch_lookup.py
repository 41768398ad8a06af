"""Kernels A and B, their plain versions, against metagraph_tpu.

* ``pack_codes32``/``pack_kmers32`` at 4 and 8 bits a code;
* the plain ``device_pack_windows`` at K = 32, 33, 40, 41, 63 and 64 (keys
  of 4 to 8 words, the nibble order across word boundaries), and a numpy
  model of kernel B's own window arithmetic against it;
* the L2 controls' tables (``kernel_times.control_table``) and a rehearsal
  of ``kernel_times.py`` on two trees;
* the plain key lookup (kernel A) against ``_hash_lookup`` on the tables
  that both packages build for DNA5, DNA_CASE and Protein graphs and a DNA
  graph at k = 41, and the host window mapping (``map_batch``) against the
  JAX engine's;
* the plain ``codes_epoch`` (kernels B, 2, 3) against ``query_epoch_codes2``
  and ``query_epoch_codes``.

Inputs come from numpy seeds; every comparison is exact.  On the CPU the
port runs the plain PyTorch versions of its kernels (tests/test_torch_gpu.py
holds the CUDA kernels against them on the card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagraph_tpu.succinct import ops as jops
from metagraph_tpu_torch import convert
from metagraph_tpu_torch._u32 import np_words, to_u64, words_np
from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
from metagraph_tpu_torch.annotation.ops import pack_annotation_bitmap
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct as TorchDBG
from metagraph_tpu_torch.query import device as tdev
from metagraph_tpu_torch.query.pipeline import QueryEngine
from metagraph_tpu_torch.query.tile_pack import tile_pack2
from metagraph_tpu_torch.succinct import ops as tops

WIDE_KS = (32, 33, 40, 41, 63, 64)


@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("K", (2, 7, 19, 20, 31, 41, 64))
def test_packers_match(K, bits):
    rng = np.random.default_rng(K * bits)
    top = 16 if bits == 4 else 28
    chars = rng.integers(1, top, (300, K)).astype(np.uint8)
    np.testing.assert_array_equal(tops.pack_codes32(chars, bits=bits),
                                  jops.pack_codes32(chars, bits=bits))
    got = tops.pack_kmers32(chars, bits)
    np.testing.assert_array_equal(got, jops.pack_kmers32(chars, bits=bits))
    assert got.shape == (300, tops.key_words(K, bits))


@pytest.mark.parametrize("K", WIDE_KS)
def test_device_pack_windows_match(K):
    """Codes 1-4 with invalid codes (5, and above) in runs and alone."""
    rng = np.random.default_rng(K)
    codes = rng.integers(1, 5, (6, 3 * K + 17)).astype(np.int32)
    codes[1, K // 2] = 5
    codes[2, K: K + 4] = 7
    codes[3, -1] = 5
    want_p, want_v = jops.device_pack_windows(jnp.asarray(codes), K)
    got_p, got_v = tops.device_pack_windows(torch.from_numpy(codes), K)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_p.shape[-1] == -(-K // 8) and not got_v[1].all()
    # the words are the BOSS-order keys of the windows' chars
    chars = np.lib.stride_tricks.sliding_window_view(codes[0], K)
    np.testing.assert_array_equal(got_p[0].numpy(),
                                  tops.pack_kmers32(chars.astype(np.uint8)))


# --------------------------------------------------------------------------
# a numpy model of kernel B's window arithmetic (csrc/codes_lookup.cu)
# --------------------------------------------------------------------------

_LEAD, _CODE_WORDS, _VALID_WORDS = 4, 80, 40     # as in codes_lookup.cu


def _funnel(lo, hi, sh):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> sh, 0 <= sh < 32."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (both >> sh.astype(np.uint64)) & np.uint64(0xFFFFFFFF)


def _stage_row(row, mis, lead, cap, rng):
    """stage_row: the row's bytes placed ``mis`` bytes into aligned 4-byte
    words (the bytes around them random, as a neighbouring row's would be),
    after ``lead`` zero words, zeros up to ``cap`` words."""
    n = (mis + len(row) + 3) >> 2
    buf = rng.integers(0, 256, 4 * n).astype(np.uint8)
    buf[mis: mis + len(row)] = row
    out = np.zeros(cap, np.uint64)
    out[lead: lead + n] = buf.view("<u4")
    return out


def _model_tile(p2row, vbrow, K, T, cmis, vmis, rng):
    """Kernel B's keys and validity of one tile's T windows, by its
    arithmetic: funnel shifts over the staged 32-bit words, 16-bit halves
    spread to nibbles, char K-1 in the last word."""
    TK, W = T + K - 1, -(-K // 8)
    sc = _stage_row(p2row[: (TK + 3) >> 2], cmis, _LEAD, _CODE_WORDS, rng)
    sv = _stage_row(vbrow[: (TK + 7) >> 3], vmis, 0, _VALID_WORDS, rng)
    j = np.arange(T)
    vo = 8 * vmis + j
    g, sh = vo >> 5, vo & 31
    v = _funnel(sv[g], sv[g + 1], sh) \
        | (_funnel(sv[g + 1], sv[g + 2], sh) << np.uint64(32))
    need = np.uint64((1 << K) - 1)
    valid = (v & need) == need
    o = 32 * _LEAD + 8 * cmis + 2 * j + 2 * K - 130
    assert o.min() >= 0 and (o >> 5).max() + 4 < _CODE_WORDS
    g, sh = o >> 5, o & 31
    u = [_funnel(sc[g + i], sc[g + i + 1], sh) for i in range(4)]
    last = (sc[g + 4] >> sh.astype(np.uint64)) & np.uint64(3)
    r = (K - 1) & 7
    words = []
    for w in range(W):
        x = (u[3 - (w >> 1)] >> np.uint64(0 if w & 1 else 16)) \
            & np.uint64(0xFFFF)
        x = (x | x << np.uint64(8)) & np.uint64(0x00FF00FF)
        x = (x | x << np.uint64(4)) & np.uint64(0x0F0F0F0F)
        x = (x | x << np.uint64(2)) & np.uint64(0x33333333)
        x = x + np.uint64(0x11111111)
        if w == W - 1:
            keep = np.uint64((0xFFFFFFFF << (32 - 4 * r)) & 0xFFFFFFFF
                             if r else 0)
            x = (x & keep) | ((last + np.uint64(1)) << np.uint64(28 - 4 * r))
        words.append(x)
    return np.stack(words, -1), valid


@pytest.mark.parametrize("mis", ((0, 0), (1, 3), (2, 1), (3, 2)),
                         ids=lambda m: f"codes+{m[0]}-valid+{m[1]}")
@pytest.mark.parametrize("K", (2, 9) + WIDE_KS)
def test_codes_kernel_window_model_matches_jax(K, mis):
    """The model of kernel B's window keys and validity, with the tile rows
    at every byte alignment, against device_pack_windows on the unpacked
    tiles: reads with N runs (an N at a read's first and last position
    too), reads shorter than K, a read longer than a tile."""
    rng = np.random.default_rng(100 * K + mis[0])
    T = tdev.TILE
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seqs = []
    for i in range(12):
        read = rng.integers(0, 4, int(rng.integers(K - 2, 3 * K + 40)))
        for _ in range(i % 3):
            at = int(rng.integers(0, len(read)))
            read[at: at + int(rng.integers(1, 6))] = 4
        if i == 5:
            read[0] = read[-1] = 4
        seqs.append(letters[read].tobytes())
    seqs.append(letters[rng.integers(0, 4, T + 2 * K)].tobytes())
    t2, vb, _, _ = tile_pack2(seqs, K, T)
    codes = tops.tile_codes(torch.from_numpy(t2), torch.from_numpy(vb),
                            T + K - 1).numpy().astype(np.int32)
    want_p, want_v = jops.device_pack_windows(jnp.asarray(codes), K)
    want_p, want_v = np.asarray(want_p), np.asarray(want_v)
    for c in range(len(t2)):
        keys, valid = _model_tile(t2[c], vb[c], K, T, *mis, rng)
        np.testing.assert_array_equal(valid, want_v[c])
        np.testing.assert_array_equal(keys[valid], want_p[c][valid])
    assert want_v.any() and not want_v.all()


# --------------------------------------------------------------------------
# the L2 controls and kernel_times.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits,K", ((4, 41), (8, 20)))
def test_control_table_keeps_load_and_keys(bits, K):
    """control_table: 2^log buckets at the source table's load, slots filled
    from slot 0, each kept key found with its id by the plain lookup."""
    from metagraph_tpu_torch.scripts.kernel_times import control_table
    rng = np.random.default_rng(K)
    n, nb = 8000, 1 << 12           # about 1.95 keys a bucket
    keys = tops.pack_kmers32(rng.integers(1, 5 if bits == 4 else 21, (n, K))
                             .astype(np.uint8), bits)
    table = tops.DeviceHashIndex._build(keys, np.arange(1, n + 1,
                                                        dtype=np.uint32), nb)
    ctab = control_table(table.reshape(nb, -1), 8)
    W = keys.shape[1]
    assert ctab.shape == (256, tops.BUCKET * (W + 1))
    tops.check_slot_fill(ctab)
    slots = ctab.reshape(256, tops.BUCKET, W + 1)
    slots = slots[slots[:, :, 0] != tops.EMPTY_WORD]
    assert abs(len(slots) / 256 - n / nb) < 0.05
    got = tops.key_lookup(np_words(slots[:, :W].copy()), np_words(ctab))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), slots[:, W])


def test_kernel_times_rehearsal_takes_turns(tmp_path):
    """kernel_times.py --rehearse on two trees (this one twice): every
    phase at a tiny size on the CPU, each tree's turn in order and then in
    reverse, exit code 2 and no result line."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "metagraph_tpu_torch", "scripts",
                          "kernel_times.py")
    out = subprocess.run([sys.executable, script, "--rehearse", "--root",
                          root, "--root", root], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 2, out.stderr[-2000:]
    turns = [ln for ln in out.stdout.splitlines() if ln.startswith("turn ")]
    assert len(turns) == 4
    for name in ("key_lookup L2 control", "codes_lookup L2 control",
                 "sw_scores", "selection_mask", "radix_sort edge",
                 "radix_sort join sentinel", "radix_sort sink",
                 "radix_sort source", "radix_sort stream",
                 "torch.sort stream", "emit_keys", "build_emit",
                 "build_p2"):
        assert sum(name in ln for ln in out.stdout.splitlines()) >= 4
    assert not out.stdout.rstrip().endswith("}")


def test_kernel_times_build_only_rehearsal(tmp_path):
    """kernel_times.py --rehearse --build-only: D2's and D4's cases alone,
    in each tree's turns, exit code 2 and no result line."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "metagraph_tpu_torch", "scripts",
                          "kernel_times.py")
    out = subprocess.run([sys.executable, script, "--rehearse",
                          "--build-only", "--root", root, "--root", root],
                         capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert out.returncode == 2, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("turn ") for ln in lines) == 4
    for name in ("radix_sort edge", "radix_sort join sentinel",
                 "radix_sort sink", "radix_sort source", "radix_sort stream",
                 "torch.sort stream", "emit_keys", "build_emit", "D4:",
                 "build_p2"):
        assert sum(name in ln for ln in lines) >= 4, name
    for name in ("key_lookup", "codes_lookup", "sw_scores",
                 "selection_mask"):
        assert not any(name in ln for ln in lines), name
    assert not out.stdout.rstrip().endswith("}")


# --------------------------------------------------------------------------
# graphs of other alphabets and wide k
# --------------------------------------------------------------------------

GRAPHS = [("DNA5", 19), ("DNA_CASE", 19), ("Protein", 20), ("DNA", 41)]
_LETTERS = {"DNA5": "ACGTN", "DNA_CASE": "ACGTNacgt",
            "Protein": "ACDEFGHIKLMNPQRSTVWY", "DNA": "ACGT"}


def _refs(rng, alphabet, n=6, length=400):
    letters = list(_LETTERS[alphabet])
    p = np.ones(len(letters))
    if "N" in letters:
        p[letters.index("N")] = 0.2
    p /= p.sum()
    return ["".join(rng.choice(letters, size=length, p=p)).encode()
            for _ in range(n)]


def _queries(rng, alphabet, refs, k):
    """Reads of the references with substitutions (characters of the
    alphabet, and bytes outside it), short and empty ones."""
    out = []
    for i, s in enumerate(refs):
        out.append(s[i * 9: i * 9 + 150])
        q = bytearray(s[40: 200])
        for p in range(0, len(q), 23):
            q[p] = ord(rng.choice(list(_LETTERS[alphabet] + "N*")))
        out.append(bytes(q))
    return out + [b"", refs[0][:k - 1], refs[1][:k], b"N" * 50]


@pytest.fixture(scope="module", params=GRAPHS,
                ids=[f"{a}-k{k}" for a, k in GRAPHS])
def graph(request, tmp_path_factory):
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.column import \
        ColumnMajorAnnotation as JaxColumns
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu.kmer.alphabets import ALPHABETS
    from metagraph_tpu.query.pipeline import QueryEngine as JaxEngine
    alphabet, k = request.param
    rng = np.random.default_rng(k + len(alphabet))
    refs = _refs(rng, alphabet)
    g = DBGSuccinct.build(refs, k, alphabet=ALPHABETS[alphabet])
    anno = JaxColumns(g.max_index())
    ag = AnnotatedDBG(g, anno)
    for i, s in enumerate(refs):
        ag.annotate_sequence(s, [f"s{i}", "all"] if i % 2 else [f"s{i}"])
    tmp = tmp_path_factory.mktemp(f"{alphabet}{k}")
    g.save(str(tmp / "g"))
    anno.save(str(tmp / "a.column.annodbg"))
    jax_engine = JaxEngine(ag, use_device=True)
    jax_engine._build_device_index()
    index = convert.load(str(tmp / "g.dbg"), str(tmp / "a.column.annodbg"))
    return dict(alphabet=alphabet, k=k, g=g, refs=refs, jax=jax_engine,
                index=index, queries=_queries(rng, alphabet, refs, k),
                tmp=tmp)


def test_index_matches_jax(graph):
    index, eng = graph["index"], graph["jax"]
    assert (index.alphabet, index.k, index.canon) == (graph["alphabet"],
                                                     graph["k"], 0)
    assert index.bits == eng._bits == (8 if graph["alphabet"] == "Protein"
                                       else 4)
    table = np.asarray(eng._device_index.table)
    assert index.table.tobytes() == table.tobytes()
    tg = TorchDBG.load(str(graph["tmp"] / "g.dbg"))
    assert (tg.alphabet, tg.k) == (graph["alphabet"], graph["k"])
    assert tg.max_index() == graph["g"].max_index()


def test_key_lookup_matches_jax(graph):
    """Every k-mer of the graph (hits), mutated and random keys (misses)."""
    index, k = graph["index"], graph["k"]
    rng = np.random.default_rng(k)
    boss = graph["g"].boss
    valid = np.flatnonzero(np.asarray(boss.valid))
    chars = np.asarray(boss.get_edge_seq(valid)).astype(np.uint8)
    top = int(chars.max())
    other = chars.copy()
    at = rng.integers(0, k, len(other))
    rows = np.arange(len(other))
    other[rows, at] = other[rows, at] % top + 1         # one substitution
    other = np.concatenate([other, rng.integers(1, top + 1, (500, k))
                            .astype(np.uint8)])
    keys = tops.pack_kmers32(np.concatenate([chars, other]), index.bits)
    want = np.asarray(jops._hash_lookup(jnp.asarray(index.table),
                                        jnp.asarray(keys)))
    got = tops.key_lookup(np_words(keys), np_words(index.table))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:len(chars)], valid)
    assert (want[len(chars):] == 0).mean() > 0.5


def test_map_batch_matches_jax(graph):
    eng = QueryEngine(graph["index"], device="cpu")
    assert eng.route == ("codes" if graph["alphabet"] == "DNA" else "map")
    want = graph["jax"].map_batch(graph["queries"])
    got = eng.map_batch(graph["queries"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sum(int((a > 0).sum()) for a in got) > 300


# --------------------------------------------------------------------------
# the codes epoch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", (32, 33, 41, 64))
def test_codes_epoch_matches_jax(K):
    """codes_epoch against query_epoch_codes2 (2-bit tiles) and
    query_epoch_codes (code tiles), on a port-built index."""
    from metagraph_tpu import native
    from metagraph_tpu.query.device import (query_epoch_codes,
                                            query_epoch_codes2,
                                            tile_codes_layout)
    from metagraph_tpu.kmer.extractor import KmerExtractor
    rng = np.random.default_rng(5000 + K)
    refs = rng.integers(0, 4, (5, 700)).astype(np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(refs, K, axis=1)
    chars, inv = np.unique(win.reshape(-1, K) + 1, axis=0,
                           return_inverse=True)
    ref_of = np.repeat(np.arange(5), 700 - K + 1)
    cols = [np.unique(inv.reshape(-1)[ref_of == c]) for c in range(5)]
    labels = [f"s{c}" for c in range(5)]
    anno = ColumnMajorAnnotation(len(chars), labels, cols)
    bitmap = pack_annotation_bitmap(anno)
    index = convert.from_kmers(tops.pack_kmers32(chars),
                               np.arange(1, len(chars) + 1, dtype=np.uint32),
                               bitmap, labels, K, anno)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seqs = []
    for i in range(30):
        r = refs[i % 5]
        a = int(rng.integers(0, 500))
        read = r[a: a + int(rng.integers(K - 2, 200))].copy()
        read[rng.random(len(read)) < 0.01] = 4
        seqs.append(letters[read].tobytes())
    seqs += [letters[np.tile(refs[0], 2)].tobytes(), b""]
    S, L = len(seqs), len(labels)
    t2, vb, tile_seq, nwins = tile_pack2(seqs, K, tdev.TILE)
    n2, nv, nts, nnw = native.tile_pack2(seqs, K, tdev.TILE)
    np.testing.assert_array_equal(t2, n2)
    np.testing.assert_array_equal(vb, nv)
    dsel, selmin = tdev._thresholds(nwins, 0.6, 0.1)
    mask, counts, present, nodes = tdev.codes_epoch(
        np_words(index.table), np_words(index.device_anno), torch.from_numpy(t2),
        torch.from_numpy(vb), torch.from_numpy(tile_seq),
        torch.from_numpy(dsel), torch.from_numpy(selmin), S, L, K)
    want = query_epoch_codes2(
        jnp.asarray(index.table), jnp.asarray(index.device_anno), jnp.asarray(t2),
        jnp.asarray(vb), jnp.asarray(tile_seq), jnp.asarray(dsel),
        jnp.asarray(selmin), S, L, K, tdev.TILE + K - 1)
    n = len(t2)
    np.testing.assert_array_equal(words_np(mask), np.asarray(want[0]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(present.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(want[3])[:n])
    ex = KmerExtractor()
    tiles, tseq, _ = tile_codes_layout([ex.encode(s) for s in seqs], K)
    want_c = query_epoch_codes(jnp.asarray(index.table),
                               jnp.asarray(index.device_anno), jnp.asarray(tiles),
                               jnp.asarray(tseq), S, L, K)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c[0]))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(want_c[2])[:n])
    assert (nodes.numpy() > 0).sum() > 1000 and words_np(mask).any()
    # the index's first keys find their ids
    keys = to_u64(np_words(tops.pack_kmers32(chars[:50])))
    assert (tops._hash_lookup_flat(np_words(index.table), keys, -(-K // 8))
            .numpy() == np.arange(1, 51)).all()
