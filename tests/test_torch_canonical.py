"""Canonical and primary graphs: the port against metagraph_tpu.

* the canonical key ops (``rc_keys2``, ``boss_rot2``, ``keys2_greater``)
  against metagraph_tpu/succinct/ops.py for K in {2, 15, 16, 17, 31};
* ``wire_epoch`` with canon 1 and 2 against ``query_epoch_wire_buf``;
* the port's ``QueryEngine`` payloads in four modes against the JAX
  engine's ``query_batch_fused``, with state from ``from_jax_arrays`` and
  from ``convert.load`` of the saved artifacts;
* the port CLI's bytes against the JAX CLI's.

Graphs are built as in tests/test_device_ops.py's ``_fused_vs_host``: a
canonical graph, and a primary graph that the JAX engine and CLI query
through ``CanonicalDBG``.  Every comparison is exact; on the CPU the port
runs the plain versions of its kernels.
"""

import contextlib
import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagraph_tpu.succinct import ops as jops
from metagraph_tpu_torch import convert
from metagraph_tpu_torch._u32 import np_words, to_u64, words_np
from metagraph_tpu_torch.annotation.annotated_dbg import graph_to_anno_index
from metagraph_tpu_torch.annotation.column import \
    ColumnMajorAnnotation as TorchColumns
from metagraph_tpu_torch.graph.canonical import CanonicalDBG
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct as TorchDBG
from metagraph_tpu_torch.query import device as tdev
from metagraph_tpu_torch.query.pipeline import QueryEngine
from metagraph_tpu_torch.succinct import ops as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (2, 15, 16, 17, 31)
MODES = ("labels", "matches", "counts", "signature")
CASES = [("canonical", 19), ("canonical", 31), ("primary", 19),
         ("primary", 31)]


def _norm(payloads):
    def third(v):
        return v.tolist() if isinstance(v, np.ndarray) else v
    return [[(t[0], t[1], third(t[2])) if isinstance(t, tuple) and len(t) == 3
             else t for t in seq_r] for seq_r in payloads]


# --------------------------------------------------------------------------
# key ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", KS)
def test_key_ops_match_jax(K):
    rng = np.random.default_rng(600 + K)
    chars = rng.integers(1, 5, (700, K)).astype(np.uint8)
    other_chars = np.concatenate(
        [chars[:300], 5 - chars[300:500, ::-1],       # reverse complements
         rng.integers(1, 5, (200, K)).astype(np.uint8)])
    keys, other = jops.pack_kmers2(chars), jops.pack_kmers2(other_chars)
    tk, to = to_u64(np_words(keys)), to_u64(np_words(other))
    rc_want = np.asarray(jops.rc_keys2(jnp.asarray(keys), K))
    rc_got = tops.rc_keys2(tk, K)
    np.testing.assert_array_equal(rc_got.numpy(), rc_want)
    # rc is the reverse complement of the chars, and an involution
    np.testing.assert_array_equal(rc_want, jops.pack_kmers2(5 - chars[:, ::-1]))
    np.testing.assert_array_equal(tops.rc_keys2(rc_got, K).numpy(), keys)
    for a, b in zip(tops.boss_rot2(tk, K),
                    jops.boss_rot2(jnp.asarray(keys), K)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for x, y, jx, jy in ((tk, to, keys, other), (tk, rc_got, keys, rc_want),
                         (to, tk, other, keys)):
        want = np.asarray(jops.keys2_greater(jnp.asarray(jx),
                                             jnp.asarray(jy), K))
        np.testing.assert_array_equal(tops.keys2_greater(x, y, K).numpy(),
                                      want)
    # BOSS order is the order of the pack_kmers32 nibble keys as integers
    big = lambda a: [int("".join(f"{w:08x}" for w in r), 16) for r in a]
    want = [x > y for x, y in zip(big(jops.pack_kmers32(chars)),
                                  big(jops.pack_kmers32(other_chars)))]
    np.testing.assert_array_equal(tops.keys2_greater(tk, to, K).numpy(),
                                  want)


# --------------------------------------------------------------------------
# graphs
# --------------------------------------------------------------------------

def _build(mode_name, k):
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu.graph.canonical import CanonicalDBG as JaxCanonical
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
    rng = np.random.default_rng(23 + k)
    refs = ["".join(rng.choice(list("ACGT"), size=400)).encode()
            for _ in range(6)]
    refs[0] = refs[0] + refs[0][50:170]        # repeated k-mers: counts 2
    g = DBGSuccinct.build(refs, k, mode=mode_name)
    graph = JaxCanonical(g) if mode_name == "primary" else g
    anno = ColumnMajorAnnotation(g.max_index())
    ag = AnnotatedDBG(graph, anno)
    for i, s in enumerate(refs):
        ag.annotate_sequence(s, [f"s{i}"])
        ag.annotate_kmer_counts(s, [f"s{i}"])
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    queries = []
    for i, s in enumerate(refs):
        queries.append(s[i * 10: i * 10 + 120])
        queries.append(s[30: 200][::-1].translate(comp))
        q = bytearray(s[50: 180])
        for p in range(0, len(q), 17):
            q[p] = ord(rng.choice(list("ACGTN")))
        queries.append(bytes(q))
        queries.append(bytes(q)[::-1].translate(comp))
    queries += [b"N" * 60, b"ACG", refs[0][:k - 1], refs[1][:k],
                refs[2][:150] + refs[3][:150][::-1].translate(comp)]
    return g, anno, ag, queries


_NATIVE_WAIT = [120.0]      # seconds left to wait for the native library


def native_lib():
    """The JAX package's native library, without which its engine's
    ``query_batch_fused`` returns None on canonical and primary graphs.  In
    a fresh checkout the parallel workers each build it with g++ into the
    same file at their first use, and a worker that loads the file while
    another is still writing it keeps None for the rest of its run.  So
    while the file exists but does not load, wait and load it again, two
    minutes at most in all; the JAX package is left as it is."""
    from metagraph_tpu import native
    while native.get_lib() is None and os.path.exists(native._SO) \
            and _NATIVE_WAIT[0] > 0:
        time.sleep(1.0)
        _NATIVE_WAIT[0] -= 1.0
        native._lib = None
    return native.get_lib()


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{m}-k{k}" for m, k in CASES])
def case(request, tmp_path_factory):
    from metagraph_tpu.query.pipeline import QueryEngine as JaxEngine
    assert native_lib() is not None, "the JAX native library does not load"
    mode_name, k = request.param
    g, anno, ag, queries = _build(mode_name, k)
    jax_engine = JaxEngine(ag, use_device=True)
    assert jax_engine._canon_mode() == (1 if mode_name == "canonical" else 2)
    want = {m: jax_engine.query_batch_fused(queries, m, 3, 0.6, 0.05)
            for m in MODES}
    assert all(w is not None for w in want.values())
    tmp = tmp_path_factory.mktemp(f"{mode_name}{k}")
    g.save(str(tmp / "g"))
    anno.save(str(tmp / "a.column.annodbg"))
    return dict(mode=mode_name, k=k, g=g, anno=anno, jax_engine=jax_engine,
                queries=queries, want=want, tmp=tmp)


def _from_jax_arrays(c):
    eng, anno = c["jax_engine"], c["anno"]
    L = anno.num_labels
    cols = TorchColumns(anno.num_rows,
                        [anno.encoder.decode(i) for i in range(L)],
                        [anno.column_rows(i) for i in range(L)],
                        values=[anno._values[i] for i in range(L)],
                        has_values=anno.has_values)
    eng._build_device_index()
    return convert.from_jax_arrays(
        np.asarray(eng._device_index.table),
        eng._build_device_annotation().unpacked(), cols.labels, c["k"],
        c["g"].max_index(), cols, eng._canon_mode())


def _from_files(c):
    return convert.load(str(c["tmp"] / "g.dbg"),
                        str(c["tmp"] / "a.column.annodbg"))


def test_wire_epoch_matches_jax(case):
    """canon 1 / 2 wire epoch: nodes, counts, present and mask."""
    from metagraph_tpu import native
    from metagraph_tpu.query.device import (TILE, query_epoch_wire_buf,
                                            wire_epoch_buffer,
                                            wire_words_layout)
    from metagraph_tpu.query.pipeline import _thresholds
    eng, K = case["jax_engine"], case["k"]
    seqs = case["queries"]
    S, L = len(seqs), case["anno"].num_labels
    t2, vb, tile_seq, nwins = native.tile_pack2(seqs, K, TILE)
    dsel, selmin = _thresholds(nwins, 0.6, 0.05, S)
    words, vwords = wire_words_layout(t2, vb, K, TILE, len(t2))
    eng._build_device_index()
    danno = eng._build_device_annotation()
    canon, offset = eng._canon_mode(), int(eng._canonical_offset or 0)
    buf = wire_epoch_buffer(words, vwords, tile_seq, dsel, selmin)
    want = query_epoch_wire_buf(
        eng._device_index.table, danno.bitmap, jnp.asarray(buf), len(words),
        words.shape[1], vwords.shape[1], S, L, K, TILE, canon, offset)
    idx = _from_jax_arrays(case)
    assert (idx.canon, idx.offset) == (canon, offset)
    mask, counts, present, nodes = tdev.wire_epoch(
        np_words(idx.table), np_words(idx.device_anno), np_words(words),
        np_words(vwords), torch.from_numpy(tile_seq),
        torch.from_numpy(dsel), torch.from_numpy(selmin), S, L, K, TILE,
        canon, offset)
    n = len(words)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(want[3])[:n])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(present.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(words_np(mask), np.asarray(want[0]))
    got = nodes.numpy()
    assert (got > 0).sum() > 300
    if canon == 2:       # the reverse-complement queries hit through rc
        assert (got > offset).sum() > 300
        # the rc hits count through their base rows
        fwd_only = tdev.label_counts(torch.where(nodes > offset, 0, nodes),
                                     np_words(idx.device_anno),
                                     torch.from_numpy(tile_seq), S, L)
        assert (counts - fwd_only[0]).sum() > 300


@pytest.mark.parametrize("source", ("jax_arrays", "files"))
@pytest.mark.parametrize("mode", MODES)
def test_payloads_match_jax(case, source, mode):
    index = _from_jax_arrays(case) if source == "jax_arrays" \
        else _from_files(case)
    engine = QueryEngine(index, device="cpu")
    got = engine.query_batch_fused(case["queries"], mode, 3, 0.6, 0.05)
    assert _norm(got) == _norm(case["want"][mode])
    assert sum(bool(p) for p in got) > 10


def test_index_from_files_equals_jax_state(case):
    a, b = _from_jax_arrays(case), _from_files(case)
    assert a.table.tobytes() == b.table.tobytes()
    np.testing.assert_array_equal(a.device_anno, b.device_anno)
    assert a.labels == b.labels
    assert (a.canon, a.offset) == (b.canon, b.offset)
    assert b.canon == (1 if case["mode"] == "canonical" else 2)


def test_graph_ids_match_jax(case):
    """The loaded graph's mode and max_index, and CanonicalDBG's id
    arithmetic and the annotation-row fold, against the JAX package."""
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.graph.canonical import CanonicalDBG as JaxCanonical
    g = TorchDBG.load(str(case["tmp"] / "g.dbg"))
    assert g.mode == case["mode"] and g.k == case["k"]
    assert g.max_index() == case["g"].max_index()
    if case["mode"] != "primary":
        with pytest.raises(ValueError):
            CanonicalDBG(g)
        return
    cg, jg = CanonicalDBG(g), JaxCanonical(case["g"])
    assert (cg.offset, cg.max_index()) == (jg.offset, jg.max_index())
    nodes = np.arange(1, jg.max_index() + 1)
    np.testing.assert_array_equal(
        cg.get_base_node(nodes), [jg.get_base_node(int(n)) for n in nodes])
    np.testing.assert_array_equal(
        cg.reverse_complement_node(nodes),
        [jg.reverse_complement_node(int(n)) for n in nodes])
    ag = AnnotatedDBG(jg, case["anno"])
    np.testing.assert_array_equal(graph_to_anno_index(nodes, cg.offset),
                                  ag.graph_to_anno_index(nodes))


def test_query_records_match_jax(case):
    from metagraph_tpu.seq_io.fasta import FastaRecord
    records = [FastaRecord(f"q{i}", s) for i, s in enumerate(case["queries"])]
    engine = QueryEngine(_from_files(case), device="cpu")
    for mode in ("labels", "counts"):
        kw = dict(num_top_labels=2, discovery_fraction=0.5,
                  presence_fraction=0.0, fwd_and_reverse=True,
                  batch_size_bp=700)
        want = [r.to_string(":", False, False, case["k"])
                for r in case["jax_engine"].query_records(records, mode, **kw)]
        got = [r.to_string(":", False, False, case["k"])
               for r in engine.query_records(records, mode, **kw)]
        assert got == want


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=("canonical", "primary"))
def cli_index(request, tmp_path_factory):
    from metagraph_tpu.cli.main import main as jax_main
    tmp = tmp_path_factory.mktemp(f"cli_{request.param}")
    rng = np.random.default_rng(43)
    refs = ["".join(rng.choice(list("ACGT"), size=int(n)))
            for n in rng.integers(200, 600, size=8)]
    refs[3] = refs[3] + refs[3][40:140]
    with open(tmp / "refs.fa", "w") as f:
        f.writelines(f">ref{i} sample\n{s}\n" for i, s in enumerate(refs))
    comp = str.maketrans("ACGT", "TGCA")
    queries = []
    for i, s in enumerate(refs):
        queries.append(s[i * 7: i * 7 + 150])
        queries.append(s[20:180][::-1].translate(comp))
        q = list(s[60:200])
        for p in range(0, len(q), 13):
            q[p] = "ACGTN"[int(rng.integers(5))]
        queries.append("".join(q))
        queries.append("".join(q)[::-1].translate(comp))
    queries += ["N" * 50, "ACGTA", refs[0][:30] + "NNNN" + refs[1][:60]]
    with open(tmp / "q.fa", "w") as f:
        f.writelines(f">q{i}\n{s}\n" for i, s in enumerate(queries))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_main(["build", "-k", "19", "--mode", request.param, "-o",
                  str(tmp / "g"), str(tmp / "refs.fa")])
        jax_main(["annotate", "-i", str(tmp / "g.dbg"), "--anno-header",
                  "--count-kmers", "-o", str(tmp / "a"),
                  str(tmp / "refs.fa")])
    return tmp


CLI_OPTIONS = [
    ["--query-mode", "labels"],
    ["--query-mode", "counts", "--min-kmers-fraction-label", "0.3"],
    ["--query-mode", "signature", "--json", "--fwd-and-reverse"],
    ["--query-mode", "matches", "--num-top-labels", "2",
     "--fwd-and-reverse", "--batch-size", "400"],
]


@pytest.mark.parametrize("opts", CLI_OPTIONS, ids=lambda o: " ".join(o))
def test_cli_stdout_matches_jax(cli_index, opts):
    from metagraph_tpu.cli.main import main as jax_main
    args = ["query", "-i", str(cli_index / "g.dbg"), "-a",
            str(cli_index / "a.column.annodbg"), *opts]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_main(args + ["--device", str(cli_index / "q.fa")])
    want = buf.getvalue().encode()
    env = dict(os.environ, PYTHONPATH=REPO)
    got = subprocess.run(
        [sys.executable, "-m", "metagraph_tpu_torch", *args, "--device",
         "--torch-device", "cpu", str(cli_index / "q.fa")],
        capture_output=True, env=env, cwd=str(cli_index), timeout=120)
    assert got.returncode == 0, got.stderr.decode()[-2000:]
    assert got.stdout == want
    assert want.count(b"\n") >= 35
