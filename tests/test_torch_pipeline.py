"""The port's QueryEngine against metagraph_tpu's device QueryEngine.

Basic-mode DNA graphs at k = 19 and 31, built like test_device_ops.py's
``_fused_vs_host``, with an annotation that carries k-mer counts.  The port
gets its state once from the JAX engine's arrays (``from_jax_arrays``) and
once from the artifacts the JAX package saved (``convert.load``).  The
payloads of all four modes must be equal.
"""

import numpy as np
import pytest

from metagraph_tpu_torch import convert
from metagraph_tpu_torch.annotation.annotated_dbg import get_min_count
from metagraph_tpu_torch.annotation.column import \
    ColumnMajorAnnotation as TorchColumns
from metagraph_tpu_torch.query.device import _thresholds
from metagraph_tpu_torch.query.pipeline import QueryEngine

MODES = ("labels", "matches", "counts", "signature")


def _norm(payloads):
    def third(v):
        return v.tolist() if isinstance(v, np.ndarray) else v
    return [[(t[0], t[1], third(t[2])) if isinstance(t, tuple) and len(t) == 3
             else t for t in seq_r] for seq_r in payloads]


def _build(k):
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
    rng = np.random.default_rng(23 + k)
    refs = ["".join(rng.choice(list("ACGT"), size=400)).encode()
            for _ in range(6)]
    refs[0] = refs[0] + refs[0][50:170]        # repeated k-mers: counts 2
    g = DBGSuccinct.build(refs, k)
    anno = ColumnMajorAnnotation(g.max_index())
    ag = AnnotatedDBG(g, anno)
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
    queries += [b"N" * 60, b"ACG", refs[0][:k - 1], refs[1][:k]]
    return g, anno, ag, queries


@pytest.fixture(scope="module", params=(19, 31))
def case(request, tmp_path_factory):
    from metagraph_tpu.query.pipeline import QueryEngine as JaxEngine
    k = request.param
    g, anno, ag, queries = _build(k)
    jax_engine = JaxEngine(ag, use_device=True)
    want = {m: jax_engine.query_batch_fused(queries, m, 3, 0.6, 0.05)
            for m in MODES}
    assert all(w is not None for w in want.values())
    tmp = tmp_path_factory.mktemp(f"k{k}")
    g.save(str(tmp / "g"))
    anno.save(str(tmp / "a.column.annodbg"))
    return dict(k=k, g=g, anno=anno, jax_engine=jax_engine, queries=queries,
                want=want, tmp=tmp)


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
        c["g"].max_index(), cols)


def _from_files(c):
    return convert.load(str(c["tmp"] / "g.dbg"),
                        str(c["tmp"] / "a.column.annodbg"))


@pytest.mark.parametrize("source", ("jax_arrays", "files"))
@pytest.mark.parametrize("mode", MODES)
def test_payloads_match_jax(case, source, mode):
    index = _from_jax_arrays(case) if source == "jax_arrays" \
        else _from_files(case)
    engine = QueryEngine(index, device="cpu")
    got = engine.query_batch_fused(case["queries"], mode, 3, 0.6, 0.05)
    assert _norm(got) == _norm(case["want"][mode])
    assert any(got)


def test_index_from_files_equals_jax_state(case):
    a, b = _from_jax_arrays(case), _from_files(case)
    assert a.table.tobytes() == b.table.tobytes()
    np.testing.assert_array_equal(a.device_anno, b.device_anno)
    assert a.labels == b.labels


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


def test_thresholds_follow_get_min_count():
    rng = np.random.default_rng(3)
    for df, pf in ((0.7, 0.0), (0.5, 0.5), (0.05, 1.0), (1.0, 0.3)):
        nk = rng.integers(0, 300, 400)
        present = (rng.random(400) * (nk + 1)).astype(np.int64)
        count = (rng.random(400) * (present + 1)).astype(np.int64)
        dsel, selmin = _thresholds(nk, df, pf)
        got = (count >= dsel) & (present >= selmin)
        want = [n > 0 and p >= (m := get_min_count(df, pf, int(n), int(p)))
                and c >= m for n, p, c in zip(nk, present, count)]
        np.testing.assert_array_equal(got, want)


def test_out_of_scope_raises(case):
    """counts-sum and coords, once refused, now give the JAX engine's
    payloads; reference-format annotations and graphs still raise and name
    their ROADMAP items (converted annotations load: test_torch_matrix)."""
    engine = QueryEngine(_from_files(case), device="cpu")
    for mode in ("counts-sum", "coords"):
        want = case["jax_engine"].query_batch_fused(case["queries"], mode, 3,
                                                    0.6, 0.05)
        got = engine.query_batch_fused(case["queries"], mode, 3, 0.6, 0.05)
        assert _norm(got) == _norm(want) and any(want)
    ref_anno = case["tmp"] / "ref.column.annodbg"
    ref_anno.write_bytes(b"\x00\x01 a reference-format annotation")
    ref_dbg = case["tmp"] / "ref.dbg"
    ref_dbg.write_bytes(b"\x00\x01 a reference-format graph")
    for graph, anno in ((case["tmp"] / "g.dbg", ref_anno),
                        (ref_dbg, case["tmp"] / "a.column.annodbg")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            convert.load(str(graph), str(anno))
