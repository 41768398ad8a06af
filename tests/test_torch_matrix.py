"""The port's converted annotations against the JAX package's.

The JAX CLI builds a small graph in tmp_path, annotates it with k-mer
counts and with coordinates, and ``transform_anno`` converts the
annotations to every ``MATRIX_TYPES`` name, to row_diff_flat,
row_diff_brwt and row_diff_sparse, to a staged row-diff (routing in
``.rd_succ``/``.anchors`` beside the graph) and to int_brwt,
row_diff_int_brwt, brwt_coord and row_diff_coord.  The port's
``load_annotation`` (with the sidecars attached, as its CLI attaches them)
answers ``get_rows_mask``, ``get_row_values`` and ``get_row_tuples`` as the
JAX package does on every row, and raises its ValueError where a
representation lacks values or coordinates.  A pickle that names any
other global is refused.
"""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest

K = 15
# (representation, source annotation); "rd" is the staged row-diff
CASES = [(t, "counts") for t in ("flat", "row_sparse", "brwt", "rbfish",
                                 "rb_brwt", "bin_rel_wt", "row_disk",
                                 "unique_row", "row_diff_flat",
                                 "row_diff_brwt", "row_diff_sparse",
                                 "int_brwt", "row_diff_int_brwt", "rd")] \
    + [(t, "coords") for t in ("brwt_coord", "row_diff_coord")]


def shared_segment_refs(rng, n=7, lo=180, hi=320):
    """Random references, two segments of which recur in most of them, so
    that some rows carry 5-6 labels."""
    refs = ["".join(rng.choice(list("ACGT"), size=int(m)))
            for m in rng.integers(lo, hi, size=n)]
    seg1, seg2 = ("".join(rng.choice(list("ACGT"), size=50))
                  for _ in range(2))
    refs = [r[:60] + (seg1 if i < 6 else "") + r[60:120]
            + (seg2 if 1 <= i <= 5 else "") + r[120:]
            for i, r in enumerate(refs)]
    refs[2] = refs[2] + refs[2][20:90]        # repeated k-mers: values 2
    return refs


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    from metagraph_tpu.cli.main import main as jax_main
    tmp = tmp_path_factory.mktemp("matrix")
    refs = shared_segment_refs(np.random.default_rng(8))
    with open(tmp / "refs.fa", "w") as f:
        f.writelines(f">ref{i}\n{s}\n" for i, s in enumerate(refs))
    g = str(tmp / "g.dbg")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_main(["build", "-k", str(K), "-o", str(tmp / "g"),
                  str(tmp / "refs.fa")])
        for src, flag in (("counts", "--count-kmers"),
                          ("coords", "--coordinates")):
            jax_main(["annotate", "-i", g, "--anno-header", flag, "-o",
                      str(tmp / src), str(tmp / "refs.fa")])
        for rep, src in CASES:
            col = str(tmp / f"{src}.column.annodbg")
            if rep == "rd":
                for stage in "012":
                    jax_main(["transform_anno", "--anno-type", "row_diff",
                              "-i", g, "--row-diff-stage", stage, "-o",
                              str(tmp / "rd"), col])
            else:
                jax_main(["transform_anno", "--anno-type", rep, "-i", g,
                          "-o", str(tmp / rep), col])
    return tmp


def _path(tmp, rep):
    name = "row_diff" if rep == "rd" else rep
    return str(tmp / f"{rep}.{name}.annodbg")


def _answers(anno, rows, what):
    """get_row_values / get_row_tuples of ``rows``, or the ValueError text
    where the representation lacks them."""
    try:
        return getattr(anno, what)(rows)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("rep,src", CASES, ids=[r for r, _ in CASES])
def test_load_annotation_answers_as_jax(converted, rep, src):
    from metagraph_tpu.cli.main import _load_annotation_for
    from metagraph_tpu_torch.convert import load_annotation_for
    from metagraph_tpu_torch.annotation.matrix import StaticAnnotation
    g, path = str(converted / "g.dbg"), _path(converted, rep)
    want = _load_annotation_for(g, path)
    got = load_annotation_for(g, path)
    assert isinstance(got, StaticAnnotation)
    assert type(got.matrix).__module__ == \
        "metagraph_tpu_torch.annotation.matrix"
    assert type(got.matrix).__name__ == type(want.matrix).__name__
    assert got.labels == [want.encoder.decode(c)
                          for c in range(want.num_labels)]
    assert (got.num_rows, got.num_labels) == (want.num_rows,
                                               want.num_labels)
    rows = np.arange(want.num_rows)
    mask = want.get_rows_mask(rows)
    np.testing.assert_array_equal(got.get_rows_mask(rows), mask)
    assert mask.sum(axis=1).max() >= 5          # overflow-sized rows
    for what in ("get_row_values", "get_row_tuples"):
        assert _answers(got, rows, what) == _answers(want, rows, what)
    if rep in ("int_brwt", "row_diff_int_brwt"):
        assert max(v for r in got.get_row_values(rows) for _, v in r) == 2


class _Evil:
    def __init__(self, target):
        self.target = target

    def __reduce__(self):
        return self.target


@pytest.mark.parametrize("target", ["system", "eval", "jax_function",
                                    "port_function"])
def test_pickle_with_another_global_is_refused(tmp_path, target):
    from metagraph_tpu.annotation import matrix as jax_matrix
    from metagraph_tpu_torch.annotation import matrix as port_matrix
    flag = tmp_path / "ran"
    reduce = {
        "system": (os.system, (f"touch {flag}",)),
        "eval": (eval, (f"open({str(flag)!r}, 'w')",)),
        "jax_function": (jax_matrix.load_annotation, (str(flag),)),
        "port_function": (port_matrix.load_annotation, (str(flag),)),
    }[target]
    path = tmp_path / "x.brwt.annodbg"
    with open(path, "wb") as f:
        pickle.dump(_Evil(reduce), f, protocol=4)
    with pytest.raises(pickle.UnpicklingError, match="may not name"):
        port_matrix.load_annotation(str(path))
    assert not flag.exists()


def test_port_pickle_round_trip(converted, tmp_path):
    """StaticAnnotation.save writes the port's class names; load reads
    them back (chip_smoke.py's BRWT takes this way)."""
    from metagraph_tpu_torch.annotation.matrix import (BRWT,
                                                       StaticAnnotation,
                                                       load_annotation)
    from metagraph_tpu_torch.annotation.column import LabelEncoder
    rng = np.random.default_rng(2)
    R, L = 300, 37
    cols = [np.unique(rng.integers(0, R, int(n)))
            for n in rng.integers(0, 60, L)]
    for linkage in (False, True):
        m = BRWT.from_columns(cols, R, L, linkage=linkage)
        anno = StaticAnnotation(m, LabelEncoder([f"x{c}" for c in range(L)]),
                                "brwt")
        anno.save(str(tmp_path / "p.brwt.annodbg"))
        back = load_annotation(str(tmp_path / "p.brwt.annodbg"))
        want = np.zeros((R, L), bool)
        for c, col in enumerate(cols):
            want[col, c] = True
        np.testing.assert_array_equal(back.get_rows_mask(np.arange(R)), want)
        assert back.labels == anno.labels


def test_brwt_from_columns_matches_jax():
    """The port's BRWT.from_columns (greedy linkage or arity 2) builds the
    JAX package's tree: the same node bitmaps in the same order."""
    from metagraph_tpu.annotation.matrix import BRWT as JaxBRWT
    from metagraph_tpu_torch.annotation.matrix import BRWT
    rng = np.random.default_rng(5)
    R, L = 500, 23
    cols = [np.unique(rng.integers(0, R, int(n)))
            for n in rng.integers(1, 90, L)]
    cols[3] = cols[4] = np.zeros(0, np.int64)     # two empty siblings

    def walk(node):
        yield node.bv.words.tobytes(), list(node.labels)
        for ch in node.children:
            yield from walk(ch)
    for linkage in (False, True):
        a = BRWT.from_columns(cols, R, L, linkage=linkage)
        b = JaxBRWT.from_columns(cols, R, L, linkage=linkage)
        assert list(walk(a.root)) == list(walk(b.root))
