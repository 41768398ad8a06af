"""The port's ``transform_anno`` against the JAX CLI's.

The JAX CLI builds k = 13 graphs from seeded random references: a basic
one, a canonical one and "cyclic" (references that repeat a stretch of
themselves and a circular sequence, so that the row-diff successors
close cycles), and annotates them by header, with counts, with
coordinates and (a second annotation over other records) by file name.
Every command line runs through the JAX CLI in this process and through
the port's CLI (``--torch-device cpu``) in one subprocess without JAX,
with the same stdout, exit code, uncaught error and ``[error]`` lines:

* every target of JAX's ``MATRIX_TYPES``, the ``row_diff*`` targets over
  each inner type, ``int_brwt``, ``row_diff_int_brwt``, ``brwt_coord``,
  ``row_diff_coord``, over one and two inputs and a converted input,
  with ``--max-path-length`` 1, 3 and the default: each converted file
  loaded by the port's ``load_annotation``, the matrices' arrays equal;
* the staged row-diff pipeline (stages 0, 1, 2): the ``.rd_succ`` and
  ``.anchors`` side files' members equal, the staged matrix equal to
  JAX's staged one, and its rows to the unstaged one's;
* ``devsparse``: the npz members equal;
* ``--to-ref-format`` and ``--dump-text-anno``: the files equal byte for
  byte;
* ``--rename-cols`` (its files' members or arrays equal), with an odd
  token count and an unknown label; ``--compute-overlap`` (stdout);
  ``--aggregate-columns`` with ``--min-count``, ``--max-count``,
  ``--min-value``, ``--max-value``, ``--count-kmers``, ``--anno-label``
  and its errors; unknown targets and a missing input.

``RowDiff.build_routing`` is also held against JAX's directly on
acyclic and cyclic graphs at several path lengths.
"""

import os

import numpy as np
import pytest

from torch_parity import jax_cli, run_jax, run_port, write_fasta

K = 13
TARGETS = ("flat", "row_sparse", "brwt", "rbfish", "rb_brwt", "bin_rel_wt",
           "row_disk", "unique_row", "row_diff", "row_diff_flat",
           "row_diff_brwt", "row_diff_sparse", "row_diff_disk",
           "row_diff_rbfish", "row_diff_bin_rel_wt", "int_brwt",
           "row_diff_int_brwt", "brwt_coord", "row_diff_coord")
SOURCE = {"int_brwt": "v", "row_diff_int_brwt": "v", "brwt_coord": "c",
          "row_diff_coord": "c"}

# case -> (flags, inputs); {t} is the directory of the side's outputs
CASES = {}
for t in TARGETS:
    CASES[f"to-{t}"] = (["--anno-type", t, "-i", "g.dbg"],
                        [f"{SOURCE.get(t, 'a')}.column.annodbg"])
for t in ("row_diff_brwt", "row_diff_int_brwt", "row_diff_coord"):
    CASES[f"cyclic-{t}"] = (["--anno-type", t, "-i", "cyc.dbg"],
                            [f"cyc{SOURCE.get(t, 'a')}.column.annodbg"])
    for n in (1, 3):
        CASES[f"cyclic-{t}-{n}"] = (["--anno-type", t, "-i", "cyc.dbg",
                                     "--max-path-length", str(n)],
                                    [f"cyc{SOURCE.get(t, 'a')}"
                                     ".column.annodbg"])
CASES.update({
    "canonical-row_diff_brwt": (["--anno-type", "row_diff_brwt", "-i",
                                 "gc.dbg", "--max-path-length", "4"],
                                ["ac.column.annodbg"]),
    "merged-brwt": (["--anno-type", "brwt", "--greedy", "--linkage"],
                    ["a.column.annodbg", "f.column.annodbg"]),
    "merged-counts-int": (["--anno-type", "int_brwt"],
                          ["v.column.annodbg", "f.column.annodbg"]),
    "merged-row_diff": (["--anno-type", "row_diff_flat", "-i", "g.dbg"],
                        ["a.column.annodbg", "f.column.annodbg"]),
    "merge-mismatch": (["--anno-type", "flat"],
                       ["a.column.annodbg", "ac.column.annodbg"]),
    "from-converted": (["--anno-type", "rbfish"], ["{j}/to-brwt.brwt.annodbg"]),
    "from-smallest": (["--anno-type", "flat"], ["s.column.annodbg"]),
    "unknown": (["--anno-type", "bogus"], ["a.column.annodbg"]),
    "unknown-inner": (["--anno-type", "row_diff_bogus", "-i", "g.dbg"],
                      ["a.column.annodbg"]),
    "default-column": ([], ["a.column.annodbg"]),
    "missing-input": (["--anno-type", "flat"], ["gone.column.annodbg"]),
    "devsparse": (["--anno-type", "devsparse"], ["a.column.annodbg"]),
    "devsparse-converted": (["--anno-type", "devsparse"],
                            ["{j}/to-brwt.brwt.annodbg"]),
    "ref-format": (["--to-ref-format"], ["a.column.annodbg"]),
    "ref-format-counts": (["--to-ref-format"], ["v.column.annodbg"]),
    "ref-format-converted": (["--to-ref-format"],
                             ["{j}/to-flat.flat.annodbg"]),
    "dump": (["--dump-text-anno"], ["a.column.annodbg"]),
    "dump-bin-rel-wt": (["--dump-text-anno"],
                        ["{j}/to-bin_rel_wt.bin_rel_wt.annodbg"]),
    "dump-brwt": (["--dump-text-anno"], ["{j}/to-brwt.brwt.annodbg"]),
    "rename": (["--rename-cols", "rename.txt"], ["a.column.annodbg"]),
    "rename-converted": (["--rename-cols", "rename.txt"],
                         ["{j}/to-brwt.brwt.annodbg"]),
    "rename-odd": (["--rename-cols", "odd.txt"], ["a.column.annodbg"]),
    "rename-unknown": (["--rename-cols", "bad.txt"], ["a.column.annodbg"]),
    "rename-duplicate": (["--rename-cols", "dup.txt"], ["a.column.annodbg"]),
    "overlap": (["--compute-overlap", "f.column.annodbg"],
                ["a.column.annodbg", "{j}/to-brwt.brwt.annodbg"]),
    "overlap-min": (["--compute-overlap", "a.column.annodbg",
                     "--min-count", "5"], ["f.column.annodbg"]),
    "aggregate": (["--aggregate-columns"], ["a.column.annodbg"]),
    "aggregate-two": (["--aggregate-columns", "--min-count", "2",
                       "--anno-label", "both"],
                      ["a.column.annodbg", "f.column.annodbg"]),
    "aggregate-max": (["--aggregate-columns", "--max-count", "1"],
                      ["a.column.annodbg"]),
    "aggregate-values": (["--aggregate-columns", "--min-value", "2",
                          "--max-value", "6"], ["v.column.annodbg"]),
    "aggregate-count-kmers": (["--aggregate-columns", "--count-kmers",
                               "--min-count", "3"], ["v.column.annodbg"]),
    "aggregate-no-values": (["--aggregate-columns", "--min-value", "2"],
                            ["a.column.annodbg"]),
    "aggregate-mismatch": (["--aggregate-columns"],
                           ["a.column.annodbg", "ac.column.annodbg"]),
})
STAGED = ("row_diff_brwt", "row_diff_flat")


def _line(tmp, case, side):
    flags, inputs = CASES[case]
    d = str(tmp / side)
    fix = (lambda x: x.replace("{j}", str(tmp / "jax"))
           if "{j}" in x else str(tmp / x) if x.endswith(
               (".annodbg", ".txt", ".dbg")) else x)
    return (["transform_anno", "-o", os.path.join(d, case)]
            + [fix(f) for f in flags] + [fix(f) for f in inputs])


def _staged_lines(tmp, side, target, stage):
    return ["transform_anno", "--anno-type", target, "--row-diff-stage",
            str(stage), "-i", str(tmp / side / "g.dbg"), "-o",
            str(tmp / side / f"staged-{target}"),
            str(tmp / "a.column.annodbg")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transform_anno")
    rng = np.random.default_rng(25)
    refs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(60, 300))))
            for _ in range(7)]
    write_fasta(tmp / "refs.fa", [(f"ref{i}", s) for i, s in
                                  enumerate(refs)])
    write_fasta(tmp / "more.fa", [(f"m{i}", s[10:]) for i, s in
                                  enumerate(refs[2:])])
    cyc = [s[:80] + s[:80] + s[:40] for s in refs[:3]] + ["ACGTTGCA" * 9]
    write_fasta(tmp / "cyc.fa", [(f"c{i}", s) for i, s in enumerate(cyc)])
    jax_cli("build", "-k", K, "-o", tmp / "g", tmp / "refs.fa")
    jax_cli("build", "-k", K, "--mode", "canonical", "-o", tmp / "gc",
            tmp / "refs.fa")
    jax_cli("build", "-k", K, "-o", tmp / "cyc", tmp / "cyc.fa")
    for name, graph, fa, flags in (
            ("a", "g", "refs.fa", ["--anno-header"]),
            ("v", "g", "refs.fa", ["--anno-header", "--count-kmers"]),
            ("c", "g", "refs.fa", ["--anno-header", "--coordinates"]),
            ("s", "g", "refs.fa", ["--anno-header", "--anno-codec",
                                   "smallest"]),
            ("f", "g", "more.fa", []),
            ("ac", "gc", "refs.fa", ["--anno-header"]),
            ("cyca", "cyc", "cyc.fa", ["--anno-header"]),
            ("cycv", "cyc", "cyc.fa", ["--anno-header", "--count-kmers"]),
            ("cycc", "cyc", "cyc.fa", ["--anno-header", "--coordinates"])):
        jax_cli("annotate", "-i", tmp / f"{graph}.dbg", *flags, "-o",
                tmp / name, tmp / fa)
    (tmp / "rename.txt").write_text("ref0 zero\nref3\tthree\n")
    (tmp / "odd.txt").write_text("ref0 zero ref1\n")
    (tmp / "bad.txt").write_text("nothere x\n")
    (tmp / "dup.txt").write_text("ref0 ref1\n")
    jax = {}
    for side in ("jax", "port"):
        os.makedirs(tmp / side)
        # each side's copy of the graph, for the staged side files
        for f in os.listdir(tmp):
            if f.startswith("g.dbg"):
                os.link(tmp / f, tmp / side / f)
    # the JAX outputs that other cases read come first
    order = sorted(CASES, key=lambda c: not c.startswith("to-"))
    for case in order:
        jax[case] = run_jax(_line(tmp, case, "jax"), stderr=True)
    staged = [_staged_lines(tmp, "port", t, s) for t in STAGED
              for s in (0, 1, 2)]
    for line in [_staged_lines(tmp, "jax", t, s) for t in STAGED
                 for s in (0, 1, 2)]:
        jax[tuple(line)] = run_jax(line, stderr=True)
    lines = [_line(tmp, c, "port") for c in order] + staged
    got = run_port(tmp, lines, stderr=True)
    port = dict(zip(order, got))
    port["staged"] = got[len(order):]
    return tmp, jax, port


def _errors(stderr):
    return [ln for ln in stderr.splitlines() if ln.startswith("[error]")]


def _arrays(obj, pre=""):
    """Every array and scalar a loaded matrix holds, by attribute path (a
    RowDisk's path aside)."""
    if isinstance(obj, np.ndarray):
        return {pre: obj}
    if isinstance(obj, (list, tuple)):
        out = {}
        for i, x in enumerate(obj):
            out.update(_arrays(x, f"{pre}[{i}]"))
        return out
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_arrays(v, f"{pre}.{k}"))
        return out
    if hasattr(obj, "__dict__") or hasattr(type(obj), "__slots__"):
        d = dict(getattr(obj, "__dict__", {}))
        for s in getattr(type(obj), "__slots__", ()):
            d[s] = getattr(obj, s)
        d.pop("path_base", None)
        return _arrays(d, pre)
    return {pre: obj}


def _same_file(a, b):
    from metagraph_tpu_torch.annotation.matrix import load_annotation
    if a.endswith(".npz") or a.endswith((".rd_succ", ".anchors")):
        with np.load(a, allow_pickle=True) as x, \
                np.load(b, allow_pickle=True) as y:
            assert x.files == y.files, a
            for m in x.files:
                assert x[m].dtype == y[m].dtype and np.array_equal(
                    x[m], y[m]), (a, m)
        return
    with open(a, "rb") as f:
        head = f.read(2)
    if head in (b"\x80\x04", b"\x80\x05"):
        x = _arrays(load_annotation(a).matrix)
        y = _arrays(load_annotation(b).matrix)
        assert x.keys() == y.keys(), a
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype and np.array_equal(
                    x[k], y[k]), (a, k)
            else:
                assert x[k] == y[k], (a, k)
        ea, eb = load_annotation(a).encoder, load_annotation(b).encoder
        assert ea.labels == eb.labels
        return
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read(), a


def _outputs(d, case):
    return sorted(f[len(case):] for f in os.listdir(d)
                  if f.startswith(case + "."))


@pytest.mark.parametrize("case", list(CASES))
def test_transform_anno_matches_jax(runs, case):
    tmp, jax, port = runs
    want, got = jax[case], port[case]
    assert got[:3] == want[:3], (got[:3], want[:3])
    assert _errors(got[3]) == _errors(want[3])
    files = _outputs(tmp / "jax", case)
    assert files == _outputs(tmp / "port", case)
    if want[1] == 0 and not case.startswith(("overlap", "dump")):
        assert files, case
    for f in files:
        _same_file(str(tmp / "jax" / case) + f, str(tmp / "port" / case) + f)


@pytest.mark.parametrize("target", STAGED)
def test_staged_row_diff_matches_jax(runs, target):
    """Stages 0, 1 and 2: the same side files and matrix as JAX's staged
    run, and the same rows as the unstaged conversion."""
    from metagraph_tpu_torch.annotation.matrix import load_annotation
    tmp, jax, port = runs
    i = STAGED.index(target)
    for s in (0, 1, 2):
        want = jax[tuple(_staged_lines(tmp, "jax", target, s))]
        got = port["staged"][3 * i + s]
        assert got[:3] == want[:3] and want[1] == 0
    for f in ("g.dbg.rd_succ", "g.dbg.anchors"):
        _same_file(str(tmp / "jax" / f), str(tmp / "port" / f))
    out = f"staged-{target}.{target}.annodbg"
    _same_file(str(tmp / "jax" / out), str(tmp / "port" / out))
    staged = load_annotation(str(tmp / "port" / out))
    assert staged.matrix.needs_sidecars
    staged.matrix.attach_sidecars(str(tmp / "port" / "g.dbg"))
    unstaged = load_annotation(str(tmp / "port" / f"to-{target}.{target}"
                                   ".annodbg"))
    rows = np.arange(staged.num_rows)
    assert np.array_equal(staged.get_rows_mask(rows),
                          unstaged.get_rows_mask(rows))
    assert staged.get_rows_mask(rows).any()


@pytest.mark.parametrize("max_length", (1, 2, 5, 100))
@pytest.mark.parametrize("kind", ("acyclic", "cyclic", "canonical"))
def test_build_routing_matches_jax(runs, kind, max_length):
    from metagraph_tpu.annotation.matrix import RowDiff as JRowDiff
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JG
    from metagraph_tpu_torch.annotation.matrix import RowDiff
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    tmp = runs[0]
    name = {"acyclic": "g", "cyclic": "cyc", "canonical": "gc"}[kind]
    path = str(tmp / f"{name}.dbg")
    js, ja = JRowDiff.build_routing(JG.load(path), max_length)
    ps, pa = RowDiff.build_routing(DBGSuccinct.load(path), max_length,
                                   "cpu")
    assert ps.dtype == js.dtype and pa.dtype == ja.dtype
    assert np.array_equal(ps, js) and np.array_equal(pa, ja)
    assert pa.any() and ((ps >= 0).any() or max_length == 1)
