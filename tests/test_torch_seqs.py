"""The ``.seqs`` coordinate-to-header mapping on the port: its
``CoordToHeader`` against the JAX class, ``cth_aggregate`` against
``AnnotatedDBG._cth_aggregate`` on the same node arrays, and
``python -m metagraph_tpu_torch query --device --torch-device cpu`` against
``python -m metagraph_tpu.cli query --device`` with a ``.seqs`` file beside
the annotation (every batch mapped through kernel A's plain version, then
aggregated per sequence), byte for byte.

The JAX CLI builds basic, canonical and primary k = 11 graphs of three
FASTA files (one label a file, several sequences in each, segments shared
within and across files) and annotates them with ``--coordinates
--index-header-coords`` in tmp_path; the port's command lines run in one
subprocess without JAX.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("labels", "matches", "counts-sum", "counts", "signature", "coords")

# runs each command line through the port's CLI in this one process: ->
# [stdout, exit code, the error an uncaught exception printed last]
RUNNER = """
import contextlib, io, json, sys
from metagraph_tpu_torch.cli import main
out = []
for args in json.load(open(sys.argv[1])):
    buf, code, err = io.StringIO(), 0, None
    try:
        with contextlib.redirect_stdout(buf):
            main(args)
    except SystemExit as e:
        code = e.code or 0
    except Exception as e:
        code, err = 1, f"{type(e).__name__}: {e}"
    out.append([buf.getvalue(), code, err])
json.dump(out, open(sys.argv[2], "w"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "metagraph_tpu")]
assert not bad, bad
"""


def run_jax(args):
    from metagraph_tpu.cli.main import main as jax_main
    buf, code, err = io.StringIO(), 0, None
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jax_main(args)
    except SystemExit as e:
        code = e.code or 0
    except Exception as e:          # noqa: BLE001 (an uncaught CLI error)
        code, err = 1, f"{type(e).__name__}: {e}"
    return [buf.getvalue(), code, err]


def run_port(tmp, lines):
    """The port's CLI on every command line (with --torch-device cpu), in
    one subprocess."""
    spec, res = tmp / "lines.json", tmp / "out.json"
    spec.write_text(json.dumps([a + ["--torch-device", "cpu"]
                                for a in lines]))
    env = dict(os.environ, PYTHONPATH=REPO)
    got = subprocess.run([sys.executable, "-c", RUNNER, str(spec), str(res)],
                         capture_output=True, env=env, cwd=str(tmp),
                         timeout=600)
    assert got.returncode == 0, got.stderr.decode()[-3000:]
    return json.loads(res.read_text())


def write_fasta(path, recs):
    with open(path, "w") as f:
        f.writelines(f">{h}\n{s}\n" for h, s in recs)


@pytest.fixture(scope="module")
def seqs_index(tmp_path_factory):
    """Three files of references (sequences shorter than k included), basic,
    canonical and primary k = 11 graphs, coordinate annotations with .seqs,
    and queries cut from the references (reverse complements,
    substitutions, N runs, reads spanning two references' shared
    segment)."""
    from metagraph_tpu.cli.main import main as jax_main
    tmp = tmp_path_factory.mktemp("seqs")
    rng = np.random.default_rng(61)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), size=int(n)))
    shared = rand(40)
    files = []
    for f, n in enumerate((5, 4, 3)):
        recs = []
        for i in range(n):
            s = rand(rng.integers(60, 160))
            if i % 2 == 0:
                s = s[:30] + shared + s[30:]
            if f == 1 and i == 1:
                s = s + s[10:50]          # a repeat: two coords a k-mer
            recs.append((f"f{f}s{i} desc", s))
        recs.append((f"f{f}short", rand(7)))
        files.append(str(tmp / f"file{f}.fa"))
        write_fasta(files[-1], recs)
    refs = [s for path in files
            for s in open(path).read().split("\n")[1::2]]
    comp = str.maketrans("ACGT", "TGCA")
    queries = []
    for i, s in enumerate(refs):
        queries.append(s[i % 7: i % 7 + 60])
        queries.append(s[5:70][::-1].translate(comp))
        q = list(s[:90])
        for p in range(3, len(q), 17):
            q[p] = "ACGTN"[int(rng.integers(5))]
        queries.append("".join(q))
    queries += [shared + rand(20), "N" * 30, "ACGTA", ""]
    write_fasta(tmp / "q.fa", [(f"q{i}", s) for i, s in enumerate(queries)])
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        for g, mode in (("g", "basic"), ("gc", "canonical"),
                        ("gp", "primary")):
            jax_main(["build", "--mode", mode, "-k", "11", "-o",
                      str(tmp / g), *files])
            jax_main(["annotate", "-i", str(tmp / f"{g}.dbg"),
                      "--coordinates", "--index-header-coords", "-o",
                      str(tmp / f"{g}a"), *files])
        # a converted coordinate annotation, with the same mapping beside it
        jax_main(["transform_anno", "--anno-type", "brwt_coord", "-o",
                  str(tmp / "gb"), str(tmp / "ga.column.annodbg")])
    shutil.copyfile(tmp / "ga.seqs", tmp / "gb.brwt_coord.seqs")
    return tmp


def test_coord_to_header_load_matches_jax(seqs_index, tmp_path):
    """The port loads the JAX CLI's .seqs as the JAX class does, maps every
    coordinate as it does, and the JAX class reads what the port saves."""
    from metagraph_tpu.annotation.coord_to_header import \
        CoordToHeader as JaxCTH
    from metagraph_tpu_torch.annotation.coord_to_header import CoordToHeader
    path = str(seqs_index / "ga.seqs")
    want, got = JaxCTH.load(path), CoordToHeader.load(path)
    assert got.num_columns() == want.num_columns() == 3
    for c in range(3):
        assert got.get_headers(c) == want.get_headers(c)
        assert got.num_sequences(c) == want.num_sequences(c) >= 3
        np.testing.assert_array_equal(got.offsets[c], want.offsets[c])
        for i in range(got.num_sequences(c)):
            assert got.num_kmers_in_sequence(c, i) \
                == want.num_kmers_in_sequence(c, i)
        for x in range(int(got.offsets[c][-1])):
            assert got.map_single_coord(c, x) == want.map_single_coord(c, x)
    got.save(str(tmp_path / "copy"))
    again = JaxCTH.load(str(tmp_path / "copy.seqs"))
    assert again.headers == want.headers
    assert all(np.array_equal(a, b)
               for a, b in zip(again.offsets, want.offsets))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("graph", ("g", "gc"))
def test_cth_aggregate_matches_jax(seqs_index, graph, mode):
    """cth_aggregate on a batch of node arrays against _cth_aggregate on
    each, with a top-n cap that filters and thresholds that drop some
    sequences."""
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation as JCA
    from metagraph_tpu.annotation.coord_to_header import \
        CoordToHeader as JaxCTH
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu.seq_io.fasta import read_fasta
    from metagraph_tpu_torch.annotation.annotated_dbg import (HeaderIndex,
                                                              cth_aggregate)
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu_torch.annotation.coord_to_header import CoordToHeader
    tmp = seqs_index
    g = DBGSuccinct.load(str(tmp / f"{graph}.dbg"))
    anno_path = str(tmp / f"{graph}a.column.annodbg.npz")
    ag = AnnotatedDBG(g, JCA.load(anno_path),
                      coord_to_header=JaxCTH.load(str(tmp / f"{graph}a.seqs")))
    nodes = [g.map_to_nodes(r.seq) if len(r.seq) >= g.k
             else np.zeros(0, np.int64)
             for r in read_fasta(str(tmp / "q.fa"))]
    for top, df, pf in ((2 ** 63, 0.7, 0.0), (1, 0.3, 0.2), (2, 0.0, 0.0)):
        want = [ag._cth_aggregate(n, top, df, pf, mode) if len(n) else []
                for n in nodes]
        got = cth_aggregate(
            ColumnMajorAnnotation.load(anno_path),
            HeaderIndex(CoordToHeader.load(str(tmp / f"{graph}a.seqs"))),
            nodes, mode, top, df, pf)
        assert str(got) == str(want)
        assert sum(bool(p) for p in want) >= 10
        if mode == "matches" and top == 2:
            assert max(len(p) for p in want) == 2


OPTIONS = [[] for _ in MODES] + [
    ["--json"], ["--fwd-and-reverse"], ["--verbose-output"],
    ["--num-top-labels", "1"], ["--no-coord-mapping"],
    ["--min-kmers-fraction-label", "0.3", "--min-kmers-fraction-graph",
     "0.5"]]
LINES = [(graph, mode, opts) for graph in ("g", "gc")
         for mode, opts in list(zip(MODES, OPTIONS)) + [
             (m, o) for o in OPTIONS[len(MODES):]
             for m in ("matches", "coords")]] + [
    ("gp", mode, opts) for mode, opts in zip(MODES, OPTIONS)]
# the brwt_coord conversion of g's annotation (its row queries)
CONVERTED = [("g", mode, []) for mode in ("labels", "counts", "coords")]


def test_cli_with_seqs_matches_jax(seqs_index):
    """The port's query prints the JAX CLI's stdout bytes and exit code
    with a .seqs beside the annotation: basic and canonical graphs, six
    modes, and --json, --fwd-and-reverse, --verbose-output,
    --num-top-labels 1, --no-coord-mapping and the fraction flags in the
    matches and coords modes; a primary graph (through CanonicalDBG) in
    six modes; a brwt_coord conversion (through its row queries)."""
    tmp = seqs_index
    lines = [["query", "-i", str(tmp / f"{g}.dbg"), "-a",
              str(tmp / f"{g}a.column.annodbg"), "--query-mode", mode,
              *opts, "--device", str(tmp / "q.fa")]
             for g, mode, opts in LINES] + [
        ["query", "-i", str(tmp / f"{g}.dbg"), "-a",
         str(tmp / "gb.brwt_coord.annodbg"), "--query-mode", mode, *opts,
         "--device", str(tmp / "q.fa")] for g, mode, opts in CONVERTED]
    got = run_port(tmp, lines)
    for args, g in zip(lines, got):
        want = run_jax(args)
        assert g == want, args
        assert want[1] == 0 and want[0].count("\n") >= 40
    # the mapping changes the output: per-file labels without it
    plain = [i for i, (_, m, o) in enumerate(LINES)
             if o == ["--no-coord-mapping"]]
    assert got[plain[0]][0] != got[LINES.index(("g", "matches", []))][0]
    # the conversion answers as the column annotation does
    for (g, mode, _), conv in zip(CONVERTED, got[len(LINES):]):
        assert conv == got[LINES.index((g, mode, []))]
