"""``python -m metagraph_tpu_torch query --device --torch-device cpu`` prints
the same bytes as ``python -m metagraph_tpu.cli query --device`` on the
annotations that ``transform_anno`` writes: brwt, row_diff_*, flat, rbfish,
int and coords, dense within METAGRAPH_DENSE_ANNO_BUDGET, block-sparse past
it, and the device BRWT / row-diff words route where the overflow patterns
pass it too.

The JAX CLI builds, annotates and converts small random-ACGT indexes in
tmp_path; its query runs in this process (stdout captured), the port's in
one subprocess without JAX for every case.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs [budget, args] items through the port's CLI in one process, and
# records for each its stdout, the error it raised, whether it wrote the
# block-sparse cache (removed after each run, so that no later run reads
# it) and the device annotation's form that ``convert.load`` gives at that
# budget; checks that JAX never loaded
_CONVERTED_RUNNER = """
import contextlib, io, json, os, sys
from metagraph_tpu_torch import convert
from metagraph_tpu_torch.cli import main
out = []
for budget, args in json.load(open(sys.argv[1])):
    os.environ.pop("METAGRAPH_DENSE_ANNO_BUDGET", None)
    if budget is not None:
        os.environ["METAGRAPH_DENSE_ANNO_BUDGET"] = budget
    anno = args[args.index("-a") + 1]
    cache = anno + ".devsparse.npz"
    buf, err, form = io.StringIO(), None, None
    try:
        with contextlib.redirect_stdout(buf):
            main(args)
        form = type(convert.load(args[args.index("-i") + 1],
                                 anno).device_anno).__name__
    except (ValueError, NotImplementedError) as e:
        err = f"{type(e).__name__}: {e}"
    out.append([buf.getvalue(), err, os.path.exists(cache), form])
    if os.path.exists(cache):
        os.remove(cache)
json.dump(out, open(sys.argv[2], "w"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "metagraph_tpu")]
assert not bad, bad
"""

# at or above the overflow patterns' Rd * L bytes (2 patterns of 8 labels)
# and below the dense bitmap's R * ceil(L/32) * 4 bytes: block-sparse with
# overflow rows; "0" goes with annotation "b", which has none
OVER = "1024"
GAP = "8"        # below Rd * L: from_matrix gives None (the words route)
QMODES = {
    "labels": ["--query-mode", "labels", "--fwd-and-reverse"],
    "matches": ["--query-mode", "matches", "--num-top-labels", "3"],
    "signature": ["--query-mode", "signature", "--min-kmers-fraction-label",
                  "0.5", "--min-kmers-fraction-graph", "0.2"],
    "counts": ["--query-mode", "counts", "--min-kmers-fraction-label",
               "0.3"],
    "counts-sum": ["--query-mode", "counts-sum", "--json"],
    "coords": ["--query-mode", "coords", "--min-kmers-fraction-label",
               "0.4"],
}
CONVERTED = (
    [("g", "a", rep, b, m) for rep in ("brwt", "row_diff_brwt", "flat",
                                       "rbfish")
     for b in (None, OVER) for m in ("labels", "matches", "signature")]
    + [("g", "b", rep, "0", m) for rep in ("brwt", "row_diff_brwt")
       for m in ("labels", "matches")]
    + [("g", "a", "int_brwt", b, m) for b in (None, OVER)
       for m in ("counts", "counts-sum")]
    + [("g", "c", "row_diff_coord", b, "coords") for b in (None, OVER)]
    # canonical and primary k = 19 (wire route, canon 1 and 2), basic
    # k = 41 (codes route) and primary k = 41 (map route)
    + [(g, "a", "brwt", OVER, m) for g in ("gc", "gp", "g41", "gp41")
       for m in ("labels", "matches")]
    # counts on a binary representation: the JAX ValueError
    + [("g", "a", "brwt", b, "counts") for b in (None, OVER)]
    # from_matrix gives None: the words route (W1 on a brwt, W2 on a
    # row-diff over a BRWT or, row_diff_flat, over a dense inner bitmap);
    # wire route at k = 19 (basic, canonical, primary), map route on the
    # basic k = 41 graph
    + [("g", "a", rep, GAP, m) for rep in ("brwt", "row_diff_brwt")
       for m in ("labels", "matches", "signature")]
    + [("g", "a", "row_diff_flat", GAP, m) for m in ("labels", "matches")]
    + [(g, "a", rep, GAP, m) for g in ("gc", "gp", "g41")
       for rep in ("brwt", "row_diff_brwt") for m in ("labels", "matches")])


def _converted_args(tmp, graph, src, rep, mode):
    return ["query", "-i", str(tmp / f"{graph}.dbg"), "-a",
            str(tmp / f"{graph}{src}.{rep}.annodbg"), *QMODES[mode],
            "--device", str(tmp / "q.fa")]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Basic, canonical and primary k = 19 graphs, and basic and primary
    k = 41 graphs, of references that share two segments (rows with 6 and
    5 labels: overflow rows at tau = 4);
    annotations "a" (counts), "c" (coordinates) and "b" (each reference's
    own part only: at most one label a row), converted by the JAX CLI; and
    the port's outputs of every CONVERTED case."""
    from metagraph_tpu.cli.main import main as jax_main
    tmp = tmp_path_factory.mktemp("converted")
    rng = np.random.default_rng(43)
    own = ["".join(rng.choice(list("ACGT"), size=int(n)))
           for n in rng.integers(200, 360, size=7)]
    seg1, seg2 = ("".join(rng.choice(list("ACGT"), size=60))
                  for _ in range(2))
    refs = [s[:70] + (seg1 if i < 6 else "") + s[70:140]
            + (seg2 if 1 <= i <= 5 else "") + s[140:]
            for i, s in enumerate(own)]
    refs[3] = refs[3] + refs[3][30:120]       # repeated k-mers: values 2
    comp = str.maketrans("ACGT", "TGCA")
    queries = []
    for i, s in enumerate(refs):
        queries += [s[i * 5: i * 5 + 150], s[40:230][::-1].translate(comp),
                    s[60:200]]
        q = list(s[100:260])
        for p in range(0, len(q), 15):
            q[p] = "ACGTN"[int(rng.integers(5))]
        queries.append("".join(q))
    queries += ["N" * 40, seg1 + seg2, refs[0][:30] + "NN" + refs[4][:80]]
    for name, seqs in (("refs", refs), ("own", own),
                       ("q", queries)):
        with open(tmp / f"{name}.fa", "w") as f:
            f.writelines(f">ref{i} s\n{s}\n" for i, s in enumerate(seqs))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        for graph, k, mode in (("g", 19, "basic"), ("gc", 19, "canonical"),
                               ("gp", 19, "primary"), ("g41", 41, "basic"),
                               ("gp41", 41, "primary")):
            jax_main(["build", "-k", str(k), "--mode", mode, "-o",
                      str(tmp / graph), str(tmp / "refs.fa")])
        for graph, src, flag, fa in (
                ("g", "a", "--count-kmers", "refs"),
                ("g", "c", "--coordinates", "refs"),
                ("g", "b", "--count-kmers", "own"),
                *((g, "a", "--count-kmers", "refs")
                  for g in ("gc", "gp", "g41", "gp41"))):
            jax_main(["annotate", "-i", str(tmp / f"{graph}.dbg"),
                      "--anno-header", flag, "-o", str(tmp / f"{graph}{src}"),
                      str(tmp / f"{fa}.fa")])
        for graph, src, rep in {c[:3] for c in CONVERTED}:
            jax_main(["transform_anno", "--anno-type", rep, "-i",
                      str(tmp / f"{graph}.dbg"), "-o",
                      str(tmp / f"{graph}{src}"),
                      str(tmp / f"{graph}{src}.column.annodbg")])
    with open(tmp / "lines.json", "w") as f:
        json.dump([[b, _converted_args(tmp, g, s, r, m)
                    + ["--torch-device", "cpu"]]
                   for g, s, r, b, m in CONVERTED], f)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("METAGRAPH_DENSE_ANNO_BUDGET", None)
    got = subprocess.run([sys.executable, "-c", _CONVERTED_RUNNER,
                          str(tmp / "lines.json"), str(tmp / "out.json")],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp), timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    with open(tmp / "out.json") as f:
        return tmp, dict(zip(CONVERTED, json.load(f)))


@pytest.mark.parametrize("case", CONVERTED,
                         ids=["-".join(map(str, c)) for c in CONVERTED])
def test_converted_annotations_match_jax_cli(converted, case, monkeypatch):
    """The port prints the JAX CLI's stdout bytes; brwt and row_diff_brwt
    past the budget take the block-sparse route (they write its cache),
    every other case the dense one.  Counts on a brwt raise the JAX
    package's ValueError.  Where from_matrix gives None (GAP), both take
    the device BRWT / row-diff words route: the port's index holds a
    FlatBRWT or FlatRowDiff and no cache is written."""
    from metagraph_tpu.cli.main import main as jax_main
    tmp, port = converted
    graph, src, rep, budget, mode = case
    out, err, sparse, form = port[case]
    if budget is None:
        monkeypatch.delenv("METAGRAPH_DENSE_ANNO_BUDGET", raising=False)
    else:
        monkeypatch.setenv("METAGRAPH_DENSE_ANNO_BUDGET", budget)
    args = _converted_args(tmp, graph, src, rep, mode)
    cache = args[args.index("-a") + 1] + ".devsparse.npz"
    buf, jax_err = io.StringIO(), None
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jax_main(args)
    except ValueError as e:
        jax_err = f"ValueError: {e}"
    finally:
        if os.path.exists(cache):
            os.remove(cache)
    assert err == jax_err
    assert out == buf.getvalue()
    if budget == GAP:
        assert not sparse and not os.path.exists(cache)
        assert form == ("FlatBRWT" if rep == "brwt" else "FlatRowDiff")
    else:
        assert sparse == (rep in ("brwt", "row_diff_brwt")
                          and budget is not None)
    if mode == "counts" and rep == "brwt":
        assert err == "ValueError: k-mer counts are not indexed in a brwt " \
            "annotator"
    else:
        assert out.count("\n") >= 30 and err is None
        assert any(":" in ln.split("\t")[-1] or "ref" in ln.split("\t")[-1]
                   for ln in out.splitlines())


def test_counts_on_binary_annotation_exit_as_jax(converted):
    """Counts mode on a brwt: both CLIs exit 1 with the same last stderr
    line, the ValueError of a representation without values."""
    tmp, _ = converted
    args = _converted_args(tmp, "g", "a", "brwt", "counts")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("METAGRAPH_DENSE_ANNO_BUDGET", None)
    runs = [subprocess.run([sys.executable, "-m", pkg, *args, *extra],
                           capture_output=True, text=True, env=env,
                           cwd=str(tmp), timeout=300)
            for pkg, extra in (("metagraph_tpu.cli", []),
                               ("metagraph_tpu_torch",
                                ["--torch-device", "cpu"]))]
    assert [r.returncode for r in runs] == [1, 1]
    last = [r.stderr.strip().splitlines()[-1] for r in runs]
    assert last[0] == last[1] == "ValueError: k-mer counts are not " \
        "indexed in a brwt annotator"
    assert runs[0].stdout == runs[1].stdout
