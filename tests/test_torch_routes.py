"""The port's CLI against the JAX CLI's ``query --device`` on every route.

The JAX CLI builds and annotates graphs in tmp_path: DNA at k = 41 (basic:
the codes route, kernels B, 2, 3; canonical and primary: the map route),
DNA5 and DNA_CASE at k = 19 (basic and canonical) and Protein at k = 20
(basic), the last four on the map route (kernel A, then kernels 2, 3).
Each graph gets a ``--count-kmers`` and a ``--coordinates`` annotation.
The JAX CLI runs in this process; the port's CLI runs every command line
of a graph in one subprocess without JAX, with ``--torch-device cpu``.  In
all six query modes the two print the same bytes.
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

GRAPHS = [("DNA", 41, "basic"), ("DNA", 41, "canonical"),
          ("DNA", 41, "primary"), ("DNA5", 19, "basic"),
          ("DNA5", 19, "canonical"), ("DNA_CASE", 19, "basic"),
          ("DNA_CASE", 19, "canonical"), ("Protein", 20, "basic")]
ROUTE = {("DNA", "basic"): "codes"}
LETTERS = {"DNA": "ACGT", "DNA5": "ACGTN", "DNA_CASE": "ACGTNacgt",
           "Protein": "ACDEFGHIKLMNPQRSTVWY"}
MODES = {
    "labels": ["--query-mode", "labels"],
    "matches": ["--query-mode", "matches", "--num-top-labels", "2"],
    "counts": ["--query-mode", "counts", "--min-kmers-fraction-label", "0.3"],
    "counts-sum": ["--query-mode", "counts-sum", "--json"],
    "signature": ["--query-mode", "signature", "--min-kmers-fraction-graph",
                  "0.2"],
    "coords": ["--query-mode", "coords", "--min-kmers-fraction-label",
               "0.4"],
}
ANNOS = ("counts", "coords")

# runs each command line of argv[1] (a JSON list) through the port's CLI,
# each stdout into its own file, and checks that JAX never loaded
_PORT_RUNNER = """
import contextlib, io, json, sys
from metagraph_tpu_torch.cli import main
for i, args in enumerate(json.load(open(sys.argv[1]))):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(args)
    open(f"{sys.argv[2]}/{i}.out", "w").write(buf.getvalue())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "metagraph_tpu")]
assert not bad, bad
"""


def _sequences(rng, alphabet, n, lo, hi):
    letters = list(LETTERS[alphabet])
    p = np.ones(len(letters))
    if "N" in letters:
        p[letters.index("N")] = 0.15
    p /= p.sum()
    return ["".join(rng.choice(letters, size=int(m), p=p))
            for m in rng.integers(lo, hi, size=n)]


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGTacgt", "TGCAtgca"))


def _queries(rng, alphabet, refs, k):
    """Reads of the references (reverse complemented too, for DNA),
    substitutions by characters of the alphabet and outside it, lowercase,
    runs of N, and short and long ones."""
    out = []
    for i, s in enumerate(refs):
        out.append(s[i * 7: i * 7 + 160])
        q = list(s[30: 230])
        for p in range(0, len(q), 19):
            q[p] = str(rng.choice(list(LETTERS[alphabet] + "Nx*")))
        out.append("".join(q))
        if alphabet != "Protein":
            out.append(_revcomp(s[10: 190]))
            out.append(s[50: 170].lower())
    out += ["N" * 60, refs[0][:k - 1], refs[1][:k],
            refs[2][:90] + "NNNN" + refs[3][:90], refs[4] + refs[5]]
    return out


@pytest.fixture(scope="module", params=GRAPHS,
                ids=[f"{a}-k{k}-{m}" for a, k, m in GRAPHS])
def graph(request, tmp_path_factory):
    from metagraph_tpu.cli.main import main as jax_main
    alphabet, k, mode = request.param
    tmp = tmp_path_factory.mktemp(f"{alphabet}{k}{mode}")
    rng = np.random.default_rng(k * 7 + len(alphabet) + len(mode))
    refs = _sequences(rng, alphabet, 6, 250, 500)
    refs[2] = refs[2] + refs[2][30: 140]      # repeated k-mers: values 2
    with open(tmp / "refs.fa", "w") as f:
        f.writelines(f">ref{i} sample\n{s}\n" for i, s in enumerate(refs))
    with open(tmp / "q.fa", "w") as f:
        f.writelines(f">q{i}\n{s}\n"
                     for i, s in enumerate(_queries(rng, alphabet, refs, k)))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_main(["build", "-k", str(k), "--mode", mode, "--alphabet",
                  alphabet, "-o", str(tmp / "g"), str(tmp / "refs.fa")])
        for anno, flag in zip(ANNOS, ("--count-kmers", "--coordinates")):
            jax_main(["annotate", "-i", str(tmp / "g.dbg"), "--anno-header",
                      flag, "-o", str(tmp / anno), str(tmp / "refs.fa")])
    lines = [_args(tmp, anno, m) for anno in ANNOS for m in MODES]
    with open(tmp / "lines.json", "w") as f:
        json.dump([a + ["--torch-device", "cpu"] for a in lines], f)
    env = dict(os.environ, PYTHONPATH=REPO)
    got = subprocess.run([sys.executable, "-c", _PORT_RUNNER,
                          str(tmp / "lines.json"), str(tmp)],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp), timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    outputs = {}
    for i, (anno, m) in enumerate((a, m) for a in ANNOS for m in MODES):
        with open(tmp / f"{i}.out", "rb") as f:
            outputs[anno, m] = f.read()
    return dict(tmp=tmp, alphabet=alphabet, k=k, mode=mode, outputs=outputs)


def _args(tmp, anno, mode):
    extra = ["--fwd-and-reverse"] if mode in ("labels", "counts") else []
    return ["query", "-i", str(tmp / "g.dbg"), "-a",
            str(tmp / f"{anno}.column.annodbg"), *MODES[mode], *extra,
            "--device", str(tmp / "q.fa")]


def test_route(graph):
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.query.pipeline import route_of
    index = convert.load(str(graph["tmp"] / "g.dbg"),
                         str(graph["tmp"] / "counts.column.annodbg"))
    assert (index.alphabet, index.k) == (graph["alphabet"], graph["k"])
    assert route_of(index) == ROUTE.get((graph["alphabet"], graph["mode"]),
                                        "map")


@pytest.mark.parametrize("anno", ANNOS)
@pytest.mark.parametrize("mode", MODES)
def test_cli_stdout_matches_jax(graph, anno, mode):
    from metagraph_tpu.cli.main import main as jax_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_main(_args(graph["tmp"], anno, mode))
    want = buf.getvalue().encode()
    assert graph["outputs"][anno, mode] == want
    assert want.count(b"\n") >= 15
    # some sequences pass their thresholds in every mode
    assert sum(b'"sample"' in ln or ln.split(b"\t", 2)[2:] not in ([], [b""])
               for ln in want.splitlines()) >= 5


@pytest.mark.parametrize("anno", ANNOS)
def test_row_queries_match_jax(graph, anno):
    """The column annotation's row queries against the JAX package's, and
    the per-label lookups the payloads use against them."""
    from metagraph_tpu.annotation.column import \
        ColumnMajorAnnotation as JaxColumns
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    path = str(graph["tmp"] / f"{anno}.column.annodbg.npz")
    want, got = JaxColumns.load(path), ColumnMajorAnnotation.load(path)
    assert (got.has_values, got.has_coords) == (anno == "counts",
                                                anno == "coords")
    rows = np.arange(-3, got.num_rows + 3)
    np.testing.assert_array_equal(got.get_rows_mask(rows),
                                  want.get_rows_mask(rows))
    values, tuples = got.get_row_values(rows), got.get_row_tuples(rows)
    assert values == want.get_row_values(rows)
    assert tuples == want.get_row_tuples(rows)
    assert sum(map(len, values)) > 100
    for c in range(got.num_labels):
        on = [i for i, row in enumerate(values) if any(x == c for x, _ in row)]
        np.testing.assert_array_equal(
            got.values_of(rows[on], c),
            [v for i in on for x, v in values[i] if x == c])
        lo, hi = got.coord_spans(rows, c)
        crd = got.coords_of(c) if anno == "coords" else None
        assert [crd[a:b].tolist() for a, b in zip(lo, hi) if b > a] == \
            [t for row in tuples for x, t in row if x == c]
