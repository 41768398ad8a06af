"""The port's ``annotate`` against the JAX CLI's.

The JAX CLI builds k = 15 graphs from seeded random references (basic,
canonical and primary succinct graphs, a DNA5 one, a hash graph and an
sshash graph) and writes the FASTA inputs: references with ``ka:f:``
abundances in their comments, records shorter than k, an N run, an empty
record, repeated headers, and the same references split over two files
(and a copy of one under another directory, for the duplicate basename
error).  Every command line runs through the JAX CLI in this process and
through the port's CLI (``--torch-device cpu``: kernel A's and D2's plain
versions) in one subprocess without JAX: the same stdout, exit code,
uncaught error and ``[error]`` lines, and each output file (the
annotation's npz and the ``.seqs`` mapping) with the same members, names,
dtypes and values.
"""

import os

import numpy as np
import pytest

from torch_parity import jax_cli, run_jax, run_port, write_fasta

K = 15

# case -> (graph, flags, inputs); {tmp} names the directory
CASES = {
    "header": ("basic", ["--anno-header"], ["refs.fa"]),
    "label": ("basic", ["--anno-label", "one"], ["refs.fa", "more.fa"]),
    "filename": ("basic", [], ["refs.fa", "more.fa"]),
    "filename-flag": ("canonical", ["--anno-filename"], ["refs.fa"]),
    "counts": ("basic", ["--anno-header", "--count-kmers"], ["refs.fa"]),
    "counts-filename": ("canonical", ["--count-kmers"],
                        ["refs.fa", "more.fa"]),
    "coords": ("basic", ["--anno-header", "--coordinates"], ["refs.fa"]),
    "coords-label": ("basic", ["--anno-label", "x", "--coordinates"],
                     ["refs.fa", "more.fa"]),
    "coords-counts": ("canonical", ["--coordinates", "--count-kmers",
                                    "--anno-header"], ["refs.fa"]),
    "header-coords": ("basic", ["--coordinates", "--index-header-coords"],
                      ["refs.fa", "more.fa"]),
    "header-coords-separately": ("basic", ["--coordinates",
                                           "--index-header-coords",
                                           "--separately"],
                                 ["refs.fa", "more.fa"]),
    "index-no-coords": ("canonical", ["--index-header-coords",
                                      "--anno-header"], ["refs.fa"]),
    "separately": ("basic", ["--separately", "-p", "2", "--anno-header"],
                   ["refs.fa", "more.fa"]),
    "separately-counts": ("primary", ["--separately", "--count-kmers"],
                          ["refs.fa", "more.fa"]),
    # more threads than cores share the graph, its table and the stats
    "separately-threads": ("canonical", ["--separately", "-p", "16",
                                         "--count-kmers", "--anno-header"],
                           [f"one{i}.fa" for i in range(12)]),
    "separately-duplicate": ("basic", ["--separately"],
                             ["refs.fa", "sub/refs.fa"]),
    "smallest": ("basic", ["--anno-header", "--anno-codec", "smallest"],
                 ["refs.fa"]),
    "smallest-counts": ("canonical", ["--anno-codec", "smallest",
                                      "--count-kmers"], ["refs.fa"]),
    "disk-swap": ("basic", ["--anno-header", "--disk-swap", "{tmp}",
                            "--mem-cap-gb", "0.00001", "--count-kmers",
                            "--coordinates"], ["refs.fa", "more.fa"]),
    "mem-cap": ("canonical", ["--mem-cap-gb", "0.00002"], ["refs.fa"]),
    "anno-type": ("basic", ["--anno-type", "column", "--anno-header",
                            "-v"], ["refs.fa"]),
    "primary": ("primary", ["--anno-header"], ["refs.fa"]),
    "primary-coords": ("primary", ["--coordinates", "--anno-header"],
                       ["refs.fa"]),
    "dna5": ("dna5", ["--anno-header", "--count-kmers"], ["refs.fa"]),
    "hash": ("hash", ["--anno-header", "--coordinates"], ["refs.fa"]),
    "sshash-canonical": ("sshash", ["--anno-header"], ["refs.fa"]),
    "missing-graph": ("nothere", ["--anno-header"], ["refs.fa"]),
    "missing-input": ("basic", ["--anno-header"], ["refs.fa", "gone.fa"]),
}
GRAPHS = {"basic": ("--mode", "basic"), "canonical": ("--mode", "canonical"),
          "primary": ("--mode", "primary"),
          "dna5": ("--alphabet", "DNA5"),
          "hash": ("--graph", "hash", "--mode", "canonical"),
          "sshash": ("--graph", "sshash", "--mode", "canonical")}


def _line(tmp, case, side):
    graph, flags, inputs = CASES[case]
    return (["annotate", "-i", str(tmp / f"{graph}.dbg"),
             "-o", str(tmp / side / case)]
            + [f.replace("{tmp}", str(tmp)) for f in flags]
            + [str(tmp / f) for f in inputs])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("annotate_cli")
    rng = np.random.default_rng(24)
    refs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(60, 400))))
            for _ in range(8)]
    recs = [(f"ref{i} ka:f:{1.5 * i + 0.5}", s) for i, s in enumerate(refs)]
    recs += [("short", refs[0][:K - 1]), ("empty", ""),
             ("nrun km:f:3", refs[1][:50] + "N" * 7 + refs[1][57:120]),
             ("ref2", refs[2][::-1])]
    write_fasta(tmp / "refs.fa", recs)
    write_fasta(tmp / "more.fa", [(f"more{i}", s[20:]) for i, s in
                                  enumerate(refs[3:])] + [("ref0", refs[5])])
    for i in range(12):
        write_fasta(tmp / f"one{i}.fa", [(f"one{i}", refs[i % 8]),
                                         (f"two{i}", refs[(i + 3) % 8])])
    os.makedirs(tmp / "sub")
    write_fasta(tmp / "sub" / "refs.fa", recs[:2])
    for name, flags in GRAPHS.items():
        jax_cli("build", *flags, "-k", K, "-o", tmp / name, tmp / "refs.fa")
    for side in ("jax", "port"):
        os.makedirs(tmp / side)
    lines = [_line(tmp, c, "port") for c in CASES]
    port = dict(zip(CASES, run_port(tmp, lines, stderr=True)))
    return tmp, port


def _members(path):
    with np.load(path, allow_pickle=True) as z:
        return {f: z[f] for f in z.files}


def _outputs(base):
    """The files an annotate run at ``base`` wrote (relative names)."""
    d = os.path.dirname(base)
    stem = os.path.basename(base)
    out = []
    for root, _, files in os.walk(d):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), d)
            if rel.startswith(stem + ".") or rel.startswith(stem + os.sep):
                out.append(rel[len(stem):])
    return sorted(out)


def _errors(stderr):
    return [ln for ln in stderr.splitlines() if ln.startswith("[error]")]


@pytest.mark.parametrize("case", list(CASES))
def test_annotate_matches_jax(runs, case):
    tmp, port = runs
    want = run_jax(_line(tmp, case, "jax"), stderr=True)
    got = port[case]
    assert got[:3] == want[:3], (got[:3], want[:3])
    assert _errors(got[3]) == _errors(want[3])
    jbase, pbase = str(tmp / "jax" / case), str(tmp / "port" / case)
    files = _outputs(jbase)
    assert files == _outputs(pbase)
    if want[1] == 0 and case != "separately-duplicate":
        assert any(f.endswith(".column.annodbg.npz") for f in files)
    for f in files:
        a, b = _members(jbase + f), _members(pbase + f)
        assert list(a) == list(b), f
        for m in a:
            assert a[m].dtype == b[m].dtype and a[m].shape == b[m].shape \
                and np.array_equal(a[m], b[m]), (f, m)
