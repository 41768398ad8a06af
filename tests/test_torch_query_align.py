"""``query --align`` and ``query --batch-align`` on the port against the
JAX CLI.

The JAX CLI builds basic, canonical and primary DNA graphs at k = 15 and
31 and a Protein graph of references with a detour (a copy of one
reference with a substitution every 97 characters), and annotates them:
the basic k = 31 graph also with k-mer counts, and with coordinates and a
``.seqs`` mapping.  The reads carry substitutions, a deletion, an N run;
one is random and gives ``0`` and ``150S``.  Every command line runs
through the JAX CLI in this process and through the port's
(``--torch-device cpu``) in one subprocess without JAX; stdout and exit
codes must be equal: TSV and ``--json``, ``--fwd-and-reverse``, the modes
labels, counts and coords, non-default ``--align-*`` scoring flags,
``-p 2`` (the same bytes as ``-p 1``), ``--batch-align`` with
``--max-hull-forks 0`` and 4 and a small ``--max-hull-depth``, and
``--batch-align`` without ``--align`` (a plain query in both); under
``-v`` the batch graphs' stderr lines are the JAX CLI's.
"""

import numpy as np
import pytest

from torch_parity import (detour_references_and_reads, jax_cli, run_jax,
                          run_port, write_fasta)

PROTEIN = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("query_align")
    rng = np.random.default_rng(61)
    refs, reads = detour_references_and_reads(rng)
    write_fasta(tmp / "refs.fa", [(f"ref{i}", s) for i, s in enumerate(refs)])
    write_fasta(tmp / "q.fa", [(f"q{i}", s) for i, s in enumerate(reads)])
    # a canonical wrapper's seeding walks every reverse-complement suffix:
    # the primary graphs get fewer reads
    write_fasta(tmp / "q8.fa", [(f"q{i}", s)
                                for i, s in enumerate(reads[-8:])])
    for mode in ("basic", "canonical", "primary"):
        for k in (15, 31):
            g = f"{mode}{k}"
            jax_cli("build", "--mode", mode, "-k", k, "-o", tmp / g,
                    tmp / "refs.fa")
            jax_cli("annotate", "-i", tmp / f"{g}.dbg", "--anno-header",
                    "-o", tmp / f"{g}a", tmp / "refs.fa")
    jax_cli("annotate", "-i", tmp / "basic31.dbg", "--anno-header",
            "--count-kmers", "-o", tmp / "counts", tmp / "refs.fa")
    jax_cli("annotate", "-i", tmp / "basic31.dbg", "--coordinates",
            "--index-header-coords", "-o", tmp / "coords", tmp / "refs.fa")
    prefs, preads = detour_references_and_reads(
        rng, n_refs=3, length=300, n_reads=8, read_len=60, letters=PROTEIN)
    write_fasta(tmp / "prot.fa", [(f"p{i}", s) for i, s in enumerate(prefs)])
    write_fasta(tmp / "pq.fa", [(f"pq{i}", s) for i, s in enumerate(preads)])
    jax_cli("build", "--alphabet", "Protein", "-k", 10, "-o", tmp / "prot",
            tmp / "prot.fa")
    jax_cli("annotate", "-i", tmp / "prot.dbg", "--anno-header", "-o",
            tmp / "prota", tmp / "prot.fa")
    return tmp


def _line(tmp, graph, anno, *flags, reads="q.fa"):
    return ["query", "-i", tmp / f"{graph}.dbg", "-a",
            tmp / f"{anno}.column.annodbg", *flags, tmp / reads]


# (case id, graph, annotation, flags, reads)
CASES = [
    (f"{mode}{k}{'-batch' if batch else ''}", f"{mode}{k}", f"{mode}{k}a",
     ["--align", *(["--batch-align"] if batch else [])],
     "q8.fa" if mode == "primary" else "q.fa")
    for mode in ("basic", "canonical", "primary") for k in (15, 31)
    for batch in (False, True)
] + [
    ("protein", "prot", "prota", ["--align"], "pq.fa"),
    ("protein-batch", "prot", "prota", ["--align", "--batch-align"],
     "pq.fa"),
    ("json", "basic31", "basic31a", ["--align", "--json"], "q.fa"),
    ("json-batch", "canonical15", "canonical15a",
     ["--align", "--batch-align", "--json"], "q.fa"),
    ("fwd-and-reverse", "basic31", "basic31a",
     ["--align", "--fwd-and-reverse"], "q.fa"),
    ("fwd-and-reverse-batch", "canonical31", "canonical31a",
     ["--align", "--batch-align", "--fwd-and-reverse", "--json"], "q.fa"),
    ("counts", "basic31", "counts", ["--align", "--query-mode", "counts"],
     "q.fa"),
    ("counts-batch-verbose", "basic31", "counts",
     ["--align", "--batch-align", "--query-mode", "counts",
      "--verbose-output"], "q.fa"),
    ("coords-seqs", "basic31", "coords",
     ["--align", "--query-mode", "coords"], "q.fa"),
    ("coords-seqs-batch", "basic31", "coords",
     ["--align", "--batch-align", "--query-mode", "coords", "--json"],
     "q.fa"),
    ("scoring", "basic15", "basic15a",
     ["--align", "--align-match-score", "3",
      "--align-mm-transition-penalty", "2",
      "--align-mm-transversion-penalty", "4",
      "--align-gap-open-penalty", "5", "--align-gap-extension-penalty", "1",
      "--align-end-bonus", "2", "--align-xdrop", "15",
      "--align-min-exact-match", "0.3", "--align-rel-score-cutoff", "0.8",
      "--align-no-seed-complexity-filter"], "q.fa"),
    ("scoring-batch", "basic31", "basic31a",
     ["--align", "--batch-align", "--align-match-score", "1",
      "--align-gap-open-penalty", "4", "--align-max-nodes-per-seq-char",
      "2.5", "--align-max-num-seeds-per-locus", "3"], "q.fa"),
    ("p2", "basic31", "basic31a",
     ["--align", "-p", "2", "--batch-size", "1000"], "q.fa"),
    ("p1", "basic31", "basic31a",
     ["--align", "-p", "1", "--batch-size", "1000"], "q.fa"),
    ("p2-batch", "canonical15", "canonical15a",
     ["--align", "--batch-align", "-p", "2", "--batch-size", "1000"],
     "q.fa"),
    ("p1-batch", "canonical15", "canonical15a",
     ["--align", "--batch-align", "-p", "1", "--batch-size", "1000"],
     "q.fa"),
    ("hull-forks-0", "basic15", "basic15a",
     ["--align", "--batch-align", "--max-hull-forks", "0"], "q.fa"),
    ("hull-forks-4-depth-6", "basic15", "basic15a",
     ["--align", "--batch-align", "--max-hull-forks", "4",
      "--max-hull-depth", "6", "--batch-size", "2000"], "q.fa"),
    ("hull-depth-1", "canonical31", "canonical31a",
     ["--align", "--batch-align", "--max-hull-depth", "1"], "q.fa"),
    ("batch-align-alone", "basic31", "basic31a", ["--batch-align"],
     "q.fa"),
]


@pytest.fixture(scope="module")
def results(data):
    """Every case's (JAX, port) result: [stdout, exit code, error]."""
    lines = [_line(data, g, a, *flags, reads=reads)
             for _, g, a, flags, reads in CASES]
    got = run_port(data, lines)
    return {case[0]: (run_jax([str(x) for x in line]), port)
            for case, line, port in zip(CASES, lines, got)}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_query_align_prints_the_jax_bytes(results, case):
    want, got = results[case]
    assert got == want
    assert want[1] == 0 and want[2] is None
    out = want[0]
    if case == "batch-align-alone":
        assert ":150=" not in out               # no alignment header
        return
    if "--json" not in dict((c[0], c[3]) for c in CASES)[case]:
        headers = [ln.split("\t")[1] for ln in out.splitlines()]
        assert all(h.count(":") >= 3 for h in headers)
    if not case.startswith(("protein", "primary")):
        # the random read: no alignment, the whole read clipped
        assert ":0:150S" in out or '"cigar": "150S"' in out


def test_parallel_bytes_equal_sequential(results):
    assert results["p2"][1] == results["p1"][1]
    assert results["p2-batch"][1] == results["p1-batch"][1]


def test_batch_align_differs_from_full_graph_somewhere(results):
    """The batch graph is a different graph: the hull bounds change some
    alignment on these reads (else the hull cases test nothing)."""
    outs = {results[c][0][0] for c in ("basic15-batch", "hull-forks-0",
                                        "hull-forks-4-depth-6")}
    assert len(outs) >= 2


def test_verbose_prints_the_batch_graph_lines(data):
    """``-v --batch-align``: each batch graph's line ("Batch graph: N query
    k-mers (M matched), H hull contigs (C chars)") as the JAX CLI prints
    it on stderr."""
    line = _line(data, "canonical15", "canonical15a", "-v", "--align",
                 "--batch-align", "--batch-size", "1500")
    want = run_jax([str(x) for x in line], stderr=True)
    got = run_port(data, [line], stderr=True)[0]
    assert got[:3] == want[:3]

    def graphs(err):
        return [ln for ln in err.splitlines() if "Batch graph:" in ln]
    assert graphs(got[3]) == graphs(want[3])
    assert len(graphs(want[3])) >= 3
