"""The port's ``align`` command against the JAX CLI's, byte for byte.

Graphs and an annotation are built by the JAX CLI from seeded random
references: DNA in basic, canonical and primary mode, DNA5, DNA_CASE and
Protein.  Every command line runs through the JAX CLI in this process and
through the port's CLI (``--torch-device cpu``, the plain versions of its
kernels) in one subprocess without JAX; stdout, exit code and uncaught
error must be equal, with and without ``--device``, for each flag family:
the TSV and ``--json`` output, seeding (``--align-min-seed-length`` above
and below k, ``--align-max-seed-length``, the complexity filter),
extension and scoring flags, ``--align-edit-distance``,
``--align-only-forwards``, ``--align-min-path-score``,
``--align-alternative-alignments``, ``--align-post-chain``, ``-p 2`` and
``--map`` (``--count-kmers``, ``--query-presence``, ``--filter-present``,
``--align-length`` below k).  ``--align-chain`` without ``-a`` gives the
JAX error line and exit 1.  ``-a`` on a hash graph prints the JAX bytes,
and with its read file missing the JAX CLI's ``[error] File not found``
after the graph and the annotation load.  ``-a``, ``--align-chain`` and
``-o *.gfa`` have files of their own (tests/test_torch_align_labeled_cli.py,
tests/test_torch_traversal_gfa.py), and so do graphs that are not
succinct (tests/test_torch_align_hash_cli.py).
"""

import numpy as np
import pytest

from test_torch_canonical import native_lib
from torch_parity import jax_cli, run_jax, run_port, write_fasta

COMP = str.maketrans("ACGT", "TGCA")

# graph -> (build flags, letters of the references)
GRAPHS = {
    "dna": (["-k", "15"], "ACGT"),
    "canonical": (["-k", "13", "--mode", "canonical"], "ACGT"),
    "primary": (["-k", "13", "--mode", "primary"], "ACGT"),
    "dna5": (["-k", "12", "--alphabet", "DNA5"], "ACGTN"),
    "dna-case": (["-k", "11", "--alphabet", "DNA_CASE"], "ACGTacgt"),
    "protein": (["-k", "8", "--alphabet", "Protein"],
                "ACDEFGHIKLMNPQRSTVWY"),
}

SCORING = ["--align-match-score", "3", "--align-mm-transition-penalty", "2",
           "--align-mm-transversion-penalty", "4",
           "--align-gap-open-penalty", "5",
           "--align-gap-extension-penalty", "1", "--align-end-bonus", "3",
           "--align-xdrop", "20", "--align-rel-score-cutoff", "0.8",
           "--align-max-nodes-per-seq-char", "3",
           "--align-max-num-seeds-per-locus", "5", "--align-max-ram", "50"]

# case -> (graph, flags); each runs without and with --device
CASES = {
    "tsv": ("dna", []),
    "json": ("dna", ["--json"]),
    "forwards": ("dna", ["--align-only-forwards"]),
    "edit-distance": ("dna", ["--align-edit-distance"]),
    "seed-below-k": ("dna", ["--align-min-seed-length", "8"]),
    "seed-above-k": ("dna", ["--align-min-seed-length", "25"]),
    "max-seed": ("dna", ["--align-max-seed-length", "20"]),
    "min-path-score": ("dna", ["--align-min-path-score", "90"]),
    "alternatives": ("dna", ["--align-alternative-alignments", "3",
                             "--json"]),
    "post-chain": ("dna", ["--align-post-chain"]),
    "scoring": ("dna", SCORING),
    "no-filter": ("dna", ["--align-no-seed-complexity-filter",
                          "--align-min-seed-length", "9",
                          "--align-min-exact-match", "0.5"]),
    "parallel": ("dna", ["-p", "2"]),
    "map-count": ("dna", ["--map", "--count-kmers"]),
    "map-presence": ("dna", ["--map", "--query-presence",
                             "--align-min-kmers-fraction", "0.6"]),
    "map-filter": ("dna", ["--map", "--query-presence", "--filter-present"]),
    "map-length": ("dna", ["--map", "--align-length", "10"]),
    "map-kmers": ("dna", ["--map"]),
    "chain": ("dna", ["--align-chain"]),
    "canonical": ("canonical", []),
    "canonical-json": ("canonical", ["--json", "--align-min-seed-length",
                                     "9"]),
    "canonical-map": ("canonical", ["--map", "--count-kmers"]),
    "primary": ("primary", []),
    "dna5": ("dna5", ["--align-alternative-alignments", "2"]),
    "dna-case": ("dna-case", []),
    "dna-case-seeds": ("dna-case", ["--align-min-seed-length", "7"]),
    "protein": ("protein", []),
    "protein-json": ("protein", ["--json", "--align-min-seed-length", "6"]),
    "protein-map": ("protein", ["--map", "--count-kmers"]),
}

# case -> (graph, flags) that the port refused before it aligned on graphs
# without a BOSS; each runs with its read file present and missing
REFUSALS = {"hash-annotation": ("hash", ["-a", "{anno}"])}


def reads_of(rng, refs, letters, dna):
    out = []
    for i in range(12):
        r = refs[i % len(refs)]
        a = int(rng.integers(0, len(r) - 90))
        s = list(r[a: a + int(rng.integers(50, 90))])
        for p in rng.choice(len(s), int(rng.integers(0, 3)), replace=False):
            s[p] = letters[(letters.index(s[p]) + 1) % len(letters)]
        if i % 4 == 3:
            del s[30: 32]
        s = "".join(s)
        if dna and i % 3 == 1:
            s = s[::-1].translate(COMP)
        out.append(s)
    out += ["".join(rng.choice(list(letters), 70)), refs[0][:5], ""]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The graphs, the reads and the port's output for every command
    line, from one subprocess."""
    assert native_lib() is not None, "the JAX native library does not load"
    tmp = tmp_path_factory.mktemp("align_cli")
    files = {}
    for name, (flags, letters) in GRAPHS.items():
        rng = np.random.default_rng(len(name))
        refs = ["".join(rng.choice(list(letters), int(rng.integers(250, 400))))
                for _ in range(4)]
        refs.append(refs[0][80:200] + refs[1][40:190])
        write_fasta(tmp / f"{name}.fa", [(f"r{i}", s)
                                         for i, s in enumerate(refs)])
        write_fasta(tmp / f"{name}.q.fa", [
            (f"q{i} read {i}", s) for i, s in enumerate(
                reads_of(rng, refs, letters, name in ("dna", "canonical",
                                                      "primary")))])
        jax_cli("build", *flags, "-o", tmp / name, tmp / f"{name}.fa")
        files[name] = (tmp / f"{name}.dbg", tmp / f"{name}.q.fa")
    jax_cli("annotate", "-i", files["dna"][0], "--anno-header", "-o",
            tmp / "anno", tmp / "dna.fa")
    jax_cli("build", "--graph", "hash", "-k", "15", "-o", tmp / "hash",
            tmp / "dna.fa")
    lines = {}
    for case, (graph, flags) in CASES.items():
        g, q = files[graph]
        for dev in ((), ("--device",)):
            lines[(case, bool(dev))] = ["align", "-i", g, *flags, *dev, q]
    for case, (graph, flags) in REFUSALS.items():
        g, q = tmp / f"{graph}.dbg", files["dna"][1]
        flags = [f.format(anno=tmp / "anno.column.annodbg") for f in flags]
        lines[(case, True)] = ["align", "-i", g, *flags, q]
        lines[(case, False)] = ["align", "-i", g, *flags, tmp / "none.fa"]
    keys = list(lines)
    got = run_port(tmp, [lines[k] for k in keys], stderr=True)
    return dict(lines=lines, got=dict(zip(keys, got)))


@pytest.mark.parametrize("device", (False, True), ids=("host", "device"))
@pytest.mark.parametrize("case", sorted(CASES))
def test_align_bytes_equal_jax(runs, case, device):
    line = [str(a) for a in runs["lines"][(case, device)]]
    want = run_jax(line)
    got = runs["got"][(case, device)][:3]
    assert got == want
    if case == "chain":
        assert want[1] == 1 and want[0] == ""
    else:
        assert want[1] == 0 and want[0]


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_after_inputs_load(runs, case):
    """With every input present the port prints the JAX CLI's bytes; with
    the read file missing it reports that file after the graph and the
    annotation load, as the JAX CLI does."""
    want = run_jax([str(a) for a in runs["lines"][(case, True)]])
    assert runs["got"][(case, True)][:3] == want
    assert want[1] == 0 and want[0].count("\n") == 15
    line = [str(a) for a in runs["lines"][(case, False)]]
    want = run_jax(line, stderr=True)
    got = runs["got"][(case, False)]
    assert got[:3] == want[:3] and want[1] == 1
    err_line = [ln for ln in want[3].splitlines()
                if ln.startswith("[error]")]
    assert err_line and err_line[-1] in got[3]
