"""The port's ``align -a`` and ``--align-chain`` against the JAX CLI's,
byte for byte.

Graphs and annotations are built by the JAX CLI from seeded random
references, some of them mosaics of the others so that paths cross label
boundaries: a basic and a canonical DNA graph; a column annotation
labelled by header, its BRWT and row_diff_brwt conversions; a coordinate
annotation labelled by file (two files of references) with its ``.seqs``
index beside it, and its brwt_coord and row_diff_coord conversions.  Every
command line runs through the JAX CLI in this process and through the
port's CLI (``--torch-device cpu``) in one subprocess without JAX; stdout,
exit code and uncaught error must be equal.  The reads are cut from the
references forward and reverse-complemented, with substitutions and an
indel, across two references, random, short and empty.
"""

import numpy as np
import pytest

from test_torch_canonical import native_lib
from torch_parity import jax_cli, run_jax, run_port, write_fasta

COMP = str.maketrans("ACGT", "TGCA")

# case -> (graph, annotation, flags); {anno} names the annotation file
CASES = {
    "labels": ("dna", "col", []),
    "labels-json": ("dna", "col", ["--json"]),
    "labels-parallel": ("dna", "col", ["-p", "2"]),
    "labels-alternatives": ("dna", "col",
                            ["--align-alternative-alignments", "3"]),
    "labels-post-chain": ("dna", "col", ["--align-post-chain"]),
    "labels-seed-below-k": ("dna", "col", ["--align-min-seed-length", "8"]),
    "labels-forwards": ("dna", "col", ["--align-only-forwards"]),
    "labels-device": ("dna", "col", ["--device"]),
    "brwt": ("dna", "col.brwt", []),
    "row-diff": ("dna", "col.row_diff_brwt", []),
    "coords-seqs": ("dna", "crd", []),
    "coords-no-mapping": ("dna", "crd", ["--no-coord-mapping"]),
    "coords-brwt": ("dna", "crd.brwt_coord", []),
    "coords-row-diff": ("dna", "crd.row_diff_coord", []),
    "chain-coords": ("dna", "crd", ["--align-chain"]),
    "chain-coords-alternatives": ("dna", "crd", [
        "--align-chain", "--align-alternative-alignments", "2"]),
    "chain-no-coords": ("dna", "col", ["--align-chain"]),
    "chain-converted": ("dna", "crd.brwt_coord", ["--align-chain"]),
    "chain-no-annotation": ("dna", None, ["--align-chain"]),
    "canonical": ("canonical", "ccol", []),
    "canonical-coords": ("canonical", "ccrd", []),
    "missing-annotation": ("dna", "none", []),
}
FILES = {"col": "col.column.annodbg", "col.brwt": "col.brwt.annodbg",
         "col.row_diff_brwt": "col.row_diff_brwt.annodbg",
         "crd": "crd.column.annodbg", "crd.brwt_coord": "crd.brwt_coord.annodbg",
         "crd.row_diff_coord": "crd.row_diff_coord.annodbg",
         "ccol": "ccol.column.annodbg", "ccrd": "ccrd.column.annodbg",
         "none": "none.column.annodbg"}


def references(rng):
    refs = ["".join(rng.choice(list("ACGT"), int(rng.integers(250, 380))))
            for _ in range(5)]
    refs.append(refs[0][60:170] + refs[1][40:200])
    refs.append(refs[2][:130] + refs[3][90:230])
    return refs


def reads_of(rng, refs):
    out = []
    for i in range(16):
        r = refs[i % len(refs)]
        a = int(rng.integers(0, len(r) - 100))
        s = list(r[a: a + int(rng.integers(60, 100))])
        for p in rng.choice(len(s), int(rng.integers(0, 3)), replace=False):
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        if i % 5 == 4:
            del s[30: 32]
        s = "".join(s)
        if i % 3 == 1:
            s = s[::-1].translate(COMP)
        out.append(s)
    out += [refs[0][120:170] + refs[1][40:90], refs[2][80:130] + refs[4][:60],
            "".join(rng.choice(list("ACGT"), 70)), refs[0][:7], ""]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert native_lib() is not None, "the JAX native library does not load"
    tmp = tmp_path_factory.mktemp("align_labeled_cli")
    rng = np.random.default_rng(22)
    refs = references(rng)
    write_fasta(tmp / "a.fa", [(f"ref{i}", s) for i, s in enumerate(refs[:4])])
    write_fasta(tmp / "b.fa", [(f"ref{i + 4}", s)
                               for i, s in enumerate(refs[4:])])
    write_fasta(tmp / "q.fa", [(f"q{i} read {i}", s)
                               for i, s in enumerate(reads_of(rng, refs))])
    fa = [tmp / "a.fa", tmp / "b.fa"]
    for name, flags in (("dna", []), ("canonical", ["--mode", "canonical"])):
        jax_cli("build", "-k", "13", *flags, "-o", tmp / name, *fa)
    for graph, col, crd in (("dna", "col", "crd"),
                            ("canonical", "ccol", "ccrd")):
        jax_cli("annotate", "-i", tmp / f"{graph}.dbg", "--anno-header",
                "-o", tmp / col, *fa)
        jax_cli("annotate", "-i", tmp / f"{graph}.dbg", "--coordinates",
                "--index-header-coords", "-o", tmp / crd, *fa)
    for src, rep in (("col", "brwt"), ("col", "row_diff_brwt"),
                     ("crd", "brwt_coord"), ("crd", "row_diff_coord")):
        jax_cli("transform_anno", "--anno-type", rep, "-i", tmp / "dna.dbg",
                "-o", tmp / src, tmp / f"{src}.column.annodbg")
    lines = {}
    for case, (graph, anno, flags) in CASES.items():
        a = ["-a", tmp / FILES[anno]] if anno else []
        lines[case] = ["align", "-i", tmp / f"{graph}.dbg", *a, *flags,
                       tmp / "q.fa"]
    lines["missing-reads"] = ["align", "-i", tmp / "dna.dbg", "-a",
                              tmp / FILES["col"], tmp / "none.fa"]
    keys = list(lines)
    got = run_port(tmp, [lines[k] for k in keys], stderr=True)
    return dict(lines=lines, got=dict(zip(keys, got)))


@pytest.mark.parametrize("case", sorted(CASES) + ["missing-reads"])
def test_align_labeled_bytes_equal_jax(runs, case):
    line = [str(a) for a in runs["lines"][case]]
    want = run_jax(line, stderr=True)
    got = runs["got"][case]
    assert got[:3] == want[:3]
    if case.startswith("chain-no") or case == "chain-converted":
        assert want[1] == 1 and want[0] == "" and "Chaining only supported" \
            in got[3]
    elif case.startswith("missing"):
        err = [ln for ln in want[3].splitlines() if ln.startswith("[error]")]
        assert want[1] == 1 and err and err[-1] in got[3]
    else:
        assert want[1] == 0 and want[0].count("\n") == 21
        mapped = [ln for ln in want[0].splitlines()
                  if ln.split("\t")[2] != "*"]
        # on the canonical graph the annotation labels one node of each
        # k-mer pair and the aligner walks the k-mers as they are: a seed
        # over the other node has no labels (JAX's behaviour)
        assert len(mapped) >= (1 if case.startswith("canonical") else 12)


def test_labels_resolve_across_headers(runs):
    """The coordinate cases print file labels with --no-coord-mapping and
    sequence headers through the .seqs index."""
    seqs = runs["got"]["coords-seqs"][0]
    plain = runs["got"]["coords-no-mapping"][0]
    assert "\tref" in seqs and ("a.fa:" in plain or "b.fa:" in plain)
    assert seqs != plain
