"""The port's ``build`` on the general route and on canonical and primary
builds, against the JAX CLI's ``build`` and ``build --device``.

Each case is one command line run three times: the JAX ``build``, the
JAX ``build --device`` (which sends these builds to its host
construction, or, for basic DNA at 3 <= k <= 21, to its device one) and
the port's ``build --device`` (``--torch-device cpu``, in one subprocess
without JAX).  They must write the same files (npz keys, dtypes and
arrays, ``weights`` and ``count_width`` included; the mmap layout's
``.npy`` files), print the same ``graph built:`` line and exit with the
same code.  The cases: ``--mode canonical|primary``; the DNA, DNA5,
DNA_CASE and Protein alphabets; k = 2, 3, 21, 22 and 31 (Protein 5 and
20); ``--count-kmers`` with a ``.kmer_counts.npz`` sidecar, with
``ka:f:``/``km:f:`` header abundances and with neither;
``--count-width 4``; ``--disk-swap`` and ``--mem-cap-gb`` (small enough
to spill); ``--mask-dummy``; ``--state fast``.  Then the error contract
of these flags, which the port refused before: a missing input is
reported first, and a ``--disk-swap`` directory that does not exist
fails as in JAX.  Every input is written here.
"""

import os

import numpy as np
import pytest

from metagraph_tpu.graph import dbg_succinct as jax_dbg
from metagraph_tpu.seq_io.fasta import write_extended_fasta
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct

from test_torch_canonical import native_lib
from torch_parity import (graph_line, run_jax, run_port, same_build_files,
                          write_fasta)

# name -> (flags, input file)
CASES = {
    "canonical-k3": (["-k", "3", "--mode", "canonical"], "in.fa"),
    "canonical-k11": (["-k", "11", "--mode", "canonical"], "in.fa"),
    "canonical-k21": (["-k", "21", "--mode", "canonical"], "in.fa"),
    "canonical-k31": (["-k", "31", "--mode", "canonical"], "in.fa"),
    "canonical-k11-mask-fast": (["-k", "11", "--mode", "canonical",
                                 "--mask-dummy", "--state", "fast"],
                                "in.fa"),
    "primary-k11": (["-k", "11", "--mode", "primary"], "in.fa"),
    "primary-k31-mask": (["-k", "31", "--mode", "primary", "--mask-dummy"],
                         "in.fa"),
    "k2": (["-k", "2"], "in.fa"),
    "k3-counts": (["-k", "3", "--count-kmers"], "in.fa"),
    "k21-counts": (["-k", "21", "--count-kmers"], "in.fa"),
    "k22": (["-k", "22"], "in.fa"),
    "k31-mmap": (["-k", "31", "--mmap"], "in.fa"),
    "dna5-k9": (["-k", "9", "--alphabet", "DNA5"], "iupac.fa"),
    "dna5-canonical-k22": (["-k", "22", "--alphabet", "DNA5", "--mode",
                            "canonical"], "iupac.fa"),
    "dna_case-k9": (["-k", "9", "--alphabet", "DNA_CASE"], "iupac.fa"),
    "dna_case-primary-k13": (["-k", "13", "--alphabet", "DNA_CASE",
                              "--mode", "primary"], "iupac.fa"),
    "protein-k5": (["-k", "5", "--alphabet", "Protein"], "protein.fa"),
    "protein-k20-mask": (["-k", "20", "--alphabet", "Protein",
                          "--mask-dummy"], "protein.fa"),
    "protein-k20-disk": (["-k", "20", "--alphabet", "Protein",
                          "--disk-swap", "swap", "--mem-cap-gb", "0.00002"],
                         "protein.fa"),
    "counts-sidecar-k11": (["-k", "11", "--count-kmers"], "counts.fa"),
    "counts-sidecar-canonical-k31": (["-k", "31", "--count-kmers", "--mode",
                                      "canonical"], "counts.fa"),
    "counts-sidecar-width4": (["-k", "11", "--count-kmers", "--count-width",
                               "4"], "counts.fa"),
    "counts-abundance-k11": (["-k", "11", "--count-kmers"], "abund.fa"),
    "counts-abundance-fast": (["-k", "17", "--count-kmers", "--state",
                               "fast"], "abund.fa"),
    "disk-swap-k11": (["-k", "11", "--disk-swap", "swap"], "in.fa"),
    "mem-cap-counts-k21": (["-k", "21", "--count-kmers", "--mem-cap-gb",
                            "0.00002"], "in.fa"),
    "disk-swap-canonical-counts": (["-k", "15", "--mode", "canonical",
                                    "--count-kmers", "--disk-swap", "swap",
                                    "--mem-cap-gb", "0.00002"], "counts.fa"),
}

# the flags that the port refused before this slice, each with a flag line
# for the missing-input check
PORTED_FLAGS = {"canonical": ["--mode", "canonical"],
                "primary": ["--mode", "primary"],
                "dna5": ["--alphabet", "DNA5"],
                "dna_case": ["--alphabet", "DNA_CASE"],
                "protein": ["--alphabet", "Protein"],
                "k2": ["-k", "2"], "k25": ["-k", "25"],
                "count_kmers": ["--count-kmers"],
                "disk_swap": ["--disk-swap", "swap"],
                "mem_cap": ["--mem-cap-gb", "1"]}


def _dna(rng, n, lo, hi, letters="ACGT"):
    return ["".join(rng.choice(list(letters), size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def _inputs(rng, tmp):
    """in.fa (DNA with N runs, lower case, a short and a repeated record),
    iupac.fa (IUPAC codes, U, mixed case), protein.fa, counts.fa with a
    .kmer_counts.npz sidecar, abund.fa with header abundances."""
    recs = []
    for i, s in enumerate(_dna(rng, 8, 150, 600)):
        if i % 3 == 1:
            a = int(rng.integers(20, 120))
            s = s[:a] + "N" * int(rng.integers(1, 30)) + s[a + 30:]
        recs.append((f"r{i}", s.lower() if i == 4 else s))
    recs += [("short", "ACG"), ("repeat", recs[0][1][:60] * 4)]
    write_fasta(tmp / "in.fa", recs)
    write_fasta(tmp / "iupac.fa", [(f"u{i}", s) for i, s in enumerate(
        _dna(rng, 8, 100, 400, "ACGTacgtNnRYUu"))])
    write_fasta(tmp / "protein.fa", [(f"p{i}", s) for i, s in enumerate(
        _dna(rng, 12, 100, 500, "ACDEFGHIKLMNPQRSTVWYXBZ*"))])
    seqs = _dna(rng, 6, 80, 300)
    write_extended_fasta(str(tmp / "counts.fa"),
                         [(f"c{i}", s) for i, s in enumerate(seqs)],
                         [rng.integers(1, 40, max(len(s) - 10, 0))
                          for s in seqs], 11)
    abund = [("a0 ka:f:12.5", seqs[0]), ("a1", seqs[1]),
             ("a2_km:f:3.2", seqs[2]), ("a3 km:f:0.4 x", seqs[3]),
             ("a4 ka:f:7", seqs[4])]
    write_fasta(tmp / "abund.fa", abund)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert native_lib() is not None, "the JAX native library does not load"
    tmp = tmp_path_factory.mktemp("build_host_cli")
    os.makedirs(tmp / "swap", exist_ok=True)
    _inputs(np.random.default_rng(17), tmp)
    cwd = os.getcwd()
    os.chdir(tmp)               # the CLIs write relative to it (--disk-swap)
    try:
        jax_out, lines, keys = {}, [], []
        for name, (flags, inp) in CASES.items():
            for tag, dev in (("h", []), ("j", ["--device"])):
                jax_out[(tag, name)] = run_jax(
                    ["build", *dev, *flags, "-o", f"{tag}-{name}", inp],
                    stderr=True)
                jax_dbg.DEFAULT_MMAP = False     # --mmap sets it for good
            lines.append(["build", "--device", *flags, "-o", f"p-{name}",
                          inp])
            keys.append(("p", name))
        for name, flags in PORTED_FLAGS.items():
            line = ["build", "-k", "11", *flags, "-o", f"m-{name}",
                    "missing.fa"]
            jax_out[("missing", name)] = run_jax(line, stderr=True)
            lines.append(line)
            keys.append(("missing", name))
        line = ["build", "-k", "11", "--disk-swap", "nodir", "-o", "nodir",
                "in.fa"]
        jax_out[("nodir",)] = run_jax(line, stderr=True)
        lines.append(line)
        keys.append(("nodir",))
        got = run_port(tmp, lines, stderr=True)
    finally:
        os.chdir(cwd)
        jax_dbg.DEFAULT_MMAP = False
    return dict(tmp=tmp, jax=jax_out, port=dict(zip(keys, got)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_jax(runs, name):
    tmp = runs["tmp"]
    flags = CASES[name][0]
    layout = "--mmap" in flags or "fast" in flags
    got = runs["port"][("p", name)]
    assert got[1] == 0 and got[2] is None, got
    assert graph_line(got[3]) != []
    for tag in ("h", "j"):
        want = runs["jax"][(tag, name)]
        assert want[1] == 0 and want[2] is None, want
        assert got[0] == want[0]
        assert graph_line(got[3]) == graph_line(want[3])
        same_build_files(tmp, f"p-{name}", f"{tag}-{name}", layout)
    g = DBGSuccinct.load(str(tmp / f"p-{name}.dbg"), mmap=layout)
    ref = jax_dbg.DBGSuccinct.load(str(tmp / f"h-{name}.dbg"), mmap=layout)
    assert g.mode == ref.mode and g.alphabet == ref.alphabet.name
    assert g.boss.count_width == ref.boss.count_width
    counted = "--count-kmers" in flags
    assert (g.boss.weights is not None) == counted
    if counted:
        assert np.array_equal(g.boss.weights, ref.boss.weights)
    # the spill directory is left empty
    assert os.listdir(tmp / "swap") == []


def test_counts_come_from_the_inputs(runs):
    """The sidecar's and the headers' counts reach the weights: the same
    graphs built without them count occurrences instead."""
    tmp = runs["tmp"]
    for name in ("counts-sidecar-k11", "counts-abundance-k11"):
        w = np.load(tmp / f"p-{name}.dbg.npz")["weights"]
        assert w.max() > 1 and w.max() <= 255
    w = np.load(tmp / "p-counts-sidecar-width4.dbg.npz")["weights"]
    assert w.max() == 15


@pytest.mark.parametrize("name", sorted(PORTED_FLAGS))
def test_missing_input_reported_first(runs, name):
    want = runs["jax"][("missing", name)]
    got = runs["port"][("missing", name)]
    assert got[:3] == want[:3] == ["", 1, None]
    assert got[3].strip() == want[3].strip() \
        == "[error] File not found: missing.fa"


def test_missing_disk_swap_dir(runs):
    """mkdtemp in a directory that does not exist: the JAX error line
    (the name of the directory it could not make) and exit 1."""
    want, got = runs["jax"][("nodir",)], runs["port"][("nodir",)]
    assert got[:3] == want[:3] == ["", 1, None]
    prefix = "[error] File not found: nodir/mg_sortdisk_"
    assert got[3].startswith(prefix) and want[3].startswith(prefix)
    assert got[3].count("\n") == want[3].count("\n") == 1
    assert not os.path.exists(runs["tmp"] / "nodir.dbg.npz")
