"""The port's ``build --suffix`` against the JAX CLI's.

Suffixes ``A``, ``AC``, ``$`` and ``$A`` (a ``$`` gives an empty chunk),
with both collectors (``--mode basic`` and ``primary``: forward windows;
``--mode canonical``: both strands), at k = 11 and 31, and one Protein
build: the ``<out>.<suffix>.chunk.npz`` (keys, dtypes, arrays), the
stderr ``chunk <suffix>: N k-mers`` line and the exit code.  The port
runs with ``--torch-device cpu`` in one subprocess without JAX.
"""

import os

import numpy as np
import pytest

from torch_parity import run_jax, run_port, write_fasta

SUFFIXES = ("A", "AC", "$", "$A")
CASES = [(s, m, k) for s in SUFFIXES for m in ("basic", "canonical",
                                                "primary")
         for k in (11, 31)]


def _name(s, m, k):
    return f"{s}-{m}-k{k}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("build_suffix")
    rng = np.random.default_rng(182)
    recs = [(f"r{i}", "".join(rng.choice(list("ACGTN"), p=[.24] * 4 + [.04],
                                         size=int(rng.integers(20, 500)))))
            for i in range(8)]
    write_fasta(tmp / "in.fa", recs + [("short", "ACGT")])
    write_fasta(tmp / "prot.fa", [(f"p{i}", "".join(rng.choice(
        list("ACDEFGHIKLMNPQRSTVWY"), size=200))) for i in range(5)])
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        jax_out, lines, keys = {}, [], []
        for c in CASES:
            s, m, k = c
            flags = ["-k", str(k), "--mode", m, "--suffix", s]
            jax_out[c] = run_jax(["build", *flags, "-o", "j-" + _name(*c),
                                  "in.fa"], stderr=True)
            lines.append(["build", *flags, "-o", "p-" + _name(*c), "in.fa"])
            keys.append(c)
        for m in ("basic", "canonical"):
            flags = ["-k", "6", "--alphabet", "Protein", "--mode", m,
                     "--suffix", "DE"]
            jax_out[("protein", m)] = run_jax(
                ["build", *flags, "-o", f"j-protein-{m}", "prot.fa"],
                stderr=True)
            lines.append(["build", *flags, "-o", f"p-protein-{m}",
                          "prot.fa"])
            keys.append(("protein", m))
        got = run_port(tmp, lines, stderr=True)
    finally:
        os.chdir(cwd)
    return dict(tmp=tmp, jax=jax_out, port=dict(zip(keys, got)))


def _chunk_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith("chunk ")]


@pytest.mark.parametrize("case", CASES, ids=[_name(*c) for c in CASES])
def test_suffix_chunk_matches_jax(runs, case):
    want, got = runs["jax"][case], runs["port"][case]
    assert got[:3] == want[:3] == ["", 0, None], (got, want)
    assert _chunk_lines(got[3]) == _chunk_lines(want[3]) != []
    s = case[0]
    tmp = runs["tmp"]
    with np.load(tmp / f"j-{_name(*case)}.{s}.chunk.npz") as x, \
            np.load(tmp / f"p-{_name(*case)}.{s}.chunk.npz") as y:
        assert sorted(x.files) == sorted(y.files) \
            == ["alphabet", "k", "kmers", "mode"]
        for f in x.files:
            assert x[f].dtype == y[f].dtype and np.array_equal(x[f], y[f]), f
        n = len(y["kmers"])
    assert (n == 0) == ("$" in s), n


def test_suffix_chunks_partition_the_kmers(runs):
    """The one-letter chunks of a build hold each k-mer with that last node
    character once (here A; the others through the JAX files above)."""
    tmp = runs["tmp"]
    with np.load(tmp / "p-A-canonical-k11.A.chunk.npz") as z:
        kmers = z["kmers"]
    assert len(kmers) and (kmers[:, 9] == 1).all()
    assert len(np.unique(kmers, axis=0)) == len(kmers)


@pytest.mark.parametrize("mode", ("basic", "canonical"))
def test_protein_suffix_matches_jax(runs, mode):
    """Protein: the basic chunk as JAX writes it; canonical mode fails in
    both packages, the alphabet having no complement."""
    want, got = runs["jax"][("protein", mode)], runs["port"][("protein", mode)]
    if mode == "canonical":
        assert got[:3] == want[:3] and want[1] == 1 \
            and want[2].startswith("ValueError"), (got, want)
        return
    assert got[:3] == want[:3] == ["", 0, None]
    assert _chunk_lines(got[3]) == _chunk_lines(want[3]) != []
    tmp = runs["tmp"]
    with np.load(tmp / "j-protein-basic.DE.chunk.npz") as x, \
            np.load(tmp / "p-protein-basic.DE.chunk.npz") as y:
        for f in x.files:
            assert x[f].dtype == y[f].dtype and np.array_equal(x[f], y[f]), f
