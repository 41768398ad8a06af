"""The port's ``build --graph`` against the JAX CLI's.

``--graph`` hash, hashfast, hashstr, bitmap and sshash, in the basic,
canonical and primary modes, at k = 11 and 31, and one ``--alphabet
Protein --graph hash`` build, which the JAX CLI makes a DNA graph of (its
``build_graph`` takes no alphabet).  Each case holds the written
``.dbg.npz`` (keys, dtypes, arrays), the stderr ``graph built:`` line and
the exit code to the JAX CLI's, and each package's load of the other's
file to the same k-mers and ids.  Then ``build_graph`` itself, on the
CPU, against the JAX factory on inputs with IUPAC codes, lower case and
short records.  The port runs with ``--torch-device cpu`` (the kernels'
plain versions) in one subprocess without JAX.
"""

import os

import numpy as np
import pytest

from metagraph_tpu.graph import build_graph as jax_build_graph
from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu_torch.graph import build_graph
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct

from torch_parity import graph_line, run_jax, run_port, write_fasta

TYPES = ("hash", "hashfast", "hashstr", "bitmap", "sshash")
MODES = ("basic", "canonical", "primary")
CASES = [(t, m, k) for t in TYPES for m in MODES for k in (11, 31)]


def _name(t, m, k):
    return f"{t}-{m}-k{k}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("build_graphs")
    rng = np.random.default_rng(18)
    recs = []
    for i in range(7):
        s = "".join(rng.choice(list("ACGT"), size=int(rng.integers(40, 400))))
        if i % 3 == 1:
            s = s[:20] + "N" * 4 + s[24:]
        recs.append((f"r{i}", s.lower() if i == 2 else s))
    recs += [("short", "ACGTAC"), ("repeat", recs[0][1][:45] * 3)]
    write_fasta(tmp / "in.fa", recs)
    write_fasta(tmp / "prot.fa", [(f"p{i}", "".join(rng.choice(
        list("ACDEFGHIKLMNPQRSTVWYT"), size=120))) for i in range(4)])
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        jax_out, lines = {}, []
        for c in CASES:
            t, m, k = c
            flags = ["-k", k, "--graph", t, "--mode", m]
            jax_out[c] = run_jax([str(a) for a in ["build", *flags, "-o",
                                  f"j-{_name(*c)}", "in.fa"]], stderr=True)
            lines.append(["build", *flags, "-o", f"p-{_name(*c)}", "in.fa"])
        prot = ["build", "-k", "5", "--alphabet", "Protein", "--graph",
                "hash"]
        jax_out["protein"] = run_jax(prot + ["-o", "j-protein", "prot.fa"],
                                     stderr=True)
        lines.append(prot + ["-o", "p-protein", "prot.fa"])
        got = run_port(tmp, lines, stderr=True)
    finally:
        os.chdir(cwd)
    return dict(tmp=tmp, jax=jax_out, port=dict(zip(CASES + ["protein"],
                                                    got)))


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files) == sorted(
            ["graph_type", "k", "mode", "kmers", "ids", "alphabet"])
        for f in x.files:
            assert x[f].dtype == y[f].dtype and x[f].shape == y[f].shape \
                and np.array_equal(x[f], y[f]), f
        return {f: x[f] for f in x.files}


@pytest.mark.parametrize("case", CASES, ids=[_name(*c) for c in CASES])
def test_graph_build_matches_jax(runs, case):
    want, got = runs["jax"][case], runs["port"][case]
    assert got[:3] == want[:3] == ["", 0, None], (got, want)
    assert graph_line(got[3]) == graph_line(want[3]) != []
    tmp, name = runs["tmp"], _name(*case)
    z = _same_npz(tmp / f"j-{name}.dbg.npz", tmp / f"p-{name}.dbg.npz")
    assert str(z["graph_type"]) == ("sshash" if case[0] == "sshash" else
                                    "bitmap" if case[0] == "bitmap"
                                    else "hash")
    assert str(z["mode"]) == case[1] and len(z["ids"]) > 50
    # each package reads the other's file: the same k-mers and ids
    for path in (f"j-{name}.dbg", f"p-{name}.dbg"):
        g = DBGSuccinct.load(str(tmp / path))
        ref = JaxDBG.load(str(tmp / path))
        pc, pi = g.node_kmers_and_ids()
        jc, ji = ref.node_kmers_and_ids()
        assert np.array_equal(pc, jc) and np.array_equal(pi, ji)
        assert g.num_nodes() == ref.num_nodes()


def test_protein_input_builds_a_dna_graph(runs):
    """``--alphabet Protein --graph hash``: the JAX CLI's ``build_graph``
    gets no alphabet, so both packages write a DNA graph of the windows
    made of A, C, G and T."""
    want, got = runs["jax"]["protein"], runs["port"]["protein"]
    assert got[:3] == want[:3] == ["", 0, None]
    assert graph_line(got[3]) == graph_line(want[3]) != []
    z = _same_npz(runs["tmp"] / "j-protein.dbg.npz",
                  runs["tmp"] / "p-protein.dbg.npz")
    assert str(z["alphabet"]) == "DNA"


@pytest.mark.parametrize("rep", TYPES)
@pytest.mark.parametrize("mode", MODES)
def test_build_graph_matches_jax_factory(rep, mode):
    """``build_graph`` on the CPU against the JAX factory: IUPAC codes, U,
    lower case, records shorter than k and an empty one."""
    rng = np.random.default_rng(181)
    seqs = ["".join(rng.choice(list("ACGTNacgtRYU"), size=int(n))).encode()
            for n in rng.integers(0, 200, 12)] + [b"", b"ACG"]
    for k in (5, 11):
        want = jax_build_graph(rep, seqs, k, mode=mode)
        got = build_graph(rep, seqs, k, mode=mode, device="cpu")
        wc, wi = want.node_kmers_and_ids()
        gc, gi = got.node_kmers_and_ids()
        assert gc.dtype == wc.dtype and gi.dtype == wi.dtype
        assert np.array_equal(gc, wc) and np.array_equal(gi, wi)
        assert got.num_nodes() == want.num_nodes() > 0


def test_sshash_below_its_minimizer_length_fails_as_jax():
    """At k = 3 the JAX sshash build's minimizers are 4 long: numpy's
    argmin over no window raises, in both packages."""
    with pytest.raises(ValueError) as want:
        jax_build_graph("sshash", [b"ACGTAC"], 3)
    with pytest.raises(ValueError) as got:
        build_graph("sshash", [b"ACGTAC"], 3, device="cpu")
    assert str(got.value) == str(want.value)
