"""The port's ``build`` against the JAX CLI's ``build --device`` and plain
``build``.

For K = 3, 11, 16, 17, 20 and 21, in every ``--state``, with and without
``--mmap`` and ``--mask-dummy``: the written files (npz keys, dtypes and
arrays; the mmap layout's ``.meta.npz`` and ``.npy`` files), the stderr
``graph built:`` line and the exit code, and each package's
``DBGSuccinct.load`` of the other's file.  Then the error contract (a
missing input, alone and with each flag of ``FLAGS``; those flags with a
present input, which the port builds as the JAX CLI does, or refuses
naming its ROADMAP item, or answers with the JAX CLI's own error), a KMC
input, and the port's ``query`` on a graph it built, with a JAX-built
annotation, against the JAX ``query --device``.  The port runs with
``--torch-device cpu`` (the kernels' plain versions) in one subprocess
without JAX.
"""

import os

import numpy as np
import pytest

from metagraph_tpu.graph import dbg_succinct as jax_dbg
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct

from test_torch_canonical import native_lib
from test_torch_kmc import write_db
from torch_parity import (graph_line, jax_cli, run_jax, run_port,
                          same_build_files, write_fasta)

KS = (3, 11, 16, 17, 20, 21)
STATES = ("stat", "small", "fast", "dynamic")
VARIANTS = [(k, state, mmap, mask) for k in KS for state in STATES
            for mmap in (False, True) for mask in (False, True)]
PLAIN = [(k, "stat", False, mask) for k in KS for mask in (False, True)]

# flags checked after a missing input, each with what the port does with
# a present input: "built" (the JAX CLI's files, ``OUTPUTS``), the ROADMAP
# item it names in its refusal, or None (the JAX CLI's own error, which
# the port prints too); the flags of the host construction are parity
# cases in tests/test_torch_build_host_cli.py, those of A12.3 in
# tests/test_torch_build_{graphs,suffix}.py,
# tests/test_torch_index_ranges.py and tests/test_torch_kmc.py
REFUSED = {"suffix": (["--suffix", "A"], "built"),
           "graph_hash": (["--graph", "hash"], "built"),
           "index_ranges": (["--index-ranges", "3"], "built"),
           "mesh_shards": (["--mesh-shards", "2"], "A15"),
           "protein_canonical": (["--alphabet", "Protein", "--mode",
                                  "canonical"], None)}
OUTPUTS = {"suffix": ".A.chunk.npz", "graph_hash": ".dbg.npz",
           "index_ranges": ".dbg.npz"}


def _name(k, state, mmap, mask):
    return f"k{k}-{state}" + ("-mmap" if mmap else "") \
        + ("-mask" if mask else "")


def _flags(k, state, mmap, mask):
    return ["-k", k, "--state", state] + (["--mmap"] if mmap else []) \
        + (["--mask-dummy"] if mask else [])


def _inputs(rng, tmp):
    recs = []
    for i in range(8):
        s = "".join(rng.choice(list("ACGT"), size=int(rng.integers(150, 600))))
        if i % 3 == 1:
            a = int(rng.integers(20, 120))
            s = s[:a] + "N" * int(rng.integers(1, 30)) + s[a + 30:]
        if i == 4:
            s = s.lower()
        recs.append((f"r{i}", s))
    recs.append(("short", "ACG"))
    recs.append(("repeat", recs[0][1][:60] * 4))
    write_fasta(tmp / "in.fa", recs)
    return recs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert native_lib() is not None, "the JAX native library does not load"
    tmp = tmp_path_factory.mktemp("build_cli")
    os.makedirs(tmp / "swap", exist_ok=True)
    recs = _inputs(np.random.default_rng(14), tmp)
    cwd = os.getcwd()
    os.chdir(tmp)               # the CLIs write relative to it (--disk-swap)
    try:
        jax_out, lines, keys = {}, [], []
        for v in VARIANTS:
            args = ["build", "--device", *_flags(*v), "-o",
                    f"j-{_name(*v)}", "in.fa"]
            jax_out[("device",) + v] = run_jax([str(a) for a in args],
                                               stderr=True)
            jax_dbg.DEFAULT_MMAP = False        # --mmap sets it for good
            lines.append(["build", "--device", *_flags(*v), "-o",
                          f"p-{_name(*v)}", "in.fa"])
            keys.append(("device",) + v)
        for v in PLAIN:
            args = ["build", *_flags(*v), "-o", f"h-{_name(*v)}", "in.fa"]
            jax_out[("plain",) + v] = run_jax([str(a) for a in args],
                                              stderr=True)
            lines.append(["build", *_flags(*v), "-o",
                          f"q-{_name(*v)}", "in.fa"])
            keys.append(("plain",) + v)
        for name, (flags, _) in REFUSED.items():
            for inp in ("missing.fa", "in.fa"):
                line = ["build", "-k", "11", *flags, inp]
                lines.append(line[:1] + ["-o", f"y-{name}"] + line[1:])
                keys.append(("refused", name, inp))
                if name == "mesh_shards" and inp == "in.fa":
                    continue                     # the port's refusal only
                jax_out[("refused", name, inp)] = run_jax(
                    line[:1] + ["-o", f"x-{name}"] + line[1:], stderr=True)
        lines.append(["build", "-k", "11", "-o", "x-missing", "missing.fa"])
        keys.append(("missing",))
        jax_out[("missing",)] = run_jax(lines[-1], stderr=True)
        # one 12-mer, ACGTACGTACGA
        write_db("db", np.array([[0, 1, 2, 3] * 2 + [0, 1, 2, 0]], np.uint8),
                 np.array([3], np.uint64), 3, 4, 1)
        lines.append(["build", "-k", "11", "-o", "y-kmc", "db.kmc_suf"])
        keys.append(("kmc",))
        jax_out[("kmc",)] = run_jax(["build", "-k", "11", "-o", "x-kmc",
                                     "db.kmc_suf"], stderr=True)
        # the port's query on its own graph, with the JAX annotation
        jax_cli("annotate", "-i", "j-k11-stat.dbg", "--anno-header", "-o",
                "anno", "in.fa")
        write_fasta(tmp / "q.fa", [(f"q{i}", s[5:90]) for i, (_, s)
                                   in enumerate(recs) if len(s) > 100])
        query = ["-a", "anno.column.annodbg", "--device", "q.fa"]
        jax_out[("query",)] = run_jax(["query", "-i", "j-k11-stat.dbg",
                                       *query], stderr=True)
        lines.append(["query", "-i", "p-k11-stat.dbg", *query])
        keys.append(("query",))
        got = run_port(tmp, lines, stderr=True)
    finally:
        os.chdir(cwd)
        jax_dbg.DEFAULT_MMAP = False
    return dict(tmp=tmp, jax=jax_out, port=dict(zip(keys, got)))


def _same_files(tmp, a, b, mmap_layout):
    if mmap_layout:                  # no counts: no weights file
        assert not os.path.exists(tmp / f"{a}.dbg.weights.npy")
        assert not os.path.exists(tmp / f"{b}.dbg.weights.npy")
    same_build_files(tmp, a, b, mmap_layout)


@pytest.mark.parametrize("v", VARIANTS, ids=[_name(*v) for v in VARIANTS])
def test_build_matches_jax_device_build(runs, v):
    k, state, mmap, mask = v
    tmp = runs["tmp"]
    want, got = runs["jax"][("device",) + v], runs["port"][("device",) + v]
    assert got[1] == want[1] == 0 and got[2] is None and want[2] is None
    assert graph_line(got[3]) == graph_line(want[3]) != []
    assert got[0] == want[0]
    name = _name(*v)
    layout = mmap or state == "fast"
    _same_files(tmp, f"p-{name}", f"j-{name}", layout)
    # each package reads the other's file
    for path, cls in ((f"p-{name}.dbg", jax_dbg.DBGSuccinct),
                      (f"j-{name}.dbg", DBGSuccinct)):
        g = cls.load(str(tmp / path), mmap=layout)
        ref = jax_dbg.DBGSuccinct.load(str(tmp / f"j-{name}.dbg"),
                                       mmap=layout)
        for f in ("W", "last", "valid", "F"):
            assert np.array_equal(getattr(g.boss, f), getattr(ref.boss, f))
        assert g.boss.state == state and g.masked == mask
        assert g.num_nodes() == ref.num_nodes() and g.k == k


@pytest.mark.parametrize("v", PLAIN, ids=[_name(*v) for v in PLAIN])
def test_build_matches_jax_plain_build(runs, v):
    want, got = runs["jax"][("plain",) + v], runs["port"][("plain",) + v]
    assert got[1] == want[1] == 0
    assert graph_line(got[3]) == graph_line(want[3]) != []
    _same_files(runs["tmp"], f"q-{_name(*v)}", f"h-{_name(*v)}", False)


def test_missing_input(runs):
    want, got = runs["jax"][("missing",)], runs["port"][("missing",)]
    assert got[:3] == want[:3] == ["", 1, None]
    assert got[3].strip() == want[3].strip() \
        == "[error] File not found: missing.fa"


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_come_after_the_inputs(runs, name):
    """A missing input is reported first, as the JAX CLI reports it; a
    present one is built as the JAX CLI builds it (the same stderr lines,
    files, keys, dtypes and arrays), refused naming the ROADMAP item
    (--mesh-shards), or gets the JAX CLI's own error."""
    item = REFUSED[name][1]
    want = runs["jax"][("refused", name, "missing.fa")]
    got = runs["port"][("refused", name, "missing.fa")]
    assert got[:3] == want[:3] == ["", 1, None]
    assert "[error] File not found: missing.fa" in got[3]
    got = runs["port"][("refused", name, "in.fa")]
    if item is None:
        want = runs["jax"][("refused", name, "in.fa")]
        assert got[:3] == want[:3] and str(got[1]).startswith("[error]")
        return
    if item == "built":
        want = runs["jax"][("refused", name, "in.fa")]
        assert got[:3] == want[:3] == ["", 0, None], (got, want)
        last = [ln for ln in want[3].splitlines()
                if ln.startswith(("graph built", "chunk"))]
        assert last and last == [ln for ln in got[3].splitlines()
                                 if ln.startswith(("graph built", "chunk"))]
        tmp, ext = runs["tmp"], OUTPUTS[name]
        x, y = np.load(tmp / f"x-{name}{ext}"), np.load(tmp / f"y-{name}{ext}")
        assert sorted(x.files) == sorted(y.files)
        for f in x.files:
            assert x[f].dtype == y[f].dtype and np.array_equal(x[f], y[f]), f
        return
    assert got[1] == 1 and got[2].startswith("NotImplementedError") \
        and f"ROADMAP {item}" in got[2], got
    assert not os.path.exists(runs["tmp"] / f"y-{name}.dbg.npz")


def test_kmc_input_refused(runs):
    """The JAX CLI fails on a KMC database input (its pre-pass imports a
    KMCReader that seq_io/kmc.py does not define); the port builds it as
    the JAX ``DBGSuccinct.build`` builds ``read_kmers``' k-mers, k taken
    from the database with the JAX warning (tests/test_torch_kmc.py holds
    the arrays)."""
    got, want = runs["port"][("kmc",)], runs["jax"][("kmc",)]
    assert want[1] == 1 and want[2].startswith("ImportError") \
        and "KMCReader" in want[2], want
    assert got[:3] == ["", 0, None], got
    assert got[3].splitlines()[0] == "warning: using k=12 from KMC database"
    want = jax_dbg.DBGSuccinct.build([b"ACGTACGTACGA"], 12, mask_dummy=False)
    assert graph_line(got[3]) == [f"graph built: k=12 nodes="
                                  f"{want.num_nodes()}"]


def test_query_on_a_port_built_graph(runs):
    want, got = runs["jax"][("query",)], runs["port"][("query",)]
    assert got[1] == want[1] == 0 and got[2] is None
    assert got[0] == want[0] and want[0].count("\n") >= 5
