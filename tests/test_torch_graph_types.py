"""Graphs that are not succinct, and the mmap layout, on the port.

The JAX CLI builds hash, hashfast, hashstr, bitmap and sshash graphs
(``build --graph``) in basic, canonical and primary mode at k = 11, 31 and
41, Protein hash and bitmap graphs (through the JAX classes' ``build``
and ``save``: ``build --graph`` makes DNA graphs only), and succinct
graphs in the mmap layout (``build --mmap``), and annotates each in
tmp_path.  The port must give the JAX graphs' node ids
(``node_kmers_and_ids``: the same k-mers and ids in the same order) and
print the JAX ``query --device`` stdout bytes and exit code for each
(``python -m metagraph_tpu_torch query --torch-device cpu``, the plain
versions of the map route's kernels, in one subprocess without JAX).
Exact everywhere.

The queries pass ``--min-kmers-fraction-label 0.3``: the JAX package
annotates a canonical-mode hash, bitmap or sshash graph by each k-mer's
forward id but queries the canonical strand's id, so about half of a
read's k-mers find its label, and at the default 0.7 every payload of a
canonical graph would be empty on both sides.
"""

import numpy as np
import pytest

from torch_parity import (jax_cli, references_and_reads, run_jax, run_port,
                          write_fasta)

DNA_TYPES = ("hash", "bitmap", "sshash")
GRAPH_MODES = ("basic", "canonical", "primary")
MODES = ("labels", "matches", "counts", "signature")

# (name, build arguments or None for the Protein API build, k, query modes)
CASES = [(f"{t}-{m}-k{k}", ("--graph", t, "--mode", m), k,
          MODES if k == 11 else ("labels", "signature"))
         for t in DNA_TYPES for m in GRAPH_MODES for k in (11, 31, 41)]
CASES += [(f"{t}-{m}-k11", ("--graph", t, "--mode", m), 11, ("labels",))
          for t in ("hashfast", "hashstr") for m in ("basic", "canonical")]
CASES += [(f"protein-{t}-k{k}", None, k, ("labels", "matches"))
          for t in ("hash", "bitmap") for k in (7, 11)]
# the mmap layout: built with --mmap, queried with and without --mmap; a
# graph with both layouts, queried both ways
MMAP = [("mmap-basic", ("--mmap",), ("--mmap",)),
        ("mmap-basic-noflag", ("--mmap",), ()),
        ("mmap-canonical", ("--mmap", "--mode", "canonical"), ("--mmap",)),
        ("mmap-both-layouts", ("both",), ("--mmap",)),
        ("mmap-both-layouts-noflag", ("both",), ())]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Every case's graph and annotation, the JAX CLI's query outputs, and
    the port's, run in one subprocess."""
    from metagraph_tpu.graph.hash_graph import DBGBitmapGraph, DBGHashGraph
    from metagraph_tpu.kmer.alphabets import PROTEIN
    tmp = tmp_path_factory.mktemp("graph_types")
    rng = np.random.default_rng(13)
    refs, reads = references_and_reads(rng)
    write_fasta(tmp / "refs.fa", [(f"ref{i}", s) for i, s in enumerate(refs)])
    write_fasta(tmp / "q.fa", [(f"q{i}", s) for i, s in enumerate(reads)])
    prefs, preads = references_and_reads(
        rng, letters="ACDEFGHIKLMNPQRSTVWY", complement=False)
    write_fasta(tmp / "prefs.fa",
                [(f"p{i}", s) for i, s in enumerate(prefs)])
    write_fasta(tmp / "pq.fa", [(f"pq{i}", s) for i, s in enumerate(preads)])
    lines, want, graphs = [], [], {}
    for name, build, k, modes in CASES:
        g, a = tmp / f"g_{name}", tmp / f"a_{name}"
        if build is None:
            cls = DBGHashGraph if "-hash-" in name else DBGBitmapGraph
            cls.build([s.encode() for s in prefs], k,
                      alphabet=PROTEIN).save(str(g))
            fa, q = tmp / "prefs.fa", tmp / "pq.fa"
        else:
            jax_cli("build", *build, "-k", k, "-o", g, tmp / "refs.fa")
            fa, q = tmp / "refs.fa", tmp / "q.fa"
        jax_cli("annotate", "-i", f"{g}.dbg", "--anno-header", "-o", a, fa)
        graphs[name] = f"{g}.dbg"
        for mode in modes:
            args = ["query", "--device", "-i", f"{g}.dbg", "-a",
                    f"{a}.column.annodbg", "--query-mode", mode,
                    "--min-kmers-fraction-label", "0.3", q]
            lines.append(args)
            want.append((name, mode, run_jax([str(x) for x in args])))
    for name, build, query in MMAP:
        g, a = tmp / f"g_{name}", tmp / f"a_{name}"
        if build == ("both",):
            jax_cli("build", "-k", 13, "-o", g, tmp / "refs.fa")
            jax_cli("build", "--mmap", "-k", 13, "-o", g, tmp / "refs.fa")
        else:
            jax_cli("build", *build, "-k", 13, "-o", g, tmp / "refs.fa")
        jax_cli("annotate", "-i", f"{g}.dbg", "--anno-header", "-o", a,
                tmp / "refs.fa")
        for mode in ("labels", "matches"):
            args = ["query", "--device", *query, "-i", f"{g}.dbg", "-a",
                    f"{a}.column.annodbg", "--query-mode", mode,
                    "--min-kmers-fraction-label", "0.3", tmp / "q.fa"]
            lines.append(args)
            want.append((name, mode, run_jax([str(x) for x in args])))
    got = run_port(tmp, lines)
    return tmp, graphs, {(n, m): (w, g)
                         for (n, m, w), g in zip(want, got)}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_node_kmers_and_ids_match_jax(built, name):
    """The port rebuilds each graph type's node ids as the JAX package
    does: the same k-mers and ids in the same order, and the same
    ``num_nodes`` and ``max_index``."""
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    _, graphs, _ = built
    want, got = JaxDBG.load(graphs[name]), DBGSuccinct.load(graphs[name])
    assert type(got).__name__ == type(want).__name__
    wc, wi = want.node_kmers_and_ids()
    gc, gi = got.node_kmers_and_ids()
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gc, wc)
    assert len(wi) > 100
    assert got.num_nodes() == want.num_nodes()
    assert got.max_index() == want.max_index()
    assert (got.k, got.mode, got.alphabet) \
        == (want.k, want.mode, want.alphabet.name)


@pytest.mark.parametrize("name,mode", [(c[0], m) for c in CASES
                                       for m in c[3]]
                         + [(c[0], m) for c in MMAP
                            for m in ("labels", "matches")])
def test_query_bytes_match_jax_cli(built, name, mode):
    """The port's query prints the JAX CLI's stdout bytes and exit code."""
    _, _, out = built
    want, got = out[(name, mode)]
    assert want[1] == 0 and want[2] is None, want
    assert got == want
    lines = [ln.split("\t") for ln in want[0].splitlines()]
    assert len(lines) >= 20
    assert sum(len(f) > 2 and f[2] != "" for f in lines) >= 5


def test_graph_classes_and_mmap_flag(built, tmp_path):
    """GRAPH_CLASSES names every type; where a graph has both layouts,
    ``mmap=True`` maps the mmap layout's arrays read-only and the npz gives
    the same arrays."""
    from metagraph_tpu_torch.graph import GRAPH_CLASSES, dbg_succinct
    from metagraph_tpu_torch.graph.hash_graph import (DBGBitmapGraph,
                                                      DBGHashGraph)
    from metagraph_tpu_torch.graph.sshash_graph import DBGSSHashGraph
    assert GRAPH_CLASSES["succinct"] is dbg_succinct.DBGSuccinct
    assert {k: v.__name__ for k, v in GRAPH_CLASSES.items()} == {
        "succinct": "DBGSuccinct", "bitmap": DBGBitmapGraph.__name__,
        "hash": DBGHashGraph.__name__, "hashfast": DBGHashGraph.__name__,
        "hashstr": DBGHashGraph.__name__, "sshash": DBGSSHashGraph.__name__}
    tmp, _, _ = built
    g = tmp / "g_mmap-both-layouts"
    base = dbg_succinct.DBGSuccinct.load(f"{g}.dbg", mmap=False)
    mm = dbg_succinct.DBGSuccinct.load(f"{g}.dbg", mmap=True)
    # mapped read-only (a view of the np.memmap), where the npz is read
    assert not mm.boss.W.flags.writeable and not mm.boss.valid.flags.writeable
    assert base.boss.W.flags.writeable
    for name in ("W", "last", "F", "valid"):
        np.testing.assert_array_equal(getattr(mm.boss, name),
                                      getattr(base.boss, name))
