"""The port's batch graph (``query/batch_graph.py``) against the JAX
package's: ``construct_batch_graph`` gives the same ``BatchGraphStats``
and a small graph with the same arrays, and ``hull_contigs`` the same
contigs, on basic and canonical graphs and a primary one seen through
``CanonicalDBG``, at k = 15 (the port builds the small graph on its
device route, D1-D4) and k = 31 (its general route, every sort through
D2), at several hull bounds; and ``QueryEngine.align_sequence`` (a read
aligned and respelled) the JAX engine's.  The port's kernels run their
plain versions on the CPU.
"""

import numpy as np
import pytest

from torch_parity import detour_references_and_reads, jax_cli, write_fasta

GRAPHS = [(mode, k) for mode in ("basic", "canonical", "primary")
          for k in (15, 31)]
# (max_hull_forks, max_hull_depth, max_nodes_per_seq_char)
BOUNDS = [(4, None, 5.0), (0, None, 5.0), (1, 8, 5.0), (4, None, 0.1)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batch_graph")
    rng = np.random.default_rng(67)
    refs, reads = detour_references_and_reads(rng, n_refs=3, length=500,
                                              n_reads=12)
    write_fasta(tmp / "refs.fa", [(f"ref{i}", s) for i, s in enumerate(refs)])
    for mode, k in GRAPHS:
        jax_cli("build", "--mode", mode, "-k", k, "-o", tmp / f"{mode}{k}",
                tmp / "refs.fa")
    jax_cli("annotate", "-i", tmp / "basic15.dbg", "--anno-header", "-o",
            tmp / "a", tmp / "refs.fa")
    return tmp, [r.encode() for r in reads]


@pytest.fixture(scope="module")
def engines(data):
    """(mode, k) -> (JAX QueryEngine, the port's), over the same graph."""
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.matrix import load_annotation as jax_anno
    from metagraph_tpu.graph.canonical import CanonicalDBG as JaxCanonical
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
    from metagraph_tpu.query.pipeline import QueryEngine as JaxEngine
    from metagraph_tpu_torch.annotation.matrix import load_annotation
    from metagraph_tpu_torch.convert import from_graph
    from metagraph_tpu_torch.graph.canonical import CanonicalDBG
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    tmp, _ = data
    anno = str(tmp / "a.column.annodbg")
    out = {}
    for mode, k in GRAPHS:
        path = str(tmp / f"{mode}{k}.dbg")
        jg, pg = JaxDBG.load(path), DBGSuccinct.load(path)
        # the annotation's rows need not match: only the graph is read
        index = from_graph(pg, load_annotation(anno))
        if mode == "primary":
            jg, pg = JaxCanonical(jg), CanonicalDBG(pg)
        out[mode, k] = (JaxEngine(AnnotatedDBG(jg, jax_anno(anno))),
                        QueryEngine(index, device="cpu", graph=pg))
    return out


def _arrays(g):
    b = g.boss
    return {"k": g.k, "mode": g.mode, "W": np.asarray(b.W),
            "last": np.asarray(b.last), "valid": np.asarray(b.valid)}


@pytest.mark.parametrize("bounds", BOUNDS, ids=lambda b: "-".join(map(str, b)))
@pytest.mark.parametrize("mode,k", GRAPHS, ids=lambda x: str(x))
def test_construct_batch_graph_matches_jax(data, engines, mode, k, bounds):
    from metagraph_tpu.query.batch_graph import \
        construct_batch_graph as jax_construct
    from metagraph_tpu_torch.graph.dbg_succinct import build_route
    from metagraph_tpu_torch.query.batch_graph import construct_batch_graph
    _, reads = data
    jax_engine, engine = engines[mode, k]
    forks, depth, per_char = bounds
    kw = dict(max_hull_forks=forks, max_hull_depth=depth,
              max_nodes_per_seq_char=per_char)
    want_g, want_st = jax_construct(jax_engine, reads, **kw)
    got_g, got_st = construct_batch_graph(engine, reads, **kw)
    assert (got_st is None) == (want_st is None)
    assert vars(got_st) == vars(want_st)
    assert want_st.num_query_kmers > 0 and want_st.num_matched_kmers > 0
    if forks and per_char >= 1:
        assert want_st.num_hull_contigs > 0
    elif not forks:
        assert want_st.num_hull_contigs == 0
    small_mode = "basic" if mode == "basic" else "canonical"
    assert build_route(k, small_mode) == ("device" if k <= 21
                                          else "general")
    want, got = _arrays(want_g), _arrays(got_g)
    assert got["k"] == want["k"] and got["mode"] == want["mode"] \
        == small_mode
    for name in ("W", "last", "valid"):
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name


@pytest.mark.parametrize("mode,k", GRAPHS, ids=lambda x: str(x))
def test_hull_contigs_match_jax(data, engines, mode, k):
    """The hull walk from every matched k-mer of the reads' first windows,
    through the JAX and the port's graph, with a batch set that cuts it."""
    from metagraph_tpu.query.batch_graph import hull_contigs as jax_hull
    from metagraph_tpu_torch.query.batch_graph import hull_contigs
    _, reads = data
    jax_engine, engine = engines[mode, k]
    ex = engine.graph.extractor
    starts, kmer_set = [], set()
    for r in reads[:8]:
        codes = ex.encode(r)
        if len(codes) < k + 40 or (codes[:k] >= ex.alphabet.sigma).any():
            continue
        node = int(engine.graph.map_to_nodes_sequentially(r[:k])[0])
        starts.append((codes[:k], node))
        kmer_set.add(codes[40: 40 + k].tobytes())
    assert starts
    for forks, depth in ((4, 60), (0, 60), (2, 5)):
        want = jax_hull(jax_engine.graph, starts, kmer_set, forks, depth)
        got = hull_contigs(engine.graph, starts, kmer_set, forks, depth)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode,k", [("basic", 31), ("primary", 15)],
                         ids=lambda x: str(x))
def test_align_sequence_matches_jax(data, engines, mode, k):
    """``QueryEngine.align_sequence`` (one read aligned and respelled, its
    ``Alignment``) against the JAX engine's, with the CLI's default
    config; a random read gives ``<len>S`` in both."""
    from dataclasses import asdict
    from metagraph_tpu.align.config import AlignerConfig as JaxConfig
    from metagraph_tpu_torch.align.config import AlignerConfig
    _, reads = data
    jax_engine, engine = engines[mode, k]
    jcfg, cfg = JaxConfig(), AlignerConfig()
    unaligned = 0
    for r in reads[-6:]:
        want_seq, want = jax_engine.align_sequence(r, jcfg)
        got_seq, got = engine.align_sequence(r, cfg)
        assert got_seq == want_seq and asdict(got) == asdict(want)
        unaligned += got.cigar == f"{len(r)}S"
    assert 0 < unaligned < 6
