"""The walks, mapping and traversal the port's aligner runs on a graph,
against the JAX package's on the same graph file.

Each graph is built by the JAX ``DBGSuccinct.build`` from seeded random
references, saved, and loaded by the port: basic DNA (masked, unmasked and
with a suffix-range index), canonical and primary DNA, DNA5, Protein and
DNA_CASE.  The BOSS walks (``succ_last``, ``pred_last``, ``fwd``, ``bwd``,
``pick_edge``, their scalar forms, ``_next_W``/``_prev_W``), the node
lookups (``index_batch``, ``index_range_batch``, ``index_range_host``,
``map_to_edges_batch``, ``map_sequence``) and the graph's mapping,
traversal and suffix matching must give the JAX answers exactly.
"""

import numpy as np
import pytest

from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu.kmer import alphabets as jalph
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct as TorchDBG

# name -> (alphabet, letters of the references, k, mode, mask_dummy,
# suffix-range index L)
GRAPHS = {
    "dna-basic": (jalph.DNA, "ACGT", 11, "basic", True, 0),
    "dna-unmasked": (jalph.DNA, "ACGT", 11, "basic", False, 0),
    "dna-ranges": (jalph.DNA, "ACGT", 13, "basic", True, 3),
    "dna-canonical": (jalph.DNA, "ACGT", 9, "canonical", True, 0),
    "dna-primary": (jalph.DNA, "ACGT", 9, "primary", True, 0),
    "dna5": (jalph.DNA5, "ACGTN", 8, "basic", True, 0),
    "protein": (jalph.PROTEIN, "ACDEFGHIKLMNPQRSTVWY", 6, "basic", True, 2),
    "dna-case": (jalph.DNA_CS, "ACGTacgt", 7, "basic", True, 0),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request, tmp_path_factory):
    alphabet, letters, k, mode, masked, L = GRAPHS[request.param]
    rng = np.random.default_rng(len(request.param))
    refs = ["".join(rng.choice(list(letters), int(rng.integers(60, 220))))
            for _ in range(6)]
    # repeats, so that nodes fork and join
    refs.append(refs[0][20:90] + refs[1][:60] + refs[0][40:100])
    g = JaxDBG.build(refs, k, mode=mode, alphabet=alphabet,
                     mask_dummy=masked)
    if L:
        g.boss.index_suffix_ranges(L)
    path = tmp_path_factory.mktemp(request.param) / "g"
    g.save(str(path))
    t = TorchDBG.load(str(path) + ".dbg.npz")
    assert t.masked == g.masked and t.mode == g.mode
    queries = [r[5: 5 + int(rng.integers(k - 2, 90))] for r in refs]
    queries += ["".join(rng.choice(list(letters), 70)) for _ in range(3)]
    queries += [refs[2][:40] + "$#" + refs[2][40:80], ""]
    return dict(jax=g, port=t, refs=refs, queries=queries, rng=rng,
                letters=letters)


def edges(g):
    return np.arange(1, len(g.boss.W), dtype=np.int64)


def test_boss_walks(graphs):
    jb, tb = graphs["jax"].boss, graphs["port"].boss
    e = edges(graphs["jax"])
    for name in ("succ_last", "pred_last", "fwd", "bwd", "node_last_char"):
        assert np.array_equal(getattr(jb, name)(e), getattr(tb, name)(e)), \
            name
    for c in range(jb.alph_size):
        cc = np.full(len(e), c)
        assert np.array_equal(jb.pick_edge(e, cc), tb.pick_edge(e, cc))
    for i in e.tolist():
        assert jb.bwd_scalar(i) == tb.bwd_scalar(i)
        assert jb.fwd_scalar(i) == tb.fwd_scalar(i)
        assert jb.succ_last_scalar(i) == tb.succ_last_scalar(i)
        assert jb.pred_last_scalar(i) == tb.pred_last_scalar(i)
        assert jb.node_last_char_scalar(i) == tb.node_last_char_scalar(i)
        for c in range(2 * jb.alph_size):
            assert jb._next_W(i, c) == tb._next_W(i, c)
            assert jb._prev_W(i, c) == tb._prev_W(i, c)
        for c in range(1, jb.alph_size):
            assert jb.pick_edge_scalar(i, c) == tb.pick_edge_scalar(i, c)


def test_boss_lookups(graphs):
    g, t = graphs["jax"], graphs["port"]
    jb, tb = g.boss, t.boss
    ex = g.extractor
    e = edges(g)
    kchars = jb.get_edge_seq(e)
    rng = graphs["rng"]
    # edge strings with a tenth of their codes changed, some to $ or to
    # the invalid code
    noise = kchars.copy()
    hit = rng.random(noise.shape) < 0.1
    noise[hit] = rng.integers(0, jb.alph_size + 1, int(hit.sum()))
    for rows in (kchars, noise):
        assert np.array_equal(jb.index_batch(rows[:, :-1]),
                              tb.index_batch(rows[:, :-1]))
        assert np.array_equal(jb.map_to_edges_batch(rows),
                              tb.map_to_edges_batch(rows))
    for q in graphs["queries"]:
        codes = ex.encode(q)
        assert np.array_equal(jb.map_sequence(codes), tb.map_sequence(codes))
        if not len(codes):
            continue
        starts = np.arange(len(codes), dtype=np.int64)
        lens = np.minimum(jb.k, len(codes) - starts)
        for a, b in zip(jb.index_range_batch(codes, starts, lens),
                        tb.index_range_batch(codes, starts, lens)):
            assert np.array_equal(a, b)
        for s in range(0, len(codes), 7):
            assert jb.index_range_host(codes[s: s + jb.k - 1]) \
                == tb.index_range_host(codes[s: s + jb.k - 1])


def test_mapping(graphs):
    g, t = graphs["jax"], graphs["port"]
    qs = [q.encode() for q in graphs["queries"]]
    for q in qs:
        assert np.array_equal(g.map_to_nodes_sequentially(q),
                              t.map_to_nodes_sequentially(q))
        assert np.array_equal(g.map_to_nodes(q), t.map_to_nodes(q))
    for a, b in zip(g.map_to_nodes_sequentially_batch(qs),
                    t.map_to_nodes_sequentially_batch(qs)):
        assert np.array_equal(a, b)
    chars = g.boss.get_edge_seq(edges(g))
    assert np.array_equal(g.map_kmers_batch(chars), t.map_kmers_batch(chars))


def test_traversal(graphs):
    g, t = graphs["jax"], graphs["port"]
    e = edges(g)
    for i in e.tolist():
        assert g.call_outgoing_kmers(i) == t.call_outgoing_kmers(i)
        assert g.call_incoming_kmers(i) == t.call_incoming_kmers(i)
        assert g.has_multiple_outgoing(i) == t.has_multiple_outgoing(i)
        assert g.has_single_incoming(i) == t.has_single_incoming(i)
        for c in graphs["letters"][:4]:
            assert g.traverse(i, c) == t.traverse(i, c)
    for a, b in zip(g.call_outgoing_batch(e), t.call_outgoing_batch(e)):
        assert np.array_equal(a, b)
    assert np.array_equal(g.has_multiple_outgoing_batch(e),
                          t.has_multiple_outgoing_batch(e))
    assert np.array_equal(g.has_single_incoming_batch(e),
                          t.has_single_incoming_batch(e))


def test_suffix_matching(graphs):
    g, t = graphs["jax"], graphs["port"]
    k = g.k
    for q in graphs["queries"]:
        qb = q.encode()
        for L in (3, k - 3, k - 1, k):
            for s in range(0, max(len(qb) - L + 1, 0), 5):
                for cap in (2 ** 63, 3):
                    assert g.call_nodes_with_suffix_matching_longest_prefix(
                        qb[s: s + L], L, cap) \
                        == t.call_nodes_with_suffix_matching_longest_prefix(
                            qb[s: s + L], L, cap)
    e = edges(g)
    rng = graphs["rng"]
    # ranges as the seeders give them: a node's last edge to another's
    n = int(g.boss.rank_last(np.array([len(g.boss.W) - 1]))[0])
    r1 = rng.integers(1, n + 1, 60)
    r2 = np.minimum(r1 + rng.integers(0, 40, 60), n)
    first, last = g.boss.select_last(r1), g.boss.select_last(r2)
    for cap in (2 ** 63, 5, 1):
        assert g.nodes_in_suffix_ranges_batch(first, last, cap) \
            == t.nodes_in_suffix_ranges_batch(first, last, cap)
        for f, l in zip(first[:20].tolist(), last[:20].tolist()):
            assert g.nodes_in_suffix_range(f, l, cap) \
                == t.nodes_in_suffix_range(f, l, cap)
    for i in e[::3].tolist():
        assert g.get_node_sequence(i) == t.get_node_sequence(i)
