"""The graph API of the port's hash, bitmap and sshash graphs against the
JAX graphs built from the same sequences.

The JAX package builds each graph (``build_graph``: hash, hashfast,
hashstr, bitmap and sshash; DNA in basic and canonical mode, and in
primary mode seen through ``CanonicalDBG``; k = 3, 15, 31 and 33, the
sshash graph from k = 15 as its minimizers need; Protein hash and bitmap
graphs at k = 7) from seeded random references and saves it; the port
loads the file (``DBGSuccinct.load``, node ids rebuilt as the JAX load
rebuilds them) and runs its lookups on the CPU (``use_device("cpu")``,
kernel A's plain version).  Node by node: the outgoing and incoming
lists, ``traverse`` for every character, the degrees and junction tests,
``get_node_sequence``; read by read: ``map_to_nodes_sequentially`` and
``map_to_nodes`` on forward, reverse-complemented, mutated, lower-case,
N-broken, short and empty reads; and each batch form
(``map_to_nodes_sequentially_batch``, ``map_to_nodes_batch``,
``map_kmers_batch``, ``call_outgoing_batch``,
``has_multiple_outgoing_batch``, ``has_single_incoming_batch``) against
the per-item JAX calls it stands for (``call_outgoing_batch`` against
the JAX flat engine's per-node loop, ``_outgoing_batch``).  An empty
graph and a node outside the graph are checked too.  Exact everywhere.
"""

import numpy as np
import pytest

from torch_parity import references_and_reads

DNA_CASES = [(t, m, k) for t in ("hash", "bitmap", "sshash")
             for m in ("basic", "canonical", "primary")
             for k in (3, 15, 31, 33) if not (t == "sshash" and k == 3)]
DNA_CASES += [(t, m, 15) for t in ("hashfast", "hashstr")
              for m in ("basic", "canonical", "primary")]
CASES = [(f"{t}-{m}-k{k}", t, m, k, "DNA") for t, m, k in DNA_CASES]
CASES += [(f"protein-{t}-k7", t, "basic", 7, "Protein")
          for t in ("hash", "bitmap")]
IDS = [c[0] for c in CASES]

PROTEIN_LETTERS = "ACDEFGHIKLMNPQRSTVWY"


def _reads(rng, alphabet):
    letters = "ACGT" if alphabet == "DNA" else PROTEIN_LETTERS
    refs, reads = references_and_reads(
        rng, n_refs=3, length=(150, 220), letters=letters,
        complement=alphabet == "DNA")
    reads = [r.encode() for r in reads]
    reads.append(reads[0].lower())
    return [r.encode() for r in refs], reads


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name -> (JAX graph, the port's graph, reads), built on first use."""
    tmp = tmp_path_factory.mktemp("hash_traversal")
    cache = {}

    def get(name, gtype, mode, k, alphabet):
        if name in cache:
            return cache[name]
        from metagraph_tpu.graph import build_graph
        from metagraph_tpu.graph.canonical import CanonicalDBG as JaxCanon
        from metagraph_tpu.kmer.alphabets import ALPHABETS
        from metagraph_tpu_torch.graph.canonical import CanonicalDBG
        from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
        rng = np.random.default_rng(k * 7 + len(name))
        refs, reads = _reads(rng, alphabet)
        jg = build_graph(gtype, refs, k, mode=mode,
                         alphabet=ALPHABETS[alphabet])
        jg.save(str(tmp / name))
        pg = DBGSuccinct.load(str(tmp / f"{name}.dbg")).use_device("cpu")
        assert type(pg).__name__ == type(jg).__name__
        if mode == "primary":
            jg, pg = JaxCanon(jg), CanonicalDBG(pg)
        cache[name] = (jg, pg, reads)
        return cache[name]
    return get


def _nodes(g, limit=120):
    """Node ids to check one by one: the first ``limit`` and the last
    (through ``CanonicalDBG``, the last reverse-complement id)."""
    n = g.max_index()
    return list(range(1, min(n, limit) + 1)) + ([n] if n > limit else [])


@pytest.mark.parametrize("name,gtype,mode,k,alphabet", CASES, ids=IDS)
def test_node_api_equals_jax(graphs, name, gtype, mode, k, alphabet):
    jg, pg, _ = graphs(name, gtype, mode, k, alphabet)
    assert pg.k == jg.k and pg.max_index() == jg.max_index()
    letters = "ACGTN" if alphabet == "DNA" else PROTEIN_LETTERS + "X"
    nodes = _nodes(jg)
    assert len(nodes) > 1
    for n in nodes:
        assert pg.get_node_sequence(n) == jg.get_node_sequence(n), n
        out = jg.call_outgoing_kmers(n)
        assert pg.call_outgoing_kmers(n) == out, n
        assert pg.call_incoming_kmers(n) == jg.call_incoming_kmers(n), n
        assert pg.has_multiple_outgoing(n) == jg.has_multiple_outgoing(n)
        assert pg.has_single_incoming(n) == jg.has_single_incoming(n)
        if mode == "primary":
            continue        # the canonical wrapper has no traverse or degree
        assert pg.outdegree(n) == jg.outdegree(n) == len(out)
        assert pg.indegree(n) == jg.indegree(n)
        for ch in letters:
            assert pg.traverse(n, ch) == jg.traverse(n, ch), (n, ch)


@pytest.mark.parametrize("name,gtype,mode,k,alphabet", CASES, ids=IDS)
def test_mapping_equals_jax(graphs, name, gtype, mode, k, alphabet):
    jg, pg, reads = graphs(name, gtype, mode, k, alphabet)
    hits = 0
    for r in reads:
        want = jg.map_to_nodes_sequentially(r)
        got = pg.map_to_nodes_sequentially(r)
        assert got.dtype == np.int64 and np.array_equal(got, want), r
        hits += int((want > 0).sum())
        if mode != "primary":
            assert np.array_equal(pg.map_to_nodes(r), jg.map_to_nodes(r))
            assert np.array_equal(pg.map_to_nodes(r.decode()),
                                  jg.map_to_nodes(r.decode()))
    assert hits > 0
    batch = pg.map_to_nodes_sequentially_batch(reads)
    assert len(batch) == len(reads)
    for r, got in zip(reads, batch):
        assert np.array_equal(got, jg.map_to_nodes_sequentially(r))
    if mode != "primary":
        for r, got in zip(reads, pg.map_to_nodes_batch(reads)):
            assert np.array_equal(got, jg.map_to_nodes(r))
    short = reads[0][: k - 1]
    assert len(pg.map_to_nodes_sequentially(short)) == 0
    assert pg.map_to_nodes_sequentially_batch([]) == []


@pytest.mark.parametrize("name,gtype,mode,k,alphabet", CASES, ids=IDS)
def test_batch_forms_equal_jax(graphs, name, gtype, mode, k, alphabet):
    from metagraph_tpu.align.flat import _outgoing_batch
    jg, pg, _ = graphs(name, gtype, mode, k, alphabet)
    nodes = np.arange(1, jg.max_index() + 1, dtype=np.int64)
    if mode == "primary":
        nodes = nodes[::7]              # through CanonicalDBG: both strands
    want = _outgoing_batch(jg, nodes)
    got = pg.call_outgoing_batch(nodes)
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)
    assert len(got[0]) > 0
    nodes = nodes[::-1].copy()
    assert np.array_equal(pg.has_multiple_outgoing_batch(nodes),
                          [jg.has_multiple_outgoing(int(n)) for n in nodes])
    assert np.array_equal(pg.has_single_incoming_batch(nodes),
                          [jg.has_single_incoming(int(n)) for n in nodes])
    e = np.zeros(0, dtype=np.int64)
    assert all(len(x) == 0 for x in pg.call_outgoing_batch(e))
    assert len(pg.has_single_incoming_batch(e)) == 0
    if mode == "primary":
        return
    # k-mers of the graph, k-mers one code away and rows with code 0 or a
    # code past the alphabet: the JAX id of each, as its mapping of the
    # decoded k-mer gives it (and its _kmer_id where the codes are real)
    rng = np.random.default_rng(k)
    sigma = pg.alph.sigma
    chars = pg.node_kmers_and_ids()[0]
    rows = np.concatenate([chars[::3], chars[1::5], rng.integers(
        1, sigma, (40, k))]).astype(np.uint8)
    rows[len(chars[::3]):, k // 2] = rng.integers(1, sigma,
                                                  len(rows) - len(chars[::3]))
    rows[-5:, 0] = 0
    rows[-10:-5, -1] = sigma
    got = pg.map_kmers_batch(rows)
    dec = jg.alphabet.decode_table
    want = [int(jg.map_to_nodes_sequentially(dec[r].tobytes())[0])
            for r in rows]
    assert np.array_equal(got, want) and (got > 0).sum() >= len(chars[::3])
    real = (rows > 0).all(axis=1) & (rows < sigma).all(axis=1)
    assert np.array_equal(got[real], [jg._kmer_id(r) for r in rows[real]])


@pytest.mark.parametrize("gtype", ("hash", "bitmap", "sshash"))
def test_empty_graph_and_unknown_node(gtype, tmp_path):
    from metagraph_tpu.graph import build_graph
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    jg = build_graph(gtype, [b"ACG"], 15, mode="basic")
    jg.save(str(tmp_path / "e"))
    pg = DBGSuccinct.load(str(tmp_path / "e.dbg")).use_device("cpu")
    assert pg.num_nodes() == jg.num_nodes() == 0
    read = b"ACGTACGTACGTACGTACGT"
    assert np.array_equal(pg.map_to_nodes(read), jg.map_to_nodes(read))
    assert np.array_equal(pg.map_to_nodes_sequentially(read), np.zeros(6))
    assert len(pg.map_kmers_batch(np.ones((3, 15), np.uint8))) == 3
    assert all(len(x) == 0 for x in pg.call_outgoing_batch([]))
    with pytest.raises(IndexError):
        pg.call_outgoing_kmers(1)
    if gtype != "sshash":
        return
    # an sshash node id that is no node: JAX's id search finds no row
    jg = build_graph(gtype, [b"ACGTTGCAACGTAGGCTAGCA"], 15, mode="basic")
    jg.save(str(tmp_path / "s"))
    g = DBGSuccinct.load(str(tmp_path / "s.dbg")).use_device("cpu")
    for node in (0, jg.max_index() + 1):
        with pytest.raises(IndexError):
            jg.call_outgoing_kmers(node)
        with pytest.raises(IndexError):
            g.call_outgoing_kmers(node)
