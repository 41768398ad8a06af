"""The port's ``DBGAligner`` against the JAX package's, on the same graph
file and reads.

``align`` (one read, a batch of one) and ``align_batch`` (every read's
extension waves batched; both on the CPU through ``wave_dp_plain``) must give
the JAX aligner's alignments: nodes, spelled sequence, score, CIGAR,
orientation and offset, in the same order.  The graphs are built by the
JAX ``DBGSuccinct.build`` from seeded random references (DNA basic,
canonical and primary, DNA5, Protein and DNA_CASE); the reads are cut
from them with substitutions, indels and reverse complements, plus random
reads that hit nothing.  The configurations cover the UniMEM and suffix
seeders, the alternative alignments, edit distance, forward-only,
post-chaining and the complexity filter.  The JAX side runs its native
engine where its library builds, as its CLI does.
"""

import numpy as np
import pytest

from metagraph_tpu.align.aligner import DBGAligner as JaxAligner
from metagraph_tpu.align.config import AlignerConfig as JaxConfig
from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu.kmer import alphabets as jalph
from metagraph_tpu_torch.align import wave_extender
from metagraph_tpu_torch.align.aligner import DBGAligner
from metagraph_tpu_torch.align.config import AlignerConfig
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct as TorchDBG
from test_torch_canonical import native_lib

COMP = str.maketrans("ACGTacgt", "TGCAtgca")

# name -> (alphabet, letters, k, mode)
GRAPHS = {
    "dna": (jalph.DNA, "ACGT", 15, "basic"),
    "dna-canonical": (jalph.DNA, "ACGT", 13, "canonical"),
    "dna-primary": (jalph.DNA, "ACGT", 13, "primary"),
    "dna5": (jalph.DNA5, "ACGT", 12, "basic"),
    "protein": (jalph.PROTEIN, "ACDEFGHIKLMNPQRSTVWY", 8, "basic"),
    "dna-case": (jalph.DNA_CS, "ACGTacgt", 11, "basic"),
}

CONFIGS = {
    "default": {},
    "suffix-seeds": dict(min_seed_length=8),
    "alternatives": dict(num_alternative_paths=3),
    "edit-distance": dict(edit_distance=True),
    "forward-only": dict(forward_and_reverse_complement=False),
    "post-chain": dict(post_chain_alignments=True),
    "no-filter": dict(seed_complexity_filter=False, min_seed_length=9,
                      xdrop=15, gap_opening_penalty=-5),
}


def mutate(rng, s, letters, n_sub, indel):
    s = list(s)
    for p in rng.choice(len(s), n_sub, replace=False):
        s[p] = letters[(letters.index(s[p]) + 1) % len(letters)]
    if indel:
        p = int(rng.integers(10, len(s) - 10))
        s = s[:p] + s[p + indel:] if indel > 0 \
            else s[:p] + list(letters[:-indel]) + s[p:]
    return "".join(s)


def reads_of(rng, refs, letters, n, complement):
    out = []
    for i in range(n):
        r = refs[i % len(refs)]
        a = int(rng.integers(0, len(r) - 80))
        s = r[a: a + int(rng.integers(45, 80))]
        s = mutate(rng, s, letters, int(rng.integers(0, 3)),
                   int(rng.choice([0, 0, 2, -1])))
        if complement and i % 3 == 1:
            s = s[::-1].translate(COMP)
        out.append(s.encode())
    out.append("".join(rng.choice(list(letters), 60)).encode())
    out.append(refs[0][:6].encode())
    return out


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def setup(request, tmp_path_factory):
    assert native_lib() is not None, "the JAX native library does not load"
    alphabet, letters, k, mode = GRAPHS[request.param]
    rng = np.random.default_rng(sum(map(ord, request.param)))
    refs = ["".join(rng.choice(list(letters), int(rng.integers(300, 500))))
            for _ in range(4)]
    refs.append(refs[0][100:220] + refs[1][50:200])      # forks and joins
    g = JaxDBG.build(refs, k, mode=mode, alphabet=alphabet)
    path = tmp_path_factory.mktemp(request.param) / "g"
    g.save(str(path))
    t = TorchDBG.load(str(path) + ".dbg.npz")
    reads = reads_of(rng, refs, letters, 14, alphabet.name == "DNA")
    return dict(name=request.param, jax=g, port=t, reads=reads,
                protein=alphabet.name == "Protein")


def configs(kw, protein):
    return (JaxConfig(protein=protein, **kw),
            AlignerConfig(protein=protein, **kw))


def as_tuple(a):
    return (a.query, list(map(int, a.nodes)), a.sequence, int(a.score),
            a.cigar.to_string(), bool(a.orientation), int(a.offset))


def same(got, want):
    assert [[as_tuple(a) for a in r] for r in got] \
        == [[as_tuple(a) for a in r] for r in want]


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_align_batch_equals_jax(setup, cfg):
    jcfg, tcfg = configs(CONFIGS[cfg], setup["protein"])
    want = JaxAligner(setup["jax"], jcfg).align_batch(setup["reads"])
    before = dict(wave_extender.STATS)
    got = DBGAligner(setup["port"], tcfg, device="cpu") \
        .align_batch(setup["reads"])
    same(got, want)
    assert sum(len(r) for r in want) > 0
    assert wave_extender.STATS["waves"] > before["waves"]


@pytest.mark.parametrize("cfg", ("default", "suffix-seeds"))
def test_align_single_equals_jax(setup, cfg):
    jcfg, tcfg = configs(CONFIGS[cfg], setup["protein"])
    ja = JaxAligner(setup["jax"], jcfg)
    ta = DBGAligner(setup["port"], tcfg, device="cpu")
    reads = setup["reads"][::3]
    before = dict(wave_extender.STATS)
    same([ta.align(q) for q in reads], [ja.align(q) for q in reads])
    assert wave_extender.STATS["waves"] > before["waves"]


def test_config_is_copied(setup):
    """The aligner clamps a private copy of its config to k (and turns
    DNA_CASE forward-only), as the JAX aligner does."""
    jcfg, tcfg = configs({}, setup["protein"])
    ja = JaxAligner(setup["jax"], jcfg)
    ta = DBGAligner(setup["port"], tcfg, device="cpu")
    assert tcfg.min_seed_length == 19
    for f in ("min_seed_length", "forward_and_reverse_complement"):
        assert getattr(ta.config, f) == getattr(ja.config, f)
    assert ta.seeder_class.__name__ == ja.seeder_class.__name__
    assert np.array_equal(ta.config.score_matrix, ja.config.score_matrix)
