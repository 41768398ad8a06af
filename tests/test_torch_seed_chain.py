"""The port's seed chaining (``align --align-chain``) against the JAX
package's align/seed_chainer.py.

``chain_seeds`` and ``iter_seed_chains`` (the JAX
``call_seed_chains_both_strands``'s chains) on seeded random anchors, and ``align_chained_seeds`` on coordinate annotations built by
the JAX CLI (mosaic references of shared blocks, k = 13): per read, and
every read's chain ends in the shared waves of one ``drive_batch`` (the
plain version of kernel B11 on the CPU), each equal to the JAX
function's alignments, whose chain ends extend through the per-read
column DP.
"""

import numpy as np
import pytest

from metagraph_tpu.align import seed_chainer as jsc
from metagraph_tpu.align.aligner import DBGAligner as JaxAligner
from metagraph_tpu.align.config import AlignerConfig as JaxConfig
from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG as JaxAG
from metagraph_tpu.annotation.column import ColumnMajorAnnotation as JaxCMA
from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu_torch.align import seed_chainer as tsc
from metagraph_tpu_torch.align import wave_extender
from metagraph_tpu_torch.align.aligner import DBGAligner
from metagraph_tpu_torch.align.batch import drive_batch
from metagraph_tpu_torch.align.config import AlignerConfig
from metagraph_tpu_torch.annotation.annotated_dbg import AnnotatedDBG
from metagraph_tpu_torch.annotation.matrix import load_annotation
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
from torch_parity import jax_cli, mosaic_references, reads_from, write_fasta

CONFIGS = {
    "default": {},
    "alternatives": dict(num_alternative_paths=3),
    "loose": dict(min_exact_match=0.3, min_seed_length=9),
    "few-seeds": dict(max_num_seeds_per_locus=1),
}


def anchors(rng, n, mod):
    out = []
    for i in range(n):
        start = int(rng.integers(0, 60))
        length = int(rng.integers(13, 25))
        out.append(mod.Anchor(int(rng.integers(0, 3)),
                              int(rng.integers(0, 200)), start,
                              start + length, length, i))
    return out


def as_tuples(anchors_):
    return [(a.label, a.coord, a.clipping, a.end, a.score, a.seed_i)
            for a in anchors_]


@pytest.mark.parametrize("seed", range(6))
def test_chain_seeds_equal_jax(seed):
    cfg, jcfg = AlignerConfig(), JaxConfig()
    a, b = anchors(np.random.default_rng(seed), 40, tsc), \
        anchors(np.random.default_rng(seed), 40, jsc)
    got, gbt = tsc.chain_seeds(cfg, 100, a)
    want, wbt = jsc.chain_seeds(jcfg, 100, b)
    assert as_tuples(got) == as_tuples(want) and gbt == wbt
    assert any(x != -1 for x in wbt)
    seeds = [(s.clipping, s.end - s.clipping, list(range(s.end - s.clipping
                                                         - 12)), 0)
             for s in sorted(a, key=lambda s: s.seed_i)]
    got = list(tsc.iter_seed_chains(
        b"", cfg, (anchors(np.random.default_rng(seed), 40, tsc), seeds),
        (anchors(np.random.default_rng(seed + 9), 30, tsc), seeds)))
    want = []
    jsc.call_seed_chains_both_strands(
        b"", b"", jcfg, (anchors(np.random.default_rng(seed), 40, jsc), seeds),
        (anchors(np.random.default_rng(seed + 9), 30, jsc), seeds),
        lambda *c: want.append(c))
    assert got == want and want


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """Mosaic references at k = 13 with a coordinate annotation labelled
    by header; reads cut from them."""
    tmp = tmp_path_factory.mktemp("seed_chain")
    rng = np.random.default_rng(11)
    refs = mosaic_references(rng, n_refs=14, n_blocks=10, per_ref=3)
    write_fasta(tmp / "r.fa", [(f"L{i}", s) for i, s in enumerate(refs)])
    jax_cli("build", "-k", "13", "-o", tmp / "g", tmp / "r.fa")
    jax_cli("annotate", "-i", tmp / "g.dbg", "--anno-header", "--coordinates",
            "-o", tmp / "a", tmp / "r.fa")
    jag = JaxAG(JaxDBG.load(str(tmp / "g.dbg")),
                JaxCMA.load(str(tmp / "a.column.annodbg")))
    tag = AnnotatedDBG(DBGSuccinct.load(str(tmp / "g.dbg")),
                       load_annotation(str(tmp / "a.column.annodbg")))
    reads = reads_from(rng, refs, 20, length=(60, 110))
    reads += [refs[0][10:70] + refs[1][30:90], refs[3][:40]]
    return jag, tag, [r.encode() for r in reads]


def fields(alns):
    return [(a.format_tsv(), [int(n) for n in a.nodes], list(a.label_columns))
            for a in alns]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_align_chained_seeds_equal_jax(deployment, config):
    jag, tag, reads = deployment
    jal = JaxAligner(jag.graph, JaxConfig(**CONFIGS[config]))
    tal = DBGAligner(tag.graph, AlignerConfig(**CONFIGS[config]),
                     device="cpu")
    want = [fields(jsc.align_chained_seeds(jal, jag, q)) for q in reads]
    assert sum(map(len, want)) >= len(reads) // 2
    one = [fields(tsc.align_chained_seeds(tal, tag, q)) for q in reads]
    assert one == want
    waves = wave_extender.STATS["waves"]
    batch = drive_batch([tsc.align_chained_seeds_gen(tal, tag, q)
                         for q in reads], "cpu",
                        max_window=max(len(q) for q in reads) + 1)
    assert [fields(a) for a in batch] == want
    # the chain ends extended in the engine's waves
    assert wave_extender.STATS["waves"] > waves
