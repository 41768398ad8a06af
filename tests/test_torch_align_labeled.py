"""The port's labeled alignment against the JAX package's.

``AnnotationBuffer`` (label words against the JAX class's Python-int
masks), the label pruning inside the port's flat engine (``LabeledAligner``
on the CPU, every read of a batch in shared waves through the plain
version of kernel B11) against the JAX ``LabeledAligner.align``, whose
``LabeledExtender`` prunes inside the per-read column DP, and
``format_labeled_alignments_tsv``: alignments, label columns and
coordinates equal.  The graphs and annotations are built by the JAX
package from seeded random references: the two diverging references of
metagraph_tpu's own label tests, and mosaics of shared blocks with 70
labels (two words of label bits), so that extensions branch into blocks of
other labels and are pruned there, with and without coordinates (a
primary graph's through ``CanonicalDBG``); a seed with a dummy node.
"""

import numpy as np
import pytest

from metagraph_tpu.align import labeled as jlab
from metagraph_tpu.align.aligner import LabeledAligner as JaxLabeledAligner
from metagraph_tpu.align.aligner import (
    format_labeled_alignments_tsv as jax_format)
from metagraph_tpu.align.alignment import seed_to_alignment as jax_seed
from metagraph_tpu.align.config import AlignerConfig as JaxConfig
from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG as JaxAG
from metagraph_tpu.annotation.column import ColumnMajorAnnotation as JaxCMA
from metagraph_tpu.graph.canonical import CanonicalDBG as JaxCanonical
from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu_torch.align import labeled, wave_extender
from metagraph_tpu_torch.align.aligner import (DBGAligner, LabeledAligner,
                                               format_labeled_alignments_tsv)
from metagraph_tpu_torch.align.alignment import seed_to_alignment
from metagraph_tpu_torch.align.batch import drive_batch
from metagraph_tpu_torch.align.config import AlignerConfig
from metagraph_tpu_torch.annotation.annotated_dbg import AnnotatedDBG
from metagraph_tpu_torch.annotation.column import LabelEncoder
from metagraph_tpu_torch.annotation.matrix import load_annotation
from metagraph_tpu_torch.graph.canonical import CanonicalDBG
from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
from torch_parity import jax_cli, mosaic_references, reads_from, write_fasta

CONFIGS = {
    "default": {},
    "suffix-seeds": dict(min_seed_length=8),
    "alternatives": dict(num_alternative_paths=3),
    "post-chain": dict(post_chain_alignments=True),
    "forward-only": dict(forward_and_reverse_complement=False),
    "xdrop": dict(xdrop=12, rel_score_cutoff=0.8),
}


def diverging():
    """metagraph_tpu's label tests (tests/test_align.py:143-160): two
    references share a prefix path, then diverge."""
    rng = np.random.default_rng(0)
    a, shared = ("".join(rng.choice(list("ACGT"), size=n)) for n in (40, 30))
    b1, b2 = ("".join(rng.choice(list("ACGT"), size=60)) for _ in range(2))
    return [a + shared + b1, a + shared + b2], 11


def build(tmp, name, refs, k, coords=False, primary=False):
    """The JAX graph and annotation (one label a reference, by header),
    saved; a primary graph seen through ``CanonicalDBG``; -> (JAX
    AnnotatedDBG, the port's)."""
    write_fasta(tmp / f"{name}.fa", [(f"L{i}", s) for i, s in enumerate(refs)])
    mode = ["--mode", "primary"] if primary else []
    jax_cli("build", "-k", k, *mode, "-o", tmp / name, tmp / f"{name}.fa")
    flags = ["--coordinates"] if coords else []
    jax_cli("annotate", "-i", tmp / f"{name}.dbg", "--anno-header", *flags,
            "-o", tmp / f"{name}_a", tmp / f"{name}.fa")
    g = JaxDBG.load(str(tmp / f"{name}.dbg"))
    anno = JaxCMA.load(str(tmp / f"{name}_a.column.annodbg"))
    tg = DBGSuccinct.load(str(tmp / f"{name}.dbg"))
    ta = load_annotation(str(tmp / f"{name}_a.column.annodbg"))
    if primary:
        g, tg = JaxCanonical(g), CanonicalDBG(tg)
    return JaxAG(g, anno), AnnotatedDBG(tg, ta)


@pytest.fixture(scope="module")
def deployments(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("align_labeled")
    out = {}
    refs, k = diverging()
    rng = np.random.default_rng(3)
    comp = str.maketrans("ACGT", "TGCA")
    reads = [refs[0][40:120], refs[0][20:80], refs[1][10:110],
             refs[0][30:120][::-1].translate(comp)]
    out["diverging"] = (*build(tmp, "div", refs, k), reads)
    refs = mosaic_references(rng, mutate=0.004)
    reads = reads_from(rng, refs, 24)
    reads += [refs[0][30:100] + refs[1][20:80], "".join(
        rng.choice(list("ACGT"), 60)), refs[2][:6]]
    out["mosaic"] = (*build(tmp, "mos", refs, 13), reads)
    refs = mosaic_references(np.random.default_rng(4), n_refs=12,
                             n_blocks=8, per_ref=3)
    reads = reads_from(np.random.default_rng(5), refs, 18)
    out["mosaic-coords"] = (*build(tmp, "crd", refs, 13, coords=True), reads)
    # the reverse strand's nodes sit above the wrapper's offset, their
    # coordinates decreasing along the path
    out["primary-coords"] = (*build(tmp, "prim", refs, 13, coords=True,
                                    primary=True), reads)
    return out


def fields(alns):
    return [(a.format_tsv(), [int(n) for n in a.nodes], list(a.label_columns),
             [list(c) for c in a.label_coordinates]) for a in alns]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dep", ("diverging", "mosaic", "mosaic-coords",
                                 "primary-coords"))
def test_labeled_alignments_equal_jax(deployments, dep, config):
    jag, tag, reads = deployments[dep]
    kw = CONFIGS[config]
    jal = JaxLabeledAligner(jag, JaxConfig(**kw))
    tal = LabeledAligner(tag, AlignerConfig(**kw), device="cpu")
    queries = [r.encode() for r in reads]
    want = [jal.align(q) for q in queries]
    got = tal.align_batch(queries)
    assert [fields(a) for a in got] == [fields(a) for a in want]
    assert sum(map(len, want)) >= len(reads) // 2
    enc = LabelEncoder(tag.annotator.labels)
    cth_k = tag.graph.k
    for q, g_, w in zip(queries, got, want):
        assert format_labeled_alignments_tsv(
            "r", q, g_, enc, 7, k=cth_k) == jax_format(
            "r", q, w, jag.annotator.encoder, 7, k=cth_k)


def test_pruning_drops_children(deployments):
    """The mosaic's reads branch into blocks of other labels: the engine
    drops those children, and the labeled alignments differ from the
    unlabeled ones of the same reads."""
    _jag, tag, reads = deployments["mosaic"]
    queries = [r.encode() for r in reads]
    before = wave_extender.STATS["pruned"]
    got = LabeledAligner(tag, AlignerConfig(), device="cpu").align_batch(
        queries)
    assert wave_extender.STATS["pruned"] > before
    plain = DBGAligner(tag.graph, AlignerConfig(), device="cpu").align_batch(
        queries)
    assert [[a.format_tsv() for a in x] for x in got] \
        != [[a.format_tsv() for a in x] for x in plain]


def test_label_cases_of_the_jax_tests(deployments):
    """tests/test_align.py:162-200 on the port: the labels of a path past
    the divergence, of the shared prefix, and never an empty label set."""
    _jag, tag, reads = deployments["diverging"]
    al = LabeledAligner(tag, device="cpu")
    names = tag.annotator.labels
    a = al.align(reads[0].encode())
    assert [names[c] for c in a[0].label_columns] == ["L0"]
    refs, _k = diverging()
    a = al.align(refs[0][20:70].encode())
    assert sorted(names[c] for c in a[0].label_columns) == ["L0", "L1"]
    for a in al.align_batch([r.encode() for r in reads]):
        for x in a:
            assert x.label_columns and al.buffer.path_words(x.nodes).any()


def as_mask(words) -> int:
    return int.from_bytes(words.astype("<u8").tobytes(), "little")


def test_annotation_buffer_equals_jax(deployments):
    """The label words of nodes and of paths against the JAX buffer's
    Python-int masks, two words of labels."""
    jag, tag, _reads = deployments["mosaic"]
    jb, tb = jlab.AnnotationBuffer(jag), labeled.AnnotationBuffer(tag)
    assert tb.n_words == 2
    rng = np.random.default_rng(7)
    n = tag.graph.max_index()
    for _ in range(4):
        nodes = [int(x) for x in rng.integers(0, n + 1, 40)] + [0, 0]
        assert [as_mask(w) for w in tb.node_words(nodes)] \
            == jb.get_labels_masks(nodes)
        path = nodes[:3]
        assert as_mask(tb.path_words(path)) == jb.intersect_path(path)
        assert tb.columns_of_path(path) \
            == jlab.mask_to_columns(jb.intersect_path(path))
    assert as_mask(tb.path_words([0, 0])) == jb.intersect_path([0, 0]) == 0
    assert labeled.words_to_columns(np.array([5, 1 << 5], np.uint64)) \
        == jlab.mask_to_columns((1 << 69) | 5)


@pytest.mark.parametrize("ffs", (True, False), ids=("fixed", "free"))
def test_dummy_node_in_seed(deployments, ffs):
    """A seed whose path holds a dummy node (0): its child passes the
    parent's labels, as in the JAX extender; the whole extension equal."""
    jag, tag, reads = deployments["mosaic"]
    g = tag.graph
    q, nodes = next((q, nodes) for q, nodes in (
        (r.encode(), [int(x) for x in g.map_to_nodes_sequentially(
            r[:30].encode())]) for r in reads) if all(nodes))
    nodes[len(nodes) // 2] = 0
    jseed = jax_seed(q, 0, 30, nodes, False, 0, JaxConfig())
    tseed = seed_to_alignment(q, 0, 30, nodes, False, 0, AlignerConfig())
    jb = jlab.AnnotationBuffer(jag)
    want = jlab.LabeledExtender(jag.graph, JaxConfig(), q, jb) \
        .get_extensions(jseed, 0, ffs)
    ext = labeled.LabeledExtender(g, AlignerConfig(), q,
                                  labeled.AnnotationBuffer(tag))
    gen = DBGAligner._get_extensions_gen(ext, tseed, 0, ffs)
    got = drive_batch([gen], "cpu", max_window=len(q) + 1)[0]
    assert fields(got) == fields(want) and want
