"""The port's annotation builder, bit vector writers and annotate methods
against the JAX package's.

* ``ColumnBuilder`` against the JAX ``ColumnMajorAnnotation`` on seeded
  random sequences of ``add_labels``, ``add_label_counts`` and
  ``add_label_coords`` calls (with and without a disk swap whose cap is
  small enough to spill many chunks): the frozen rows, values and
  coordinates, their dtypes and shapes, equal; both codecs' npz members
  equal, and the port's loader reads the port's files back; ``sum_rows``.
* The bit vector writers: each kind's ``to_dict`` array for array equal
  to the JAX dict, on vectors of several lengths and densities, the
  chosen kind of ``bit_vector_smallest`` equal, the port's reader giving
  the set positions back.
* ``AnnotatedDBG``'s annotate methods and their batch form (every record
  of a batch mapped in one ``map_to_nodes_batch``, kernel A's plain
  version here) against the JAX ``AnnotatedDBG`` record at a time, on
  succinct graphs of every mode (a primary one through ``CanonicalDBG``,
  as both CLIs wrap it), masked and not, DNA, DNA5, DNA_CASE and Protein,
  k = 2, 31 and 63, and on hash, bitmap and sshash graphs; records shorter
  than k, with N runs, lower case and empty.  Exact everywhere.
"""

import numpy as np
import pytest

from torch_parity import jax_cli, write_fasta

CPU = "cpu"


def _frozen_equal(j, f):
    """A frozen JAX ``ColumnMajorAnnotation`` and a port one hold the same
    labels, rows, values and coordinates."""
    assert j.encoder.labels == f.labels
    for c in range(j.num_labels):
        for a, b in ((j._rows[c], f._rows[c]), (j._values[c], f._values[c]),
                     (j._coords[c], f._coords[c])):
            assert a.dtype == b.dtype and a.shape == b.shape \
                and np.array_equal(a, b), c


def _random_build(rng, R, j, p, steps=80, most=40):
    for _ in range(steps):
        labels = [f"L{int(x)}" for x in rng.integers(0, 9, size=int(
            rng.integers(1, 3)))]
        rows = rng.integers(0, R, size=int(rng.integers(0, most)))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            j.add_labels(rows, labels)
            p.add_labels(rows, labels)
        elif kind == 1:
            c = rng.integers(1, 9, size=len(rows))
            j.add_label_counts(rows, c, labels)
            p.add_label_counts(rows, c, labels)
        else:
            c = rng.integers(0, 5000, size=len(rows))
            j.add_label_coords(rows, c, labels)
            p.add_label_coords(rows, c, labels)


@pytest.mark.parametrize("swap", (False, True))
@pytest.mark.parametrize("seed", range(3))
def test_builder_matches_jax(tmp_path, seed, swap):
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu_torch.annotation.column import ColumnBuilder
    rng = np.random.default_rng(seed)
    R = int(rng.integers(50, 3000))
    j, p = ColumnMajorAnnotation(R), ColumnBuilder(R, CPU)
    if swap:
        j.enable_disk_swap(str(tmp_path), 1000)
        p.enable_disk_swap(str(tmp_path), 1000)
    _random_build(rng, R, j, p, *((200, 400) if swap else ()))
    if swap:
        assert len(p._spills) == len(j._spills) > 2
    j.freeze()
    f = p.freeze()
    _frozen_equal(j, f)
    assert p.freeze() is f
    # no spill directory is left behind
    assert not list(tmp_path.glob("mg_annoswap_*"))


@pytest.mark.parametrize("codec", ("sorted", "smallest"))
def test_save_members_match_jax(tmp_path, codec):
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu_torch.annotation.column import (
        ColumnBuilder, ColumnMajorAnnotation as PortColumns)
    rng = np.random.default_rng(11)
    R = 4000
    j, p = ColumnMajorAnnotation(R), ColumnBuilder(R, CPU)
    _random_build(rng, R, j, p)
    # columns dense enough for stat and rrr, sparse ones for sd
    for lab, n in (("dense", 3500), ("half", 1800), ("sparse", 12)):
        rows = rng.choice(R, n, replace=False)
        j.add_labels(rows, [lab])
        p.add_labels(rows, [lab])
    j.save(str(tmp_path / "j"), codec=codec)
    p.save(str(tmp_path / "p"), codec=codec)
    za = np.load(tmp_path / "j.npz", allow_pickle=True)
    zb = np.load(tmp_path / "p.npz", allow_pickle=True)
    assert za.files == zb.files
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape \
            and np.array_equal(za[k], zb[k]), k
    back = PortColumns.load(str(tmp_path / "p.npz"))
    j.freeze()
    _frozen_equal(j, back)
    if codec == "smallest":
        assert set(back.column_codecs) == {"sd", "stat", "rrr"}


def test_sum_rows_matches_jax():
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu_torch.annotation.column import ColumnBuilder
    rng = np.random.default_rng(4)
    j, p = ColumnMajorAnnotation(300), ColumnBuilder(300, CPU)
    _random_build(rng, 300, j, p)
    f = p.freeze()
    rc = [(int(r), int(m)) for r, m in zip(rng.integers(0, 300, 50),
                                           rng.integers(1, 4, 50))]
    for mc in (1, 5, 30):
        assert j.sum_rows(rc, mc) == f.sum_rows(rc, mc)
    assert f.sum_rows([], 1) == j.sum_rows([], 1) == []


@pytest.mark.parametrize("n", (0, 1, 15, 64, 1000, 5001))
@pytest.mark.parametrize("density", (0.0, 0.002, 0.2, 0.5, 1.0))
def test_bitvector_dicts_match_jax(n, density):
    from metagraph_tpu.succinct import bitvector as J
    from metagraph_tpu_torch.succinct import bitvector as P
    rng = np.random.default_rng(n + int(density * 100))
    bits = rng.random(n) < density
    pos = np.flatnonzero(bits)
    pairs = [(J.BitVectorStat(bits.astype(np.uint8)),
              P.BitVectorStat.from_bits(bits)),
             (J.BitVectorRRR(bits), P.BitVectorRRR.from_bits(bits))]
    if n:
        pairs.append((J.BitVectorSD(positions=pos, n=n),
                      P.BitVectorSD.from_positions(pos, n)))
    pairs.append((J.bit_vector_smallest(positions=pos, n=n),
                  P.bit_vector_smallest(positions=pos, n=n)))
    for a, b in pairs:
        da, db = a.to_dict(), b.to_dict()
        assert da.keys() == db.keys()
        for k in da:
            x, y = np.asarray(da[k]), np.asarray(db[k])
            assert x.dtype == y.dtype and x.shape == y.shape \
                and np.array_equal(x, y), (a.kind, k)
        back = P.bitvector_from_dict(db)
        assert back.num_set_bits == len(pos)
        got = back.select1(np.arange(len(pos))) if len(pos) else pos
        assert np.array_equal(got, pos)


# (alphabet, letters, mode, k, masked) of the succinct graphs
GRAPHS = [("DNA", "ACGT", "basic", 2, True),
          ("DNA", "ACGT", "basic", 31, True),
          ("DNA", "ACGT", "basic", 31, False),
          ("DNA", "ACGT", "canonical", 31, True),
          ("DNA", "ACGT", "primary", 31, True),
          ("DNA", "ACGT", "basic", 63, True),
          ("DNA", "ACGT", "canonical", 63, False),
          ("DNA5", "ACGTN", "basic", 31, True),
          ("DNA5", "ACGTN", "canonical", 2, True),
          ("DNA_CASE", "ACGTacgt", "basic", 31, True),
          ("DNA_CASE", "ACGTacgt", "primary", 31, True),
          ("Protein", "ACDEFGHIKLMNPQRSTVWY", "basic", 2, True),
          ("Protein", "ACDEFGHIKLMNPQRSTVWY", "basic", 31, True),
          ("Protein", "ACDEFGHIKLMNPQRSTVWY", "basic", 63, True)]


def _records(rng, letters, k, n=6):
    refs = ["".join(rng.choice(list(letters), size=int(rng.integers(
        k + 20, k + 160)))) for _ in range(n)]
    recs = refs + [refs[0][5: 5 + k + 30], refs[1][: max(k - 1, 1)], "",
                   refs[2][:40] + "N" * 6 + refs[2][46:],
                   refs[3].lower(), refs[4] + refs[4][: k + 3]]
    return refs, [r.encode() for r in recs]


def _annotate_both(jg, pg, base_rows, recs, seed):
    """The JAX AnnotatedDBG record at a time and the port's batch form,
    with coordinates and counts: -> (JAX frozen annotation, port's)."""
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG as JA
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu_torch.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu_torch.annotation.column import ColumnBuilder
    rng = np.random.default_rng(seed)
    labels = [[f"lab{int(x)}"] for x in rng.integers(0, 4, len(recs))]
    starts = [int(x) for x in rng.integers(0, 1000, len(recs))]
    abund = [int(x) for x in rng.integers(1, 5, len(recs))]
    ja = JA(jg, ColumnMajorAnnotation(base_rows))
    for rec, lab, st, ab in zip(recs, labels, starts, abund):
        ja.annotate_kmer_coords(rec, lab, st)
        ja.annotate_kmer_counts(rec, lab, abundance=ab)
    pa = AnnotatedDBG(pg, ColumnBuilder(base_rows, CPU))
    pa.annotate_batch(recs, labels, starts=starts, abundances=abund)
    ja.annotator.freeze()
    # the single-record forms give the same rows
    pb = AnnotatedDBG(pg, ColumnBuilder(base_rows, CPU))
    jb = JA(jg, ColumnMajorAnnotation(base_rows))
    for rec, lab in zip(recs, labels):
        pb.annotate_sequence(rec, lab)
        jb.annotate_sequence(rec, lab)
    jb.annotator.freeze()
    _frozen_equal(jb.annotator, pb.annotator.freeze())
    return ja.annotator, pa.annotator.freeze()


@pytest.mark.parametrize("alphabet,letters,mode,k,masked", GRAPHS)
def test_annotate_methods_match_jax(tmp_path, alphabet, letters, mode, k,
                                    masked):
    from metagraph_tpu.graph.canonical import CanonicalDBG as JC
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JG
    from metagraph_tpu.kmer.alphabets import ALPHABETS
    from metagraph_tpu_torch.graph.canonical import CanonicalDBG
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    rng = np.random.default_rng(k * 7 + len(letters) + masked)
    refs, recs = _records(rng, letters, k)
    g = JG.build([r.encode() for r in refs], k=k, mode=mode,
                 alphabet=ALPHABETS[alphabet], mask_dummy=masked)
    g.save(str(tmp_path / "g"))
    p = DBGSuccinct.load(str(tmp_path / "g.dbg.npz")).use_device(CPU)
    base_rows = g.max_index()
    jg, pg = (JC(g), CanonicalDBG(p)) if mode == "primary" else (g, p)
    j, f = _annotate_both(jg, pg, base_rows, recs, k)
    _frozen_equal(j, f)
    assert sum(len(r) for r in f._rows) > 0


@pytest.mark.parametrize("gtype,mode", [("bitmap", "basic"),
                                        ("hash", "canonical"),
                                        ("hash", "primary"),
                                        ("sshash", "basic"),
                                        ("sshash", "canonical")])
def test_annotate_other_graphs_match_jax(tmp_path, gtype, mode):
    from metagraph_tpu.graph.canonical import CanonicalDBG as JC
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JG
    from metagraph_tpu_torch.graph.canonical import CanonicalDBG
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    rng = np.random.default_rng(len(gtype) + len(mode))
    refs, recs = _records(rng, "ACGT", 15)
    write_fasta(tmp_path / "r.fa", [(f"r{i}", s) for i, s in
                                    enumerate(refs)])
    jax_cli("build", "--graph", gtype, "--mode", mode, "-k", 15, "-o",
            tmp_path / "g", tmp_path / "r.fa")
    g = JG.load(str(tmp_path / "g.dbg"))
    p = DBGSuccinct.load(str(tmp_path / "g.dbg")).use_device(CPU)
    base_rows = g.max_index()
    jg, pg = (JC(g), CanonicalDBG(p)) if mode == "primary" else (g, p)
    j, f = _annotate_both(jg, pg, base_rows, recs, 3)
    _frozen_equal(j, f)
    assert sum(len(r) for r in f._rows) > 0
