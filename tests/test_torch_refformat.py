"""The reference formats and the "smallest" column codec on the port.

The JAX CLI writes the inputs in tmp_path: basic and canonical k = 11
graphs, with and without ``--count-kmers``, and their reference-format
``.dbg`` (``transform --to-ref-format``); column annotations and their
reference-format ``.column.annodbg`` (``transform_anno --to-ref-format``);
``annotate --anno-codec smallest`` annotations, on references whose
labels cover few, about half and nearly all rows, so that every kind of
bit vector (sd, stat, rrr) is chosen.  A ``.weights`` sidecar (a bare
sdsl int_vector, written with the JAX writer's helpers) sits beside one
reference graph, one of the wrong length beside another.

The port's loaders must give the JAX loaders' rows, labels, values, BOSS
arrays and weights, and the port's ``query --torch-device cpu`` the JAX
``query --device`` stdout bytes and exit code, in the labels, matches,
counts and signature modes.  The sdsl readers' other branches (the sd and
stat bit vectors, the LE-v2.0 label encoder, long labels) are held on
bytes written here with the same helpers.  Exact everywhere.
"""

import struct

import numpy as np
import pytest

from torch_parity import (jax_cli, references_and_reads, run_jax, run_port,
                          write_fasta)

MODES = ("labels", "matches", "counts", "signature")
# (name, graph, annotation) of the query cases
QUERIES = [("refanno", "gs.dbg", "aref.column.annodbg"),
           ("refanno-canonical", "gc.dbg", "acref.column.annodbg"),
           ("smallest", "gs.dbg", "asm.column.annodbg"),
           ("smallest-counts", "gs.dbg", "asmv.column.annodbg"),
           ("refgraph", "gref.dbg", "as.column.annodbg"),
           ("refgraph-canonical", "gcref.dbg", "ac.column.annodbg"),
           ("refgraph-counts", "grefn.dbg", "av.column.annodbg"),
           ("refgraph-canonical-counts", "gcrefn.dbg", "acv.column.annodbg"),
           ("refgraph-refanno", "gref.dbg", "aref.column.annodbg"),
           ("refgraph-bad-state", "gbad.dbg", "as.column.annodbg")]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu.seq_io.refwrite import Writer, write_int_vector
    tmp = tmp_path_factory.mktemp("refformat")
    rng = np.random.default_rng(5)
    refs, reads = references_and_reads(rng, n_refs=8, length=(150, 300))
    recs = [(f"ref{i}", s) for i, s in enumerate(refs)]
    recs += [("half", "N".join(refs[:4])), ("all", "N".join(refs))]
    write_fasta(tmp / "refs.fa", recs)
    write_fasta(tmp / "q.fa", [(f"q{i}", s) for i, s in enumerate(reads)])
    fa = tmp / "refs.fa"
    for g, extra in (("gs", ()), ("gc", ("--mode", "canonical")),
                     ("gsn", ("--count-kmers",)),
                     ("gcn", ("--mode", "canonical", "--count-kmers"))):
        jax_cli("build", *extra, "-k", 11, "-o", tmp / g, fa)
    for a, g, extra in (("as", "gs", ()), ("ac", "gc", ()),
                        ("av", "gsn", ("--count-kmers",)),
                        ("acv", "gcn", ("--count-kmers",)),
                        ("asm", "gs", ("--anno-codec", "smallest")),
                        ("asmv", "gs", ("--anno-codec", "smallest",
                                        "--count-kmers"))):
        jax_cli("annotate", "-i", tmp / f"{g}.dbg", "--anno-header", *extra,
                "-o", tmp / a, fa)
    jax_cli("transform_anno", "--to-ref-format", "-o", tmp / "aref",
            tmp / "as.column.annodbg")
    jax_cli("transform_anno", "--to-ref-format", "-o", tmp / "acref",
            tmp / "ac.column.annodbg")
    for src, out in (("gs", "gref"), ("gc", "gcref"), ("gsn", "grefn"),
                     ("gcn", "gcrefn")):
        jax_cli("transform", "--to-ref-format", "-o", tmp / out,
                tmp / f"{src}.dbg")
    # node weights beside a reference graph: max_index + 1 values, index 0
    # npos; one of the wrong length beside another
    for src, out, cut in (("gsn", "grefn", 0), ("gcn", "gcrefn", 1)):
        w = DBGSuccinct.load(str(tmp / f"{src}.dbg")).boss.weights
        w = np.asarray(w, dtype=np.uint64)[: len(w) - cut]
        wr = Writer()
        write_int_vector(wr, w, max(int(w.max()).bit_length(), 1))
        (tmp / f"{out}.dbg.weights").write_bytes(bytes(wr.buf))
    # a reference graph in another state than SMALL
    data = bytearray((tmp / "gref.dbg").read_bytes())
    nF = struct.unpack_from(">Q", data, 0)[0]
    struct.pack_into(">Q", data, 8 * (nF + 2), 2)
    (tmp / "gbad.dbg").write_bytes(bytes(data))
    return tmp


@pytest.mark.parametrize("name", ("aref", "acref", "asm", "asmv"))
def test_column_loaders_match_jax(files, name):
    """A reference-format or "smallest"-codec annotation loads into the
    JAX loader's rows, labels and values; the smallest annotations use
    every kind of bit vector."""
    from metagraph_tpu.annotation.matrix import load_annotation as jax_load
    from metagraph_tpu_torch.annotation.matrix import load_annotation
    path = str(files / f"{name}.column.annodbg")
    want, got = jax_load(path), load_annotation(path)
    assert got.labels == want.encoder.labels
    assert got.num_rows == want.num_rows
    assert (got.has_values, got.has_coords) \
        == (want.has_values, want.has_coords)
    rows = np.arange(want.num_rows)
    for c in range(want.num_labels):
        np.testing.assert_array_equal(got.column_rows(c),
                                      want.column_rows(c))
        assert len(want.column_rows(c))
        if want.has_values:
            np.testing.assert_array_equal(
                got.values_of(want.column_rows(c), c),
                [v for r in want.get_row_values(want.column_rows(c))
                 for cc, v in r if cc == c])
    np.testing.assert_array_equal(got.get_rows_mask(rows),
                                  want.get_rows_mask(rows))
    if name.startswith("asm"):
        assert got.column_codecs == want.column_codecs
        assert set(got.column_codecs) == {"sd", "stat", "rrr"}


@pytest.mark.parametrize("name", ("gref", "gcref", "grefn", "gcrefn"))
def test_reference_boss_matches_jax(files, name):
    """A reference-format .dbg loads into the JAX loader's BOSS arrays,
    mode and weights (a sidecar of the wrong length is ignored)."""
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    path = str(files / f"{name}.dbg")
    want, got = JaxDBG.load(path), DBGSuccinct.load(path)
    assert (got.k, got.mode, got.alphabet) \
        == (want.k, want.mode, want.alphabet.name)
    assert got.mode == ("canonical" if "gc" in name else "basic")
    wb, gb = want.boss, got.boss
    assert (gb.k, gb.alph_size) == (wb.k, wb.alph_size)
    for arr in ("W", "last", "F", "valid"):
        np.testing.assert_array_equal(getattr(gb, arr), getattr(wb, arr))
    assert (gb.weights is None) == (wb.weights is None)
    assert (gb.weights is None) == (name != "grefn")
    if wb.weights is not None:
        np.testing.assert_array_equal(gb.weights, wb.weights)
    assert got.num_nodes() == want.num_nodes()
    assert got.max_index() == want.max_index()


def _vectors():
    """(name, bytes of a bit_vector_smart) for each representation."""
    from metagraph_tpu.seq_io.refwrite import (Writer, write_bit_vector,
                                               write_bit_vector_small,
                                               write_int_vector)
    rng = np.random.default_rng(3)
    out = []
    for n, m in ((1000, 37), (4096, 1), (500, 0), (300, 290)):
        pos = np.sort(rng.choice(n, m, replace=False))
        for inverted in (0, 1):
            # sd_vector: size, low width, low int_vector, high bit_vector,
            # two empty select supports; then bit_vector_sd's flag
            wl = max(int(np.floor(np.log2(n / max(m, 1)))), 0)
            w = Writer()
            w.be64(1)
            w.le64(n)
            w.u8(wl)
            write_int_vector(w, pos & ((1 << wl) - 1), wl)
            hi = np.zeros(m + (n >> wl) + 1, dtype=bool)
            hi[(pos >> wl) + np.arange(m)] = True
            write_bit_vector(w, hi)
            w.le64(0)
            w.le64(0)
            w.u8(inverted)
            out.append((f"sd-{n}-{m}-inv{inverted}", bytes(w.buf)))
        bits = np.zeros(n, dtype=bool)
        bits[pos] = True
        w = Writer()                  # stat: bits, count, rank blocks, select
        w.be64(2)
        write_bit_vector(w, bits)
        w.be64(m)
        write_int_vector(w, np.zeros(n // 512 * 2 + 2, np.uint64), 64,
                         fixed_width=True)
        w.le64(0)
        out.append((f"stat-{n}-{m}", bytes(w.buf)))
        w = Writer()
        write_bit_vector_small(w, bits)
        out.append((f"rrr-{n}-{m}", bytes(w.buf)))
    return out


@pytest.mark.parametrize("name,data", _vectors(), ids=[v[0] for v in
                                                        _vectors()])
def test_bit_vector_readers_match_jax(name, data):
    from metagraph_tpu.seq_io import refformat as jax_ref
    from metagraph_tpu_torch.seq_io import refformat
    wc, gc = jax_ref.Cursor(data), refformat.Cursor(data)
    (wp, wn), (gp, gn) = jax_ref.read_bit_vector_smart(wc), \
        refformat.read_bit_vector_smart(gc)
    assert gn == wn and gc.off == wc.off == len(data)
    np.testing.assert_array_equal(gp, wp)


@pytest.mark.parametrize("v2", (False, True))
def test_label_encoders_match_jax(v2):
    """Both label-encoder layouts, with a label longer than 127 bytes (a
    multi-byte length in the legacy layout) and a non-ASCII one."""
    from metagraph_tpu.seq_io import refformat as jax_ref
    from metagraph_tpu.seq_io.refwrite import Writer, write_label_encoder
    from metagraph_tpu_torch.seq_io import refformat
    labels = ["a", "x" * 200, "ünïcode", "", "label 5"]
    w = Writer()
    if v2:
        w.raw(b"LE-v2.0")
        w.le64(2)
        w.le64(len(labels))
        w.le64(8)
        w.raw(struct.pack("<f", 0.5))
        for lab in labels:
            w.be64(len(lab.encode()))
            w.raw(lab.encode())
        w.raw(bytes(8 * 16))
    else:
        write_label_encoder(w, labels)
    w.raw(b"tail")
    data = bytes(w.buf)
    wc, gc = jax_ref.Cursor(data), refformat.Cursor(data)
    assert refformat.read_label_encoder(gc) \
        == jax_ref.read_label_encoder(wc) == labels
    assert gc.off == wc.off == len(data) - 4


@pytest.fixture(scope="module")
def queried(files):
    lines, want = [], []
    for name, g, a in QUERIES:
        for mode in MODES:
            args = ["query", "--device", "-i", str(files / g), "-a",
                    str(files / a), "--query-mode", mode, str(files / "q.fa")]
            lines.append(args)
            want.append(run_jax(args))
    got = run_port(files, lines)
    return {(n, m): (w, g) for (n, m), w, g in zip(
        [(n, m) for n, _, _ in QUERIES for m in MODES], want, got)}


@pytest.mark.parametrize("name,mode", [(q[0], m) for q in QUERIES
                                       for m in MODES])
def test_query_bytes_match_jax_cli(queried, name, mode):
    """The port's query prints the JAX CLI's stdout bytes and exit code (a
    reference graph in another state: the same error and exit code)."""
    want, got = queried[(name, mode)]
    assert got == want
    if name == "refgraph-bad-state":
        assert want[1] == 1 and "state SMALL" in want[2]
        return
    assert want[1] == 0 and want[2] is None, want
    lines = [ln.split("\t") for ln in want[0].splitlines()]
    assert len(lines) >= 30
    assert sum(len(f) > 2 and f[2] != "" for f in lines) >= 10
