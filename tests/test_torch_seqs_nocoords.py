"""A ``.seqs`` mapping beside an annotation without coordinates.

``annotate --anno-filename --index-header-coords`` without
``--coordinates`` writes the mapping all the same, and ``query`` loads it.
No k-mer then carries a coordinate, so every sequence comes back with an
empty result.  The port's ``query --torch-device cpu`` must print the JAX
CLI's stdout bytes and exit code in the six modes and with ``--json``,
with ``--device`` and without; ``cth_aggregate`` must give what
``AnnotatedDBG._cth_aggregate`` gives on the same node arrays.

The JAX CLI builds a basic k = 11 graph of two FASTA files and annotates
it in tmp_path; the port's command lines run in one subprocess without
JAX (tests/torch_parity.py).
"""

import contextlib
import io

import numpy as np
import pytest

from torch_parity import (jax_cli, references_and_reads, run_jax, run_port,
                          write_fasta)

MODES = ("labels", "matches", "counts-sum", "counts", "signature", "coords")


@pytest.fixture(scope="module")
def nocoords(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nocoords")
    rng = np.random.default_rng(16)
    refs, reads = references_and_reads(rng, n_refs=4)
    files = []
    for f in range(2):
        files.append(str(tmp / f"file{f}.fa"))
        write_fasta(files[-1], [(f"f{f}s{i}", s)
                                for i, s in enumerate(refs[2 * f: 2 * f + 2])])
    write_fasta(tmp / "q.fa", [(f"q{i}", s) for i, s in enumerate(reads)])
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_cli("build", "-k", "11", "-o", tmp / "g", *files)
        jax_cli("annotate", "-i", tmp / "g.dbg", "--anno-filename",
                "--index-header-coords", "-o", tmp / "gh", *files)
    assert (tmp / "gh.seqs").exists()
    return tmp


LINES = [(mode, opts, device) for device in (True, False)
         for mode in MODES for opts in ([], ["--json"])]


def test_query_without_coordinates_matches_jax(nocoords):
    """Every mode, with and without --json and --device: the JAX CLI's
    bytes (each sequence with an empty result) and exit code 0."""
    tmp = nocoords
    lines = [["query", "-i", tmp / "g.dbg", "-a", tmp / "gh.column.annodbg",
              "--query-mode", mode, *opts, *(["--device"] if device else []),
              tmp / "q.fa"] for mode, opts, device in LINES]
    got = run_port(tmp, lines)
    n_reads = len(open(tmp / "q.fa").read().split(">")) - 1
    for args, g in zip(lines, got):
        want = run_jax([str(a) for a in args])
        assert g == want, args
        assert want[1] == 0 and want[0].count("\n") == n_reads
    labels = got[LINES.index(("labels", [], True))][0].splitlines()
    assert labels[0] == "0\tq0\t"
    assert got[LINES.index(("matches", [], True))][0].splitlines()[0] \
        == "0\tq0"


@pytest.mark.parametrize("mode", MODES)
def test_cth_aggregate_without_coordinates_matches_jax(nocoords, mode):
    """cth_aggregate on a batch of node arrays against _cth_aggregate on
    each: every sequence empty, at thresholds that pass and that fail."""
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation as JCA
    from metagraph_tpu.annotation.coord_to_header import \
        CoordToHeader as JaxCTH
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu.seq_io.fasta import read_fasta
    from metagraph_tpu_torch.annotation.annotated_dbg import (HeaderIndex,
                                                              cth_aggregate)
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu_torch.annotation.coord_to_header import CoordToHeader
    tmp = nocoords
    g = DBGSuccinct.load(str(tmp / "g.dbg"))
    anno_path = str(tmp / "gh.column.annodbg.npz")
    ag = AnnotatedDBG(g, JCA.load(anno_path),
                      coord_to_header=JaxCTH.load(str(tmp / "gh.seqs")))
    nodes = [g.map_to_nodes(r.seq) if len(r.seq) >= g.k
             else np.zeros(0, np.int64)
             for r in read_fasta(str(tmp / "q.fa"))]
    assert sum(int((n > 0).sum()) for n in nodes) > 100
    for top, df, pf in ((2 ** 63, 0.7, 0.0), (1, 0.0, 0.0), (2, 1.0, 1.0)):
        want = [ag._cth_aggregate(n, top, df, pf, mode) if len(n) else []
                for n in nodes]
        got = cth_aggregate(
            ColumnMajorAnnotation.load(anno_path),
            HeaderIndex(CoordToHeader.load(str(tmp / "gh.seqs"))),
            nodes, mode, top, df, pf)
        assert str(got) == str(want)
        assert got == [[] for _ in nodes]
