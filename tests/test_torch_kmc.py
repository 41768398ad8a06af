"""KMC database inputs: the port's ``seq_io/kmc.py`` and ``build`` of a
``.kmc_suf`` against the JAX package.

The databases are written here (``write_db``, the KMC3 layout that the
JAX reader parses), at several k, prefix lengths, counter widths and
strand flags.  ``KMCDatabase`` and ``read_kmers`` must give the JAX
arrays and dtypes.  The JAX CLI cannot build a KMC input (its pre-pass
imports a ``KMCReader`` that seq_io/kmc.py does not define: pinned
below), so the port's ``build`` of one is held to what its ``cmd_build``
describes: the JAX ``DBGSuccinct.build`` over the JAX ``read_kmers``
k-mers (both strands unless the graph is canonical), with their counts as
weights under ``--count-kmers``, saved with the CLI's defaults.  The
port's CLI runs with ``--torch-device cpu`` in one subprocess without
JAX.
"""

import os
import struct

import numpy as np
import pytest

from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
from metagraph_tpu.seq_io import kmc as jax_kmc
from metagraph_tpu_torch.seq_io import kmc

from torch_parity import (graph_line, run_jax, run_port, same_build_files,
                          write_fasta)

ACGT = np.frombuffer(b"ACGT", np.uint8)


def write_db(base, codes, counts, lp, counter_size, single_strand):
    """(N, k) 2-bit codes (distinct) and counts -> base.kmc_pre/.kmc_suf."""
    N, k = codes.shape
    order = np.lexsort(codes.T[::-1])
    codes, counts = codes[order], counts[order]
    prefix = (codes[:, :lp] * (4 ** np.arange(lp - 1, -1, -1))).sum(axis=1)
    lut = np.searchsorted(prefix, np.arange(4 ** lp)).astype("<u8")
    nsb = (k - lp + 3) // 4
    rec = bytearray()
    for row, c in zip(codes, counts):
        suf = np.zeros(nsb, np.uint8)
        for p, x in enumerate(row[lp:]):
            suf[p // 4] |= x << (6 - 2 * (p % 4))
        rec += suf.tobytes() + int(c).to_bytes(counter_size, "little")
    header = struct.pack("<6IQ", k, 0, counter_size, lp, 2, 99, N) \
        + bytes([single_strand]) + bytes(23)
    with open(base + ".kmc_pre", "wb") as f:
        f.write(b"KMCP" + lut.tobytes() + header
                + struct.pack("<I", len(header)) + b"KMCP")
    with open(base + ".kmc_suf", "wb") as f:
        f.write(b"KMCS" + bytes(rec) + b"KMCS")


def _random_db(tmp, name, k, n, lp=3, counter_size=4, single_strand=1,
               seed=0, canonical_only=False):
    rng = np.random.default_rng(seed)
    codes = np.unique(rng.integers(0, 4, (n, k)).astype(np.uint8), axis=0)
    if canonical_only:                  # each k-mer as the lesser strand
        rc = (3 - codes)[:, ::-1]
        weight = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
        rc_less = (rc * weight).sum(axis=1) < (codes * weight).sum(axis=1)
        codes = np.unique(np.where(rc_less[:, None], rc, codes), axis=0)
    counts = rng.integers(1, 2 ** min(8 * counter_size, 20),
                          len(codes)).astype(np.uint64)
    base = str(tmp / name)
    write_db(base, codes, counts, lp, counter_size, single_strand)
    return base + ".kmc_suf"


DBS = [(k, lp, cs, ss) for k, lp, cs, ss in
       [(11, 2, 1, 1), (11, 4, 4, 0), (21, 3, 2, 1), (31, 4, 4, 1),
        (31, 1, 3, 0), (5, 1, 1, 0)]]


@pytest.mark.parametrize("k,lp,cs,ss", DBS,
                         ids=[f"k{k}-lp{lp}-c{cs}-s{ss}" for k, lp, cs, ss
                              in DBS])
def test_reader_matches_jax(tmp_path, k, lp, cs, ss):
    path = _random_db(tmp_path, "db", k, 300, lp, cs, ss, seed=k + lp)
    want, got = jax_kmc.KMCDatabase(path), kmc.KMCDatabase(path)
    for f in ("k", "mode", "counter_size", "lut_prefix_length",
              "min_count", "max_count", "total_kmers", "both_strands",
              "suffix_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    for a, b in zip(got.kmers_and_counts(), want.kmers_and_counts()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for both in (True, False):
        for lo, hi in ((1, 2 ** 63), (3, 1000)):
            g = kmc.read_kmers(path, both, lo, hi)
            w = jax_kmc.read_kmers(path, both, lo, hi)
            assert g[2] == w[2] == k
            for a, b in zip(g[:2], w[:2]):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    assert kmc.is_kmc_file(path) and kmc.is_kmc_file(path[:-3] + "pre")
    assert not kmc.is_kmc_file(path[:-8] + ".fa")


def test_jax_cli_fails_on_kmc_input(tmp_path):
    """The watch-list item: the JAX ``build`` of a KMC input dies in its
    pre-pass with an ImportError."""
    path = _random_db(tmp_path, "db", 11, 50)
    out = run_jax(["build", "-k", "11", "-o", str(tmp_path / "x"), path],
                  stderr=True)
    assert out[1] == 1 and out[2].startswith("ImportError") \
        and "KMCReader" in out[2], out


CLI = [("basic", False, 1), ("basic", True, 1), ("canonical", True, 1),
       ("canonical", False, 0), ("primary", True, 0), ("basic", True, 0)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kmc")
    paths = {ss: _random_db(tmp, f"db{ss}", 21, 400, single_strand=ss,
                            seed=40 + ss, canonical_only=bool(ss))
             for ss in (0, 1)}
    rng = np.random.default_rng(41)
    write_fasta(tmp / "in.fa", [(f"r{i}", "".join(rng.choice(
        list("ACGT"), size=120))) for i in range(3)])
    lines, keys = [], []
    for mode, counts, ss in CLI:
        tag = f"{mode}-{int(counts)}-{ss}"
        lines.append(["build", "-k", "15", "--mode", mode, "-o",
                      str(tmp / f"p-{tag}"), paths[ss]]
                     + (["--count-kmers"] if counts else []))
        keys.append((mode, counts, ss))
    # a KMC database beside a FASTA input: k from the database for both
    lines.append(["build", "-k", "9", "--count-kmers", "-o",
                  str(tmp / "p-mixed"), str(tmp / "in.fa"), paths[1]])
    keys.append("mixed")
    got = run_port(tmp, lines, stderr=True)
    return dict(tmp=tmp, paths=paths, port=dict(zip(keys, got)))


def _jax_graph(tmp, out, seqs, k, mode, weights):
    g = JaxDBG.build(seqs, k, mode=mode, with_counts=weights is not None,
                     mask_dummy=False, window_weights=weights)
    g.boss.state = "stat"
    g.save(str(tmp / out))
    return g


@pytest.mark.parametrize("mode,counts,ss", CLI,
                         ids=[f"{m}-{'counts' if c else 'plain'}-s{s}"
                              for m, c, s in CLI])
def test_build_of_kmc_matches_jax_build_of_read_kmers(runs, mode, counts, ss):
    tmp = runs["tmp"]
    tag = f"{mode}-{int(counts)}-{ss}"
    got = runs["port"][(mode, counts, ss)]
    assert got[:3] == ["", 0, None], got
    assert got[3].splitlines()[0] == "warning: using k=21 from KMC database"
    chars, cnt, k = jax_kmc.read_kmers(
        runs["paths"][ss], both_from_canonical=mode != "canonical")
    seqs = [chars[i].tobytes() for i in range(len(chars))]
    g = _jax_graph(tmp, f"j-{tag}", seqs, k, mode,
                   [np.array([c], np.uint64) for c in cnt] if counts
                   else None)
    assert graph_line(got[3]) == [f"graph built: k=21 nodes="
                                  f"{g.num_nodes()}"]
    same_build_files(tmp, f"p-{tag}", f"j-{tag}", False)
    if counts:
        assert g.boss.weights is not None and g.boss.weights.max() > 1


def test_kmc_beside_fasta(runs):
    """The pre-pass sets k = 21 before the FASTA input is read, so its
    windows and their weights use that k, as the JAX cmd_build orders
    it."""
    from metagraph_tpu.seq_io.fasta import read_fasta
    tmp = runs["tmp"]
    got = runs["port"]["mixed"]
    assert got[:3] == ["", 0, None], got
    recs = read_fasta(str(tmp / "in.fa"))
    chars, cnt, k = jax_kmc.read_kmers(runs["paths"][1])
    seqs = [r.seq for r in recs] + [chars[i].tobytes()
                                    for i in range(len(chars))]
    w = [np.ones(len(r.seq) - k + 1, np.uint64) for r in recs] \
        + [np.array([c], np.uint64) for c in cnt]
    g = _jax_graph(tmp, "j-mixed", seqs, k, "basic", w)
    assert graph_line(got[3]) == [f"graph built: k=21 nodes={g.num_nodes()}"]
    same_build_files(tmp, "p-mixed", "j-mixed", False)
    assert os.path.exists(tmp / "p-mixed.dbg.npz")
