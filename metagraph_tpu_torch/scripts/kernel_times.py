"""Time kernels A, B, 3, 4, S1, S2, W1, W2, D2 and D4 (``key_lookup``,
``codes_lookup``, ``selection_mask``, ``sw_scores``,
``sparse_label_counts``, ``overflow_counts``, ``brwt_row_words``,
``rowdiff_row_words``, ``radix_sort``, ``emit_keys`` + ``build_emit``) of
one or more trees of the port on the card, each held exactly against its
plain version.

    python metagraph_tpu_torch/scripts/kernel_times.py [--root DIR ...]
        [--build-only]

``--root`` names a tree whose ``metagraph_tpu_torch`` is timed (by default
the one this file lives in).  Given more than once, the trees are timed in
one process on the same inputs, in turns: in the order given, then in
reverse (parent, change, change, parent for two), so that a commit unpacked
with ``git archive`` and the working tree compare on one card; their
wrappers take the same arguments.  The inputs come from fixed seeds:

* ``key_lookup`` on 27,150,000 keys of 5 words, 8 bits a code (the protein
  deployment's shape, k = 20), 80% of them in the table, into a table of
  8,100,000 such keys in 2^22 buckets (the deployments' load, about 1.9
  keys a bucket);
* ``codes_lookup`` on the K = 41 tiles (T = 256) of 150,000 reads of 200 bp
  drawn from 1,000 random references of 8,101 bp (10% reverse complemented,
  1% substitutions, 3% with an N run) and of reference 0 repeated past
  2^24 windows, into a table of the references' 8,061,000 k-mers in 2^22
  buckets (the k41 deployment's shape);
* both again on their L2 controls: tables of 2^15 buckets at the same load,
  built from a prefix of each table's keys (``control_table``), which stay
  in the card's L2;
* ``sw_scores`` on 4,096 pairs of 150 x 300 and 1,024 pairs of 1,000 x
  1,000 (the two shapes of ``chip_smoke.py``'s SW phase: related pairs,
  ragged padding on both sides), default scores;
* ``selection_mask`` on (150,001, 1,000) int32 counts (the query
  deployments' shape) with every row's presence passing (selmin = 0) and
  with half of the rows failing it;
* ``sparse_label_counts`` (S1) at the many-labels deployment's shapes,
  with no graph build: R = 8,100,000 rows, 8,100 of each of 1,000
  references at random (BOSS-order) ids; a row of reference r >= 16
  carries label r and 0-2 random ones (tau = 4), a row of reference r < 16
  overflow pattern r (48-64 labels; 17 rows of ``dense8``), L = 4,096.
  150,000 reads of 170 windows in 256-window tiles (a reference and a
  start at random; 10% reverse complemented, which miss; 1% substitutions
  and 3% with an N run, whose windows miss) and reference 0's rows
  repeated until pattern 0 passes 2^24 hits (30 misses a period, as at
  the copies' junctions): 150,001 sequences.  Then its two controls: the
  same windows on an L2-resident table (each window's position in its
  reference taken modulo 256, so its row keeps its reference's kind:
  1,000 x 256 rows, 5 MB), which removes the random row sectors, and on a
  table whose label ids are all the sentinel, which removes the counts
  atomics.  Then a hashed-tally shape: L = 65,536 (random labels drawn
  again, 16 patterns of 48-64 of them), S cut to the first 15,000 reads
  and the long sequence so that the counts stay under 4 GB;
* ``overflow_counts`` (S2) on S1's multiplicities and counts (L = 4,096),
  and on multiplicities that are all zero (its scan alone);
* ``brwt_row_words`` (W1) and ``rowdiff_row_words`` (W2) at the words
  deployments' shapes: S1's table at L = 4,096 as a BRWT (arity 2, no
  linkage) and as a row-diff BRWT whose successor is each row's next row
  in its reference (an anchor every 100 rows and at a reference's end), on
  the first words chunk of S1's windows (512 tiles, 131,072 windows); and
  their L2 controls: the same windows on the control rows of S1's (each
  reference's first 256 rows, its BRWT and walk about 1 MB).  A tree
  without ``annotation/device_matrix.py`` skips them.  Before the turns,
  W2's walks on both are counted (``walk_counts``: the steps of a walk a
  window, the distinct rows, the forward-linked windows, the tails and
  their chain steps); in each tree's first turn that has the split build
  (``_build.VARIANTS``), W1 and W2 run once more in it and print the
  cycles a lane waits on the descent's node and word loads and a round's
  cycles, then once under torch.profiler (the device ms of each kernel a
  call launches: W2's four steps); ``--slots 1,2,4,8`` times W1 and W2
  again at each number of windows a warp, in the trees that have that
  setting;
* ``radix_sort`` (D2) on the sorts of a pan-shaped build
  (``chip_smoke.py``'s "pan": 5 random base genomes of 4,000,000 bp with
  4 strains each at 1% substitutions, 3 N runs a reference, k = 21): the
  edge sort of the window keys (D1's), the join sort of D3's entries and
  the sink and source node lists, the inputs made with the first tree's
  kernels (and the plain sorts between them).  Each tree sorts each as
  its build does (the join sort with ``sentinel=`` where its wrapper
  takes it, and once more without it), ``torch.sort(stable=True)`` over
  the same keys beside them.  A tree without
  ``succinct/device_build.py`` skips them;
* D4 by launch and ``build_p2`` on that build's P1 keys and dummy rows,
  each tree with its own code (``time_build_p2``): its ``emit_keys``, the
  stream sort of those keys as its build runs it (a tree that pads the
  stream with sentinels sorts it with ``sentinel=``), ``torch.sort`` over
  them, ``build_emit`` on the sorted U + D rows, their sums, and
  ``build_p2`` whole (its host syncs included), then in each tree's
  first turn the device ms of every kernel and memset that ``build_p2``
  launches (torch.profiler).  ``--build-only`` times D2 and D4 alone.

The last line of stdout is a JSON object: every tree's times in its turns
(CUDA events, mean of ``--reps`` launches after a warm-up) and the card.
It needs a CUDA card; ``--rehearse`` runs the same steps at a tiny size on
the CPU with the plain versions and exits 2 without a result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

SW_SHAPES = ((4096, 150, 300), (1024, 1000, 1000))
SELECT_SHAPE = (150_001, 1000)
K41, KP = 41, 20
FULL = dict(keys=27_150_000, key_table=8_100_000, refs=1000, ref_len=8101,
            reads=150_000, read_len=200, long_windows=1 << 24,
            buckets_log=22, ctrl_log=15, sw=SW_SHAPES, select=SELECT_SHAPE,
            sparse=dict(refs=1000, ref_rows=8100, reads=150_000, read_len=200,
                        long_hits=1 << 24, labels=(4096, 65_536),
                        wide_reads=15_000, patterns=(16, 48, 65),
                        ctrl_rows=256, anchor_every=100, words_tiles=None),
            pan=(5, 4_000_000, 4, 0.01, 3), build_k=21)
TINY = dict(keys=5000, key_table=1500, refs=12, ref_len=300, reads=200,
            read_len=120, long_windows=2000, buckets_log=9, ctrl_log=6,
            sw=((16, 37, 60), (4, 70, 90)), select=(301, 100),
            sparse=dict(refs=24, ref_rows=400, reads=300, read_len=120,
                        long_hits=3000, labels=(4096, 65_536), wide_reads=40,
                        patterns=(4, 8, 13), ctrl_rows=64, anchor_every=10,
                        words_tiles=8),
            pan=(2, 3000, 2, 0.01, 2), build_k=21)


def sw_pairs(rng, B, LQ, LR):
    """Pairs sharing a mutated segment, with ragged padding on both
    sides."""
    qs = rng.integers(0, 4, (B, LQ)).astype(np.int32)
    rs = rng.integers(0, 4, (B, LR)).astype(np.int32)
    for b in range(B):
        n = int(rng.integers(LQ // 3, LQ))
        at = int(rng.integers(0, LR - n))
        seg = qs[b, :n].copy()
        mut = rng.random(n) < 0.05
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        rs[b, at: at + n] = seg
        qs[b, int(rng.integers(LQ - LQ // 5, LQ + 1)):] = -1
        rs[b, int(rng.integers(LR - LR // 5, LR + 1)):] = -1
    return qs, rs


def control_table(table: np.ndarray, log_buckets: int) -> np.ndarray:
    """A (2^log_buckets, row) uint32 table at ``table``'s load, built by the
    port's builder from a prefix of its keys (in bucket order): at 2^15
    buckets it stays in the card's L2, so a kernel's time on it is its time
    without device-memory latency."""
    from metagraph_tpu_torch.succinct import ops
    nb, W = table.shape[0], table.shape[1] // ops.BUCKET - 1
    slots = table.reshape(nb, ops.BUCKET, W + 1)
    slots = slots[slots[:, :, 0] != ops.EMPTY_WORD]
    nbc = 1 << log_buckets
    keep = slots[: round(len(slots) * nbc / nb)]
    ctab = ops.DeviceHashIndex._build(keep[:, :W], keep[:, W], nbc)
    if ctab is None:
        raise AssertionError("the control table overflowed a bucket")
    return ctab.reshape(nbc, -1)


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn) -> float:
    """One run on the host clock: rehearsals only, no device metric."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def exact(torch, got, want, what):
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what} disagrees with its plain version")


def load_port(root: str) -> SimpleNamespace:
    """Import ``root``'s metagraph_tpu_torch afresh.  A tree imported
    before stays alive through the functions taken from it; each builds
    its kernels into its own ``build/torch_kernels``."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "metagraph_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        mods = {n: importlib.import_module(f"metagraph_tpu_torch.{n}")
                for n in ("succinct.ops", "align.sw", "query.device",
                          "query.tile_pack", "annotation.sparse_device",
                          "annotation.matrix")}
        dm, db = (importlib.import_module(f"metagraph_tpu_torch.{m}")
                  if os.path.exists(os.path.join(
                      root, "metagraph_tpu_torch", *m.split("."))
                      + ".py") else None
                  for m in ("annotation.device_matrix",
                            "succinct.device_build"))
    finally:
        sys.path.remove(root)
    build = importlib.import_module("metagraph_tpu_torch._build")
    return SimpleNamespace(root=root, ops=mods["succinct.ops"], build=build,
                           sw=mods["align.sw"], qd=mods["query.device"],
                           tile_pack2=mods["query.tile_pack"].tile_pack2,
                           sd=mods["annotation.sparse_device"], dm=dm,
                           db=db, matrix=mods["annotation.matrix"])


def protein_inputs(rng, s, ops):
    """-> (table, queries): ``key_table`` random keys of KP codes 1..20 at 8
    bits, in 2^buckets_log buckets; ``keys`` queries, 80% of them drawn
    from the table's keys."""
    n, Q = s["key_table"], s["keys"]
    keys = ops.pack_kmers32(rng.integers(1, 21, (n, KP), dtype=np.uint8), 8)
    table = ops.DeviceHashIndex._build(keys, np.arange(1, n + 1,
                                                       dtype=np.uint32),
                                       1 << s["buckets_log"])
    if table is None:
        raise AssertionError("the protein table overflowed a bucket")
    hit = rng.random(Q) < 0.8
    q = np.empty((Q, keys.shape[1]), np.uint32)
    q[hit] = keys[rng.integers(0, n, int(hit.sum()))]
    q[~hit] = ops.pack_kmers32(rng.integers(1, 21, (Q - int(hit.sum()), KP),
                                            dtype=np.uint8), 8)
    return table.reshape(1 << s["buckets_log"], -1), q


def k41_inputs(rng, s, ops, tile_pack2, T):
    """-> (table, packed2, validb): the k-mers of random references in
    2^buckets_log buckets, and the tiles of reads drawn from them plus
    reference 0 repeated past ``long_windows`` windows."""
    refs = rng.integers(0, 4, (s["refs"], s["ref_len"]), dtype=np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(refs, K41, axis=1)
    keys = ops.pack_kmers32(win.reshape(-1, K41) + 1)
    table = ops.DeviceHashIndex._build(keys, np.arange(1, len(keys) + 1,
                                                       dtype=np.uint32),
                                       1 << s["buckets_log"])
    if table is None:
        raise AssertionError("the k41 table overflowed a bucket")
    n, m = s["reads"], s["read_len"]
    which = rng.integers(0, len(refs), n)
    start = rng.integers(0, s["ref_len"] - m, n)
    codes = refs[which[:, None], start[:, None] + np.arange(m)]
    codes = np.where(rng.random((n, m)) < 0.01,
                     (codes + rng.integers(1, 4, (n, m))) % 4, codes)
    rc = rng.random(n) < 0.1
    codes[rc] = 3 - codes[rc, ::-1]
    at, ln = rng.integers(0, m - 20, n), rng.integers(1, 20, n)
    col = np.arange(m)
    nrun = (rng.random(n) < 0.03)[:, None] & (col >= at[:, None]) \
        & (col < (at + ln)[:, None])
    codes = np.where(nrun, 4, codes).astype(np.uint8)
    long = np.tile(refs[0], s["long_windows"] // (s["ref_len"] - K41 + 1)
                   + 1)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seqs = [letters[row].tobytes() for row in codes]
    seqs.append(letters[long].tobytes())
    t2, vb, _, _ = tile_pack2(seqs, K41, T)
    return table.reshape(1 << s["buckets_log"], -1), t2, vb


def sparse_tables(rng, L, rows_of, n_pat, lo, hi):
    """-> (entries (R+1, 4) uint32, dmap (R+1,) int32, dense8 (n_pat+1, L)
    int8) for rows listed by reference (``rows_of[r, p]``: the id of
    reference r's p-th row): label r and 0-2 random ones, or pattern r for
    r < n_pat."""
    nref, nrow = rows_of.shape
    ref = np.repeat(np.arange(nref), nrow)
    lab = np.stack([ref, *rng.integers(0, L, (2, ref.size))], 1)
    extra = rng.integers(0, 3, ref.size)          # 0-2 random labels
    lab[:, 1:][np.arange(2)[None, :] >= extra[:, None]] = L
    lab = np.sort(lab, 1)
    lab[:, 1:][lab[:, 1:] == lab[:, :-1]] = L
    lab = np.sort(lab, 1)
    lab[ref < n_pat] = L
    entries = np.full((rows_of.size + 1, 4), L, np.uint32)
    entries[rows_of.reshape(-1), :3] = lab
    dmap = np.zeros(rows_of.size + 1, np.int32)
    dmap[rows_of[:n_pat].reshape(-1)] = np.repeat(np.arange(1, n_pat + 1),
                                                  nrow)
    dense8 = np.zeros((n_pat + 1, L), np.int8)
    for d in range(1, n_pat + 1):
        dense8[d, rng.choice(L, int(rng.integers(lo, hi)), replace=False)] = 1
    return entries, dmap, dense8


def sparse_windows(rng, sp, T, K=31):
    """-> (ref, pos, hit) of every window slot of the reads' tiles and the
    long sequence's (see the module docstring), and tile_seq."""
    n, m, nrow = sp["reads"], sp["read_len"], sp["ref_rows"]
    nw = m - K + 1
    ref = np.repeat(rng.integers(0, sp["refs"], n)[:, None], nw, 1)
    pos = rng.integers(0, nrow - nw + 1, n)[:, None] + np.arange(nw)
    bad = rng.random((n, m)) < 0.01
    for i in np.flatnonzero(rng.random(n) < 0.03):
        at = int(rng.integers(0, m - 20))
        bad[i, at: at + int(rng.integers(1, 20))] = True
    cs = np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(bad, 1)], 1)
    hit = (cs[:, K: K + nw] == cs[:, :nw]) & (rng.random(n) >= 0.1)[:, None]
    reads = [np.zeros((n, T), np.int64) for _ in range(3)]
    for out, a in zip(reads, (ref, pos, hit)):
        out[:, :nw] = a
    reps = -(-sp["long_hits"] // nrow)
    reps += 1 - reps % 2
    period = nrow + K - 1
    lp = np.tile(np.arange(period), reps)
    nt = -(-lp.size // T)
    lpos = np.zeros(nt * T, np.int64)
    lpos[:lp.size] = lp
    lhit = np.zeros(nt * T, bool)
    lhit[:lp.size] = lp < nrow
    long = [np.zeros((nt, T), np.int64), np.minimum(lpos, nrow - 1)
            .reshape(nt, T), lhit.reshape(nt, T)]
    tile_seq = np.concatenate([np.arange(n), np.full(nt, n)]).astype(np.int32)
    return [np.concatenate([a, b]) for a, b in zip(reads, long)], tile_seq


def sparse_inputs(port, s, torch, dev):
    """S1's and S2's inputs (the module docstring) and plain results."""
    from metagraph_tpu_torch._u32 import np_words
    sp, T, sd = s["sparse"], port.qd.TILE, port.sd
    rng = np.random.default_rng(8)
    nref, nrow, M = sp["refs"], sp["ref_rows"], sp["ctrl_rows"]
    n_pat, lo, hi = sp["patterns"]
    rows_of = (rng.permutation(nref * nrow) + 1).reshape(nref, nrow)
    (ref, pos, hit), tile_seq = sparse_windows(rng, sp, T)
    ids = np.where(hit, rows_of[ref, pos], 0).astype(np.int32)
    ctrl = np.where(hit, ref * M + pos % M + 1, 0).astype(np.int32)
    del ref, pos, hit
    up = lambda a: np_words(a).to(dev) if a.dtype == np.uint32 \
        else torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    S = int(tile_seq[-1]) + 1
    cases = {}
    for L in sp["labels"]:
        entries, dmap, dense8 = sparse_tables(rng, L, rows_of, n_pat, lo, hi)
        if L == sp["labels"][0]:
            words = (entries, dmap, dense8)
            # the control table: row 0, then each reference's first M rows
            first = rows_of[:, :M].reshape(-1)
            tabs = {"": (entries, dmap, ids),
                    " L2 control": (entries[np.r_[0, first]],
                                    dmap[np.r_[0, first]], ctrl),
                    " sentinel control": (np.full_like(entries, L), dmap,
                                          ids)}
            for what, (e, d, i) in tabs.items():
                cases["sparse_label_counts" + what] = (
                    up(i), up(tile_seq), up(e), up(d), S, L, n_pat + 1)
            dense = up(dense8)
        else:
            keep = (tile_seq < sp["wide_reads"]) | (tile_seq == S - 1)
            ts = np.where(tile_seq == S - 1, sp["wide_reads"], tile_seq)
            cases[f"sparse_label_counts L={L}"] = (
                up(ids[keep]), up(ts[keep].astype(np.int32)), up(entries),
                up(dmap), sp["wide_reads"] + 1, L, n_pat + 1)
    want = {}
    for name, (i, ts, e, d, S_, L, P) in cases.items():
        out = sparse_zeros(torch, dev, S_, L, P)
        sd.sparse_label_counts_plain(i, ts, e, d, *out, chunk=1024)
        want[name] = out
    counts, _, mult = want["sparse_label_counts"]
    ref = counts.clone()
    sd.overflow_counts_plain(ref, mult, dense)
    want["overflow_counts"] = ref
    i = cases["sparse_label_counts"][0]
    print(f"sparse inputs: {i.numel()} window slots in {i.shape[0]} tiles, "
          f"{int((i > 0).sum())} hits on {int(torch.unique(i[i > 0]).numel())}"
          f" distinct rows of {nref * nrow}; {S} sequences; "
          f"{int((mult[:, 1:] > 0).sum())} (sequence, pattern) pairs",
          flush=True)
    return SimpleNamespace(cases=cases, want=want, dense8=dense,
                           words=words_inputs(port, s, torch, dev, words,
                                              rows_of, ids, ctrl))


class Arity2BRWT:
    """BRWT.from_columns with arity 2 and no linkage (greedy linkage is
    Python over millions of pairs a round at 4,096 labels): the words
    deployments' trees, and RowDiff.from_annotation's inner type for
    them."""

    @staticmethod
    def from_columns(columns, num_rows, num_labels):
        from metagraph_tpu_torch.annotation.matrix import BRWT
        return BRWT.from_columns(columns, num_rows, num_labels,
                                 linkage=False)


def table_columns(entries, dmap, dense8, rows):
    """The label columns of table rows ``rows`` (ids; column rows are the
    places in ``rows``): their label ids and overflow patterns."""
    L = dense8.shape[1]
    e = entries[rows]
    r, c = np.nonzero(e < L)
    lab = e[r, c].astype(np.int64)
    pr, pl = [r], [lab]
    for d in range(1, dense8.shape[0]):
        at = np.flatnonzero(dmap[rows] == d)
        pat = np.flatnonzero(dense8[d])
        pr.append(np.repeat(at, len(pat)))
        pl.append(np.tile(pat, len(at)))
    r, lab = np.concatenate(pr), np.concatenate(pl)
    order = np.lexsort((r, lab))
    starts = np.searchsorted(lab[order], np.arange(L + 1))
    return [r[order[starts[c]: starts[c + 1]]] for c in range(L)]


def words_inputs(port, s, torch, dev, table, rows_of, ids, ctrl):
    """W1's and W2's inputs (the module docstring) on the device, with
    their plain results; None for a tree without them."""
    dm = port.dm
    if dm is None:
        return None
    RowDiff = port.matrix.RowDiff
    sp, T = s["sparse"], port.qd.TILE
    M, every = sp["ctrl_rows"], sp["anchor_every"]
    nref, nrow = rows_of.shape
    L = table[2].shape[1]
    Lw = -(-L // 32)
    step = sp["words_tiles"] or max(
        1, port.qd.WORDS_BYTES // (T * -(-Lw // 4) * 16))
    cases, t0 = {}, time.perf_counter()
    for what, rows, n, win in (
            ("", rows_of, nrow, ids),
            (" L2 control", rows_of[:, :M], M, ctrl)):
        R = rows.size
        # column row i holds table id i + 1; the control's column rows are
        # reference r's first M rows at r * M + p (its ids ``ctrl``)
        if what:
            cols = table_columns(*table, rows.reshape(-1))
            place = np.arange(R).reshape(nref, n)
        else:
            cols = table_columns(*table, np.arange(1, R + 1))
            place = rows - 1
        succ = np.full(R, -1, np.int64)
        succ[place[:, :-1].reshape(-1)] = place[:, 1:].reshape(-1)
        anchors = np.zeros(R, bool)
        anchors[place[:, every - 1::every].reshape(-1)] = True
        anchors |= succ < 0
        brwt = dm.BRWTOnDevice.from_host(dm.FlatBRWT.from_brwt(
            Arity2BRWT.from_columns(cols, R, L)), dev)
        rd = RowDiff.from_annotation(cols, R, L, (succ, anchors),
                                     Arity2BRWT)
        walk = dm.RowDiffOnDevice.from_host(dm.FlatRowDiff.from_row_diff(
            rd, dm.FlatBRWT.from_brwt(rd.inner)), dev)
        w = torch.from_numpy(
            np.ascontiguousarray(win[:step].reshape(-1))).to(dev)
        cases["brwt_row_words" + what] = (brwt, w)
        cases["rowdiff_row_words" + what] = (walk, w)
    want = {name: getattr(dm, name.split()[0] + "_plain")(a, w)
            for name, (a, w) in cases.items()}
    w = cases["brwt_row_words"][1]
    print(f"words inputs: {w.numel()} windows, {int((w > 0).sum())} hits; "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    for what in ("", " L2 control"):
        walks = walk_counts(dm, torch, *cases["rowdiff_row_words" + what])
        print(f"  rowdiff_row_words{what} walks: {walks}", flush=True)
    return SimpleNamespace(cases=cases, want=want)


def walk_counts(dm, torch, rd, ids, offset=0) -> dict:
    """W2's walks on ``ids``, from its plain version: the steps that a walk
    a window takes (rows stepped on, repeats counted), the distinct rows
    among them, the hit windows whose successor is the next window's row
    (forward links: next_row[row(q)] == row(q + 1)), and the steps of the
    walks of the windows that link forward to none (tails) past their own
    row: a descent of every hit window's own row and of the tails' chains
    is what a walk that shares each linked run's chain takes."""
    visited = {}
    dm.rowdiff_row_words_plain(rd, ids, offset, visited)
    rows = torch.cat(visited["rows"]) if visited else ids[:0].long()
    r = dm._rows_of(ids, offset, rd.num_rows)
    link = torch.zeros_like(r, dtype=torch.bool)
    link[:-1] = (r[:-1] >= 0) & (r[1:] >= 0) \
        & (rd.next_row.long()[r[:-1].clamp(min=0)] == r[1:])
    tails = (r >= 0) & ~link
    tail_steps = {}
    dm.rowdiff_row_words_plain(rd, torch.where(tails, ids, 0), offset,
                               tail_steps)
    n_tail = sum(int(v.numel()) for v in tail_steps.get("rows", []))
    return {"windows": int(ids.numel()), "hits": int((r >= 0).sum()),
            "steps": int(rows.numel()),
            "distinct rows": int(torch.unique(rows).numel()),
            "forward-linked": int(link.sum()), "tails": int(tails.sum()),
            "tail chain steps": n_tail - int(tails.sum())}


def sparse_zeros(torch, dev, S, L, P):
    return (torch.zeros((S, L), dtype=torch.int32, device=dev),
            torch.zeros(S, dtype=torch.int32, device=dev),
            torch.zeros((S, P), dtype=torch.int32, device=dev))


def pan_seqs(rng, pan):
    """``chip_smoke.py``'s pan-genome: ``genomes`` random base genomes of
    ``length`` bp, each with ``strains`` strains at ``sub_rate``
    substitutions, ``runs`` runs of N (1-500 bp) a reference, as bytes."""
    G, L, S, sub, runs = pan
    refs = np.empty((G * (S + 1), L), np.uint8)
    for g in range(G):
        base = rng.integers(0, 4, L, dtype=np.uint8)
        refs[g * (S + 1)] = base
        for i in range(1, S + 1):
            at = np.flatnonzero(rng.random(L) < sub)
            strain = base.copy()
            strain[at] = (strain[at] + rng.integers(1, 4, len(at))) % 4
            refs[g * (S + 1) + i] = strain
    for r in refs:
        for _ in range(runs):
            at = int(rng.integers(0, len(r) - 500))
            r[at: at + int(rng.integers(1, 500))] = 4
    letters = np.frombuffer(b"ACGTN", np.uint8)
    return [letters[r].tobytes() for r in refs]


def sort_inputs(port, s, torch, dev):
    """D2's four shared cases and D4's inputs of a pan-shaped build (the
    module docstring): {case: (keys, bits, sentinel)}, the plain sorts'
    keys, and D4's inputs (P1's sorted keys, uniq flags and U, the dummy
    rows' 3-bit keys) with the sorted U + D rows of the stream; None for a
    tree without the device construction."""
    db = port.db
    if db is None:
        return None
    from metagraph_tpu_torch._u32 import np_words
    t0 = time.perf_counter()
    k = s["build_k"]
    seqs = pan_seqs(np.random.default_rng(9), s["pan"])
    t2, vb, _, _ = port.tile_pack2(seqs, k, db.T_WIRE)
    del seqs
    words, vwords = port.qd.wire_words_layout(t2, vb, k, db.T_WIRE, len(t2))
    del t2, vb
    keys = db.build_windows(np_words(words).to(dev),
                            np_words(vwords).to(dev), k)
    del words, vwords
    skeys = db.radix_sort_plain(keys, 2 * k + 1)[0]
    uniq, J, U = db.build_join(skeys, k)
    sink, src1, _, _ = db.join_nodes(db.radix_sort_plain(J, 2 * k + 1)[0],
                                     k, db.capd_limit(db._CAPD_DEFAULT,
                                                      1 << 22))
    sink, src1 = (db.radix_sort_plain(x, 2 * k - 2)[0] for x in (sink, src1))
    dummies = db.expand_dummies(db.unpack_node_keys(sink.cpu().numpy(), k),
                                db.unpack_node_keys(src1.cpu().numpy(), k),
                                k)
    d3 = torch.from_numpy(db.host_key3(dummies, k)).to(dev)
    stream = torch.sort(torch.cat([db.key3_plain(skeys[uniq], k), d3]))[0]
    cases = {"edge": (keys, 2 * k + 1, None),
             "join": (J, 2 * k + 1, db._sent2(k)),
             "sink": (sink, 2 * k - 2, None),
             "source": (src1, 2 * k - 2, None)}
    want = {name: db.radix_sort_plain(x, bits)[0]
            for name, (x, bits, _) in cases.items()}
    print("sort inputs: " + ", ".join(
        f"{name} {len(x)} keys over {bits} bits"
        + (f" ({int((x != sent).sum())} not the sentinel)"
           if sent is not None else "")
        for name, (x, bits, sent) in cases.items())
        + f"; stream: n = {len(skeys)} window slots, U = {U}, "
        f"{len(dummies)} dummy rows; made in "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
    emit = SimpleNamespace(skeys=skeys, uniq=uniq, U=U, d3=d3, k=k,
                           S=stream)
    return SimpleNamespace(cases=cases, want=want, emit=emit)


def time_sorts(db, sorts, torch, clock, check) -> dict:
    """D2 on each sort case as the tree's build runs it, and without the
    sentinel too; ``torch.sort(stable=True)`` over the same keys.  A tree
    whose ``radix_sort`` takes no ``sentinel=`` sorts without it: drop that
    branch once no tree timed is that old."""
    import inspect
    takes = "sentinel" in inspect.signature(db.radix_sort).parameters
    times = {}
    for case, (keys, bits, sent) in sorts.cases.items():
        for s in (sent, None) if sent is not None and takes else (None,):
            kw = {} if s is None else {"sentinel": s}
            name = f"radix_sort {case}" + ("" if s is None else " sentinel")
            if check:
                exact(torch, db.radix_sort(keys, bits, **kw)[0],
                      sorts.want[case], name)
            times[name] = clock(lambda: db.radix_sort(keys, bits, **kw))
            plan = ", {} passes".format(len(db.radix_plan_of(
                keys, bits, s)[1])) if hasattr(db, "radix_plan_of") else ""
            print(f"  {name}: {times[name]:.4f} ms ({len(keys)} keys, "
                  f"{bits} bits{plan})", flush=True)
        name = f"torch.sort {case}"
        times[name] = clock(lambda: torch.sort(keys, stable=True))
        print(f"  {name}: {times[name]:.4f} ms", flush=True)
    return times


def time_build_p2(db, sorts, torch, clock, check) -> dict:
    """D4 by launch and ``build_p2`` as the tree's own code runs them: its
    ``emit_keys`` (a tree whose wrapper takes no U writes a sentinel row
    for every key that is not unique, and its build sorts the stream with
    ``sentinel=``), the stream sort of those keys, ``torch.sort`` over
    them, ``build_emit`` on the sorted U + D rows, the sum of D4's two,
    D4 + the stream sort, and ``build_p2`` whole (its host syncs
    included).  The branch for a tree whose ``emit_keys`` takes no U
    serves parents from before the compacted stream: drop it once no tree
    timed is that old."""
    import inspect
    e = sorts.emit
    k, M = e.k, e.U + len(e.d3)
    compact = "U" in inspect.signature(db.emit_keys).parameters
    args = (e.skeys, e.uniq) + ((e.U,) if compact else ()) + (e.d3, k)
    sent = None if compact else (1 << (3 * k)) - 1
    kw = {} if sent is None else {"sentinel": sent}
    k3 = db.emit_keys(*args)
    times = {}
    steps = (("emit_keys", lambda: db.emit_keys(*args),
              lambda: db.emit_keys_plain(*args)),
             ("radix_sort stream", lambda: db.radix_sort(k3, 3 * k, **kw)[0],
              lambda: db.radix_sort_plain(k3, 3 * k, **kw)[0]),
             ("build_emit", lambda: db.build_emit(e.S, M, k),
              lambda: db.build_emit_plain(e.S, M, k)),
             ("build_p2", lambda: db.build_p2(e.skeys, e.uniq, e.U, e.d3, k),
              lambda: db.build_emit_plain(e.S, M, k)))
    for name, fn, plain in steps:
        if check:
            got, want = fn(), plain()
            for g, w in zip(*((x if isinstance(x, tuple) else (x,))
                              for x in (got, want))):
                exact(torch, g, w, name)
        times[name] = clock(fn)
        print(f"  {name}: {times[name]:.4f} ms", flush=True)
    print(f"    (stream: {len(k3)} keys over {3 * k} bits"
          + ("" if sent is None else f", {M} not the sentinel")
          + f", {len(db.radix_plan_of(k3, 3 * k, sent)[1])} passes)",
          flush=True)
    if check and k3.is_cuda:
        times["build_p2 kernels"] = launch_profile(
            lambda: db.build_p2(e.skeys, e.uniq, e.U, e.d3, k), torch)
    times["torch.sort stream"] = clock(lambda: torch.sort(k3, stable=True))
    times["D4"] = times["emit_keys"] + times["build_emit"]
    times["D4 + radix_sort stream"] = times["D4"] \
        + times["radix_sort stream"]
    for name in ("torch.sort stream", "D4", "D4 + radix_sort stream"):
        print(f"  {name}: {times[name]:.4f} ms", flush=True)
    return times


def make_inputs(port, s, torch, dev, build_only=False):
    """Every kernel's inputs and plain result, from fixed seeds, with the
    first tree's host code (every tree has the same); ``build_only``: D2's
    and D4's alone."""
    if build_only:
        return SimpleNamespace(build_only=True,
                               sorts=sort_inputs(port, s, torch, dev))
    from metagraph_tpu_torch._u32 import np_words
    ops, qd, T = port.ops, port.qd, port.qd.TILE
    rng = np.random.default_rng(7)
    ptab, q = protein_inputs(rng, s, ops)
    ktab, t2, vb = k41_inputs(rng, s, ops, port.tile_pack2, T)
    up = lambda a: np_words(a).to(dev)     # noqa: E731
    inp = SimpleNamespace(build_only=False, q=up(q),
                          p2=torch.from_numpy(t2).to(dev),
                          vb=torch.from_numpy(vb).to(dev), T=T, tables={})
    for kernel, tab in (("key_lookup", ptab), ("codes_lookup", ktab)):
        inp.tables[kernel] = {"": up(tab), " L2 control": up(
            control_table(tab, s["ctrl_log"]))}
    inp.want = {}
    for what, tab in inp.tables["key_lookup"].items():
        inp.want["key_lookup" + what] = ops.key_lookup_plain(inp.q, tab)
    for what, tab in inp.tables["codes_lookup"].items():
        inp.want["codes_lookup" + what] = ops.codes_lookup_plain(
            inp.p2, inp.vb, tab, K41, T, 1024)
    hits = [int((inp.want[k] > 0).sum()) for k in ("key_lookup",
                                                     "codes_lookup")]
    print(f"inputs: {len(q)} keys of {q.shape[1]} words into "
          f"{ptab.shape[0]} buckets; {len(t2)} tiles of K = {K41} into "
          f"{ktab.shape[0]} buckets; hits {hits[0]} and {hits[1]}",
          flush=True)
    inp.sw = [sw_pairs(rng, *shape) for shape in s["sw"]]
    S, L = s["select"]
    inp.select = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 40, (S, L)).astype(np.int32),
        rng.integers(0, 200, S).astype(np.int32),
        rng.integers(1, 40, S).astype(np.int32))]
    inp.half = torch.where(torch.arange(S) % 2 == 0, 0, 2 ** 31 - 1).to(
        dev, torch.int32)
    inp.sparse = sparse_inputs(port, s, torch, dev)
    inp.sorts = sort_inputs(port, s, torch, dev)
    return inp


def time_tree(port, inp, s, torch, dev, reps, check, slots=()):
    """-> {case: ms} for one tree; with ``check``, each kernel's output is
    first held against its plain version's; W1 and W2 also at each of
    ``slots`` windows a warp, where the tree has that setting."""
    clock = (lambda fn: cuda_ms(torch, fn, reps)) if dev.type == "cuda" \
        else host_ms
    if inp.build_only:
        return {} if port.db is None or inp.sorts is None else {
            **time_sorts(port.db, inp.sorts, torch, clock, check),
            **time_build_p2(port.db, inp.sorts, torch, clock, check)}
    ops, qd, T = port.ops, port.qd, inp.T
    cases = []
    for what, tab in inp.tables["key_lookup"].items():
        cases.append((f"key_lookup{what}",
                      lambda what=what: inp.want["key_lookup" + what],
                      lambda tab=tab: ops.key_lookup(inp.q, tab)))
    for what, tab in inp.tables["codes_lookup"].items():
        cases.append((f"codes_lookup{what}",
                      lambda what=what: inp.want["codes_lookup" + what],
                      lambda tab=tab: ops.codes_lookup(inp.p2, inp.vb, tab,
                                                       K41, T)))
    for (B, LQ, LR), (qs, rs) in zip(s["sw"], inp.sw):
        qt, rt = torch.from_numpy(qs).to(dev), torch.from_numpy(rs).to(dev)
        cases.append((f"sw_scores {B}x{LQ}x{LR}",
                      lambda qt=qt, rt=rt: port.sw.sw_scores_plain(
                          qt, rt, 2, -3, -6, -2),
                      lambda qt=qt, rt=rt: port.sw.sw_scores(qt, rt)))
    counts, present, dsel = inp.select
    for what, selmin in (("every row", torch.zeros_like(present)),
                         ("half the rows", inp.half)):
        args = (counts, present, dsel, selmin)
        cases.append((f"selection_mask {tuple(counts.shape)} {what}",
                      lambda args=args: qd.selection_mask_plain(*args),
                      lambda args=args: qd.selection_mask(*args)))
    times = {}
    for name, plain, fn in cases:
        if check:
            exact(torch, fn(), plain(), name)
        times[name] = clock(fn)
        print(f"  {name}: {times[name]:.4f} ms", flush=True)
    times.update(time_sparse(port.sd, inp.sparse, torch, dev, clock, check))
    words = inp.sparse.words
    if port.dm is not None and words is not None:
        for name, (anno, w) in words.cases.items():
            fn = getattr(port.dm, name.split()[0])
            if check:
                exact(torch, fn(anno, w), words.want[name], name)
            times[name] = clock(lambda: fn(anno, w))
            print(f"  {name}: {times[name]:.4f} ms", flush=True)
        if check and dev.type == "cuda" \
                and "row_words_split" in getattr(port.build, "VARIANTS", {}):
            times["split"] = load_split(port, words, torch)
            times["kernels"] = kernel_profile(port.dm, words, torch)
        if hasattr(port.dm, "SLOTS"):
            times.update(time_slots(port.dm, words, slots, torch, clock))
    if port.db is not None and inp.sorts is not None:
        times.update(time_sorts(port.db, inp.sorts, torch, clock, check))
        times.update(time_build_p2(port.db, inp.sorts, torch, clock, check))
    return times


def launch_profile(fn, torch, calls=5) -> dict:
    """{kernel: device ms a call} of what ``fn`` launches (memsets
    included), a mean over ``calls`` calls, from torch.profiler; {} where
    the profiler records no device time."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or 0
        if us > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            name = re.split(r"[(<]", name)[0][:48]
            ms[name] = ms.get(name, 0.0) + us / calls / 1e3
    print("    device ms a call: " + ", ".join(
        f"{n} {v:.4f}" for n, v in sorted(ms.items(), key=lambda x: -x[1])),
        flush=True)
    return ms


def kernel_profile(dm, words, torch, calls=5) -> dict:
    """The device ms of each kernel that a W1 or W2 call launches (W2's
    steps one by one), a mean over ``calls`` calls (``launch_profile``)."""
    out = {}
    for name, (anno, w) in words.cases.items():
        fn = getattr(dm, name.split()[0])
        print(f"  kernels of {name}:", flush=True)
        out[name] = launch_profile(lambda: fn(anno, w), torch, calls)
    return out


def time_slots(dm, words, slots, torch, clock) -> dict:
    """W1 and W2 again with at most each of ``slots`` windows a warp
    (device_matrix.SLOTS; the trees' stack bound holds for fewer)."""
    times, keep = {}, dm.SLOTS
    try:
        for n in slots:
            dm.SLOTS = n
            for name, (anno, w) in words.cases.items():
                fn = getattr(dm, name.split()[0])
                exact(torch, fn(anno, w), words.want[name], name)
                key = f"{name} slots={n}"
                times[key] = clock(lambda: fn(anno, w))
                print(f"  {key}: {times[key]:.4f} ms", flush=True)
    finally:
        dm.SLOTS = keep
    return times


def load_split(port, words, torch) -> dict:
    """W1's and W2's descents in the split build (csrc/row_words.cu,
    MG_ROW_WORDS_SPLIT), one launch a case: the cycles a lane waits on the
    node load and on the word load per node it loads, a round's cycles
    and the lanes that load a node per round."""
    import ctypes
    dm, out = port.dm, {}
    read = port.build.function("row_words_split", "mg_row_words_split",
                               [ctypes.c_void_p])
    buf = (ctypes.c_ulonglong * 5)()
    dm.LIBRARY = "row_words_split"
    try:
        for name, (anno, w) in words.cases.items():
            fn = getattr(dm, name.split()[0])
            torch.cuda.synchronize()
            port.build.check(read(buf), "mg_row_words_split")
            exact(torch, fn(anno, w), words.want[name], name + " (split)")
            torch.cuda.synchronize()
            port.build.check(read(buf), "mg_row_words_split")
            node, word, rnd, rounds, loads = (int(x) for x in buf)
            out[name] = {"node wait / load": node / max(loads, 1),
                         "word wait / load": word / max(loads, 1),
                         "cycles / round": rnd / max(rounds, 1),
                         "loads / round": loads / max(rounds, 1),
                         "rounds": rounds}
            print(f"  split {name}: {out[name]}", flush=True)
    finally:
        dm.LIBRARY = "row_words"
    return out


def time_sparse(sd, sp, torch, dev, clock, check):
    """S1 on each of its cases, then S2, into buffers zeroed once: each
    launch adds into them, as a caller's zeroed buffers take one batch.
    S1 reads its table as a SparseOnDevice holds it (row records, where the
    tree has them)."""
    times = {}
    for name, (i, ts, e, d, S, L, P) in sp.cases.items():
        if hasattr(sd, "row_records"):   # the views a SparseOnDevice holds
            rec = sd.row_records(e, d)
            e, d = rec[:, :e.shape[1]], rec[:, e.shape[1]]
        out = sparse_zeros(torch, dev, S, L, P)
        if check:
            sd.sparse_label_counts(i, ts, e, d, *out)
            for g, w in zip(out, sp.want[name]):
                exact(torch, g, w, name)
        times[name] = clock(lambda: sd.sparse_label_counts(i, ts, e, d,
                                                           *out))
        print(f"  {name}: {times[name]:.4f} ms", flush=True)
        del out
    counts, _, mult = sp.want["sparse_label_counts"]
    for what, m, want in (("", mult, sp.want["overflow_counts"]),
                          (" no multiplicities", torch.zeros_like(mult),
                           counts)):
        name = "overflow_counts" + what
        got = counts.clone()
        if check:
            sd.overflow_counts(got, m, sp.dense8)
            exact(torch, got, want, name)
        times[name] = clock(lambda: sd.overflow_counts(got, m, sp.dense8))
        print(f"  {name}: {times[name]:.4f} ms", flush=True)
    return times


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append",
                    help="a tree to time (repeat to time several in turns)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--slots", default="",
                    help="comma-separated windows a warp at which W1 and W2 "
                         "are timed again (device_matrix.SLOTS)")
    ap.add_argument("--build-only", action="store_true",
                    help="time D2 and D4 alone (their inputs take about 2 "
                         "minutes; the other kernels' are not made)")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU with the plain versions; "
                         "exits 2 without a result")
    args = ap.parse_args(argv)
    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in
             args.root or [os.path.dirname(os.path.dirname(here))]]
    dev = torch.device("cpu" if args.rehearse else "cuda")
    s = TINY if args.rehearse else FULL
    ports = [load_port(r) for r in roots]
    if not args.rehearse:
        print(card(), flush=True)
    t0 = time.perf_counter()
    inp = make_inputs(ports[0], s, torch, dev, args.build_only)
    print(f"inputs made in {time.perf_counter() - t0:.1f} s", flush=True)
    turns = ports + ports[::-1] if len(ports) > 1 else ports
    times = {p.root: [] for p in ports}
    for i, port in enumerate(turns):
        print(f"turn {i + 1}: {port.root}", flush=True)
        times[port.root].append(time_tree(
            port, inp, s, torch, dev, args.reps, not times[port.root],
            [int(n) for n in args.slots.split(",") if n]))
    if args.rehearse:
        print("rehearsal finished: no result on the CPU", file=sys.stderr)
        return 2
    print(json.dumps({"ms": times, "card": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
