#!/usr/bin/env python3
"""Smoke test of metagraph_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out DIR]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It builds the port's kernels from ``metagraph_tpu_torch/csrc``,
then:

1. prints the card (``nvidia-smi``) and the build time;
2. drives the main path at full size: a dense-annotated k = 31 DNA index of
   over 8 M k-mers and 1,000 labels, made from ``--seed``, queried through
   ``QueryEngine.query_records`` with one batch of 150,000 reads of 200 bp
   (1% substitutions, some N runs) plus one sequence of more than 2^24
   windows, in the labels and counts modes, and holds the payloads of a
   sample and of the long sequence against an independent numpy oracle;
3. holds kernels 1-3 against their plain PyTorch versions on the main
   path's own inputs, exactly, and times both;
4. runs ``batch_local_align_scores`` (kernel 4) on 4,096 pairs and holds it
   against its plain version and, on a sample, the numpy oracle.

Launch counters are set to 0 just before each driven path and read just
after; comparison launches do not count.  The second-to-last line of
stdout is a JSON object with every kernel's numbers, the last is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without CUDA the script exits 1 before printing a result.  Long compiler
reports go to ``--out``.

``--rehearse`` runs the same phases at a tiny size on the CPU with the
plain versions (no build, no card) and exits 2 without a result: a dry run
of the control flow.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 31
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 rate outside tensor cores

FULL = dict(n_refs=1000, base_len=8101, repeat=(1000, 1300), n_reads=150_000,
            read_len=200, long_windows=1 << 24, sample=2000,
            sw=(4096, 150, 300), sw_oracle=12, plain_chunks=(1024, 256))
TINY = dict(n_refs=24, base_len=501, repeat=(100, 160), n_reads=300,
            read_len=120, long_windows=5000, sample=60,
            sw=(40, 37, 60), sw_oracle=4, plain_chunks=(16, 8))


def log(msg: str):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def device_ms(torch, dev, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` runs after one warm-up run, by CUDA
    events (a host clock on the CPU, rehearsals only)."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max().item())


# --------------------------------------------------------------------------
# the index and the batch, from the seed
# --------------------------------------------------------------------------

def window_keys(codes: np.ndarray, k: int):
    """(n,) codes 0..3 (4 = N) -> (n-k+1,) uint64 2-bit keys (char i at bits
    2i) and the windows' validity."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    c = codes.astype(np.uint64) & np.uint64(3)
    key = np.zeros(n, dtype=np.uint64)
    for i in range(k):
        key |= c[i: i + n] << np.uint64(2 * i)
    bad = np.concatenate([[0], np.cumsum(codes >= 4)])
    return key, (bad[k:] - bad[:-k]) == 0


def make_index(cfg, rng):
    """Random references, one label each; each carries a repeat of part of
    itself, so some k-mers occur twice (annotation value 2)."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu_torch.annotation.ops import pack_annotation_bitmap
    from metagraph_tpu_torch.succinct.ops import pack_kmers32
    a, b = cfg["repeat"]
    refs = []
    for _ in range(cfg["n_refs"]):
        base = rng.integers(0, 4, cfg["base_len"]).astype(np.uint8)
        refs.append(np.concatenate([base, base[a:b]]))
    keys, labs = [], []
    for i, r in enumerate(refs):
        kk, _ = window_keys(r, K)
        keys.append(kk)
        labs.append(np.full(len(kk), i, np.int64))
    keys, labs = np.concatenate(keys), np.concatenate(labs)
    pairs, mult = np.unique(np.stack([keys, labs.astype(np.uint64)], 1),
                            axis=0, return_counts=True)
    ukeys, row_of_pair = np.unique(pairs[:, 0], return_inverse=True)
    pair_label = pairs[:, 1].astype(np.int64)
    R, L = len(ukeys), len(refs)
    # rows -> (label, value) pairs, sorted by row (pairs are key-sorted)
    csr_start = np.searchsorted(row_of_pair, np.arange(R + 1))
    chars = np.empty((R, K), np.uint8)
    for i in range(K):
        chars[:, i] = ((ukeys >> np.uint64(2 * i)) & np.uint64(3)) + 1
    order = np.lexsort((row_of_pair, pair_label))
    col_start = np.searchsorted(pair_label[order], np.arange(L + 1))
    cols = [row_of_pair[order[col_start[c]:col_start[c + 1]]]
            for c in range(L)]
    vals = [mult[order[col_start[c]:col_start[c + 1]]] for c in range(L)]
    labels = [f"ref{i}" for i in range(L)]
    anno = ColumnMajorAnnotation(R, labels, cols, values=vals,
                                 has_values=True)
    index = convert.from_kmers(pack_kmers32(chars),
                               np.arange(1, R + 1, dtype=np.uint32),
                               pack_annotation_bitmap(anno, R), labels, K,
                               anno)
    oracle = dict(keys=ukeys, row_of_pair=row_of_pair, pair_label=pair_label,
                  mult=mult, csr_start=csr_start, L=L)
    return refs, index, oracle


def make_batch(cfg, rng, refs):
    """Reads drawn from the references (10% reverse-complemented, 1%
    substitutions, 3% with an N run) and one long sequence: reference 0
    repeated an odd number of times until its label's count passes
    ``long_windows`` (2^24 at full size) and is odd."""
    n, m = cfg["n_reads"], cfg["read_len"]
    which = rng.integers(0, len(refs), n)
    start = rng.integers(0, len(refs[0]) - m, n)
    cat = np.concatenate(refs)
    offs = np.concatenate([[0], np.cumsum([len(r) for r in refs])])
    codes = cat[(offs[which] + start)[:, None] + np.arange(m)]
    sub = rng.random((n, m)) < 0.01
    codes = np.where(sub, (codes + rng.integers(1, 4, (n, m))) % 4, codes)
    rc = rng.random(n) < 0.1
    codes[rc] = 3 - codes[rc, ::-1]
    nrun = np.flatnonzero(rng.random(n) < 0.03)
    for i in nrun:
        at = int(rng.integers(0, m - 20))
        codes[i, at: at + int(rng.integers(1, 20))] = 4
    codes = codes.astype(np.uint8)
    per_copy = len(refs[0]) - K + 1
    reps = cfg["long_windows"] // per_copy + 1
    reps += 1 - reps % 2
    long_codes = np.tile(refs[0], reps)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seqs = [letters[row].tobytes() for row in codes]
    seqs.append(letters[long_codes].tobytes())
    return seqs, list(codes) + [long_codes], reps * per_copy


def oracle_payload(codes, mode, o, df=0.7, pf=0.0, top=2 ** 63):
    """Independent numpy oracle: sorted uint64 keys + searchsorted, exact
    bincounts, get_min_count."""
    import math
    keys, valid = window_keys(codes, K)
    nk = len(keys)
    if nk == 0:
        return []
    pos = np.minimum(np.searchsorted(o["keys"], keys), len(o["keys"]) - 1)
    hit = valid & (o["keys"][pos] == keys)
    rows = pos[hit]
    present = len(rows)
    lo, hi = o["csr_start"][rows], o["csr_start"][rows + 1]
    span = hi - lo
    pidx = np.repeat(lo - np.cumsum(np.concatenate([[0], span[:-1]])),
                     span) + np.arange(span.sum())
    counts = np.bincount(o["pair_label"][pidx], minlength=o["L"])
    if present < max(1.0, math.ceil(pf * nk)):
        return []
    min_count = int(max(1.0, math.ceil(df * nk)))
    if present < min_count:
        return []
    sel = [c for c in range(o["L"]) if counts[c] >= min_count]
    if mode == "labels":
        return [f"ref{c}" for c in sel]
    sel = sorted(sel, key=lambda c: (-counts[c], c))[:top]
    out = []
    win = np.flatnonzero(hit)
    for c in sel:
        ab = np.zeros(nk, dtype=np.int64)
        mine = o["pair_label"][pidx] == c
        owner = np.repeat(np.arange(len(rows)), span)[mine]
        ab[win[owner]] = o["mult"][pidx[mine]]
        out.append((f"ref{c}", int(counts[c]), ab))
    return out


def same_payload(got, want) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            if g[:2] != w[:2] or not np.array_equal(g[2], w[2]):
                return False
        elif g != w:
            return False
    return True


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def card_and_build(rehearse: bool, out_dir: str):
    if rehearse:
        return "rehearsal on the CPU, no card", 0.0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(card)
    from metagraph_tpu_torch import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, (_, report) in built.items():
            f.write(f"== {name}\n{report}\n")
    for name, (s, report) in built.items():
        regs = [ln.split("Used", 1)[1].strip() for ln in report.splitlines()
                if "Used" in ln]
        log(f"built {name} in {s:.1f} s; ptxas: {'; '.join(regs)}")
    log(f"build: {secs:.1f} s for {len(built)} kernel libraries")
    return card, secs


def counters():
    from metagraph_tpu_torch.align.sw import sw_scores
    from metagraph_tpu_torch.query.device import label_counts, selection_mask
    from metagraph_tpu_torch.succinct.ops import wire_lookup
    return {"wire_lookup": wire_lookup, "label_counts": label_counts,
            "selection_mask": selection_mask, "sw_scores": sw_scores}


def run_path(fn):
    """Zero every launch counter, run ``fn``, read the counters."""
    fns = counters()
    for f in fns.values():
        f.launches = 0
    out = fn()
    return out, {name: f.launches for name, f in fns.items()}


def main_path(engine, seqs, codes, oracle, cfg, rng, torch, dev):
    from metagraph_tpu_torch.seq_io.fasta import FastaRecord
    records = [FastaRecord(f"r{i}", s) for i, s in enumerate(seqs)]
    windows = sum(max(len(s) - K + 1, 0) for s in seqs)
    total_bp = sum(len(s) for s in seqs)
    sample = np.sort(rng.choice(len(seqs) - 1, cfg["sample"], replace=False))
    sample = np.append(sample, len(seqs) - 1)          # the long sequence
    launches, report = {}, {}
    for mode in ("labels", "counts"):
        def drive():
            t0 = time.perf_counter()
            res = list(engine.query_records(records, mode))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        (results, secs), launches[mode] = run_path(drive)
        st = engine.last_batch_seconds
        log(f"main path [{mode}]: {len(seqs)} sequences, {total_bp} bp, "
            f"{windows} k-mers in {secs:.3f} s = {windows / secs:.4g} "
            f"k-mers/s (host packing {st['pack']:.3f} s, device incl. "
            f"upload and mask download {st['device']:.3f} s, payloads "
            f"{st['collect']:.3f} s); launches {launches[mode]}")
        if len(results) != len(seqs):
            raise AssertionError(f"{len(results)} results for {len(seqs)} "
                                 "sequences")
        bad = [i for i in sample if not same_payload(
            results[i].payload, oracle_payload(codes[i], mode, oracle))]
        if bad:
            raise AssertionError(f"{mode}: payloads differ from the oracle "
                                 f"for sequences {bad[:10]}")
        hits = sum(bool(results[i].payload) for i in sample)
        log(f"  oracle: {len(sample)} sequences equal ({hits} with hits)")
        if mode == "counts":
            long_res = results[-1].payload
            report["long_count"] = long_res[0][1] if long_res else 0
        report[f"{mode}_seconds"] = secs
    n = report["long_count"]
    log(f"long sequence: {len(seqs[-1]) - K + 1} windows, label count {n} "
        f"(> 2^24: {n > 1 << 24}; float32 would hold {int(np.float32(n))})")
    if cfg is FULL and not (n > 1 << 24 and int(np.float32(n)) != n):
        raise AssertionError("the long sequence does not test the 2^24 bound")
    for mode, got in launches.items():
        for name in ("wire_lookup", "label_counts", "selection_mask"):
            if dev.type == "cuda" and got[name] < 1:
                raise AssertionError(f"{name} never launched in the {mode} "
                                     "run of the main path")
    report["windows"] = windows
    return launches["labels"], report


def kernel_checks(engine, seqs, cfg, torch, dev):
    """Kernels 1-3 against their plain versions on the main path's inputs
    (the same batch, packed as query_batch_fused packs it)."""
    from metagraph_tpu_torch._u32 import np_words, to_u64
    from metagraph_tpu_torch.query import device as qd
    from metagraph_tpu_torch.query.tile_pack import tile_pack2
    from metagraph_tpu_torch.succinct import ops
    S, L = len(seqs), len(engine.labels)
    tiles2, validb, tile_seq, nwins = tile_pack2(seqs, K, qd.TILE)
    N = len(tiles2)
    words, vwords = qd.wire_words_layout(tiles2, validb, K, qd.TILE, N)
    dsel, selmin = qd._thresholds(nwins, 0.7, 0.0)
    words, vwords = np_words(words).to(dev), np_words(vwords).to(dev)
    tile_seq, dsel, selmin = (torch.from_numpy(a).to(dev)
                              for a in (tile_seq, dsel, selmin))
    table, bitmap = engine.hash_index.table, engine.annotation.bitmap
    c1, c2 = cfg["plain_chunks"]
    entries = {}

    def entry(name, got, want, ms, plain_ms, nbytes):
        err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        entries[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by="bytes")
        log(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
            f"{bound:.4f} ms from {nbytes} bytes), max_abs_err {err}")
        if err:
            raise AssertionError(f"{name} disagrees with its plain version")

    def plain_ms(fn):
        return device_ms(torch, dev, fn, 1)

    nodes = qd.wire_lookup(words, vwords, table, K, qd.TILE)
    nodes_p = ops.wire_lookup_plain(words, vwords, table, K, qd.TILE, c1)
    # bytes the data needs: the tile words, the bucket rows probed (each
    # once) and the node ids written
    nb, W = table.shape[0], table.shape[1] // ops.BUCKET - 1
    touched = torch.zeros(nb, dtype=torch.bool, device=dev)
    for lo in range(0, N, c1):
        wd, vw = to_u64(words[lo: lo + c1]), to_u64(vwords[lo: lo + c1])
        keys = ops.keys2_to_keys4(ops.extract_windows2(wd, K, qd.TILE), K)
        valid = ops.window_valid2(vw, K, qd.TILE)
        touched[ops._hash_words(keys[valid], nb, 1)] = True
    entry("wire_lookup", [nodes], [nodes_p],
          device_ms(torch, dev, lambda: qd.wire_lookup(
              words, vwords, table, K, qd.TILE), 10),
          plain_ms(lambda: ops.wire_lookup_plain(words, vwords, table, K,
                                                 qd.TILE, c1)),
          words.nbytes + vwords.nbytes + nodes.nbytes
          + int(touched.sum()) * 64 * (W + 1))

    counts, present = qd.label_counts(nodes, bitmap, tile_seq, S, L)
    want = qd.label_counts_plain(nodes, bitmap, tile_seq, S, L, c2)
    rows = int(torch.unique(nodes[nodes > 0]).numel())
    entry("label_counts", [counts, present], want,
          device_ms(torch, dev, lambda: qd.label_counts(
              nodes, bitmap, tile_seq, S, L), 10),
          plain_ms(lambda: qd.label_counts_plain(nodes, bitmap, tile_seq, S,
                                                 L, c2)),
          nodes.nbytes + tile_seq.nbytes + rows * bitmap.shape[1] * 4
          + counts.nbytes + present.nbytes)

    mask = qd.selection_mask(counts, present, dsel, selmin)
    entry("selection_mask", [mask],
          [qd.selection_mask_plain(counts, present, dsel, selmin)],
          device_ms(torch, dev, lambda: qd.selection_mask(
              counts, present, dsel, selmin), 20),
          plain_ms(lambda: qd.selection_mask_plain(counts, present, dsel,
                                                   selmin)),
          counts.nbytes + 3 * present.nbytes + mask.nbytes)
    return entries


def sw_phase(cfg, rng, torch, dev):
    from metagraph_tpu_torch.align.sw import (batch_local_align_scores,
                                              reference_local_align_score,
                                              sw_scores, sw_scores_plain)
    B, LQ, LR = cfg["sw"]
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

    def drive():
        t0 = time.perf_counter()
        out = batch_local_align_scores(qs, rs, device=dev)
        return out, time.perf_counter() - t0
    (scores, secs), launches = run_path(drive)
    q, r = torch.from_numpy(qs).to(dev), torch.from_numpy(rs).to(dev)
    want = sw_scores_plain(q, r, 2, -3, -6, -2)
    err = max_abs_err(torch, torch.from_numpy(scores).to(dev), want)
    pick = rng.choice(B, cfg["sw_oracle"], replace=False)
    oracle = [reference_local_align_score(qs[b], rs[b]) for b in pick]
    if err or not np.array_equal(scores[pick], oracle):
        raise AssertionError("sw_scores disagrees with its plain version or "
                             "the oracle")
    ms = device_ms(torch, dev, lambda: sw_scores(q, r), 10)
    plain = device_ms(torch, dev, lambda: sw_scores_plain(q, r, 2, -3, -6,
                                                          -2), 1)
    nbytes = (qs.nbytes + rs.nbytes + 4 * B)
    ops_ = 12 * B * LQ * LR       # int32 operations of the recurrence
    bound = max(nbytes / HBM_BYTES_PER_S, ops_ / CUDA_CORE_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S \
        > ops_ / CUDA_CORE_OPS_PER_S else "operations"
    if dev.type == "cuda" and launches["sw_scores"] < 1:
        raise AssertionError("sw_scores never launched in the SW phase")
    log(f"SW phase: {B} pairs of {LQ} x {LR} in {secs:.3f} s through "
        f"batch_local_align_scores; kernel {ms:.4f} ms = {B / ms * 1e3:.4g} "
        f"pairs/s (plain {plain:.2f} ms, bound {bound:.4f} ms by "
        f"{bound_by}); {len(pick)} pairs equal to the oracle; launches "
        f"{launches['sw_scores']}")
    return launches["sw_scores"], dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain, bound_ms=bound,
                                       bound_by=bound_by)


SOURCES = {
    "wire_lookup": ("metagraph_tpu_torch/csrc/wire_lookup.cu",
                    "metagraph_tpu/succinct/ops.py:439"),
    "label_counts": ("metagraph_tpu_torch/csrc/label_counts.cu",
                     "metagraph_tpu/query/device.py:107"),
    "selection_mask": ("metagraph_tpu_torch/csrc/selection_mask.cu",
                       "metagraph_tpu/query/device.py:168"),
    "sw_scores": ("metagraph_tpu_torch/csrc/sw_scores.cu",
                  "metagraph_tpu/align/pallas_sw.py:35"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chip_smoke"))
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU with the plain versions; "
                         "exits 2 without a result")
    args = ap.parse_args(argv)
    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    cfg = TINY if args.rehearse else FULL
    dev = torch.device("cpu" if args.rehearse else "cuda")
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    card, _ = card_and_build(args.rehearse, args.out)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    refs, index, oracle = make_index(cfg, rng)
    log(f"index: {index.num_rows} k-mers (k = {K}), {len(index.labels)} "
        f"labels; hash table {index.table.shape} = {index.table.nbytes} B, "
        f"bitmap {index.bitmap.shape} = {index.bitmap.nbytes} B; made in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = QueryEngine(index, device=dev)
    seqs, codes, long_windows = make_batch(cfg, rng, refs)
    launches, _ = main_path(engine, seqs, codes, oracle, cfg, rng, torch,
                            dev)
    entries = kernel_checks(engine, seqs, cfg, torch, dev)
    launches["sw_scores"], entries["sw_scores"] = sw_phase(cfg, rng, torch,
                                                           dev)
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        e = entries[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"], "library_ms": None})
    log("kernels: " + ", ".join(
        f"{k['name']} launches={k['launches']} "
        f"match={'exact' if k['max_abs_err'] == 0 else 'NO'}"
        for k in kernels))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if args.rehearse:
        print("rehearsal finished: no result on the CPU", file=sys.stderr)
        return 2
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
