#!/usr/bin/env python3
"""Smoke test of metagraph_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out DIR] [--work DIR]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It builds the port's kernels from ``metagraph_tpu_torch/csrc``,
then:

1. prints the card (``nvidia-smi``) and the build time;
1a. builds two graphs at k = 21 with the device construction (kernels
   D1-D4 of ``succinct/device_build.py``), each through the port's CLI
   (``build --device -v``, its ``main`` in this process, so that the
   launch counters show) from a FASTA file it writes from the seed's
   stream 8: "pan", a pan-genome of 3 random base genomes of
   4,000,000 bp with 4 strains each at 1% substitutions (15 references,
   60,000,000 bp, 3 N runs a reference), and "reads", 100,000 reads of
   150 bp from the strains, half reverse-complemented, 1% substitutions,
   3% with an N run (several hundred thousand dummy sink and source
   nodes).  For each: the wall and the phases the build traced; D1-D4
   against their plain versions on the card, step by step through the
   build on its own inputs (every output whole, exactly; the kernels' W,
   last, valid and F equal to the file's), each timed beside its plain
   version and D2 beside ``torch.sort(stable=True)`` over the same keys
   (a line a sort: n, bits, the passes its plan runs, ms, torch.sort's ms
   and the pass floor of 16 B a key a pass);
   an independent oracle (the valid edges are the distinct valid windows,
   numpy 2-bit keys sorted and deduped, label by label, and 100,000
   edges decoded with ``BOSS.get_edge_seq`` are among them); and, for
   "pan", the file loaded back through ``DBGSuccinct.load`` and
   ``convert.from_graph`` (one label on every valid edge), queried with
   100,000 of the input's windows through ``QueryEngine.query_batch``
   (kernels 1, 2, 3): each must come back labelled; "pan" is built with
   ``--index-ranges 8``, and each of the 65,536 ranges must hold as many
   nodes as a numpy count of the distinct nodes (dummy source nodes
   among them) ending in its 8 characters;
1b. builds three more graphs through the port's CLI, each checking the
   route its ``-v`` line names and held to an independent numpy oracle
   (the valid edges are the distinct k-mers of the collector, 100,000
   decoded edges among them): "pan-canonical", the pan-genome at k = 21
   with ``--mode canonical`` (the device route, D1's strand mode: D1-D4
   step by step against their plain versions as in 1a, the oracle the
   distinct keys of both strands); "reads-k31-counts", the read set at k =
   31 with ``--mode canonical --count-kmers`` (the general route, 2 words
   a k-mer; each sampled edge's weight its multiplicity over both strands,
   capped at 255); "protein-k20-disk", the protein deployment's 1,000
   references (below) at k = 20 with ``--disk-swap`` and ``--mem-cap-gb
   0.04`` (the general route in bounded RAM, 3 words a k-mer, at least 4
   spilled chunks).  The general route's builds run again through
   ``DBGSuccinct.build`` with the CLI's arguments (protein: the same disk
   swap and memory cap, spilling as many chunks), every D2 call held whole
   against ``radix_sort_plain`` and timed beside a stable ``torch.sort``
   with its payload's gather (a line a sort), their launches and arrays
   equal to the CLI build's; protein's arrays also equal to an uncapped
   build's;
2. drives the main path at full width: a dense-annotated k = 31 DNA index
   of over 8 M k-mers and 1,000 labels, made from ``--seed``, queried
   through ``QueryEngine.query_records`` with one batch of 20,000 reads of
   200 bp (the first of a batch of 150,000: 1% substitutions, some N
   runs) plus one sequence of more than 2^24
   windows, in the labels and counts modes, and holds the payloads of a
   sample and of the long sequence against an independent numpy oracle;
3. holds kernels 1-3 against their plain PyTorch versions on the main
   path's own inputs, exactly, and times both; times kernels 1 and 2 again
   on L2-resident controls (a 2^15-bucket table, ids remapped to 4,096
   rows), also held against their plain versions; runs kernel 3 on a
   control with selmin = 0 for every row (all counts read), exact and
   timed beside ``torch.amax`` over the same counts;
3a. queries the same batch cut into ``par_batches`` batches in the labels
   mode sequentially and with ``par_threads`` batches in flight (``query
   -p``): the same output bytes and exactly the same launches of every
   kernel; both walls printed;
3b. runs the JAX package's own workload (its ``bench.py`` and
   ``__graft_entry__``'s epochs, ROADMAP A10) on the basic references,
   built by the port's ``DBGSuccinct.build`` at k = 31 with their 1,000
   labels placed on its node ids, and the basic batch's 150,000 reads:
   ``DeviceQueryPipeline.query_labels`` (labels, matches),
   ``query_step``, ``query_epoch_tiled``, ``query_epoch_codes`` and
   ``query_epoch_dedup`` after ``dedup_batch`` (kernels A and 2, D2 in
   the distinct pass): every epoch's counts and presence equal, a
   sample's equal to the oracle's, as are its payloads; each epoch's
   seconds and device ms (torch.profiler, each epoch run once more
   outside the counted run), the distinct share; kernels A and 2 against
   their plain versions at these shapes;
3c. builds through the port's CLI ``--graph bitmap`` (the basic
   references), ``--graph hash --mode canonical`` and ``--graph sshash``
   (the wide DNA references of 5d) at k = 31: each file's k-mers and ids
   equal to those computed here (rank in sorted order; for hash, first
   occurrence in the stream of each reference's windows, then its
   reverse complement's), every D2 call held against its plain version
   as the build runs (as in all of 3b and 3c); ``--suffix`` A, C, G,
   T and $ of the wide DNA references: each chunk's k-mers end their
   node in the suffix, are distinct windows of the input and together
   all of them, $ empty; a KMC database written here of the canonical
   21-mers of the wide DNA references and their first stream's reads
   with their counts, built with ``--mode canonical --count-kmers`` (k
   from the database, with its warning): the valid edges both strands'
   distinct keys, a sample's weights their counts capped at 255;
4. drives the same query path on a primary graph (the references' forward
   k-mers, queried through CanonicalDBG: canon 2) in the labels and counts
   modes and on a canonical graph (both strands, about 16 M k-mers: canon
   1) in the labels mode, with a batch of reads from both strands and a
   long sequence of more than 2^24 windows that hits only through the
   reverse-complement probe; payloads against the oracle, and the canon
   modes of kernels 1 and 2 against their plain versions;
5. drives a k = 41 graph of the same references (keys of 6 words: the
   codes route, kernels B, 2, 3) with values and coordinates, on the basic
   batch's reads and a long sequence of more than 2^24 windows, in the
   labels, counts-sum and coords modes (coords on a prefix of the reads),
   and a Protein graph at k = 20 (8-bit keys, 5 words: the map route,
   kernel A, then kernels 2, 3) of 1,000 random protein references, with
   20,000 reads of 200 residues, in the labels and matches modes;
   payloads against the oracle, kernels A, B, 2 and 3 against their plain
   versions on each path's own inputs, and A and B again on L2-resident
   controls (2^15-bucket tables), also held against their plain versions;
5a. drives the basic graph's table and batch with a converted annotation
   of 4,096 labels ("many-labels"): each row of references 16-999 carries
   1-3 random labels, each row of reference r < 16 carries pattern r of
   48-64 labels.  It is saved as a ``.brwt.annodbg`` (the port's
   ``BRWT.from_columns``, arity 2) with its ``.devsparse.npz`` (the port's
   ``DeviceBlockSparseAnno.from_columns``, as ``transform_anno --anno-type
   devsparse`` writes it), loaded back through ``load_annotation`` and
   ``convert.from_annotation``, whose dense bitmap (4.15 GB) would pass
   the 2 GiB budget, so the index is block-sparse: kernels 1, then S1 and
   S2 in kernel 2's place, then 3.  Labels and matches modes; payloads
   against the oracle; S1 and S2 against their plain versions exactly on
   the path's own inputs (the long sequence puts more than 2^24 windows on
   pattern 0), S1 timed beside ``index_add_`` over the keys it forms (and
   the 32 B sectors its data touches printed beside its bound), S2 beside
   ``torch.mm`` in float64, which computes its function exactly;
5b. drives the same columns past a budget of 32,768 bytes, which the 16
   overflow patterns pass, so the index keeps them compressed on the card
   (the words route: kernels 1, W1 or W2, 2, 3): "words-brwt" loads a copy
   of the many-labels .brwt.annodbg without its .devsparse.npz,
   "words-rowdiff" a row_diff_brwt of the same columns built by
   ``RowDiff.from_annotation`` along the references (anchors every 100
   windows); each must take the words form and write no cache.  Labels
   and matches modes on the first 15,000 reads and reference 0 once;
   payloads against the oracle; W1 and W2 against their plain versions
   exactly on the first and the last words chunk of the batch (which hold
   pattern rows), timed on the first, and kernel 2 on that chunk's words;
   W2's walks of the first chunk counted (steps of a walk a window,
   distinct rows, forward-linked windows, tails and their chain steps);
5c. drives the k41 index with a ``.seqs`` mapping (the port's
   ``CoordToHeader``, saved and loaded back) that splits each label into
   ``seqs_headers`` headers of consecutive k-mers, on the first
   ``coords_prefix`` reads in the labels, matches and coords modes: every
   batch maps through kernel A (W = 6), then aggregates per header on the
   host, and no codes epoch runs; payloads against an independent oracle
   (per-header k-mer membership by coordinate range), kernel A against its
   plain version;
5d. drives four deployments of keys wider than 8 words from a sixth
   stream of the seed (``WIDE``: 200 references of 8,101 bp or residues,
   20,000 reads of 200, 0.2% substitutions): DNA k = 70 basic (the codes
   route, kernel B at W = 9, its key a word at a time) and canonical (the
   map route, kernel A at W = 9), Protein k = 40 (kernel A at W = 10) and
   k = 80 (kernel A's warp form, W = 20), in the labels mode; payloads
   against the oracle, kernels B or A (with an L2 control), 2 and 3
   against their plain versions;
5e. drives graphs that are not succinct, each loaded from the
   ``.dbg.npz`` that 3c's CLI build wrote in the JAX package's layout
   (``graph_type``, ``k``, ``mode``, ``kmers``, ``ids``, ``alphabet``)
   through ``DBGSuccinct.load``, which rebuilds their node ids, and
   ``convert.from_graph``: the map route (kernel A, then kernels 2, 3).
   "bitmap" holds the basic deployment's k-mers (node id = rank in
   left-to-right code order; its annotation is the basic one with rows
   moved to those ids), queried with the basic batch's first
   ``bitmap_reads`` reads (10,000: the script's depth cuts, below) in the
   labels and counts
   modes; "hash-canonical" (both strands, ids in insertion order,
   labels on the strand first in BOSS order) and "sshash" (basic, ids by
   rank, entries bucketed by minimizer) hold the wide deployments' DNA
   references at k = 31 and take their reads (50% and 10% reverse
   complemented), in the labels mode: their Python rebuilds set the cut,
   as the JAX package rebuilds them too.  Payloads against the oracle
   (ids computed here from the keys, not by the port), kernels A, 2 and 3
   against their plain versions, A with an L2 control;
5f. serves the basic deployment's index with the port's
   ``MetaGraphServer`` on 127.0.0.1 (a port the system chooses, in the
   background): eight ``/search`` requests of ``server_reads`` reads,
   two at a time from two client threads, in the matches, signature and
   counts-sum modes, each reply equal to the engine's own sequential
   ``query_records`` output and, label for label and count for count, to
   the oracle; then ``/stats``, ``/column_labels``, a malformed request
   (400) and ``/align`` (500, naming ROADMAP A13); each request's latency
   printed;
6. runs ``batch_local_align_scores`` (kernel 4) on 4,096 pairs of 150 x
   300 and holds it against its plain version and, on a sample, the numpy
   oracle; then on 1,024 pairs of 1,000 x 1,000 and 256 pairs of 2,000 x
   2,000 (two query blocks) against the plain version;
7. runs the gather micro-benchmark's sweep
   (``metagraph_tpu_torch.scripts.exp_gather``) and holds its kernels 5 and
   6 against their plain version on the full output; then times both on
   two controls, also held against the plain version: sequential indices
   on the sweep's 2^17-row table (L2's rate without randomness) and random
   indices into a 2^21-row table (268 MB, random rows from device
   memory);
8. (run right after 3b, on its graph, saved in the mmap layout) aligns
   reads through the port's CLI ``align`` (its ``main`` in this process):
   150 bp reads of the basic references from the seed's stream 12, 5%
   random, a quarter of the rest error-free, the others with 1%
   substitutions and, a tenth of them, a 1-3 bp indel, half
   reverse-complemented.  A calibration command aligns 20 reads, which
   build the graph's lazy tables, then 200 reads, whose seconds give the
   rate; the counted run takes 1,000 reads (a batch whose waves hold up
   to 1,000 rows), or as many as that rate puts in 40 s where that is
   fewer (at least 200): one ``align_wave`` launch a wave over the
   engine's column store on the card and no ``wave_dp``, every wave's
   written store rows, statistics and read-back rows held whole against
   ``align_wave_plain`` on the card on the same store (the check's
   seconds left out of the rate), the bytes each wave copies over PCIe
   printed beside those of ``compute_wave``'s four planes up and three
   down, each printed alignment held to an independent oracle (its
   score recomputed from its CIGAR, the CIGAR applied to the read
   spelling the printed sequence, that sequence's k-mers all among the
   references'), every
   error-free read aligned end to end with an all-match CIGAR; the first
   20 reads' bytes equal to a ``--torch-device cpu`` run's, the first
   100 reads' to a ``-p 4`` run's; reads/s and the split into seeding,
   waves, the engine's host work and output printed; ``align_wave``
   timed on the run's largest wave (events and the profiler), and
   ``wave_dp`` on its planes through ``compute_wave``'s own entry;
8b. (right after 8, on the same graph file) ``query --align`` and
   ``--batch-align`` through ``QueryEngine.query_records`` with the
   ``AlignerConfig`` that the CLI's parser and helper make, each result
   written as ``--json`` writes it, over the graph's index
   (``convert.from_graph`` with 3b's annotation): 150 bp reads of
   ``align_reads`` from the seed's stream 13 at 37,500 bp a batch.  A
   warm run of 20 reads builds the graph's lazy tables and a run of 200
   gives the rate; then 1,000 reads (fewer where that rate puts fewer in
   60 s, at least 200) on the full graph, the same reads with
   ``--batch-align`` (k = 31: each batch graph on the general route, D2),
   and 200 reads of the first 100 references with ``--batch-align``
   against their k = 21 graph built by the port (the batch graph on the
   device route, D1-D4).  Each run under the launch counters: one
   ``align_wave`` a wave, no ``wave_dp``, kernels A, 2 and 3 on every
   respelled batch and no wire route, D2 (or D1-D4) for every batch
   graph and no other build kernel; every alignment held to the
   independent oracle of 8, every respelled sequence's labels to the
   numpy oracle, every error-free read all-match (under
   ``--batch-align``, those whose forward k-mers the references hold: a
   basic graph's batch graph holds the reads' forward k-mers only); the
   first 100 reads' lines (the first batch's under ``--batch-align``)
   equal to a run of the plain versions on the CPU; reads/s and the
   seconds of seeding, alignment, the batch graphs and the respelled
   query printed.  The graph then goes to the server of 4, whose
   ``/align`` gets two requests of 100 more reads in flight together
   (the second with two alternative alignments), each reply equal to the
   same request's sequential reply, every alignment held to the oracle,
   one ``align_wave`` a wave.

Depth cuts, which keep the script inside its time limit (widths are
never cut): the basic batch is drawn at 150,000 reads, which 3b takes
whole; the main path (2, 3, 3a) and the primary, canonical, k41, protein
and many-labels deployments take ``path_reads`` = 20,000 reads (the
first of the basic batch, or of their own stream; 150,000, then 40,000
before) and
the long sequence, the coords mode and the seqs deployment
``coords_prefix`` = 10,000 (20,000 before), the bitmap deployment 10,000;
the pan-genome holds 3 base genomes (5, then 4 before) and the read set
100,000 reads (400,000 before); phase 8 counts 1,000 reads (2,000
before); 8b's k = 21 graph holds the first 100 of the 1,000 references.

Launch counters are set to 0 just before each driven path and read just
after; comparison launches do not count.  The second-to-last line of
stdout is a JSON object with every kernel's numbers (D1-D4 for each build,
``build_windows/pan`` and the like, D2 with its ``torch.sort`` ms as
``library_ms``, ``align_wave/align`` and ``wave_dp/align`` (phase 8's
largest wave),
``radix_sort/reads-k31-counts`` and
``radix_sort/protein-k20-disk`` for the general route,
``radix_sort/graph_bitmap``, ``.../graph_hash_canonical``,
``.../graph_sshash``, ``.../suffix`` and ``.../kmc`` for 3c, and
``key_lookup/a10``, ``label_counts/a10`` and ``radix_sort/a10`` for 3b;
kernels 1-3 once more
for each of the primary and canonical deployments, kernels B, 2, 3 for
k41, A for seqs, A, 2, 3 for protein, 3 for many-labels, 2 for each words
deployment, B or A, 2, 3 for each wide deployment and A, 2, 3 for each
graph-types deployment, named
``<kernel>/<deployment>``, and
``sw_scores/large`` and ``sw_scores/long`` for the other SW shapes), the
last is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without CUDA the script exits 1 before printing a result.  Long compiler
reports go to ``--out``; the many-labels annotation files to ``--work``.

``--rehearse`` runs the same phases at a tiny size on the CPU with the
plain versions (no build, no card) and exits 2 without a result: a dry run
of the control flow.  ``--only-build`` runs the card, the kernels' build
and phases 1a and 1b alone and exits 3 without a result.
"""

from __future__ import annotations

import argparse
import dataclasses
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

K41 = 41                       # the k41 deployment (codes route)
SUFFIX_L = 8                   # pan's suffix-range index (--index-ranges)
KMC_K = 21                     # the KMC database's k
KP = 20                        # the protein deployment (map route)
# the least share of sampled sequences with a non-empty payload in every
# run that is held against the oracle, so that it does not pass on empty
# payloads against empty ones
MIN_HIT_SHARE = 0.25
AMINO = "ACDEFGHIKLMNPQRSTVWY"  # protein references; code 20 = outside

FULL = dict(n_refs=1000, base_len=8101, repeat=(1000, 1300), n_reads=150_000,
            read_len=200, long_windows=1 << 24, sample=2000,
            sw=(4096, 150, 300), sw_big=(1024, 1000, 1000),
            sw_long=(256, 2000, 2000), sw_oracle=12,
            plain_chunks=(1024, 256), coords_prefix=10_000,
            protein_len=8120, protein_repeat=(1000, 1300),
            gather=(22, (16, 17), 1024), gather_big=21, ctrl_log=15,
            ctrl_rows=4096, many=(4096, 16, (48, 65)), anno_budget=2 << 30,
            words_budget=32768, words_reads=15_000, rd_max_length=100,
            seqs_headers=10, par_batches=8, par_threads=4,
            wide=(200, 8101, 20_000, 200), server_reads=2000,
            bitmap_reads=10_000, pan=(3, 4_000_000, 4, 0.01, 3),
            build_reads=(100_000, 150, 0.5, 0.01), build_k=21,
            path_reads=20_000,
            build_sample=100_000, build_reps=3, host_k=31, disk_cap_gb=0.04,
            align=dict(read_len=150, pool=20_000, warm=20, calibrate=200,
                       budget_s=40, target=1000, least=200, cpu=20, par=100,
                       par_procs=4),
            query_align=dict(pool=1500, warm=20, calibrate=200, budget_s=60,
                             target=1000, least=200, batch_bp=37_500,
                             cpu=100, k21_refs=100, k21_reads=200,
                             server_reads=100))
TINY = dict(n_refs=24, base_len=501, repeat=(100, 160), n_reads=300,
            read_len=120, long_windows=5000, sample=60,
            sw=(40, 37, 60), sw_big=(8, 70, 90), sw_long=(3, 1030, 1040),
            sw_oracle=4, plain_chunks=(16, 8), coords_prefix=100,
            protein_len=480, protein_repeat=(100, 160),
            gather=(12, (6, 7), 64), gather_big=9, ctrl_log=6,
            ctrl_rows=64, many=(256, 2, (8, 13)), anno_budget=1 << 16,
            words_budget=256, words_reads=100, rd_max_length=20,
            seqs_headers=2, par_batches=3, par_threads=4,
            wide=(8, 501, 100, 120), server_reads=30, bitmap_reads=100,
            path_reads=200,
            pan=(2, 3000, 2, 0.01, 2), build_reads=(300, 150, 0.5, 0.01),
            build_k=21, build_sample=500, build_reps=1, host_k=31,
            disk_cap_gb=0.00006,
            align=dict(read_len=150, pool=80, warm=5, calibrate=10,
                       budget_s=0, target=30, least=30, cpu=5, par=12,
                       par_procs=4),
            query_align=dict(pool=60, warm=5, calibrate=10, budget_s=0,
                             target=30, least=30, batch_bp=1500, cpu=10,
                             k21_refs=6, k21_reads=20, server_reads=5))


def log(msg: str):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def device_ms(torch, dev, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` runs after one warm-up run, by CUDA
    events (one run on a host clock on the CPU, rehearsals only)."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
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


def rc_window_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """Window i's reverse-complement key, from the reversed complemented
    codes (N stays N)."""
    comp = np.where(codes < 4, 3 - codes.astype(np.int16), 4).astype(np.uint8)
    return window_keys(comp[::-1], k)[0][::-1]


def boss_rot(keys: np.ndarray, k: int) -> np.ndarray:
    """An integer whose order is BOSS priority order (chars k-2 .. 0, then
    k-1): the 2-bit rotate left of the 2k-bit key."""
    mask = np.uint64((1 << (2 * k)) - 1)
    return ((keys << np.uint64(2)) & mask) | (keys >> np.uint64(2 * k - 2))


def wide_window_keys(codes: np.ndarray, k: int, bits: int, invalid: int):
    """(n,) codes -> ((n-k+1,) opaque sortable keys of ``bits`` bits a
    char, the windows' validity (no code >= ``invalid``)); for keys too
    wide for one uint64."""
    n = len(codes) - k + 1
    per = 64 // bits
    words = np.zeros((max(n, 0), -(-k // per)), np.uint64)
    if n <= 0:
        return as_void(words), np.zeros(0, bool)
    c = codes.astype(np.uint64)
    for i in range(k):
        words[:, i // per] |= c[i: i + n] << np.uint64(bits * (i % per))
    bad = np.concatenate([[0], np.cumsum(codes >= invalid)])
    return as_void(words), (bad[k:] - bad[:-k]) == 0


def as_void(words: np.ndarray) -> np.ndarray:
    """(n, w) uint64 -> (n,) keys that sort and compare as byte strings."""
    be = np.ascontiguousarray(words.astype(">u8"))
    return be.view(f"V{8 * words.shape[1]}").ravel()


def void_chars(keys: np.ndarray, k: int, bits: int) -> np.ndarray:
    """wide_window_keys' keys -> (n, k) codes."""
    per = 64 // bits
    words = np.frombuffer(keys.tobytes(), ">u8").reshape(len(keys), -1)
    chars = np.empty((len(keys), k), np.uint8)
    for i in range(k):
        chars[:, i] = (words[:, i // per] >> np.uint64(bits * (i % per))) \
            & np.uint64((1 << bits) - 1)
    return chars


def make_oracle(keys: np.ndarray, labs: np.ndarray, L: int, k: int = K,
                keys_of=None, pos: np.ndarray | None = None):
    """(key, label) occurrences -> sorted distinct keys with a CSR of their
    (label, multiplicity) pairs; with ``pos``, each pair's sorted
    positions too.  ``keys_of(codes)`` gives a sequence's window keys and
    validity (by default window_keys at K)."""
    ukeys, inv = np.unique(keys, return_inverse=True)
    pair = inv.reshape(-1).astype(np.int64) * L + labs
    upair, pair_of, mult = np.unique(pair, return_inverse=True,
                                     return_counts=True)
    row_of_pair = upair // L
    o = dict(keys=ukeys, row_of_pair=row_of_pair, pair_label=upair % L,
             mult=mult, L=L, k=k,
             keys_of=keys_of or (lambda codes: window_keys(codes, K)),
             csr_start=np.searchsorted(row_of_pair,
                                       np.arange(len(ukeys) + 1)))
    if pos is not None:
        o["coord_pos"] = pos[np.lexsort((pos, pair_of.reshape(-1)))]
        o["coord_start"] = np.concatenate([[0], np.cumsum(mult)])
    return o


def key_chars(keys: np.ndarray) -> np.ndarray:
    chars = np.empty((len(keys), K), np.uint8)
    for i in range(K):
        chars[:, i] = ((keys >> np.uint64(2 * i)) & np.uint64(3)) + 1
    return chars


def make_index(cfg, rng):
    """Random references, one label each; each carries a repeat of part of
    itself, so some k-mers occur twice (annotation value 2)."""
    from metagraph_tpu_torch import convert
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
    L = len(refs)
    oracle = make_oracle(np.concatenate(keys), np.concatenate(labs), L)
    ukeys, R = oracle["keys"], len(oracle["keys"])
    labels = [f"ref{i}" for i in range(L)]
    anno = annotation_of(oracle, labels)
    index = convert.from_kmers(pack_kmers32(key_chars(ukeys)),
                               np.arange(1, R + 1, dtype=np.uint32),
                               pack_annotation_bitmap(anno, R), labels, K,
                               anno)
    return refs, index, oracle


def make_canonical_index(refs, labels):
    """The canonical graph of the references: both strands of every k-mer,
    ids 1..R in key order; each (k-mer, rc) pair's labels sit on its
    canonical strand, the one first in BOSS order.  The oracle keys each
    pair by min(fwd, rc) as integers, which identifies it as well."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.succinct.ops import pack_kmers32
    fwd = [window_keys(r, K)[0] for r in refs]
    labs = np.concatenate([np.full(len(f), i, np.int64)
                           for i, f in enumerate(fwd)])
    fwd = np.concatenate(fwd)
    rc = np.concatenate([rc_window_keys(r, K) for r in refs])
    ukeys = np.unique(np.concatenate([fwd, rc]))
    rows = np.searchsorted(ukeys, np.where(
        boss_rot(fwd, K) <= boss_rot(rc, K), fwd, rc))
    L = len(refs)
    bitmap = np.zeros((len(ukeys), max((L + 31) // 32, 1)), np.uint32)
    np.bitwise_or.at(bitmap, (rows, labs // 32),
                     (np.uint32(1) << (labs % 32).astype(np.uint32)))
    index = convert.from_kmers(pack_kmers32(key_chars(ukeys)),
                               np.arange(1, len(ukeys) + 1, dtype=np.uint32),
                               bitmap, labels, K, canon=1)
    return index, make_oracle(np.minimum(fwd, rc), labs, L)


def make_batch(cfg, rng, refs, rc_share=0.1, long_rc=False):
    """Reads drawn from the references (``make_reads``) and one long
    sequence: reference 0 (its reverse complement with ``long_rc``)
    repeated an odd number of times until its label's count passes
    ``long_windows`` (2^24 at full size) and is odd.  Returns the
    sequences, their codes and the long sequence's period."""
    seqs, codes = make_reads(cfg["n_reads"], cfg["read_len"], rng, refs,
                             rc_share)
    long_codes = long_sequence(cfg, refs[0], K, long_rc)
    seqs.append(np.frombuffer(b"ACGTN", np.uint8)[long_codes].tobytes())
    return seqs, codes + [long_codes], len(refs[0])


def make_reads(n, m, rng, refs, rc_share=0.1, sub_rate=0.01):
    """``n`` reads of ``m`` bp drawn from the DNA references, ``rc_share``
    of them reverse-complemented, ``sub_rate`` substitutions, 3% with an N
    run: -> (sequences, codes)."""
    which = rng.integers(0, len(refs), n)
    start = rng.integers(0, len(refs[0]) - m, n)
    cat = np.concatenate(refs)
    offs = np.concatenate([[0], np.cumsum([len(r) for r in refs])])
    codes = cat[(offs[which] + start)[:, None] + np.arange(m)]
    sub = rng.random((n, m)) < sub_rate
    codes = np.where(sub, (codes + rng.integers(1, 4, (n, m))) % 4, codes)
    rc = rng.random(n) < rc_share
    codes[rc] = 3 - codes[rc, ::-1]
    nrun = np.flatnonzero(rng.random(n) < 0.03)
    for i in nrun:
        at = int(rng.integers(0, m - 20))
        codes[i, at: at + int(rng.integers(1, 20))] = 4
    codes = codes.astype(np.uint8)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    return [letters[row].tobytes() for row in codes], list(codes)


def long_sequence(cfg, ref, k, rc=False):
    """``ref`` (its reverse complement with ``rc``) repeated an odd number
    of times, until its k-mers inside the copies pass ``long_windows``."""
    reps = cfg["long_windows"] // (len(ref) - k + 1) + 1
    reps += 1 - reps % 2
    return np.tile(3 - ref[::-1] if rc else ref, reps)


def make_wide_index(refs, labels):
    """The references at k = 41 (keys of 6 words): the values of the basic
    index (each k-mer's occurrences in its reference) and its coordinates
    (the positions in the reference where it occurs)."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.annotation.ops import pack_annotation_bitmap
    from metagraph_tpu_torch.succinct.ops import pack_kmers32
    keys_of = lambda codes: wide_window_keys(codes, K41, 2, 4)   # noqa
    keys = [keys_of(r)[0] for r in refs]
    labs = np.concatenate([np.full(len(kk), i, np.int64)
                           for i, kk in enumerate(keys)])
    pos = np.concatenate([np.arange(len(kk)) for kk in keys])
    oracle = make_oracle(np.concatenate(keys), labs, len(refs), K41,
                         keys_of, pos)
    anno = annotation_of(oracle, labels, coords=True)
    R = len(oracle["keys"])
    index = convert.from_kmers(
        pack_kmers32(void_chars(oracle["keys"], K41, 2) + 1),
        np.arange(1, R + 1, dtype=np.uint32), pack_annotation_bitmap(anno, R),
        labels, K41, anno)
    return index, oracle


def annotation_of(o, labels, coords=False):
    """The oracle's pairs as a column annotation: rows, values (the pair's
    multiplicity) and, with ``coords``, (row, position) pairs."""
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    L, rows, lab = o["L"], o["row_of_pair"], o["pair_label"]
    order = np.lexsort((rows, lab))
    start = np.searchsorted(lab[order], np.arange(L + 1))
    cols = [rows[order[start[c]:start[c + 1]]] for c in range(L)]
    vals = [o["mult"][order[start[c]:start[c + 1]]] for c in range(L)]
    crd = None
    if coords:
        cs, cp = o["coord_start"], o["coord_pos"]
        crd = []
        for c in range(L):
            pairs = order[start[c]:start[c + 1]]
            n = o["mult"][pairs]
            at = np.repeat(cs[pairs], n) + np.arange(n.sum()) - np.repeat(
                np.cumsum(n) - n, n)
            crd.append(np.stack([np.repeat(rows[pairs], n), cp[at]], 1))
    return ColumnMajorAnnotation(len(o["keys"]), labels, cols, values=vals,
                                 coords=crd, has_values=True,
                                 has_coords=coords)


def protein_refs(cfg, rng):
    """``n_refs`` random protein references of ``protein_len`` codes over
    the 20 amino acids (``AMINO``), each with a repeat of part of
    itself."""
    a, b = cfg["protein_repeat"]
    refs = []
    for _ in range(cfg["n_refs"]):
        base = rng.integers(0, 20, cfg["protein_len"]).astype(np.uint8)
        refs.append(np.concatenate([base, base[a:b]]))
    return refs


def make_protein_index(cfg, rng, labels):
    """Random protein references over the 20 amino acids, each with a
    repeat of part of itself, k = 20 on 8-bit keys (5 words)."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.annotation.ops import pack_annotation_bitmap
    from metagraph_tpu_torch.kmer.alphabets import PROTEIN
    from metagraph_tpu_torch.succinct.ops import pack_kmers32
    refs = protein_refs(cfg, rng)
    keys_of = lambda codes: wide_window_keys(codes, KP, 5, 21)   # noqa
    keys = [keys_of(r)[0] for r in refs]
    labs = np.concatenate([np.full(len(kk), i, np.int64)
                           for i, kk in enumerate(keys)])
    oracle = make_oracle(np.concatenate(keys), labs, len(refs), KP, keys_of)
    anno = annotation_of(oracle, labels)
    R = len(oracle["keys"])
    boss = np.array([PROTEIN.letters.index(ch) for ch in AMINO + "X"],
                    np.uint8)
    index = convert.from_kmers(
        pack_kmers32(boss[void_chars(oracle["keys"], KP, 5)], 8),
        np.arange(1, R + 1, dtype=np.uint32), pack_annotation_bitmap(anno, R),
        labels, KP, anno, alphabet="Protein")
    return refs, index, oracle


def make_protein_batch(cfg, rng, refs, sub_rate=0.01):
    """Reads of the protein references: ``sub_rate`` substitutions, 3% with
    a run of '*' (outside the alphabet: it encodes as X, which no reference
    holds; code 20 here)."""
    n, m = cfg["n_reads"], cfg["read_len"]
    which = rng.integers(0, len(refs), n)
    start = rng.integers(0, len(refs[0]) - m, n)
    cat = np.concatenate(refs)
    offs = np.concatenate([[0], np.cumsum([len(r) for r in refs])])
    codes = cat[(offs[which] + start)[:, None] + np.arange(m)]
    sub = rng.random((n, m)) < sub_rate
    codes = np.where(sub, (codes + rng.integers(1, 20, (n, m))) % 20, codes)
    for i in np.flatnonzero(rng.random(n) < 0.03):
        at = int(rng.integers(0, m - 20))
        codes[i, at: at + int(rng.integers(1, 20))] = 20
    codes = codes.astype(np.uint8)
    letters = np.frombuffer((AMINO + "*").encode(), np.uint8)
    return [letters[row].tobytes() for row in codes], list(codes)


WIDE = {"wide-dna70": ("DNA", 70, 0), "wide-dna70c": ("DNA", 70, 1),
        "wide-prot40": ("Protein", 40, 0), "wide-prot80": ("Protein", 80, 0)}


def make_wide_deployment(refs, alphabet, k, canon):
    """The wide deployments (keys of more than 8 words): DNA at k = 70
    (4-bit keys of 9 words; basic: the codes route, kernel B; canonical:
    the map route, kernel A), Protein at k = 40 and 80 (8-bit keys of 10
    and 20 words: kernel A, the second at its warp form), one label a
    reference.  A canonical index holds both strands; each k-mer's labels
    sit on the strand first in BOSS order, the one the map route probes;
    its oracle keys each pair by the smaller of the two strands' keys.  ->
    (QueryIndex, oracle)."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.annotation.ops import pack_annotation_bitmap
    from metagraph_tpu_torch.kmer.alphabets import PROTEIN
    from metagraph_tpu_torch.succinct.ops import pack_kmers32
    if alphabet == "DNA":
        def keys_of(codes):
            return wide_window_keys(codes, k, 2, 4)

        def rc_of(codes):
            comp = np.where(codes < 4, 3 - codes.astype(np.int16), 4)
            return keys_of(comp[::-1].astype(np.uint8))[0][::-1]

        def chars_of(keys):
            return void_chars(keys, k, 2) + 1
        bits = 4
    else:
        boss = np.array([PROTEIN.letters.index(ch) for ch in AMINO + "X"],
                        np.uint8)

        def keys_of(codes):
            return wide_window_keys(codes, k, 5, 21)

        def chars_of(keys):
            return boss[void_chars(keys, k, 5)]
        bits = 8
    keys = [keys_of(r)[0] for r in refs]
    if canon:
        keys = [key_min(f, rc_of(r)) for f, r in zip(keys, refs)]
    labs = np.concatenate([np.full(len(kk), i, np.int64)
                           for i, kk in enumerate(keys)])
    L = len(refs)
    oracle = make_oracle(np.concatenate(keys), labs, L, k, keys_of)
    labels = [f"ref{i}" for i in range(L)]
    R = len(oracle["keys"])
    chars = chars_of(oracle["keys"])
    if not canon:
        anno = annotation_of(oracle, labels)
        return convert.from_kmers(
            pack_kmers32(chars, bits), np.arange(1, R + 1, dtype=np.uint32),
            pack_annotation_bitmap(anno, R), labels, k, anno,
            alphabet=alphabet), oracle
    oracle["rc_of"] = rc_of
    fwd = pack_kmers32(chars)
    rev = pack_kmers32(5 - chars[:, ::-1])
    W = fwd.shape[1]

    def as_bytes(x):
        return np.ascontiguousarray(x.astype(">u4")).view(f"S{4 * W}") \
            .ravel()
    first = np.where((as_bytes(rev) < as_bytes(fwd))[:, None], rev, fwd)
    both = np.unique(np.concatenate([fwd, rev]).astype(">u4").view(
        f"V{4 * W}").ravel())
    table_keys = np.frombuffer(both.tobytes(), ">u4").reshape(-1, W) \
        .astype(np.uint32)
    row_of = np.searchsorted(both, np.ascontiguousarray(
        first.astype(">u4")).view(f"V{4 * W}").ravel())
    Lw = max((L + 31) // 32, 1)
    bitmap = np.zeros((len(both), Lw), np.uint32)
    pl, pr = oracle["pair_label"], oracle["row_of_pair"]
    np.bitwise_or.at(bitmap, (row_of[pr], pl // 32),
                     np.uint32(1) << (pl % 32).astype(np.uint32))
    return convert.from_kmers(
        table_keys, np.arange(1, len(both) + 1, dtype=np.uint32), bitmap,
        labels, k, canon=1), oracle


def make_many_labels(cfg, rng, oracle, index, out_dir):
    """The many-labels annotation over the basic index's rows: every row
    of references 16-999 carries its reference's label and 0-2 random
    ones, every row of reference r < 16 carries pattern r (48-64 fixed
    labels; 2 patterns of 8-12 in a rehearsal); a row of several such
    references carries the first one's.  Saved as a .brwt.annodbg with
    its .devsparse.npz, loaded back and indexed with the basic index's
    keys -> (QueryIndex, oracle, seconds by step, the label columns)."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.annotation.column import LabelEncoder
    from metagraph_tpu_torch.annotation.matrix import (BRWT,
                                                       StaticAnnotation,
                                                       load_annotation)
    from metagraph_tpu_torch.annotation.sparse_device import \
        DeviceBlockSparseAnno
    from metagraph_tpu_torch.succinct.ops import pack_kmers32
    L, n_pat, (lo, hi) = cfg["many"]
    R = len(oracle["keys"])
    t0 = time.perf_counter()
    rows, refs = oracle["row_of_pair"], oracle["pair_label"]
    patterns = [np.sort(rng.choice(L, int(rng.integers(lo, hi)),
                                   replace=False)) for _ in range(n_pat)]
    # a row's pattern: that of its first reference below n_pat (-1: none);
    # other rows carry their first reference's own label r and 0-2 random
    # ones (sorted, repeats dropped), so that a read of reference r passes
    # the discovery fraction on the label ids of the table's entries.
    # Pairs come out in (row, label) order with no global sort, by counts
    # and offsets
    first = np.full(R, L, np.int64)
    np.minimum.at(first, rows, refs)
    pid = np.where(first < n_pat, first, -1)
    free = np.flatnonzero(pid < 0)
    draw = rng.integers(0, L, (len(free), 3))
    draw[:, 0] = first[free]
    draw[np.arange(3)[None, :] > rng.integers(0, 3, len(free))[:, None]] = L
    draw = np.sort(draw, axis=1)
    keep = draw < L
    keep[:, 1:] &= draw[:, 1:] != draw[:, :-1]
    plen = np.array([len(p) for p in patterns] + [0])
    nl = plen[pid]
    nl[free] = keep.sum(axis=1)
    csr_start = np.concatenate([[0], np.cumsum(nl)])
    row_of_pair = np.repeat(np.arange(R), nl)
    pair_label = np.empty(int(csr_start[-1]), np.int64)
    pair_label[np.repeat(csr_start[free], 3).reshape(-1, 3)[keep]
               + (np.cumsum(keep, axis=1) - 1)[keep]] = draw[keep]
    prow = np.flatnonzero(pid >= 0)
    table = np.zeros((n_pat, max(plen)), np.int64)
    for i, p in enumerate(patterns):
        table[i, :len(p)] = p
    within = np.arange(len(row_of_pair)) - csr_start[row_of_pair]
    at = np.flatnonzero(pid[row_of_pair] >= 0)
    pair_label[at] = table[pid[row_of_pair[at]], within[at]]
    o = dict(oracle, row_of_pair=row_of_pair, pair_label=pair_label,
             mult=np.ones(len(pair_label), np.int64), L=L,
             csr_start=csr_start)
    # columns by a stable radix sort of the 16-bit labels
    order = np.argsort(pair_label.astype(np.uint16), kind="stable")
    starts = np.searchsorted(pair_label[order], np.arange(L + 1))
    cols = [row_of_pair[order[starts[c]: starts[c + 1]]] for c in range(L)]
    del order, within, at
    secs = {"pairs": time.perf_counter() - t0}
    t0 = time.perf_counter()
    brwt = BRWT.from_columns(cols, R, L, linkage=False)
    secs["BRWT"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path = os.path.join(out_dir, "many_labels.brwt.annodbg")
    StaticAnnotation(brwt, LabelEncoder([f"ref{c}" for c in range(L)]),
                     "brwt").save(path)
    del brwt
    secs["save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    DeviceBlockSparseAnno.from_columns(cols, R, L).save(
        path + ".devsparse.npz")
    secs["devsparse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    anno = load_annotation(path)
    index_m = convert.from_annotation(
        pack_kmers32(key_chars(oracle["keys"])),
        np.arange(1, R + 1, dtype=np.uint32), anno, K, R,
        cache=path + ".devsparse.npz")
    secs["load and index"] = time.perf_counter() - t0
    if not isinstance(index_m.device_anno, DeviceBlockSparseAnno):
        raise AssertionError("the many-labels index is not block-sparse")
    if not np.array_equal(index_m.table, index.table):
        raise AssertionError("the many-labels index has another table")
    return index_m, o, secs, cols


def reference_routing(refs, oracle, max_length=100):
    """A row-diff routing along the references: a row's successor is the
    row of the next window of the reference where the row first occurs,
    kept only where that next window is the successor's own first
    occurrence, so first occurrences rise along a chain and no chain
    cycles; an anchor at every ``max_length``-th window of a reference
    and wherever no successor is kept -> (succ, anchors)."""
    keys = np.concatenate([window_keys(r, K)[0] for r in refs])
    n = np.array([len(r) - K + 1 for r in refs])
    j = np.arange(len(keys)) - np.repeat(np.cumsum(n) - n, n)
    last = j == np.repeat(n - 1, n)
    rows = np.searchsorted(oracle["keys"], keys)
    R = len(oracle["keys"])
    _, first = np.unique(rows, return_index=True)
    if len(first) != R:
        raise AssertionError("a row occurs in no reference")
    nxt = np.where(last[first], -1,
                   rows[np.minimum(first + 1, len(rows) - 1)])
    keep = (nxt >= 0) & (first[np.maximum(nxt, 0)] == first + 1)
    succ = np.where(keep, nxt, -1)
    anchors = ((j[first] + 1) % max_length == 0) | (succ < 0)
    return succ, anchors


def make_words(cfg, refs, oracle_m, index_m, cols, work):
    """The words deployments' indexes over the many-labels columns, past
    ``words_budget`` bytes, which the 16 overflow patterns pass (so
    from_matrix gives None): "words-brwt" loads a copy of the many-labels
    .brwt.annodbg without its .devsparse.npz; "words-rowdiff" a
    row_diff_brwt of the same columns (RowDiff.from_annotation over
    reference_routing, its inner an arity-2 BRWT).  Each is loaded with
    load_annotation and given its device annotation by
    convert.device_annotation (the many-labels index's table is kept);
    each must take the words form and write no cache -> ({name:
    QueryIndex}, seconds by step)."""
    import shutil
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.annotation.column import LabelEncoder
    from metagraph_tpu_torch.annotation.device_matrix import (FlatBRWT,
                                                              FlatRowDiff)
    from metagraph_tpu_torch.annotation.matrix import (RowDiff,
                                                       StaticAnnotation,
                                                       load_annotation)
    from metagraph_tpu_torch.scripts.kernel_times import Arity2BRWT
    R, L = index_m.num_rows, len(index_m.labels)
    secs, out = {}, {}
    brwt_path = os.path.join(work, "words.brwt.annodbg")
    shutil.copyfile(os.path.join(work, "many_labels.brwt.annodbg"),
                    brwt_path)
    t0 = time.perf_counter()
    succ, anchors = reference_routing(refs, oracle_m, cfg["rd_max_length"])
    rd = RowDiff.from_annotation(cols, R, L, (succ, anchors), Arity2BRWT)
    rd_path = os.path.join(work, "words.row_diff_brwt.annodbg")
    StaticAnnotation(rd, LabelEncoder(index_m.labels),
                     "row_diff_brwt").save(rd_path)
    del rd
    secs["row-diff build and save"] = time.perf_counter() - t0
    for name, path, form in (("words-brwt", brwt_path, FlatBRWT),
                             ("words-rowdiff", rd_path, FlatRowDiff)):
        t0 = time.perf_counter()
        cache = path + ".devsparse.npz"
        if os.path.exists(cache):
            os.remove(cache)
        anno = load_annotation(path)
        dev = convert.device_annotation(anno, R, cache)
        if not isinstance(dev, form):
            raise AssertionError(f"{name}: device annotation "
                                 f"{type(dev).__name__}, not the words form")
        if os.path.exists(cache):
            raise AssertionError(f"{name} wrote a block-sparse cache")
        out[name] = dataclasses.replace(index_m, device_anno=dev,
                                        annotation=anno)
        secs[name] = time.perf_counter() - t0
    return out, secs


def oracle_lookup(codes, o, canon):
    """Per window: the oracle row and whether the window hits.  canon 1
    looks up min(fwd, rc) in an oracle keyed so; canon 2 the forward key,
    then the reverse complement.  An oracle of wide keys names its
    reverse-complement keys (``rc_of``)."""
    keys, valid = o["keys_of"](codes)
    if canon:
        rc = o["rc_of"](codes) if "rc_of" in o else rc_window_keys(codes, K)

    def find(q):
        pos = np.minimum(np.searchsorted(o["keys"], q), len(o["keys"]) - 1)
        return pos, valid & (o["keys"][pos] == q)
    pos, hit = find(key_min(keys, rc) if canon == 1 else keys)
    if canon == 2:
        pos_r, hit_r = find(rc)
        pos = np.where(hit, pos, pos_r)
        hit = hit | hit_r
    return pos, hit


def key_min(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Element-wise min of two key arrays: integers, or wide_window_keys'
    byte strings (compared as bytes)."""
    if a.dtype.kind != "V":
        return np.minimum(a, b)
    s = f"S{a.dtype.itemsize}"
    return np.where(a.view(s) <= b.view(s), a, b)


def oracle_payload(codes, mode, o, canon=0, period=0, df=0.7, pf=0.0,
                   top=2 ** 63):
    """Independent numpy oracle: sorted keys + searchsorted, exact
    bincounts, get_min_count.  With a ``period`` (``codes`` is one block
    repeated, as the long sequence is), window i + period is window i, so
    the lookup runs on one block and the windows across a join and is
    tiled."""
    import math
    k = o["k"]
    nk = len(codes) - k + 1
    if nk <= 0:
        return []
    if period:
        if nk < period or not np.array_equal(codes[period:],
                                             codes[:-period]):
            raise AssertionError(f"codes do not repeat with period {period}")
        pos, hit = oracle_lookup(codes[:period + k - 1], o, canon)
        reps = -(-nk // period)
        pos, hit = np.tile(pos, reps)[:nk], np.tile(hit, reps)[:nk]
    else:
        pos, hit = oracle_lookup(codes, o, canon)
    rows = pos[hit]
    present = len(rows)

    def pairs_of(r):
        """The oracle's (row, label) pair indices of rows ``r``, and each
        row's span of them."""
        lo, hi = o["csr_start"][r], o["csr_start"][r + 1]
        span = hi - lo
        return np.repeat(lo - np.cumsum(np.concatenate([[0], span[:-1]])),
                         span) + np.arange(span.sum()), span
    # counts over the distinct rows, each weighted by its windows
    urows, rmult = np.unique(rows, return_counts=True)
    upidx, uspan = pairs_of(urows)
    weight = np.repeat(rmult, uspan)
    counts = np.zeros(o["L"], np.int64)
    np.add.at(counts, o["pair_label"][upidx], weight)
    if present < max(1.0, math.ceil(pf * nk)):
        return []
    min_count = int(max(1.0, math.ceil(df * nk)))
    if present < min_count:
        return []
    sel = np.flatnonzero(counts >= min_count).tolist()
    if mode == "labels":
        return [f"ref{c}" for c in sel]
    if mode == "counts-sum":
        # every window's occurrences of the label, summed
        sums = np.zeros(o["L"], np.int64)
        np.add.at(sums, o["pair_label"][upidx], o["mult"][upidx] * weight)
        sel = sorted(sel, key=lambda c: (-sums[c], c))[:top]
        return [(f"ref{c}", int(sums[c])) for c in sel]
    sel = sorted(sel, key=lambda c: (-counts[c], c))[:top]
    if mode == "matches":
        return [(f"ref{c}", int(counts[c])) for c in sel]
    out = []
    pidx, span = pairs_of(rows)
    labs = o["pair_label"][pidx]
    win = np.flatnonzero(hit)
    owner = np.repeat(np.arange(len(rows)), span)
    for c in sel:
        mine = labs == c
        if mode == "coords":
            cs, co = o["coord_start"], [[] for _ in range(nk)]
            for w, p in zip(win[owner[mine]], pidx[mine]):
                co[w] = o["coord_pos"][cs[p]: cs[p + 1]].tolist()
            out.append((f"ref{c}", int(counts[c]), co))
            continue
        ab = np.zeros(nk, dtype=np.int64)
        ab[win[owner[mine]]] = o["mult"][pidx[mine]]
        out.append((f"ref{c}", int(counts[c]), ab))
    return out


def same_payload(got, want) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if isinstance(w, tuple) and len(w) == 3:
            third = np.array_equal(g[2], w[2]) if isinstance(
                w[2], np.ndarray) else list(g[2]) == w[2]
            if g[:2] != w[:2] or not third:
                return False
        elif g != w:
            return False
    return True


# --------------------------------------------------------------------------
# the build phase: the device construction (kernels D1-D4)
# --------------------------------------------------------------------------

def make_pangenome(cfg, rng):
    """``genomes`` random base genomes of ``length`` bp, each with
    ``strains`` strains at ``sub_rate`` substitutions: -> (n, length) codes
    0..3, the base genomes at rows 0, strains + 1, ..."""
    G, L, S, sub, _ = cfg["pan"]
    refs = np.empty((G * (S + 1), L), np.uint8)
    for g in range(G):
        base = rng.integers(0, 4, L, dtype=np.uint8)
        refs[g * (S + 1)] = base
        for s in range(1, S + 1):
            at = np.flatnonzero(rng.random(L) < sub)
            strain = base.copy()
            strain[at] = (strain[at] + rng.integers(1, 4, len(at))) % 4
            refs[g * (S + 1) + s] = strain
    return refs


def add_n_runs(refs, runs, rng):
    """``runs`` runs of N (1-500 bp) in every reference, in place."""
    for r in refs:
        for _ in range(runs):
            at = int(rng.integers(0, len(r) - 500))
            r[at: at + int(rng.integers(1, 500))] = 4


def window_keys_2d(codes: np.ndarray, k: int):
    """(n, m) codes -> ((n, m-k+1) uint64 2-bit keys, validity), as
    ``window_keys`` row by row."""
    n, m = codes.shape
    w = m - k + 1
    c = codes.astype(np.uint64) & np.uint64(3)
    key = np.zeros((n, w), np.uint64)
    for i in range(k):
        key |= c[:, i: i + w] << np.uint64(2 * i)
    bad = np.concatenate([np.zeros((n, 1), np.int64),
                          np.cumsum(codes >= 4, axis=1)], axis=1)
    return key, (bad[:, k:] - bad[:, :-k]) == 0


def write_records(path, codes):
    letters = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for i, row in enumerate(codes):
            f.write(b">s%d\n" % i + letters[row].tobytes() + b"\n")


def cli_build(fa, out, k, dev, flags=()):
    """``python -m metagraph_tpu_torch build --device -v`` with ``flags``
    (its ``main`` in this process, so that the launch counters show): ->
    (wall s, the phases it traced, the nodes it reported (the k-mers of a
    ``--suffix`` chunk), the other lines: its route, the disk sort's
    chunks, warnings)."""
    import contextlib
    import io
    from metagraph_tpu_torch.cli import main as cli_main
    from metagraph_tpu_torch.graph import dbg_succinct
    from metagraph_tpu_torch.utils.timer import set_trace
    args = ["build", "--device", "-v", "-k", str(k), *flags, "-o", out, fa] \
        + (["--torch-device", "cpu"] if dev.type == "cpu" else [])
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            cli_main(args)
    finally:
        set_trace(False)
        dbg_succinct.DEFAULT_MMAP = False
    wall = time.perf_counter() - t0
    phases, nodes, notes = {}, None, []
    for ln in err.getvalue().splitlines():
        if ln.startswith("[trace] ") and " sec, RSS" in ln:
            name, rest = ln[8:].split(": ", 1)
            phases[name] = float(rest.split(" sec")[0])
        elif ln.startswith("[trace] build route: ") \
                or ln.startswith("[trace] disk sort: "):
            notes.append(ln[8:])
        elif ln.startswith("warning: "):
            notes.append(ln)
        elif ln.startswith("graph built: "):
            nodes = int(ln.rsplit("nodes=", 1)[1])
        elif ln.startswith("chunk ") and ln.endswith(" k-mers"):
            nodes = int(ln.split(": ", 1)[1].split()[0])
    if nodes is None:
        raise AssertionError(f"build printed no 'graph built' or 'chunk' "
                             f"line: {err.getvalue()[-2000:]}")
    return wall, phases, nodes, notes


def build_kernel_checks(seqs, k, torch, dev, reps, strands=1):
    """D1-D4 against their plain versions, on the card, on this build's
    inputs, step by step through the build (every output held whole,
    exactly), each timed beside its plain version, D2 also beside
    ``torch.sort(stable=True)`` over the same keys -> (entries, the
    kernels' W, last, valid, F).  ``strands`` 2: a canonical build (D1's
    strand mode, no dummy limit)."""
    from metagraph_tpu_torch._u32 import np_words
    from metagraph_tpu_torch.query.device import wire_words_layout
    from metagraph_tpu_torch.query.tile_pack import tile_pack2
    from metagraph_tpu_torch.succinct import device_build as db
    tiles2, validb, _, _ = tile_pack2(seqs, k, db.T_WIRE)
    words, vwords = wire_words_layout(tiles2, validb, k, db.T_WIRE,
                                      len(tiles2))
    words, vwords = np_words(words).to(dev), np_words(vwords).to(dev)
    del tiles2, validb
    res = {}

    def step(name, fn, plain, nbytes, cmp=None):
        got, want = fn(), plain()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        if cmp is not None:
            got_t, want_t = cmp(got_t), cmp(want_t)
        err = max((max_abs_err(torch, torch.as_tensor(g),
                               torch.as_tensor(w))
                   for g, w in zip(got_t, want_t)), default=0)
        e = res.setdefault(name, dict(max_abs_err=0, ms=0.0, plain_ms=0.0,
                                      nbytes=0, library_ms=None))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ms"] += device_ms(torch, dev, fn, reps)
        e["plain_ms"] += device_ms(torch, dev, plain, 1)
        e["nbytes"] += nbytes
        if err:
            raise AssertionError(f"{name} disagrees with its plain version")
        return got

    def sort(what, x, bits, sentinel=None):
        """One D2 sort as the build runs it (``sentinel=`` for the join
        sort), held whole against the plain version without it;
        a line with its passes (the plan's, and on the card the launches
        of one call less the memset and the histogram), its ms, torch.sort's
        and the pass floor (16 B a key a pass)."""
        kw = {} if sentinel is None else {"sentinel": sentinel}
        passes = len(db.radix_plan_of(x, bits, sentinel)[1])
        if dev.type == "cuda" and len(x):
            before = db.radix_sort.launches
            db.radix_sort(x, bits, **kw)
            if db.radix_sort.launches - before != 2 + passes:
                raise AssertionError(f"radix_sort {what}: launches differ "
                                     "from its pass plan")
        e0 = res.get("radix_sort", {}).get("ms", 0.0)
        out = step("radix_sort", lambda: db.radix_sort(x, bits, **kw)[0],
                   lambda: db.radix_sort_plain(x, bits)[0], 16 * len(x))
        ms = res["radix_sort"]["ms"] - e0
        lib = device_ms(torch, dev, lambda: torch.sort(x, stable=True), reps)
        e = res["radix_sort"]
        e["library_ms"] = (e["library_ms"] or 0.0) + lib
        floor = 16 * len(x) * passes / HBM_BYTES_PER_S * 1e3
        log(f"kernel radix_sort [build k = {k}, {what}]: n = {len(x)}, "
            f"bits {bits}" + ("" if sentinel is None else
                              f", {int((x != sentinel).sum())} not the "
                              "sentinel")
            + f", {passes} passes: {ms:.4f} ms (torch.sort {lib:.4f} ms, "
            f"pass floor {floor:.4f} ms)")
        return out

    n = strands * words.shape[0] * db.T_WIRE
    keys = step("build_windows",
                lambda: db.build_windows(words, vwords, k, strands=strands),
                lambda: db.build_windows_plain(words, vwords, k,
                                               strands=strands),
                words.numel() * 4 + vwords.numel() * 4 + 8 * n)
    skeys = sort("edge", keys, 2 * k + 1)
    del keys
    uniq, J, U = step("build_join", lambda: db.build_join(skeys, k),
                      lambda: db.build_join_plain(skeys, k), 25 * n)
    J = sort("join", J, 2 * k + 1, db._sent2(k))
    # the build's limit: the JAX device construction's, or none
    cap = db.capd_limit(db._CAPD_DEFAULT, 1 << 22) if strands == 1 else n

    def sorted_lists(t):
        return tuple(torch.sort(x).values for x in t[:2]) \
            + tuple(torch.tensor(x) for x in t[2:])

    sink, src1, n_sink, n_src1 = step(
        "build_join", lambda: db.join_nodes(J, k, cap),
        lambda: db.join_nodes_plain(J, k, cap), 16 * n, sorted_lists)
    res["build_join"]["nbytes"] += 8 * (n_sink + n_src1)
    del J
    sink, src1 = sort("sink", sink, 2 * k - 2), \
        sort("source", src1, 2 * k - 2)
    dummies = db.expand_dummies(db.unpack_node_keys(sink.cpu().numpy(), k),
                                db.unpack_node_keys(src1.cpu().numpy(), k),
                                k)
    d3 = torch.from_numpy(db.host_key3(dummies, k)).to(dev)
    D = len(dummies)
    # the compaction: the n flags read, the U set rows' keys read (no other
    # key is needed), the dummy rows read and the U + D keys written
    k3 = step("build_emit", lambda: db.emit_keys(skeys, uniq, U, d3, k),
              lambda: db.emit_keys_plain(skeys, uniq, U, d3, k),
              n + 16 * U + 16 * D)
    # for information beside the bound: the 32 B sectors of skeys that
    # hold a set flag, which the compaction fetches whole
    lead = skeys.data_ptr() // 8 % 4
    key_sectors = int(torch.nn.functional.pad(
        uniq.to(torch.uint8), (lead, -(lead + n) % 4)).view(-1, 4)
        .amax(1).sum())
    S = sort("stream", k3, 3 * k)
    del k3
    M = U + D
    # the emission: the M rows read, F written, then 3 B a row written of
    # row 0 and the kept rows
    W, last, valid, F = step(
        "build_emit", lambda: db.build_emit(S, M, k),
        lambda: db.build_emit_plain(S, M, k), 8 * M + 40)
    res["build_emit"]["nbytes"] += 3 * len(W)
    entries = {}
    for name, e in res.items():
        bound = e.pop("nbytes") / HBM_BYTES_PER_S * 1e3
        entries[name] = dict(e, bound_ms=bound, bound_by="bytes")
        lib = e["library_ms"]
        log(f"kernel {name} [build k = {k}]: {e['ms']:.4f} ms (plain "
            f"{e['plain_ms']:.2f} ms, bound {bound:.4f} ms"
            + (f", torch.sort {lib:.4f} ms" if lib is not None else "")
            + f"), max_abs_err {e['max_abs_err']}")
    log(f"build inputs: {n} windows, U = {U} distinct edges, {n_sink} sink "
        f"and {n_src1} source nodes, {D} dummy rows, {len(W) - 1} rows")
    log(f"  build_emit: the compaction's key sectors holding a set flag: "
        f"{key_sectors} ({32 * key_sectors} B, "
        f"{32 * key_sectors / HBM_BYTES_PER_S * 1e3:.4f} ms; the bound "
        f"counts {8 * U} B of keys)")
    return entries, tuple(x.cpu().numpy() for x in (W, last, valid, F))


def sorted_window_keys(codes, k: int, both: bool = False) -> np.ndarray:
    """The 2-bit keys (k <= 32) of the valid windows of (n, m) code rows,
    and with ``both`` of their reverse complements, sorted."""
    keys = []
    for lo in range(0, len(codes), 1 << 14):
        block = codes[lo: lo + (1 << 14)]
        kk, ok = window_keys_2d(block, k)
        keys.append(kk[ok])
        if both:
            comp = np.where(block < 4, 3 - block.astype(np.int16), 4)
            rk = window_keys_2d(comp[:, ::-1].astype(np.uint8), k)[0]
            keys.append(rk[:, ::-1][ok])
    return np.sort(np.concatenate(keys))


def distinct_sorted(keys: np.ndarray):
    """Sorted keys -> (distinct keys, their multiplicities): np.unique's
    result by its own method, an adjacent compare (np.unique itself, numpy
    2.3.5, took 67 and 85 s over the builds' keys on the H100 machine's
    host, where sorting them took 13 and 4 s)."""
    new = np.ones(len(keys), bool)
    new[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(new)
    return keys[starts], np.diff(np.append(starts, len(keys)))


def rc_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """2-bit keys of k characters -> their reverse complements' keys."""
    out = np.zeros_like(keys)
    for i in range(k):
        out |= (np.uint64(3) - ((keys >> np.uint64(2 * i)) & np.uint64(3))) \
            << np.uint64(2 * (k - 1 - i))
    return out


def build_oracle(boss, distinct, k, rng, sample, counts=None, cap=255):
    """An oracle independent of the code under test: the valid edges are
    ``distinct``, the sorted distinct 2-bit keys of the collector's
    windows, label by label; a sample of edges decoded with
    ``get_edge_seq`` is among them, and where ``counts`` (the keys'
    multiplicities) are given, each sampled edge's weight is its count,
    capped at ``cap``.  -> the label counts."""
    t0 = time.perf_counter()
    ids = np.flatnonzero(boss.valid)
    if len(ids) != len(distinct):
        raise AssertionError(f"{len(ids)} valid edges, {len(distinct)} "
                             "distinct valid windows")
    want = np.bincount((distinct >> np.uint64(2 * (k - 1))).astype(np.int64)
                       & 3, minlength=4)
    got = np.bincount(boss.W[ids] % boss.alph_size, minlength=5)[1:]
    if not np.array_equal(got, want):
        raise AssertionError(f"label counts {got} != {want}")
    pick = rng.choice(ids, min(sample, len(ids)), replace=False)
    chars = boss.get_edge_seq(pick).astype(np.uint64) - np.uint64(1)
    key = np.zeros(len(pick), np.uint64)
    for i in range(k):
        key |= chars[:, i] << np.uint64(2 * i)
    at = np.minimum(np.searchsorted(distinct, key), len(distinct) - 1)
    if not np.array_equal(distinct[at], key):
        raise AssertionError("a decoded edge is no window of the input")
    if counts is not None:
        w = np.asarray(boss.weights)[pick]
        if not np.array_equal(w, np.minimum(counts[at], cap)):
            raise AssertionError("a sampled edge's weight is not its count")
    log(f"build oracle: {len(pick)} edges checked in "
        f"{time.perf_counter() - t0:.1f} s")
    return got


def build_lookup(path, codes, k, rng, sample, torch, dev):
    """The written graph, loaded back (``DBGSuccinct.load``), indexed
    (``convert.from_graph``, one label on every valid edge) and queried
    (``QueryEngine.query_batch``: kernels 1, 2, 3) with a sample of the
    input's windows as sequences: every one must come back with its
    label."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    t0 = time.perf_counter()
    g = DBGSuccinct.load(path)
    t1 = time.perf_counter()
    anno = ColumnMajorAnnotation(g.max_index(), ["all"],
                                 [np.flatnonzero(g.boss.valid) - 1])
    index = convert.from_graph(g, anno)
    t2 = time.perf_counter()
    rows = rng.integers(0, len(codes), 4 * sample)
    at = rng.integers(0, codes.shape[1] - k + 1, 4 * sample)
    wins = codes[rows[:, None], at[:, None] + np.arange(k)]
    wins = wins[(wins < 4).all(axis=1)][:sample]
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seqs = [letters[w].tobytes() for w in wins]
    engine = QueryEngine(index, device=dev)
    got = engine.query_batch(seqs, "labels", 2 ** 63, 0.7, 0.0)
    t3 = time.perf_counter()
    missed = sum(1 for p in got if not p)
    if missed or len(got) != len(wins) or len(wins) < sample // 2:
        raise AssertionError(f"{missed} of {len(wins)} sampled windows not "
                             "found in the built graph")
    log(f"build lookup: {len(wins)} sampled windows found; load "
        f"{t1 - t0:.1f} s, from_graph {t2 - t1:.1f} s, query "
        f"{t3 - t2:.1f} s")
    return g


def build_phase(cfg, seed, torch, dev, work, timed):
    """The device construction on two deployments from ``seed``:
    "pan" (a pan-genome of related assemblies) and "reads" (reads drawn
    from its strains), each built through the port's CLI and held against
    the plain versions, the oracle and (pan) the query path; then the
    three builds of ``host_builds``."""
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    k = cfg["build_k"]
    rng = np.random.default_rng([seed, 8])
    refs = timed("build inputs", make_pangenome, cfg, rng)
    S = cfg["pan"][2]
    strains = np.array([r for i, r in enumerate(refs) if i % (S + 1)])
    n, m, rc_share, err = cfg["build_reads"]
    reads = timed("build inputs", make_reads, n, m, rng, strains, rc_share,
                  err)[1]
    reads = np.stack(reads)
    del strains
    add_n_runs(refs, cfg["pan"][4], rng)
    out = {}
    for name, codes in (("pan", refs), ("reads", reads)):
        fa = os.path.join(work, f"{name}.fa")
        timed("build inputs", write_records, fa, codes)
        base = os.path.join(work, f"{name}-k{k}")
        # pan with its suffix-range index (--index-ranges)
        flags = ["--index-ranges", str(SUFFIX_L)] if name == "pan" else []
        (wall, phases, nodes, _), launches = timed(
            "build cli", run_path, lambda: cli_build(fa, base, k, dev,
                                                     flags))
        log(f"build {name}: {len(codes)} sequences, {codes.size} bp, k = "
            f"{k}: {nodes} nodes in {wall:.1f} s (" + ", ".join(
                f"{p} {v:.3f}" for p, v in phases.items()) + ")")
        for kern in BUILD_KERNELS:
            if dev.type == "cuda" and not launches[kern]:
                raise AssertionError(f"build {name} launched no {kern}")
        letters = np.frombuffer(b"ACGTN", np.uint8)
        seqs = [letters[r].tobytes() for r in codes]
        entries, arrays = timed("build checks", build_kernel_checks, seqs,
                                k, torch, dev, cfg["build_reps"])
        del seqs
        g = DBGSuccinct.load(base + ".dbg")
        for f, a in zip(("W", "last", "valid", "F"), arrays):
            if not np.array_equal(getattr(g.boss, f), a):
                raise AssertionError(f"build {name}: the file's {f} is not "
                                     "the kernels' ")
        if g.num_nodes() != nodes:
            raise AssertionError("nodes")
        t0 = time.perf_counter()
        distinct = distinct_sorted(timed("build oracle", sorted_window_keys,
                                         codes, k))[0]
        log(f"build {name} oracle: keys sorted and deduped in "
            f"{time.perf_counter() - t0:.1f} s")
        labels = timed("build oracle", build_oracle, g.boss, distinct, k,
                       rng, cfg["build_sample"])
        log(f"build {name} oracle: {len(distinct)} valid edges = distinct "
            f"valid windows, labels A/C/G/T {labels.tolist()}; "
            f"{cfg['build_sample']} decoded edges among them")
        if name == "pan":
            timed("build oracle", suffix_range_oracle, g.boss, distinct, k,
                  phases)
        del g
        if name == "pan":
            pan_distinct = distinct
        del distinct
        if name == "pan":
            timed("build lookup", build_lookup, base + ".dbg", codes, k, rng,
                  cfg["build_sample"], torch, dev)
        out[name] = ({kern: launches[kern] for kern in BUILD_KERNELS},
                     entries)
    out.update(host_builds(cfg, seed, torch, dev, work, timed, refs,
                           pan_distinct, reads))
    return out


# --------------------------------------------------------------------------
# the host construction (the general route) and canonical builds
# --------------------------------------------------------------------------

def sort_checks(torch, dev, reps, tag):
    """A D2 ``radix_sort`` that, besides sorting, holds each call whole
    against ``radix_sort_plain`` (exactly), checks its launches against
    its pass plan, times it, the plain version and the library call (a
    stable ``torch.sort`` of the keys in unsigned order and the payload's
    gather) and prints a line a call; ``.entry()`` sums the calls and
    ``.path_launches()`` counts the launches of the sorts themselves (not
    of the checks).  Put in place of ``device_build.radix_sort`` (``with
    .active()``), every sort of the general route goes through it."""
    import contextlib
    from metagraph_tpu_torch.succinct import device_build as db
    real = db.radix_sort
    e = dict(max_abs_err=0, ms=0.0, plain_ms=0.0, nbytes=0, library_ms=0.0,
             calls=0, launches=0)

    def spy(keys, bits, payload=None, **kw):
        before = spy.launches
        out = real(keys, bits, payload, **kw)
        e["launches"] += spy.launches - before
        n = len(keys)
        if not n:
            return out
        want = db.radix_sort_plain(keys, bits, payload, **kw)
        if not all(g is None and w is None or torch.equal(g, w)
                   for g, w in zip(out, want)):
            raise AssertionError(f"radix_sort [{tag}] disagrees with its "
                                 "plain version")
        del want
        passes = len(db.radix_plan_of(keys, bits, kw.get("sentinel"))[1])
        if dev.type == "cuda":
            before = spy.launches
            real(keys, bits, payload, **kw)
            if spy.launches - before != 2 + passes:
                raise AssertionError(f"radix_sort [{tag}]: launches differ "
                                     "from its pass plan")
        ms = device_ms(torch, dev, lambda: real(keys, bits, payload, **kw),
                       reps)
        plain = device_ms(torch, dev, lambda: db.radix_sort_plain(
            keys, bits, payload, **kw), 1)
        ukeys = keys ^ torch.iinfo(torch.int64).min if bits == 64 \
            else keys & ((1 << bits) - 1)

        def library():
            r = torch.sort(ukeys, stable=True)
            return r.values, None if payload is None \
                else payload.index_select(0, r.indices)
        lib = device_ms(torch, dev, library, reps)
        del ukeys
        nbytes = 16 * n + (0 if payload is None
                           else 2 * payload.element_size() * n)
        e["ms"] += ms
        e["plain_ms"] += plain
        e["library_ms"] += lib
        e["nbytes"] += nbytes
        e["calls"] += 1
        if n >= 1 << 16:
            log(f"kernel radix_sort [{tag}]: n = {n}, bits {bits}, payload "
                f"{None if payload is None else payload.dtype}, {passes} "
                f"passes: {ms:.4f} ms (torch.sort {lib:.4f} ms, plain "
                f"{plain:.2f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f}"
                " ms)")
        return out

    spy.launches = 0

    def entry():
        bound = e["nbytes"] / HBM_BYTES_PER_S * 1e3
        log(f"kernel radix_sort [{tag}]: {e['calls']} sorts, {e['ms']:.4f} "
            f"ms (plain {e['plain_ms']:.2f} ms, bound {bound:.4f} ms, "
            f"torch.sort {e['library_ms']:.4f} ms), max_abs_err 0")
        return dict(max_abs_err=0, ms=e["ms"], plain_ms=e["plain_ms"],
                    bound_ms=bound, bound_by="bytes",
                    library_ms=e["library_ms"])

    @contextlib.contextmanager
    def active():
        db.radix_sort = spy
        try:
            yield
        finally:
            db.radix_sort = real

    spy.active, spy.entry = active, entry
    spy.path_launches = lambda: e["launches"]
    return spy


def checked_build(torch, dev, reps, what, cli_launches, seqs, k, **kw):
    """``DBGSuccinct.build(seqs, k, **kw)`` on ``dev`` with the port's
    trace on and every D2 call checked (``sort_checks``): its sorts must
    launch D2 as often as the CLI build did (``cli_launches``), so that
    they are the sorts of that build at its shapes.  -> (the graph, the
    D2 entry, the build's trace lines)."""
    import contextlib
    import io
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu_torch.utils.timer import set_trace
    spy = sort_checks(torch, dev, reps, what)
    err = io.StringIO()
    set_trace(True)
    try:
        with spy.active(), contextlib.redirect_stderr(err):
            g = DBGSuccinct.build(seqs, k, device=dev, **kw)
    finally:
        set_trace(False)
    if dev.type == "cuda" and spy.path_launches() != cli_launches:
        raise AssertionError(f"build {what}: the checked build launched D2 "
                             f"{spy.path_launches()} times, the CLI's "
                             f"{cli_launches}")
    notes = [ln[8:] for ln in err.getvalue().splitlines()
             if ln.startswith("[trace] ")]
    return g, spy.entry(), notes


def same_boss(boss, arrays, what):
    for f in ("W", "last", "valid", "F", "weights"):
        a, b = getattr(boss, f), getattr(arrays, f)
        if (a is None) != (b is None) or a is not None and not (
                np.asarray(a).dtype == b.dtype and np.array_equal(a, b)):
            raise AssertionError(f"{what}: {f} differs")


def protein_words(codes: np.ndarray, k: int) -> np.ndarray:
    """(n,) amino-acid codes 0..19 -> (n-k+1, 2) uint64 rows of 5-bit
    codes (12 a word), comparable as (word 0, word 1)."""
    n = len(codes) - k + 1
    out = np.zeros((n, 2), np.uint64)
    c = codes.astype(np.uint64)
    for i in range(k):
        out[:, i // 12] |= c[i: i + n] << np.uint64(5 * (11 - i % 12))
    return out


def protein_oracle(boss, refs, k, rng, sample):
    """The valid edges of a Protein graph are the distinct windows of the
    references (numpy rows, sorted and deduped); a sample of edges decoded
    with ``get_edge_seq`` is among them.  -> the number of edges."""
    from metagraph_tpu_torch.kmer.alphabets import PROTEIN
    t0 = time.perf_counter()
    rows = np.concatenate([protein_words(r, k) for r in refs])
    rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    new = np.ones(len(rows), bool)
    new[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    distinct = as_void(rows[new])
    del rows, new
    ids = np.flatnonzero(boss.valid)
    if len(ids) != len(distinct):
        raise AssertionError(f"{len(ids)} valid edges, {len(distinct)} "
                             "distinct windows")
    amino = np.full(len(PROTEIN.letters), 255, np.uint8)
    for i, ch in enumerate(AMINO):
        amino[PROTEIN.letters.index(ch)] = i
    pick = rng.choice(ids, min(sample, len(ids)), replace=False)
    chars = amino[boss.get_edge_seq(pick)]
    if (chars == 255).any():
        raise AssertionError("a decoded edge holds no amino acid")
    key = as_void(np.concatenate([protein_words(c, k) for c in chars]))
    at = np.minimum(np.searchsorted(distinct, key), len(distinct) - 1)
    if not (distinct[at] == key).all():
        raise AssertionError("a decoded edge is no window of the input")
    log(f"build oracle: {len(distinct)} distinct windows, {len(pick)} "
        f"edges checked in {time.perf_counter() - t0:.1f} s")
    return len(distinct)


def host_builds(cfg, seed, torch, dev, work, timed, pan, pan_distinct,
                reads):
    """Three builds through the port's CLI, each held to an independent
    oracle: "pan-canonical" (the pan-genome at k = 21, both strands: the
    device route, D1's strand mode against its plain version on the
    build's tiles, D1-D4 step by step), "reads-k31-counts" (the read set,
    canonical, k = 31, ``--count-kmers``: the general route, 2 words a
    k-mer, each sampled edge's weight its multiplicity over both strands)
    and "protein-k20-disk" (the protein references at k = 20, 3 words a
    k-mer, ``--disk-swap`` and a ``--mem-cap-gb`` that spills at least 4
    chunks: its arrays equal to the uncapped build's).  The general
    route's D2 calls are held against ``radix_sort_plain`` as the same
    build, with the CLI's arguments, runs again (``checked_build``)."""
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    letters = np.frombuffer(b"ACGTN", np.uint8)
    rng = np.random.default_rng([seed, 9])
    reps, sample = cfg["build_reps"], cfg["build_sample"]
    out = {}

    def cli(name, fa, k, flags, kernels, route):
        base = os.path.join(work, name)
        (wall, phases, nodes, notes), launches = timed(
            "build cli", run_path, lambda: cli_build(fa, base, k, dev, flags))
        log(f"build {name}: k = {k} {' '.join(flags)}: {nodes} nodes in "
            f"{wall:.1f} s (" + ", ".join(f"{p} {v:.3f}"
                                          for p, v in phases.items())
            + "); " + "; ".join(notes))
        if not notes or not notes[0].startswith(f"build route: {route} "):
            raise AssertionError(f"build {name} took no {route} route")
        for kern in kernels:
            if dev.type == "cuda" and not launches[kern]:
                raise AssertionError(f"build {name} launched no {kern}")
        g = DBGSuccinct.load(base + ".dbg")
        if g.num_nodes() != nodes:
            raise AssertionError(f"build {name}: nodes")
        return g, {kern: launches[kern] for kern in kernels}, notes

    # pan-canonical: the device route with D1's strand mode
    k = cfg["build_k"]
    g, launches, _ = cli("pan-canonical", os.path.join(work, "pan.fa"), k,
                         ["--mode", "canonical"], BUILD_KERNELS, "device")
    seqs = [letters[r].tobytes() for r in pan]
    entries, arrays = timed("build checks", build_kernel_checks, seqs, k,
                            torch, dev, reps, strands=2)
    del seqs
    for f, a in zip(("W", "last", "valid", "F"), arrays):
        if not np.array_equal(getattr(g.boss, f), a):
            raise AssertionError(f"build pan-canonical: the file's {f} is "
                                 "not the kernels'")
    t0 = time.perf_counter()
    distinct = distinct_sorted(np.sort(np.concatenate(
        [pan_distinct, rc_keys(pan_distinct, k)])))[0]
    log(f"build pan-canonical oracle: both strands' keys in "
        f"{time.perf_counter() - t0:.1f} s")
    labels = timed("build oracle", build_oracle, g.boss, distinct, k, rng,
                   sample)
    log(f"build pan-canonical oracle: {len(distinct)} valid edges = distinct"
        f" keys of both strands, labels A/C/G/T {labels.tolist()}; {sample} "
        "decoded edges among them")
    out["pan-canonical"] = (launches, entries)
    del g, distinct

    # reads-k31-counts: the general route, counted
    k = cfg["host_k"]
    g, launches, _ = cli("reads-k31-counts", os.path.join(work, "reads.fa"),
                         k, ["--mode", "canonical", "--count-kmers"],
                         ("radix_sort",), "general")
    seqs = [letters[r].tobytes() for r in reads]
    again, entry, _ = timed(
        "build checks", checked_build, torch, dev, reps,
        f"reads-k31-counts, k = {k}", launches["radix_sort"], seqs, k,
        mode="canonical", with_counts=True)
    del seqs
    same_boss(g.boss, again.boss, "build reads-k31-counts (checked sorts)")
    del again
    t0 = time.perf_counter()
    distinct, counts = distinct_sorted(timed(
        "build oracle", sorted_window_keys, reads, k, True))
    log(f"build reads-k31-counts oracle: both strands' keys in "
        f"{time.perf_counter() - t0:.1f} s")
    labels = timed("build oracle", build_oracle, g.boss, distinct, k, rng,
                   sample, counts, (1 << 8) - 1)
    log(f"build reads-k31-counts oracle: {len(distinct)} valid edges = "
        f"distinct keys of both strands, labels A/C/G/T {labels.tolist()}; "
        f"{sample} decoded edges among them, each weight its count (max "
        f"{int(counts.max())}) capped at 255")
    out["reads-k31-counts"] = (launches, {"radix_sort": entry})
    del g, distinct, counts

    # protein-k20-disk: the general route in bounded RAM
    refs = protein_refs(cfg, np.random.default_rng([seed, 3]))
    amino = np.frombuffer(AMINO.encode(), np.uint8)
    fa = os.path.join(work, "protein.fa")
    with open(fa, "wb") as f:
        for i, r in enumerate(refs):
            f.write(b">p%d\n" % i + amino[r].tobytes() + b"\n")
    swap = os.path.join(work, "swap")
    os.makedirs(swap, exist_ok=True)
    cap = cfg["disk_cap_gb"]
    g, launches, notes = cli(
        "protein-k20-disk", fa, KP, ["--alphabet", "Protein", "--disk-swap",
                                     swap, "--mem-cap-gb", str(cap)],
        ("radix_sort",), "general")

    def spilled(notes, what):
        chunks = [int(n.split()[2]) for n in notes
                  if n.startswith("disk sort")]
        if len(chunks) != 1 or chunks[0] < 4 or os.listdir(swap):
            raise AssertionError(f"build {what} spilled {chunks} chunks (at "
                                 "least 4 wanted) or left files")
        return chunks[0]
    chunks = spilled(notes, "protein-k20-disk")
    seqs = [amino[r].tobytes() for r in refs]
    # the same bounded-RAM build (the CLI's --mem-cap-gb in bytes), its
    # sorts checked
    again, entry, notes = timed(
        "build checks", checked_build, torch, dev, reps,
        f"protein-k20-disk, k = {KP}", launches["radix_sort"], seqs, KP,
        alphabet="Protein", disk_swap=swap, mem_cap_bytes=int(cap * (1 << 30)))
    if spilled(notes, "protein-k20-disk (checked sorts)") != chunks:
        raise AssertionError("build protein-k20-disk: the checked build "
                             "spilled another number of chunks")
    same_boss(g.boss, again.boss, "build protein-k20-disk (checked sorts)")
    del again
    uncapped = timed("build checks", DBGSuccinct.build, seqs, KP,
                     alphabet="Protein", device=dev)
    del seqs
    same_boss(g.boss, uncapped.boss, "build protein-k20-disk (uncapped)")
    del uncapped
    n = timed("build oracle", protein_oracle, g.boss, refs, KP, rng, sample)
    log(f"build protein-k20-disk oracle: {n} valid edges = distinct windows;"
        f" {chunks} chunks spilled; arrays equal to the uncapped build's")
    out["protein-k20-disk"] = (launches, {"radix_sort": entry})
    return out


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


BUILD_KERNELS = ("build_windows", "radix_sort", "build_join", "build_emit")


def counters():
    from metagraph_tpu_torch.align.sw import sw_scores
    from metagraph_tpu_torch.succinct import device_build
    from metagraph_tpu_torch.query.device import label_counts, selection_mask
    from metagraph_tpu_torch.scripts.exp_gather import gather_loop, gather_take
    from metagraph_tpu_torch.succinct.ops import (codes_lookup, key_lookup,
                                                  wire_lookup)
    from metagraph_tpu_torch.annotation.sparse_device import (
        overflow_counts, sparse_label_counts)
    from metagraph_tpu_torch.annotation.device_matrix import (
        brwt_row_words, rowdiff_row_words)
    from metagraph_tpu_torch.align.wave_extender import align_wave, wave_dp
    return {"align_wave": align_wave, "wave_dp": wave_dp,
            "wire_lookup": wire_lookup, "label_counts": label_counts,
            "selection_mask": selection_mask, "sw_scores": sw_scores,
            "gather_loop": gather_loop, "gather_take": gather_take,
            "key_lookup": key_lookup, "codes_lookup": codes_lookup,
            "sparse_label_counts": sparse_label_counts,
            "overflow_counts": overflow_counts,
            "brwt_row_words": brwt_row_words,
            "rowdiff_row_words": rowdiff_row_words,
            **{name: getattr(device_build, name) for name in BUILD_KERNELS}}


def run_path(fn):
    """Zero every launch counter, run ``fn``, read the counters."""
    fns = counters()
    for f in fns.values():
        f.launches = 0
    out = fn()
    return out, {name: f.launches for name, f in fns.items()}


def main_path(engine, seqs, codes, period, oracle, cfg, rng, torch, dev,
              tag="main path", modes=("labels", "counts"),
              kernels=("wire_lookup", "label_counts", "selection_mask"),
              check_last=False, oracle_of=None, idle=()):
    """Query the batch through ``query_records`` in each mode; hold a sample
    and the long sequence (last, of that ``period``; none without one; the
    last sequence with ``check_last``) against the oracle
    (``oracle_of(codes, mode)`` where given), and check that each of
    ``kernels`` launched and none of ``idle``.  The coords mode runs on the
    first ``coords_prefix`` reads, to bound the host time of its
    per-position lists."""
    from metagraph_tpu_torch.seq_io.fasta import FastaRecord
    canon, k = engine.index.canon, engine.k
    n_reads = len(seqs) - (1 if period else 0)
    sample = np.sort(rng.choice(n_reads, cfg["sample"], replace=False))
    if period or check_last:
        sample = np.union1d(sample, [len(seqs) - 1])   # the long sequence
    launches, long_count = {}, None
    for mode in modes:
        n = min(cfg["coords_prefix"], n_reads) if mode == "coords" \
            else len(seqs)
        records = [FastaRecord(f"r{i}", s) for i, s in enumerate(seqs[:n])]
        windows = sum(max(len(s) - k + 1, 0) for s in seqs[:n])
        total_bp = sum(len(s) for s in seqs[:n])

        def drive():
            t0 = time.perf_counter()
            res = list(engine.query_records(records, mode))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        (results, secs), launches[mode] = run_path(drive)
        st = engine.last_batch_seconds
        log(f"{tag} [{mode}]: {n} sequences, {total_bp} bp, "
            f"{windows} k-mers in {secs:.3f} s = {windows / secs:.4g} "
            f"k-mers/s (host packing {st['pack']:.3f} s, device incl. "
            f"uploads and downloads {st['device']:.3f} s, payloads "
            f"{st['collect']:.3f} s); launches {launches[mode]}")
        if len(results) != n:
            raise AssertionError(f"{len(results)} results for {n} sequences")
        t0 = time.perf_counter()
        mine = [i for i in sample if i < n]
        bad = [i for i in mine if not same_payload(
            results[i].payload, oracle_of(codes[i], mode) if oracle_of
            else oracle_payload(codes[i], mode, oracle, canon,
                                period if period and i == len(seqs) - 1
                                else 0))]
        if bad:
            raise AssertionError(f"{tag} {mode}: payloads differ from the "
                                 f"oracle for sequences {bad[:10]}")
        hits = sum(bool(results[i].payload) for i in mine)
        log(f"  oracle: {len(mine)} sequences equal ({hits} with hits) "
            f"in {time.perf_counter() - t0:.1f} s")
        if hits < MIN_HIT_SHARE * len(mine):
            raise AssertionError(
                f"{tag} {mode}: {hits} of {len(mine)} sampled sequences "
                f"have hits, below {MIN_HIT_SHARE}: the payload check "
                "holds too few labels")
        if mode == "counts" and period:
            long_res = results[-1].payload
            long_count = long_res[0][1] if long_res else 0
    if long_count is not None:
        n = long_count
        log(f"  long sequence: {len(seqs[-1]) - k + 1} windows, label count "
            f"{n} (> 2^24: {n > 1 << 24}; float32 would hold "
            f"{int(np.float32(n))})")
        if cfg is FULL and not (n > 1 << 24 and int(np.float32(n)) != n):
            raise AssertionError("the long sequence does not test the 2^24 "
                                 "bound")
    for mode, got in launches.items():
        for name in kernels:
            if dev.type == "cuda" and got[name] < 1:
                raise AssertionError(f"{name} never launched in the {mode} "
                                     f"run of the {tag}")
        for name in idle:
            if got[name]:
                raise AssertionError(f"{name} launched in the {mode} run "
                                     f"of the {tag}")
    return launches[modes[0]]


def seqs_oracle(o, starts, names, df=0.7, pf=0.0):
    """Independent oracle of a .seqs query (per-header k-mer membership by
    coordinate range): window w carries header h of label c iff one of its
    k-mer's positions in reference c lies in [starts[c][h],
    starts[c][h + 1]); a header's count is its windows; headers pass
    get_min_count and keep their first-seen order (window, label, position;
    no top-n cap); coords are each window's local positions.  ->
    oracle_of(codes, mode)."""
    import math
    cs, cp = o["coord_start"], o["coord_pos"]

    def oracle_of(codes, mode):
        nk = len(codes) - o["k"] + 1
        if nk <= 0:
            return []
        pos, hit = oracle_lookup(codes, o, 0)
        present = int(hit.sum())
        min_count = int(max(1.0, math.ceil(df * nk)))
        if present < max(1.0, math.ceil(pf * nk)) or present < min_count:
            return []
        seen = {}                  # (label, header) -> {window: [local]}
        for w in np.flatnonzero(hit):
            r = pos[w]
            for p in range(o["csr_start"][r], o["csr_start"][r + 1]):
                c = int(o["pair_label"][p])
                for x in cp[cs[p]: cs[p + 1]]:
                    h = int(np.searchsorted(starts[c], x, "right")) - 1
                    seen.setdefault((c, h), {}).setdefault(int(w), []) \
                        .append(int(x - starts[c][h]))
        out = []
        for (c, h), wins in seen.items():
            if len(wins) < min_count:
                continue
            name = names[c][h]
            if mode == "labels":
                out.append(name)
            elif mode == "matches":
                out.append((name, len(wins)))
            else:
                co = [[] for _ in range(nk)]
                for w, xs in wins.items():
                    co[w] = sorted(xs)
                out.append((name, len(wins), co))
        return out
    return oracle_of


def seqs_phase(cfg, index41, oracle41, refs, seqs41, codes41, rng, torch,
               dev, work):
    """The k41 deployment's coordinate annotation with a .seqs mapping
    (the port's CoordToHeader, saved and loaded back) that splits each
    label into ``seqs_headers`` headers of consecutive k-mers; the first
    ``coords_prefix`` reads in the labels, matches and coords modes: every
    batch maps through kernel A (W = 6) and aggregates per header on the
    host, no codes epoch."""
    from metagraph_tpu_torch.annotation.coord_to_header import CoordToHeader
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    nh = cfg["seqs_headers"]
    names, sizes = [], []
    for c, r in enumerate(refs):
        n = len(r) - K41 + 1
        sizes.append([n // nh] * (nh - 1) + [n - (nh - 1) * (n // nh)])
        names.append([f"ref{c}.{h}" for h in range(nh)])
    path = os.path.join(work, "k41.seqs")
    CoordToHeader(names, sizes).save(path)
    cth = CoordToHeader.load(path)
    t0 = time.perf_counter()
    engine = QueryEngine(index41, device=dev, coord_to_header=cth)
    log(f"seqs: {sum(map(len, names))} headers in {path} "
        f"({os.path.getsize(path)} B); engine and row index in "
        f"{time.perf_counter() - t0:.1f} s")
    n = cfg["coords_prefix"]
    starts = [np.concatenate([[0], np.cumsum(z)]) for z in sizes]
    launches = main_path(engine, seqs41[:n], codes41[:n], 0, oracle41, cfg,
                         rng, torch, dev, "k41 with .seqs (map route)",
                         modes=("labels", "matches", "coords"),
                         kernels=("key_lookup",),
                         oracle_of=seqs_oracle(oracle41, starts, names),
                         idle=("codes_lookup", "label_counts"))
    return launches, key_checks(engine, seqs41[:n], cfg, torch, dev,
                                " [seqs]", counts=False)


def parallel_phase(engine, seqs, cfg, torch, dev):
    """The basic deployment's batch cut into ``par_batches`` batches,
    queried sequentially and with ``par_threads`` batches in flight
    (``query -p``): the same output bytes and exactly the same launches of
    every kernel; both walls printed."""
    from metagraph_tpu_torch.seq_io.fasta import FastaRecord
    records = [FastaRecord(f"r{i}", s) for i, s in enumerate(seqs)]
    size = sum(len(s) for s in seqs) // cfg["par_batches"] + 1
    runs = {}
    for n in (1, cfg["par_threads"]):
        def drive():
            t0 = time.perf_counter()
            out = [r.to_string(":", False, False, engine.k) for r in
                   engine.query_records(records, "labels",
                                        batch_size_bp=size, n_threads=n)]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        (out, secs), launches = run_path(drive)
        runs[n] = (out, launches)
        log(f"parallel [labels, -p {n}]: {len(out)} sequences in batches "
            f"of {size} bp, wall {secs:.3f} s; launches {launches}")
    (a, la), (b, lb) = runs.values()
    if a != b:
        raise AssertionError("-p changed the output")
    if la != lb:
        raise AssertionError(f"-p changed the launches: {la} != {lb}")
    batches, acc = 0, 0
    for s in seqs:
        acc += len(s)
        if acc >= size:
            batches, acc = batches + 1, 0
    batches += acc > 0
    for name in ("wire_lookup", "label_counts", "selection_mask"):
        if dev.type == "cuda" and lb[name] < batches:
            raise AssertionError(f"{name} launched {lb[name]} times for "
                                 f"{batches} batches under -p")
    log(f"  parallel: {sum(map(len, a))} bytes equal to the sequential "
        "run's, launches equal")
    return lb


def wide_inputs(cfg, seed):
    """The wide deployments' references and reads, from a sixth stream of
    the seed: (DNA references, protein references, reads by stream: 0 and
    1 of the DNA references, 10% and 50% reverse-complemented, and
    "Protein"; the stream, which wide_phase's oracle samples go on
    drawing from)."""
    n_refs, ref_len, n_reads, read_len = cfg["wide"]
    rng = np.random.default_rng([seed, 6])
    dna = list(rng.integers(0, 4, (n_refs, ref_len)).astype(np.uint8))
    prot = list(rng.integers(0, 20, (n_refs, ref_len)).astype(np.uint8))
    reads = {
        0: make_reads(n_reads, read_len, rng, dna, 0.1, 0.002),
        1: make_reads(n_reads, read_len, rng, dna, 0.5, 0.002),
        "Protein": make_protein_batch(dict(cfg, n_reads=n_reads,
                                           read_len=read_len), rng, prot,
                                      0.002)}
    return dna, prot, reads, rng


def wide_phase(cfg, torch, dev, wide, timed):
    """The four WIDE deployments: references and reads from their own
    streams of the seed (``wide_inputs``: DNA shared by dna70 and dna70c,
    10% and 50% of its reads reverse-complemented; Protein by prot40 and
    prot80), labels mode
    against the oracle, then each kernel of the path against its plain
    version on the path's inputs (kernel B or A with an L2 control, 2, 3).
    The reads carry 0.2% substitutions: at 1% a read of 200 holds two on
    average, and each takes k windows, so that at k = 70 and 80 too few
    reads keep 70% of their k-mers for the oracle check to hold labels.
    -> {deployment: (launches, entries)}."""
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    dna, prot, reads, rng = wide
    out = {}
    for name, (alphabet, k, canon) in WIDE.items():
        index, oracle = timed("wide indexes", make_wide_deployment,
                              dna if alphabet == "DNA" else prot, alphabet,
                              k, canon)
        log(f"{name} index: {index.num_rows} k-mers (k = {k}, "
            f"{index.table.shape[1] // 16 - 1} words a key), hash table "
            f"{index.table.shape} = {index.table.nbytes} B")
        seqs, codes = reads["Protein" if alphabet == "Protein" else canon]
        engine = timed("uploads", QueryEngine, index, device=dev)
        kern = "codes_lookup" if engine.route == "codes" else "key_lookup"
        launches = timed(
            "query paths and oracle", main_path, engine, seqs, codes, 0,
            oracle, cfg, rng, torch, dev, f"{name} ({engine.route} route)",
            modes=("labels",),
            kernels=(kern, "label_counts", "selection_mask"))
        check = codes_checks if kern == "codes_lookup" else key_checks
        kw = {"long": False} if kern == "codes_lookup" else {}
        out[name.replace("-", "_")] = (launches, timed(
            "kernel checks", check, engine, seqs, cfg, torch, dev,
            f" [{name}]", **kw))
        del engine, index, oracle
    return out


def lex_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """2-bit keys (char i at bits 2i) -> integers in the order of the
    codes read left to right (char 0 most significant): the order of a
    bitmap or sshash graph's node ids."""
    out = np.zeros_like(keys)
    for i in range(k):
        out |= ((keys >> np.uint64(2 * i)) & np.uint64(3)) \
            << np.uint64(2 * (k - 1 - i))
    return out


def rank_of(keys: np.ndarray) -> np.ndarray:
    """Each key's rank among ``keys`` (distinct)."""
    rank = np.empty(len(keys), np.int64)
    rank[np.argsort(keys, kind="stable")] = np.arange(len(keys))
    return rank


def moved_annotation(anno, row_of: np.ndarray):
    """A column annotation with row r moved to ``row_of[r]`` (values moved
    with their rows)."""
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    cols, vals = [], []
    for c in range(anno.num_labels):
        rows = row_of[anno.column_rows(c)]
        order = np.argsort(rows, kind="stable")
        cols.append(rows[order])
        if anno.has_values:
            vals.append(anno.values_of(anno.column_rows(c), c)[order])
    return ColumnMajorAnnotation(len(row_of), anno.labels, cols,
                                 values=vals if anno.has_values else None,
                                 has_values=anno.has_values)


def graph_types_phase(cfg, deployments, seqs, codes, rng, torch, dev,
                      timed):
    """Each graph-types deployment through ``convert.from_graph``: it must
    take the map route; the labels mode (and the counts mode on bitmap, on
    the basic batch's first ``bitmap_reads`` reads) against the oracle,
    then kernels A (with an L2 control), 2 and 3 against their plain
    versions.  -> {deployment: (launches, entries)}."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    out = {}
    for name, (graph, anno, oracle, reads) in deployments.items():
        t0 = time.perf_counter()
        index = timed("graph-types indexes", convert.from_graph, graph,
                      anno)
        log(f"{name} index: {index.num_rows} rows, graph type "
            f"{index.graph_type}, canon {index.canon}, hash table "
            f"{index.table.shape} = {index.table.nbytes} B; "
            f"convert.from_graph in {time.perf_counter() - t0:.1f} s")
        engine = timed("uploads", QueryEngine, index, device=dev)
        if engine.route != "map":
            raise AssertionError(f"{name} takes the {engine.route} route")
        n = cfg["bitmap_reads"]
        s, c, p = (seqs[:n], codes[:n], 0) if reads is None \
            else (reads[0], reads[1], 0)
        launches = timed(
            "query paths and oracle", main_path, engine, s, c, p, oracle,
            cfg, rng, torch, dev, f"{name} graph (map route)",
            modes=("labels", "counts") if name == "bitmap" else ("labels",),
            kernels=("key_lookup", "label_counts", "selection_mask"),
            idle=("wire_lookup", "codes_lookup"))
        out[name.replace("-", "_")] = (launches, timed(
            "kernel checks", key_checks, engine, s, cfg, torch, dev,
            f" [{name}]"))
        del engine, index
    return out


# --------------------------------------------------------------------------
# the last flags of build --device: --graph, --suffix, --index-ranges, KMC
# --------------------------------------------------------------------------

GRAPH_BUILDS = {"bitmap": ("bitmap", "basic"),
                "hash-canonical": ("hash", "canonical"),
                "sshash": ("sshash", "basic")}


def suffix_range_oracle(boss, distinct, k, phases):
    """The pan build's suffix-range index (``--index-ranges SUFFIX_L``)
    against an independent count: each live combo's range holds as many
    nodes as there are distinct nodes ending in its SUFFIX_L characters,
    counted here from the sorted distinct 2-bit keys of the valid edges:
    the (k-1)-mers that begin or end an edge, and the dummy source nodes
    $^j P[:k-1-j] of each node P that no edge enters (j <= k-1-SUFFIX_L,
    so that its last SUFFIX_L characters are real); a dead combo holds
    none."""
    L, n = SUFFIX_L, k - 1
    t0 = time.perf_counter()
    if boss.suffix_L != L or "index suffix ranges" not in phases:
        raise AssertionError(f"pan: no suffix-range index of length {L} "
                             f"(suffix_L {boss.suffix_L}, phases "
                             f"{sorted(phases)})")
    tail = np.uint64((1 << (2 * L)) - 1)

    def combos(keys, length):
        return ((keys >> np.uint64(2 * (length - L))) & tail).astype(
            np.int64)
    pre = distinct_sorted(np.sort(distinct & np.uint64((1 << (2 * n)) - 1)))[0]
    suf = distinct_sorted(np.sort(distinct >> np.uint64(2)))[0]
    at = np.minimum(np.searchsorted(suf, pre), len(suf) - 1)
    shared = suf[at] == pre
    want = np.bincount(combos(pre, n), minlength=4 ** L) \
        + np.bincount(combos(suf, n), minlength=4 ** L) \
        - np.bincount(combos(pre[shared], n), minlength=4 ** L)
    src = pre[~shared]
    for j in range(1, n - L + 1):
        head = np.unique(src & np.uint64((1 << (2 * (n - j))) - 1))
        want += np.bincount(combos(head, n - j), minlength=4 ** L)
    cum = np.concatenate([[0], np.cumsum(boss.last, dtype=np.int64)])
    width = np.where(boss.suf_ok == 1, cum[boss.suf_ru + 1]
                     - cum[boss.suf_rl], 0)
    if not np.array_equal(width, want):
        bad = np.flatnonzero(width != want)
        raise AssertionError(f"pan: {len(bad)} suffix ranges of the wrong "
                             f"width, e.g. combo {bad[0]}: "
                             f"{width[bad[0]]} nodes, {want[bad[0]]} wanted")
    log(f"build pan suffix ranges: {int((boss.suf_ok == 1).sum())} of "
        f"{4 ** L} combos of {L} characters live, every range's width the "
        f"count of nodes with its suffix ({int(want.sum())} nodes, "
        f"{len(src)} without an incoming edge); index "
        f"{phases['index suffix ranges']:.3f} s, oracle "
        f"{time.perf_counter() - t0:.1f} s")


def kmer_graph_maps(oracle, anno, wide):
    """The graph-types deployments as computed here, independently of the
    port: {name: (sorted distinct 2-bit keys, their node ids, annotation,
    oracle, reads)}.  bitmap: the basic deployment's k-mers, id = 1 + rank
    in left-to-right code order (the reads are the caller's: None);
    hash-canonical: the wide DNA references' windows, each reference's
    forward windows then its reverse complement's, id = rank of first
    occurrence, labels on the strand first in BOSS order; sshash: their
    forward windows, id = 1 + rank in left-to-right code order."""
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    out = {}
    keys = oracle["keys"]
    rank = rank_of(lex_keys(keys, K))
    out["bitmap"] = (keys, rank + 1, moved_annotation(anno, rank), oracle,
                     None)
    dna, _, reads, _ = wide
    L = len(dna)
    labels = [f"ref{i}" for i in range(L)]
    fwd = [window_keys(r, K)[0] for r in dna]
    labs = np.concatenate([np.full(len(f), i, np.int64)
                           for i, f in enumerate(fwd)])
    rc = [rc_window_keys(r, K) for r in dna]
    order = np.concatenate([np.concatenate([f, r[::-1]])
                            for f, r in zip(fwd, rc)])
    ukeys, first = np.unique(order, return_index=True)
    ids = np.empty(len(ukeys), np.int64)
    ids[np.argsort(first)] = np.arange(1, len(ukeys) + 1)
    fwd_all, rc_all = np.concatenate(fwd), np.concatenate(rc)
    probed = np.where(boss_rot(fwd_all, K) <= boss_rot(rc_all, K), fwd_all,
                      rc_all)
    rows = ids[np.searchsorted(ukeys, probed)] - 1
    cols = [np.unique(rows[labs == c]) for c in range(L)]
    out["hash-canonical"] = (
        ukeys, ids, ColumnMajorAnnotation(len(ukeys), labels, cols),
        make_oracle(np.minimum(fwd_all, rc_all), labs, L), reads[1])
    o = make_oracle(fwd_all, labs, L)
    rank = rank_of(lex_keys(o["keys"], K))
    out["sshash"] = (o["keys"], rank + 1,
                     moved_annotation(annotation_of(o, labels), rank), o,
                     reads[0])
    return out


def chars_keys(chars: np.ndarray) -> np.ndarray:
    """(n, k) DNA codes 1..4 -> 2-bit keys (char i at bits 2i)."""
    key = np.zeros(len(chars), np.uint64)
    for i in range(chars.shape[1]):
        key |= (chars[:, i].astype(np.uint64) - np.uint64(1)) \
            << np.uint64(2 * i)
    return key


def check_kmer_file(path, gtype, mode, keys, ids):
    """A ``build --graph`` file against the ids computed here: the JAX
    layout's keys, its graph type and mode, every k-mer once with its
    id."""
    with np.load(path) as z:
        files = sorted(z.files)
        kmers, got = z["kmers"], z["ids"]
        tags = (str(z["graph_type"]), int(z["k"]), str(z["mode"]),
                str(z["alphabet"]))
    if files != ["alphabet", "graph_type", "ids", "k", "kmers", "mode"] \
            or tags != (gtype, K, mode, "DNA") or kmers.dtype != np.uint8 \
            or got.dtype != np.int64:
        raise AssertionError(f"{path}: keys {files}, tags {tags}")
    key = chars_keys(kmers)
    at = np.minimum(np.searchsorted(keys, key), len(keys) - 1)
    if len(key) != len(keys) or not np.array_equal(keys[at], key) \
            or len(np.unique(at)) != len(keys) \
            or not np.array_equal(ids[at], got):
        raise AssertionError(f"{path}: its k-mers and ids are not those "
                             "computed here")


def graph_build_phase(cfg, maps, refs, wide, work, torch, dev, timed):
    """``build --graph`` through the port's CLI: bitmap (the basic
    deployment's references), hash ``--mode canonical`` and sshash (the
    wide DNA references), at k = 31, every D2 call held against its plain
    version as the build runs (``sort_checks``: its wall includes the
    checks).  Each file's k-mers and ids against ``kmer_graph_maps``.  ->
    (the files, {deployment: (launches, entries)})."""
    inputs = {"basic": (os.path.join(work, "basic.fa"), refs),
              "wide": (os.path.join(work, "wide-dna.fa"), wide[0])}
    for fa, codes in inputs.values():
        timed("build inputs", write_records, fa, codes)
    paths, out = {}, {}
    for name, (rep, mode) in GRAPH_BUILDS.items():
        fa, codes = inputs["basic" if name == "bitmap" else "wide"]
        base = os.path.join(work, f"graph-{name}")
        spy = sort_checks(torch, dev, cfg["build_reps"], f"graph {name}")
        with spy.active():
            wall, phases, nodes, _ = timed(
                "graph builds", run_path, lambda: cli_build(
                    fa, base, K, dev, ["--graph", rep, "--mode", mode]))[0]
        log(f"build --graph {rep} --mode {mode} ({name}): {len(codes)} "
            f"sequences, k = {K}: {nodes} nodes in {wall:.1f} s ("
            + ", ".join(f"{p} {v:.3f}" for p, v in phases.items()) + ")")
        if dev.type == "cuda" and not spy.path_launches():
            raise AssertionError(f"build --graph {rep} launched no D2")
        keys, ids = maps[name][:2]
        timed("graph builds", check_kmer_file, base + ".dbg.npz", rep, mode,
              keys, ids)
        if nodes != len(keys):
            raise AssertionError(f"{name}: {nodes} nodes, {len(keys)} "
                                 "k-mers")
        log(f"build --graph {rep} ({name}) oracle: {len(keys)} k-mers, "
            "each with the id computed here")
        paths[name] = base + ".dbg.npz"
        out["graph_" + name.replace("-", "_")] = (
            {"radix_sort": spy.path_launches()}, {"radix_sort": spy.entry()})
    return paths, out


def load_kmer_graphs(maps, paths):
    """The graph-types deployments from the ``build --graph`` files, each
    loaded through ``DBGSuccinct.load`` (node ids rebuilt from the file):
    -> {name: (graph, annotation, oracle, reads)}."""
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    out = {}
    for name, path in paths.items():
        t0 = time.perf_counter()
        graph = DBGSuccinct.load(path[:-4])
        log(f"{name}: {os.path.getsize(path)} B file; loaded and rebuilt "
            f"({type(graph).__name__}, {graph.max_index()} nodes) in "
            f"{time.perf_counter() - t0:.1f} s")
        out[name] = (graph, *maps[name][2:])
    return out


def suffix_phase(cfg, wide, work, torch, dev, timed):
    """``build --suffix`` A, C, G, T and $ on the wide DNA references at
    k = 31, each D2 call held against its plain version as the builds run:
    each chunk's k-mers carry its suffix as their last node character and
    are distinct valid windows of the input, the $ chunk is empty, and the
    four counts sum to the distinct count (numpy 2-bit keys).  ->
    (launches, entries)."""
    fa = os.path.join(work, "wide-dna.fa")
    distinct = distinct_sorted(sorted_window_keys(np.stack(wide[0]), K))[0]
    total = 0
    spy = sort_checks(torch, dev, cfg["build_reps"], "suffix chunks")
    for s in "ACGT$":
        base = os.path.join(work, "wide")
        with spy.active():
            wall, phases, n, _ = timed(
                "suffix chunks", run_path, lambda: cli_build(
                    fa, base, K, dev, ["--suffix", s]))[0]
        with np.load(f"{base}.{s}.chunk.npz") as z:
            kmers = z["kmers"]
        log(f"build --suffix {s}: {n} k-mers in {wall:.1f} s (" + ", ".join(
            f"{p} {v:.3f}" for p, v in phases.items()) + ")")
        if len(kmers) != n or (s == "$") != (n == 0):
            raise AssertionError(f"chunk {s}: {n} k-mers, {len(kmers)} in "
                                 "its file")
        if s == "$":
            continue
        key = chars_keys(kmers)
        at = np.minimum(np.searchsorted(distinct, key), len(distinct) - 1)
        if not (kmers[:, K - 2] == "ACGT".index(s) + 1).all() \
                or not np.array_equal(distinct[at], key) \
                or len(np.unique(key)) != n:
            raise AssertionError(f"chunk {s}: a k-mer without its suffix, "
                                 "twice, or no window of the input")
        total += n
    if total != len(distinct):
        raise AssertionError(f"the chunks hold {total} k-mers, the input "
                             f"{len(distinct)}")
    log(f"build --suffix oracle: the chunks A, C, G, T hold the "
        f"{len(distinct)} distinct k-mers, each once with its suffix; $ "
        "empty")
    if dev.type == "cuda" and not spy.path_launches():
        raise AssertionError("build --suffix launched no D2")
    return {"radix_sort": spy.path_launches()}, {"radix_sort": spy.entry()}


def write_kmc(base: str, kmers: np.ndarray, counts: np.ndarray,
              lut_prefix_length: int = 4, counter_size: int = 4):
    """``base``.kmc_pre/.kmc_suf from (N, k) ACGT byte k-mers (distinct)
    and their counts, in the KMC3 layout ``seq_io/kmc.py`` reads: the
    records sorted by their 2-bit codes (A < C < G < T), a suffix's codes
    4 a byte from the most significant bits, the counter little-endian,
    the strand byte 1 (``both_strands`` False)."""
    import struct
    N, k = kmers.shape
    lp = lut_prefix_length
    code = np.full(256, 255, dtype=np.uint8)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    c = code[kmers]
    if (c == 255).any() or not 0 < lp < k:
        raise ValueError("KMC k-mers hold A, C, G and T only, longer than "
                         "the prefix")
    order = np.lexsort(c.T[::-1])
    c, counts = c[order], np.asarray(counts, dtype=np.uint64)[order]
    prefix = np.zeros(N, dtype=np.int64)
    for i in range(lp):
        prefix = (prefix << 2) | c[:, i]
    nsb = (k - lp + 3) // 4
    rec = np.zeros((N, nsb + counter_size), dtype=np.uint8)
    for p in range(k - lp):
        rec[:, p // 4] |= c[:, lp + p] << np.uint8(6 - 2 * (p % 4))
    for b in range(counter_size):
        rec[:, nsb + b] = ((counts >> np.uint64(8 * b))
                           & np.uint64(255)).astype(np.uint8)
    lut = np.searchsorted(prefix, np.arange(4 ** lp)).astype("<u8")
    header = struct.pack("<6IQ", k, 0, counter_size, lp, 1,
                         int(counts.max()), N) + bytes([1]) + bytes(31)
    with open(base + ".kmc_pre", "wb") as f:
        f.write(b"KMCP" + lut.tobytes() + header
                + struct.pack("<I", len(header)) + b"KMCP")
    with open(base + ".kmc_suf", "wb") as f:
        f.write(b"KMCS" + rec.tobytes() + b"KMCS")


def kmc_phase(cfg, wide, work, torch, dev, timed, rng):
    """A KMC database written here (``write_kmc``) of the
    canonical 21-mers (the lesser strand in A < C < G < T order) of the
    wide DNA references and their first stream's reads, with their counts
    (occurrences of either strand: about 3x coverage), built with
    ``build -k 31 --mode canonical --count-kmers``: k taken from the
    database with the JAX warning; the valid edges are both strands'
    distinct keys and each sampled edge's weight its count capped at 255
    (``build_oracle``); each D2 call held against its plain version as the
    build runs.  -> (launches, entries)."""
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    k = KMC_K
    t0 = time.perf_counter()
    fwd = np.concatenate([kk[ok] for kk, ok in (
        window_keys(r, k) for r in list(wide[0]) + list(wide[2][0][1]))])
    distinct, counts = distinct_sorted(np.sort(np.concatenate(
        [fwd, rc_keys(fwd, k)])))
    del fwd
    lesser = lex_keys(distinct, k) < lex_keys(rc_keys(distinct, k), k)
    letters = np.frombuffer(b"ACGT", np.uint8)
    canon = distinct[lesser]
    chars = letters[(canon[:, None] >> np.uint64(2) * np.arange(
        k, dtype=np.uint64)) & np.uint64(3)]
    base = os.path.join(work, "wide-k21")
    write_kmc(base, chars, counts[lesser])
    log(f"KMC database: {len(canon)} canonical {k}-mers, counts up to "
        f"{int(counts.max())}, written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "kmc-k21")
    spy = sort_checks(torch, dev, cfg["build_reps"], "KMC, k = 21")
    with spy.active():
        wall, phases, nodes, notes = timed(
            "kmc build", run_path, lambda: cli_build(
                base + ".kmc_suf", out, K, dev,
                ["--mode", "canonical", "--count-kmers"]))[0]
    log(f"build KMC --mode canonical --count-kmers: {nodes} nodes in "
        f"{wall:.1f} s (" + ", ".join(f"{p} {v:.3f}"
                                      for p, v in phases.items())
        + "); " + "; ".join(notes))
    if f"warning: using k={k} from KMC database" not in notes \
            or not any(n.startswith("build route: general ") for n in notes):
        raise AssertionError(f"KMC build: k not taken from the database or "
                             f"not the general route: {notes}")
    if dev.type == "cuda" and not spy.path_launches():
        raise AssertionError("KMC build launched no D2")
    g = DBGSuccinct.load(out + ".dbg")
    if g.num_nodes() != nodes:
        raise AssertionError("KMC build: nodes")
    timed("kmc build", build_oracle, g.boss, distinct, k, rng,
          cfg["build_sample"], counts, 255)
    log(f"build KMC oracle: {len(distinct)} valid edges = both strands of "
        f"the {len(canon)} canonical k-mers; {cfg['build_sample']} decoded "
        "edges among them, each weight its count capped at 255")
    return {"radix_sort": spy.path_launches()}, {"radix_sort": spy.entry()}


# --------------------------------------------------------------------------
# A10: the older epochs and the dedup epoch, on the basic deployment
# --------------------------------------------------------------------------

def profiled_ms(torch, dev, fn):
    """Device ms of the kernels one call of ``fn`` launches: the sum of
    their self device times under torch.profiler; None on the CPU or
    where the profiler records no device time."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0
             for e in prof.key_averages())
    return us / 1e3 if us > 0 else None


def oracle_counts(codes, o):
    """A read's label counts (its windows whose k-mer carries the label)
    and present windows, from the oracle."""
    pos, hit = oracle_lookup(codes, o, 0)
    urows, rmult = np.unique(pos[hit], return_counts=True)
    lo, hi = o["csr_start"][urows], o["csr_start"][urows + 1]
    span = hi - lo
    idx = np.repeat(lo - np.cumsum(np.concatenate([[0], span[:-1]])),
                    span) + np.arange(span.sum())
    counts = np.zeros(o["L"], np.int64)
    np.add.at(counts, o["pair_label"][idx], np.repeat(rmult, span))
    return counts, int(hit.sum())


def a10_graph(refs, oracle, labels, dev):
    """The basic references' graph built by the port (``DBGSuccinct.build``,
    k = 31) with the oracle's labels placed on its node ids
    (``graph_annotation``)."""
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    letters = np.frombuffer(b"ACGTN", np.uint8)
    g = DBGSuccinct.build([letters[r].tobytes() for r in refs], K,
                          device=dev)
    return g, graph_annotation(g, oracle, labels)


def graph_annotation(g, oracle, labels):
    """The oracle's labels placed on a graph's node ids (each valid edge,
    decoded, found among the oracle's keys): a column annotation."""
    from metagraph_tpu_torch.annotation.column import ColumnMajorAnnotation
    edges = np.flatnonzero(g.boss.valid)
    key = chars_keys(g.boss.get_edge_seq(edges))
    keys = oracle["keys"]
    pos = np.minimum(np.searchsorted(keys, key), len(keys) - 1)
    if len(edges) != len(keys) or not np.array_equal(keys[pos], key):
        raise AssertionError("the graph's edges are not the oracle's "
                             "k-mers")
    lo, hi = oracle["csr_start"][pos], oracle["csr_start"][pos + 1]
    span = hi - lo
    idx = np.repeat(lo - np.cumsum(np.concatenate([[0], span[:-1]])),
                    span) + np.arange(span.sum())
    lab = oracle["pair_label"][idx]
    row = np.repeat(edges - 1, span)
    order = np.lexsort((row, lab))
    start = np.searchsorted(lab[order], np.arange(len(labels) + 1))
    cols = [row[order[start[c]: start[c + 1]]] for c in range(len(labels))]
    return ColumnMajorAnnotation(g.max_index(), labels, cols)


def a10_phase(cfg, refs, oracle, labels, seqs, codes, rng, torch, dev,
              timed):
    """The JAX package's own workload (``DeviceQueryPipeline``,
    ``query_step``, ``query_epoch_tiled``, ``query_epoch_codes``,
    ``query_epoch_dedup`` with ``dedup_batch``) on the basic deployment's
    references, built by the port at k = 31 (``a10_graph``), with the
    basic batch's reads: each epoch's counts and presence equal to
    ``query_step``'s, a sample's to the oracle's; ``query_labels`` in the
    labels and matches modes against the oracle's payloads; kernels A and
    2 against their plain versions at these shapes, D2 checked as
    ``dedup_batch``'s distinct pass runs it.  -> (launches, entries, the
    graph, its annotation)."""
    from metagraph_tpu_torch._u32 import to_u64
    from metagraph_tpu_torch.query import device as qd
    from metagraph_tpu_torch.succinct import ops
    n = cfg["n_reads"]
    rseqs, rcodes = seqs[:n], codes[:n]
    S, L = n, len(labels)
    t0 = time.perf_counter()
    g, anno = timed("a10 graph", a10_graph, refs, oracle, labels, dev)
    t1 = time.perf_counter()
    pipe = timed("a10 graph", qd.DeviceQueryPipeline, g, anno, device=dev)
    log(f"a10 graph: {g.num_nodes()} k-mers (k = {K}), {L} labels; built "
        f"and labelled in {t1 - t0:.1f} s, DeviceQueryPipeline in "
        f"{time.perf_counter() - t1:.1f} s (hash table "
        f"{tuple(pipe.index.table.shape)}, bitmap "
        f"{tuple(pipe.annotation.bitmap.shape)})")
    table, bitmap = pipe.index.table, pipe.annotation.bitmap
    res, secs, calls = {}, {}, {}
    # D2 in dedup_batch's distinct pass, each call checked as it runs
    spy = sort_checks(torch, dev, cfg["build_reps"], "a10 dedup_batch")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def epoch(name, fn, *args):
        sync()
        t = time.perf_counter()
        res[name] = fn(*args)
        sync()
        secs[name] = time.perf_counter() - t
        calls[name] = (fn, args)

    def drive():
        t = time.perf_counter()
        q, sid, nk = pipe._prepare(rseqs)
        sync()
        secs["prepare_batch"] = time.perf_counter() - t
        epoch("query_step", qd.query_step, table, bitmap, q, sid, S, L)
        qh, sh = q.cpu().numpy(), sid.cpu().numpy()
        tiles, tile_seq = qd.tile_layout(qh.view(np.uint32), sh, S)
        tiles_t = torch.from_numpy(tiles.view(np.int32)).to(dev)
        tile_seq_t = torch.from_numpy(tile_seq).to(dev)
        epoch("query_epoch_tiled", qd.query_epoch_tiled, table, bitmap,
              tiles_t, tile_seq_t, S, L)
        ex = g.extractor
        ct, ts, _ = qd.tile_codes_layout([ex.encode(s) for s in rseqs], K)
        epoch("query_epoch_codes", qd.query_epoch_codes, table, bitmap,
              torch.from_numpy(ct).to(dev), torch.from_numpy(ts).to(dev), S,
              L, K)
        t = time.perf_counter()
        with spy.active():
            dk, dt, dts, D = qd.dedup_batch(qh.view(np.uint32), sh, S,
                                            device=dev)
        secs["dedup_batch"] = time.perf_counter() - t
        epoch("query_epoch_dedup", qd.query_epoch_dedup, table, bitmap,
              torch.from_numpy(dk.view(np.int32)).to(dev),
              torch.from_numpy(dt).to(dev), torch.from_numpy(dts).to(dev),
              S, L)
        for mode in ("labels", "matches"):
            t = time.perf_counter()
            res[mode] = pipe.query_labels(rseqs, mode)
            secs[f"query_labels {mode}"] = time.perf_counter() - t
        return q, sid, nk, tiles_t, tile_seq_t, D
    (q, sid, nk, tiles_t, tile_seq_t, D), launches = timed(
        "a10 epochs", run_path, drive)
    # the path's own D2 launches, not the checks'
    launches["radix_sort"] = spy.path_launches()
    for kern in ("key_lookup", "label_counts", "radix_sort"):
        if dev.type == "cuda" and not launches[kern]:
            raise AssertionError(f"a10 launched no {kern}")
    for kern in ("wire_lookup", "codes_lookup", "selection_mask"):
        if launches[kern]:
            raise AssertionError(f"a10 launched {kern}")
    # each epoch once more under the profiler, outside the counted run
    dms = {name: profiled_ms(torch, dev, lambda: fn(*args))
           for name, (fn, args) in calls.items()}
    windows = int(sum(nk))
    for name in ("query_step", "query_epoch_tiled", "query_epoch_codes",
                 "query_epoch_dedup"):
        ms = dms[name]
        log(f"a10 {name}: {secs[name]:.3f} s, device "
            + ("not measured" if ms is None else f"{ms:.3f} ms")
            + f", {windows / secs[name]:.4g} k-mers/s")
    log(f"a10 prepare_batch {secs['prepare_batch']:.3f} s, dedup_batch "
        f"{secs['dedup_batch']:.3f} s: {D} distinct of {len(q)} windows "
        f"({D / len(q):.4f}); query_labels labels "
        f"{secs['query_labels labels']:.3f} s, matches "
        f"{secs['query_labels matches']:.3f} s")
    counts, present = res["query_step"][:2]
    for name in ("query_epoch_tiled", "query_epoch_codes",
                 "query_epoch_dedup"):
        c, p = res[name][:2]
        if not (torch.equal(c, counts) and torch.equal(p, present)):
            raise AssertionError(f"a10 {name}: counts differ from "
                                 "query_step's")
    # the tiled epoch's padding keys take the JAX probe's answer (-1 or
    # 0), the codes epoch's invalid windows 0
    nodes_tiled = res["query_epoch_tiled"][2]
    if not torch.equal(res["query_epoch_codes"][2], nodes_tiled.clamp(0)):
        raise AssertionError("a10: the codes epoch's nodes differ")
    pick = rng.choice(S, min(cfg["sample"], S), replace=False)
    ch, ph = counts[torch.from_numpy(pick).to(dev)].cpu().numpy(), \
        present[torch.from_numpy(pick).to(dev)].cpu().numpy()
    hits = 0
    for j, i in enumerate(pick):
        want_c, want_p = oracle_counts(rcodes[i], oracle)
        if not (np.array_equal(ch[j], want_c) and ph[j] == want_p):
            raise AssertionError(f"a10: read {i}'s counts differ from the "
                                 "oracle's")
        for mode in ("labels", "matches"):
            want = oracle_payload(rcodes[i], mode, oracle)
            if res[mode][i] != want:
                raise AssertionError(f"a10: read {i}'s {mode} differ from "
                                     f"the oracle's: {res[mode][i][:5]} "
                                     f"{want[:5]}")
        hits += bool(want)
    if hits < MIN_HIT_SHARE * len(pick):
        raise AssertionError(f"a10: only {hits} sampled reads with labels")
    log(f"a10 oracle: {len(pick)} sampled reads' counts, presence, labels "
        f"and matches ({hits} with labels); every epoch's counts equal")
    entries = {}
    # kernel A on the batch's windows (its padding rows get the JAX answer
    # without a probe), kernel 2 on the tiled epoch's nodes
    live = q[~(q == -1).all(dim=1)]
    chunk = 1 << 16
    ids = ops.key_lookup(live, table)
    groups_bytes, _ = probe_bytes(table, (to_u64(live[lo: lo + chunk])
                                          for lo in range(0, len(live),
                                                          chunk)),
                                  torch, dev)
    add_entry(entries, torch, " [a10]", "key_lookup", [ids],
              [ops.key_lookup_plain(live, table, chunk)],
              device_ms(torch, dev, lambda: ops.key_lookup(live, table), 10),
              device_ms(torch, dev, lambda: ops.key_lookup_plain(
                  live, table, chunk), 1),
              live.nbytes + ids.nbytes + groups_bytes)
    _, c2 = cfg["plain_chunks"]
    got = qd.label_counts(nodes_tiled, bitmap, tile_seq_t, S, L)
    rows = int(torch.unique(nodes_tiled[nodes_tiled > 0]).numel())
    add_entry(entries, torch, " [a10]", "label_counts", got,
              qd.label_counts_plain(nodes_tiled, bitmap, tile_seq_t, S, L,
                                    c2),
              device_ms(torch, dev, lambda: qd.label_counts(
                  nodes_tiled, bitmap, tile_seq_t, S, L), 10),
              device_ms(torch, dev, lambda: qd.label_counts_plain(
                  nodes_tiled, bitmap, tile_seq_t, S, L, c2), 1),
              nodes_tiled.nbytes + tile_seq_t.nbytes
              + rows * bitmap.shape[1] * 4 + got[0].nbytes + got[1].nbytes)
    entries["radix_sort"] = spy.entry()
    return {k: launches[k] for k in ("key_lookup", "label_counts",
                                     "radix_sort")}, entries, g, anno


def server_phase(cfg, index, graph, seqs, codes, oracle, torch, dev,
                 aseqs, akinds):
    """The basic deployment's index served by the port's MetaGraphServer
    on 127.0.0.1 (a port the system chooses) with ``graph``, the 3b graph
    of the same k-mers: eight /search requests of ``server_reads`` reads,
    two at a time from two client threads, in the matches, signature and
    counts-sum modes; each reply equal to the engine's sequential
    ``query_records`` output and, label and count, to the oracle; then
    /stats, /column_labels, a malformed request, /align of a 4 bp read
    (no alignment), and two /align requests in flight together (phase 8b,
    step 4: ``aseqs`` halved, the second with two alternative alignments),
    under the launch counters (one ``align_wave`` a wave), each reply
    equal to the same request's sequential reply and every alignment held
    to ``check_aligned``.  -> the launches of the /search requests."""
    import threading
    import urllib.error
    import urllib.request
    from metagraph_tpu_torch.seq_io.fasta import FastaRecord
    from metagraph_tpu_torch.server.server import MetaGraphServer
    t0 = time.perf_counter()
    server = MetaGraphServer(graph, index.annotation, device=dev,
                             index=index)
    server.serve("127.0.0.1", 0, background=True)
    log(f"server: listening on 127.0.0.1:{server.port} after "
        f"{time.perf_counter() - t0:.1f} s")
    n = cfg["server_reads"]
    modes = ["matches", "signature", "counts-sum"] * 3
    flag = {"matches": {}, "signature": {"with_signature": True},
            "counts-sum": {"abundance_sum": True}}
    jobs = [(i, modes[i], list(range(i * n, (i + 1) * n))) for i in range(8)]

    def ask(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/{path}",
            data=None if body is None else body.encode(),
            method="GET" if body is None else "POST")
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as f:
                code, reply = f.status, json.loads(f.read())
        except urllib.error.HTTPError as e:
            code, reply = e.code, json.loads(e.read())
        return code, reply, time.perf_counter() - t

    replies = {}

    def client(mine):
        for i, mode, which in mine:
            fasta = "".join(f">r{j}\n{seqs[j].decode()}\n" for j in which)
            replies[i] = ask("search", json.dumps(dict(FASTA=fasta,
                                                       **flag[mode])))

    def drive():
        threads = [threading.Thread(target=client, args=(jobs[t::2],))
                   for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    try:
        _, launches = run_path(drive)
        for i, mode, which in jobs:
            code, got, secs = replies[i]
            log(f"server /search {i} [{mode}]: {len(which)} reads, status "
                f"{code}, {secs:.3f} s")
            if code != 200:
                raise AssertionError(f"server /search {i}: status {code}")
            recs = [FastaRecord(f"r{j}", seqs[j]) for j in which]
            want = sorted((json.loads(r.to_json(False, index.k)) for r in
                           server.engine.query_records(recs, mode, 10000,
                                                       0.7, 0.0)),
                          key=lambda r: r["seq_description"])
            if got != want:
                raise AssertionError(f"server /search {i} [{mode}] differs "
                                     "from the engine's sequential run")
            oracle_mode = "counts-sum" if mode == "counts-sum" \
                else "matches"
            hits = 0
            for r in got:
                j = int(r["seq_description"][1:])
                pairs = [(x["sample"], x["kmer_count"]) for x in r["results"]]
                if pairs != oracle_payload(codes[j], oracle_mode, oracle,
                                           top=10000):
                    raise AssertionError(f"server /search {i}: read {j} "
                                         "differs from the oracle")
                hits += bool(pairs)
            if hits < MIN_HIT_SHARE * len(got):
                raise AssertionError(f"server /search {i}: {hits} of "
                                     f"{len(got)} reads with hits")
        log(f"  server: 8 replies equal to the sequential engine and the "
            f"oracle; launches {launches}")
        for name in ("wire_lookup", "label_counts", "selection_mask"):
            if dev.type == "cuda" and launches[name] < 8:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     "times for 8 requests")
        checks = [("stats", None, 200), ("column_labels", None, 200),
                  ("search", "{FASTA", 400),
                  ("align", json.dumps({"FASTA": ">a\nACGT\n"}), 200)]
        for path, body, status in checks:
            code, reply, secs = ask(path, body)
            log(f"server /{path}: status {code}, {secs:.3f} s: "
                f"{json.dumps(reply)[:160]}")
            if code != status:
                raise AssertionError(f"server /{path}: status {code}, "
                                     f"expected {status}")
            if path == "column_labels" and reply != index.labels:
                raise AssertionError("server /column_labels differs")
            if path == "align" and reply != [{"seq_description": "a",
                                              "alignments": []}]:
                raise AssertionError("server /align of a 4 bp read aligned")
            if path == "stats" and reply["annotation"]["labels"] \
                    != len(index.labels):
                raise AssertionError("server /stats labels differ")
        server_align(ask, aseqs, akinds, oracle, torch, dev)
    finally:
        server.shutdown()
    return launches


def server_align(ask, aseqs, akinds, oracle, torch, dev):
    """Two /align requests in flight together (see ``server_phase``)."""
    import threading
    from metagraph_tpu_torch.align.wave_extender import STATS
    half = len(aseqs) // 2
    bodies = [json.dumps(dict(FASTA="".join(
        f">a{j}\n{aseqs[j].decode()}\n" for j in range(h * half,
                                                      (h + 1) * half)),
        **extra)) for h, extra in enumerate(
            ({}, {"max_alternative_alignments": 2}))]
    replies = [None, None]

    def client(h):
        replies[h] = ask("align", bodies[h])

    def drive():
        threads = [threading.Thread(target=client, args=(h,))
                   for h in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    waves0 = STATS["waves"]
    _, launches = run_path(drive)
    waves = STATS["waves"] - waves0
    for h in range(2):
        code, got, secs = replies[h]
        again = ask("align", bodies[h])
        if code != 200 or again[:2] != (200, got):
            raise AssertionError(f"server /align {h}: status {code}, the "
                                 "reply differs from the sequential one")
        mapped = 0
        for entry in got:
            j = int(entry["seq_description"][1:])
            for a in entry["alignments"]:
                check_aligned(aseqs[j], a["score"], a["cigar"],
                              a["orientation"], a["sequence"].encode(),
                              oracle["keys"], K)
            if akinds[j] == "exact" and \
                    entry["alignments"][0]["cigar"] != f"{len(aseqs[j])}=":
                raise AssertionError(f"server /align: error-free read {j}")
            mapped += bool(entry["alignments"])
        if mapped < 0.8 * half:
            raise AssertionError(f"server /align {h}: {mapped} of {half} "
                                 "reads aligned")
        log(f"server /align {h}: {half} reads, status {code}, {secs:.3f} s "
            f"in flight with the other ({len(got)} entries, "
            f"{sum(len(e['alignments']) for e in got)} alignments held to "
            f"the oracle), {again[2]:.3f} s alone; equal replies")
    log(f"  server /align: launches {launches} for {waves} waves")
    if dev.type == "cuda" and (launches["align_wave"] != waves or not waves
                               or launches["wave_dp"]):
        raise AssertionError(f"server /align: {launches['align_wave']} "
                             f"align_wave launches for {waves} waves")


def add_entry(entries, torch, tag, name, got, want, ms, plain_ms, nbytes):
    """Hold a kernel's outputs exactly against its plain version's and
    keep its row of the kernels line (bound by bytes)."""
    err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    entries[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by="bytes")
    log(f"kernel {name}{tag}: {ms:.4f} ms (plain {plain_ms:.2f} ms, "
        f"bound {bound:.4f} ms from {nbytes} bytes), max_abs_err {err}")
    if err:
        raise AssertionError(f"{name}{tag} disagrees with its plain version")


def probe_bytes(table, key_chunks, torch, dev):
    """Bytes of slot groups that the stop rule reads for these probes:
    of each bucket probed, the furthest group any of its probes reaches,
    once (ops.probe_groups); and, for comparison, the probed buckets'
    whole rows."""
    from metagraph_tpu_torch.succinct import ops
    nb, W = table.shape[0], table.shape[1] // ops.BUCKET - 1
    reach = torch.zeros(nb, dtype=torch.int64, device=dev)
    for q in key_chunks:
        b, g = ops.probe_groups(table, q, W)
        reach.scatter_reduce_(0, b, g, reduce="amax")
    return (int(reach.sum()) * 16 * (W + 1),
            int((reach > 0).sum()) * 64 * (W + 1))


def kernel_checks(engine, seqs, cfg, torch, dev, tag=""):
    """Kernels 1-3 against their plain versions on the path's inputs (the
    same batch, packed as query_batch_fused packs it), with the engine's
    canon mode and offset."""
    from metagraph_tpu_torch._u32 import np_words, to_u64
    from metagraph_tpu_torch.query import device as qd
    from metagraph_tpu_torch.query.tile_pack import tile_pack2
    from metagraph_tpu_torch.succinct import ops
    S = len(seqs)
    canon, offset = engine.index.canon, engine.index.offset
    tiles2, validb, tile_seq, nwins = tile_pack2(seqs, K, qd.TILE)
    N = len(tiles2)
    words, vwords = qd.wire_words_layout(tiles2, validb, K, qd.TILE, N)
    dsel, selmin = qd._thresholds(nwins, 0.7, 0.0)
    words, vwords = np_words(words).to(dev), np_words(vwords).to(dev)
    tile_seq, dsel, selmin = (torch.from_numpy(a).to(dev)
                              for a in (tile_seq, dsel, selmin))
    table = engine.hash_index.table
    c1, _ = cfg["plain_chunks"]
    entries = {}

    nodes = qd.wire_lookup(words, vwords, table, K, qd.TILE, canon, offset)
    nodes_p = ops.wire_lookup_plain(words, vwords, table, K, qd.TILE, c1,
                                    canon, offset)

    # bytes the data needs: the tile words, the ids and the slot groups of
    # the buckets probed (the chosen strand's for canon 1; for canon 2 the
    # forward key's and, where it missed, the reverse complement's)
    def probed():
        for lo in range(0, N, c1):
            wd, vw = to_u64(words[lo: lo + c1]), to_u64(vwords[lo: lo + c1])
            keys = ops.extract_windows2(wd, K, qd.TILE)
            valid = ops.window_valid2(vw, K, qd.TILE)
            qs = [keys[valid]]
            if canon:
                rc = ops.rc_keys2(keys, K)
                if canon == 1:
                    take = ops.keys2_greater(keys, rc, K)[..., None]
                    qs = [torch.where(take, rc, keys)[valid]]
                else:
                    nd = nodes[lo: lo + c1]
                    qs.append(rc[valid & ~((nd > 0) & (nd <= offset))])
            for q in qs:
                yield ops.keys2_to_keys4(q, K)
    groups_bytes, rows_bytes = probe_bytes(table, probed(), torch, dev)
    io = words.nbytes + vwords.nbytes + nodes.nbytes
    log(f"  wire_lookup{tag} bound counts {groups_bytes} B of slot groups; "
        f"whole rows (the former yardstick) would be {rows_bytes} B = "
        f"{(io + rows_bytes) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    add_entry(entries, torch, tag, "wire_lookup", [nodes], [nodes_p],
              device_ms(torch, dev, lambda: qd.wire_lookup(
                  words, vwords, table, K, qd.TILE, canon, offset), 10),
              device_ms(torch, dev, lambda: ops.wire_lookup_plain(
                  words, vwords, table, K, qd.TILE, c1, canon, offset), 1),
              io + groups_bytes)
    l2_control("wire_lookup", tag, engine.index.table,
               lambda t: qd.wire_lookup(words, vwords, t, K, qd.TILE, canon,
                                        offset),
               lambda t: ops.wire_lookup_plain(words, vwords, t, K, qd.TILE,
                                               c1, canon, offset),
               cfg, torch, dev)

    if canon == 2:
        last = nodes[tile_seq == S - 1]            # the long sequence
        fwd = int(((last > 0) & (last <= offset)).sum())
        rc = int((last > offset).sum())
        log(f"  long sequence{tag}: {fwd} forward hits, {rc} reverse-"
            "complement hits")
        if fwd or not rc:
            raise AssertionError("the long sequence must hit through the "
                                 "reverse-complement probe only")
    count_select_checks(entries, engine, nodes, tile_seq, dsel, selmin,
                        offset, cfg, torch, dev, tag)
    return entries


def count_select_checks(entries, engine, nodes, tile_seq, dsel, selmin,
                        offset, cfg, torch, dev, tag, controls=True):
    """Kernels 2 and 3 against their plain versions on the path's tiled
    ids (folded by ``offset`` for canon 2) and thresholds, and with
    ``controls`` kernel 2's L2 control and kernel 3's selmin = 0 control."""
    from metagraph_tpu_torch.query import device as qd
    S, L = len(dsel), len(engine.labels)
    bitmap = engine.annotation
    _, c2 = cfg["plain_chunks"]
    counts, present = qd.label_counts(nodes, bitmap, tile_seq, S, L, offset)
    want = qd.label_counts_plain(nodes, bitmap, tile_seq, S, L, c2, offset)
    base = torch.where(nodes > offset, nodes - offset, nodes) if offset \
        else nodes
    rows = int(torch.unique(base[base > 0]).numel())
    add_entry(entries, torch, tag, "label_counts", [counts, present], want,
              device_ms(torch, dev, lambda: qd.label_counts(
                  nodes, bitmap, tile_seq, S, L, offset), 10),
              device_ms(torch, dev, lambda: qd.label_counts_plain(
                  nodes, bitmap, tile_seq, S, L, c2, offset), 1),
              nodes.nbytes + tile_seq.nbytes + rows * bitmap.shape[1] * 4
              + counts.nbytes + present.nbytes)
    if controls:
        l2_control_counts(nodes, bitmap, tile_seq, S, L, offset, cfg, torch,
                          dev, tag)

    mask = qd.selection_mask(counts, present, dsel, selmin)
    # bytes the data needs: the counts of the rows whose presence passes
    # (the kernel reads no other row's), the thresholds and the mask
    passing = int((present >= selmin).sum())
    small = 3 * present.nbytes + mask.nbytes
    log(f"  selection_mask{tag}: {passing} of {S} rows pass presence, bound "
        f"counts their {passing * L * 4} B of counts; every row's (the "
        f"former yardstick) would be {counts.nbytes + small} B = "
        f"{(counts.nbytes + small) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    add_entry(entries, torch, tag, "selection_mask", [mask],
              [qd.selection_mask_plain(counts, present, dsel, selmin)],
              device_ms(torch, dev, lambda: qd.selection_mask(
                  counts, present, dsel, selmin), 20),
              device_ms(torch, dev, lambda: qd.selection_mask_plain(
                  counts, present, dsel, selmin), 1),
              passing * L * 4 + small)
    if controls:
        select_control(counts, present, dsel, torch, dev, tag)
    return counts


def codes_checks(engine, seqs, cfg, torch, dev, tag, long=True):
    """Kernel B, then kernels 2 and 3, against their plain versions on the
    codes route's inputs (the batch packed as query_batch_fused packs
    it); with ``long``, the last sequence's label count passes 2^24."""
    from metagraph_tpu_torch.query import device as qd
    from metagraph_tpu_torch.query.tile_pack import tile_pack2
    from metagraph_tpu_torch.succinct import ops
    k, S, table = engine.k, len(seqs), engine.hash_index.table
    tiles2, validb, tile_seq, nwins = tile_pack2(seqs, k, qd.TILE)
    dsel, selmin = qd._thresholds(nwins, 0.7, 0.0)
    p2, vb, tile_seq, dsel, selmin = (
        torch.from_numpy(a).to(dev)
        for a in (tiles2, validb, tile_seq, dsel, selmin))
    c1, _ = cfg["plain_chunks"]
    entries = {}
    nodes = ops.codes_lookup(p2, vb, table, k, qd.TILE)
    nodes_p = ops.codes_lookup_plain(p2, vb, table, k, qd.TILE, c1)

    def probed():          # the valid windows' keys, as kernel B packs them
        for lo in range(0, len(p2), c1):
            keys, valid = ops.device_pack_windows(ops.tile_codes(
                p2[lo: lo + c1], vb[lo: lo + c1], qd.TILE + k - 1), k)
            yield keys[valid]
    groups_bytes, rows_bytes = probe_bytes(table, probed(), torch, dev)
    io = p2.nbytes + vb.nbytes + nodes.nbytes
    log(f"  codes_lookup{tag}: bound counts {groups_bytes} B of slot "
        f"groups (whole rows: {rows_bytes} B)")
    add_entry(entries, torch, tag, "codes_lookup", [nodes], [nodes_p],
              device_ms(torch, dev, lambda: ops.codes_lookup(
                  p2, vb, table, k, qd.TILE), 10),
              device_ms(torch, dev, lambda: ops.codes_lookup_plain(
                  p2, vb, table, k, qd.TILE, c1), 1),
              io + groups_bytes)
    l2_control("codes_lookup", tag, engine.index.table,
               lambda t: ops.codes_lookup(p2, vb, t, k, qd.TILE),
               lambda t: ops.codes_lookup_plain(p2, vb, t, k, qd.TILE, c1),
               cfg, torch, dev)
    counts = count_select_checks(entries, engine, nodes, tile_seq, dsel,
                                 selmin, 0, cfg, torch, dev, tag,
                                 controls=False)
    if not long:
        return entries
    n = int(counts[S - 1].max())
    log(f"  long sequence{tag}: {nwins[-1]} windows, label count {n} "
        f"(> 2^24: {n > 1 << 24}; float32 would hold {int(np.float32(n))})")
    if cfg is FULL and not (n > 1 << 24 and int(np.float32(n)) != n):
        raise AssertionError("the long sequence does not test the 2^24 bound")
    return entries


def key_checks(engine, seqs, cfg, torch, dev, tag, counts=True):
    """Kernel A on the keys of the batch's valid windows (packed as
    map_batch packs them: of a canonical graph, the strand first in BOSS
    order), then kernels 2 and 3 on the host-tiled rows of the ids it
    found (with ``counts``), against their plain versions."""
    from metagraph_tpu_torch._u32 import np_words, to_u64
    from metagraph_tpu_torch.kmer.extractor import _rows_greater
    from metagraph_tpu_torch.query import device as qd
    from metagraph_tpu_torch.succinct import ops
    k, ex, S = engine.k, engine.extractor, len(seqs)
    table = engine.hash_index.table
    cat = np.concatenate([np.concatenate([ex.encode(s), [ex.invalid]])
                          for s in seqs]).astype(np.uint8)
    wins = np.lib.stride_tricks.sliding_window_view(cat, k)
    bad = np.concatenate([[0], np.cumsum(cat >= ex.invalid)])
    valid = (bad[k:] - bad[:-k]) == 0
    sub = wins[valid]
    if engine.index.canon == 1:
        rc = np.lib.stride_tricks.sliding_window_view(
            ex.extended_complement_table()[cat[::-1]], k)[::-1][valid]
        sub = np.where(_rows_greater(ops.pack_kmers32(sub),
                                     ops.pack_kmers32(rc))[:, None], rc, sub)
    step = 1 << 22
    keys = np_words(np.concatenate([
        ops.pack_kmers32(sub[lo: lo + step], engine.index.bits)
        for lo in range(0, len(sub), step)])).to(dev)
    chunk = 1 << 16
    ids = ops.key_lookup(keys, table)
    ids_p = ops.key_lookup_plain(keys, table, chunk)
    groups_bytes, rows_bytes = probe_bytes(
        table, (to_u64(keys[lo: lo + chunk])
                for lo in range(0, len(keys), chunk)), torch, dev)
    log(f"  key_lookup{tag}: {len(keys)} keys of {keys.shape[1]} words; "
        f"bound counts {groups_bytes} B of slot groups (whole rows: "
        f"{rows_bytes} B)")
    entries = {}
    add_entry(entries, torch, tag, "key_lookup", [ids], [ids_p],
              device_ms(torch, dev, lambda: ops.key_lookup(keys, table), 10),
              device_ms(torch, dev, lambda: ops.key_lookup_plain(
                  keys, table, chunk), 1),
              keys.nbytes + ids.nbytes + groups_bytes)
    l2_control("key_lookup", tag, engine.index.table,
               lambda t: ops.key_lookup(keys, t),
               lambda t: ops.key_lookup_plain(keys, t, chunk), cfg, torch,
               dev)
    if not counts:
        return entries
    # count_epoch_tiled's input: rows + 1 of the hits, tiled per sequence
    flat = np.zeros(len(wins), np.int64)
    flat[valid] = ids.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum([len(s) + 1 for s in seqs])])
    nk = [max(len(s) - k + 1, 0) for s in seqs]
    seq_ids = np.repeat(np.arange(S, dtype=np.int32), nk)
    at = np.concatenate([np.arange(a, a + n) for a, n in zip(starts, nk)])
    rows1, tile_seq = qd.tile_layout(flat[at].astype(np.int32), seq_ids, S,
                                     fill=0)
    dsel, selmin = qd._thresholds(nk, 0.7, 0.0)
    rows1, tile_seq, dsel, selmin = (torch.from_numpy(a).to(dev) for a in (
        np.ascontiguousarray(rows1), tile_seq, dsel, selmin))
    count_select_checks(entries, engine, rows1, tile_seq, dsel, selmin, 0,
                        cfg, torch, dev, tag, controls=False)
    return entries


def sparse_checks(engine, seqs, cfg, torch, dev, tag):
    """Kernels S1 and S2 against their plain versions on the many-labels
    path's inputs (kernel 1's ids of the batch, packed as
    query_batch_fused packs it), exactly; S1 timed beside index_add_ over
    the keys it forms (built before the timer: a yardstick of the scatter
    alone), S2 beside torch.mm in float64 over the multiplicities and the
    patterns (converted before the timer); then kernel 3 on their
    counts."""
    from metagraph_tpu_torch._u32 import np_words, to_u64
    from metagraph_tpu_torch.annotation import sparse_device as sd
    from metagraph_tpu_torch.query import device as qd
    from metagraph_tpu_torch.query.tile_pack import tile_pack2
    anno = engine.annotation
    S, L, P = len(seqs), anno.num_labels, anno.dense8.shape[0]
    tau = anno.entries.shape[1]
    tiles2, validb, tile_seq, nwins = tile_pack2(seqs, K, qd.TILE)
    words, vwords = qd.wire_words_layout(tiles2, validb, K, qd.TILE,
                                         len(tiles2))
    dsel, selmin = qd._thresholds(nwins, 0.7, 0.0)
    tile_seq, dsel, selmin = (torch.from_numpy(a).to(dev)
                              for a in (tile_seq, dsel, selmin))
    nodes = qd.wire_lookup(np_words(words).to(dev), np_words(vwords).to(dev),
                           engine.hash_index.table, K, qd.TILE)
    del words, vwords
    c2 = cfg["plain_chunks"][1]

    def zeros():
        return (torch.zeros((S, L), dtype=torch.int32, device=dev),
                torch.zeros(S, dtype=torch.int32, device=dev),
                torch.zeros((S, P), dtype=torch.int32, device=dev))

    def s1(out):
        sd.sparse_label_counts(nodes, tile_seq, anno.entries, anno.dmap, *out)

    def s1_plain(out):
        sd.sparse_label_counts_plain(nodes, tile_seq, anno.entries,
                                     anno.dmap, *out, chunk=c2)
    got, want = zeros(), zeros()
    s1(got)
    s1_plain(want)
    entries = {}
    # bytes the data needs: the ids and tile owners, each distinct hit
    # row's tau ids and pattern slot once, and the count, present and
    # multiplicity cells written
    rows = int(torch.unique(nodes[nodes > 0]).numel())
    cells, pairs = int((got[0] > 0).sum()), int((got[2] > 0).sum())
    scratch = zeros()
    ms = device_ms(torch, dev, lambda: s1(scratch), 10)
    scratch = zeros()
    plain = device_ms(torch, dev, lambda: s1_plain(scratch), 1)
    del scratch
    add_entry(entries, torch, tag, "sparse_label_counts", got, want, ms,
              plain, nodes.nbytes + tile_seq.nbytes + rows * (tau + 1) * 4
              + cells * 4 + S * 4 + pairs * 4)
    del want
    # for information beside the bound: the 32 B sectors the data makes
    # S1 touch, each hit window's row record and each counts sector that a
    # flush adds to (a read's flush adds each of its labels once)
    hits = int((nodes > 0).sum())
    rec_sectors = hits * anno.record.shape[1] * 4 // 32
    n8 = -(-L // 8)
    cnt_sectors = int(torch.nn.functional.pad(
        (got[0] > 0).to(torch.int8), (0, 8 * n8 - L)).view(S, n8, 8)
        .any(-1).sum())
    sectors = rec_sectors + cnt_sectors + pairs + int((got[1] > 0).sum())
    log(f"  sparse_label_counts{tag}: 32 B sectors touched: {rec_sectors} "
        f"row records ({hits} hit windows on {rows} distinct rows), "
        f"{cnt_sectors} counts, {pairs} multiplicities and the present "
        f"counts: {sectors * 32} B, {sectors * 32 / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms at {HBM_BYTES_PER_S / 1e12} TB/s")
    keys = (tile_seq.long().repeat_interleave(qd.TILE)[:, None] * (L + 1)
            + to_u64(anno.entries[nodes.reshape(-1).long()])).reshape(-1)
    ones = torch.ones(keys.shape[0], dtype=torch.int32, device=dev)
    buf = torch.zeros(S * (L + 1), dtype=torch.int32, device=dev)
    lib = device_ms(torch, dev, lambda: buf.index_add_(0, keys, ones), 10)
    entries["sparse_label_counts"]["library_ms"] = lib
    log(f"  sparse_label_counts{tag}: {nodes.numel()} windows, {rows} "
        f"distinct hit rows, tau {tau}, {cells} count cells, {pairs} "
        f"(sequence, pattern) pairs; index_add_ of its {keys.shape[0]} keys "
        f"{lib:.4f} ms")
    del keys, ones, buf

    counts, mult = got[0], got[2]
    kern, ref = counts.clone(), counts.clone()
    sd.overflow_counts(kern, mult, anno.dense8)
    sd.overflow_counts_plain(ref, mult, anno.dense8)
    nz = mult[:, 1:] > 0
    seq_rows, pats = int(nz.any(1).sum()), int(nz.any(0).sum())
    scratch = counts.clone()
    ms = device_ms(torch, dev, lambda: sd.overflow_counts(
        scratch, mult, anno.dense8), 20)
    plain = device_ms(torch, dev, lambda: sd.overflow_counts_plain(
        scratch, mult, anno.dense8), 1)
    del scratch
    # the multiplicities, each pattern row used and each counts row written
    add_entry(entries, torch, tag, "overflow_counts", [kern], [ref], ms,
              plain, mult.nbytes + pats * L + seq_rows * L * 4)
    # yardstick: one float64 product computes S2's function (integers
    # below 2^53 are exact), its operands converted before the timer
    m64, d64 = mult.double(), anno.dense8.double()
    prod = torch.mm(m64, d64)
    if not torch.equal(prod, (kern - counts).double()):
        raise AssertionError("the float64 product disagrees with S2")
    del prod
    entries["overflow_counts"]["library_ms"] = device_ms(
        torch, dev, lambda: torch.mm(m64, d64), 10)
    del m64, d64
    log(f"  overflow_counts{tag}: torch.mm in float64 "
        f"{entries['overflow_counts']['library_ms']:.4f} ms")
    n = int(kern[S - 1].max())
    log(f"  overflow_counts{tag}: {seq_rows} sequences on {pats} patterns; "
        f"long sequence {nwins[-1]} windows, label count {n} (> 2^24: "
        f"{n > 1 << 24}; float32 would hold {int(np.float32(n))})")
    if cfg is FULL and not (n > 1 << 24 and int(np.float32(n)) != n):
        raise AssertionError("the long sequence does not test the 2^24 bound")
    del counts, mult, ref

    present = got[1]
    mask = qd.selection_mask(kern, present, dsel, selmin)
    passing = int((present >= selmin).sum())
    add_entry(entries, torch, tag, "selection_mask", [mask],
              [qd.selection_mask_plain(kern, present, dsel, selmin)],
              device_ms(torch, dev, lambda: qd.selection_mask(
                  kern, present, dsel, selmin), 20),
              device_ms(torch, dev, lambda: qd.selection_mask_plain(
                  kern, present, dsel, selmin), 1),
              passing * L * 4 + 3 * present.nbytes + mask.nbytes)
    return entries


def words_checks(engine, seqs, cfg, torch, dev, tag):
    """Kernel W1 or W2 against its plain version on the words deployment's
    inputs (kernel 1's ids of the batch, cut into the chunks that
    words_count_epoch cuts), exactly, on the first chunk and the last (the
    last sequence's, reference 0: pattern rows); W timed on the first, a
    full chunk, beside its plain version.  Then kernel 2 on the first
    chunk's words, as words_count_epoch calls it."""
    from metagraph_tpu_torch._u32 import np_words, to_u64
    from metagraph_tpu_torch.annotation import device_matrix as dm
    from metagraph_tpu_torch.query import device as qd
    from metagraph_tpu_torch.query.tile_pack import tile_pack2
    anno = engine.annotation
    brwt = isinstance(anno, dm.BRWTOnDevice)
    name = "brwt_row_words" if brwt else "rowdiff_row_words"
    fn, plain = ((dm.brwt_row_words, dm.brwt_row_words_plain) if brwt else
                 (dm.rowdiff_row_words, dm.rowdiff_row_words_plain))
    S, L = len(seqs), anno.num_labels
    Lw = max((L + 31) // 32, 1)
    ld = -(-Lw // 4) * 4
    tiles2, validb, tile_seq, nwins = tile_pack2(seqs, K, qd.TILE)
    words, vwords = qd.wire_words_layout(tiles2, validb, K, qd.TILE,
                                         len(tiles2))
    tile_seq = torch.from_numpy(tile_seq).to(dev)
    nodes = qd.wire_lookup(np_words(words).to(dev), np_words(vwords).to(dev),
                           engine.hash_index.table, K, qd.TILE)
    N = nodes.shape[0]
    step = max(1, qd.WORDS_BYTES // (qd.TILE * ld * 4))
    starts = sorted({0, (N - 1) // step * step})
    got, want, visited = [], [], {}
    for t0 in starts:
        ids = nodes[t0: t0 + step].reshape(-1).contiguous()
        # rows padded to a multiple of 4 words, as words_count_epoch pads
        # them for kernel 2
        out = torch.zeros((ids.shape[0], ld), dtype=torch.int32,
                          device=dev)[:, :Lw]
        got.append(fn(anno, ids, 0, out))
        want.append(plain(anno, ids, 0, visited if t0 == 0 else None))
    ids, out = nodes[:step].reshape(-1).contiguous(), got[0]
    if not brwt:
        from metagraph_tpu_torch.scripts.kernel_times import walk_counts
        log(f"  {name}{tag} walks of the first chunk: "
            f"{walk_counts(dm, torch, anno, ids)}")
    ms = device_ms(torch, dev, lambda: fn(anno, ids, 0, out), 10)
    plain_ms = device_ms(torch, dev, lambda: plain(anno, ids), 1)
    # the compared windows whose row has more than tau = 4 labels (an
    # overflow pattern)
    pop = sum(int((dm.popcount32(to_u64(g)).sum(1) > 4).sum()) for g in got)
    # bytes the data needs: the ids, the words written, and each node,
    # word and successor that the walk reads, once
    nbytes = ids.nbytes + ids.shape[0] * Lw * 4
    uniq = {k: int(torch.unique(torch.cat(v)).numel())
            for k, v in visited.items()}
    nbytes += 16 * uniq.get("nodes", 0) + 8 * uniq.get("words", 0) \
        + 4 * uniq.get("rows", 0)
    entries = {}
    add_entry(entries, torch, tag, name, got, want, ms, plain_ms, nbytes)
    entries[name]["library_ms"] = None
    log(f"  {name}{tag}: chunks at tiles {starts} of {N} ({ids.shape[0]} "
        f"windows a chunk, {int((ids > 0).sum())} hits in the first); "
        f"distinct reads {uniq}; {pop} compared windows hold more than "
        "4 labels")
    if pop == 0:
        raise AssertionError(f"{name}{tag}: no compared window holds an "
                             "overflow pattern")
    # kernel 2 on the first chunk's words, the chunk's places as ids
    chunk = nodes[:step]
    place = torch.arange(1, chunk.numel() + 1, dtype=torch.int32,
                         device=dev).view(chunk.shape)
    local = torch.where(chunk > 0, place, 0)
    bitmap, ts = got[0], tile_seq[:step]
    c, p = qd.label_counts(local, bitmap, ts, S, L)
    _, c2 = cfg["plain_chunks"]
    hits = int((chunk > 0).sum())
    add_entry(entries, torch, tag, "label_counts", [c, p],
              qd.label_counts_plain(local, bitmap, ts, S, L, c2),
              device_ms(torch, dev, lambda: qd.label_counts(
                  local, bitmap, ts, S, L), 10),
              device_ms(torch, dev, lambda: qd.label_counts_plain(
                  local, bitmap, ts, S, L, c2), 1),
              local.nbytes + ts.nbytes + hits * Lw * 4 + c.nbytes + p.nbytes)
    return entries


def select_control(counts, present, dsel, torch, dev, tag):
    """Kernel 3 with selmin = 0 for every row, so that it reads every
    row's counts: held exactly against the plain version and timed beside
    its bound and beside torch.amax(counts), one PyTorch call that streams
    the same bytes (information only)."""
    from metagraph_tpu_torch.query import device as qd
    S, L = counts.shape
    zero = torch.zeros_like(present)
    got = qd.selection_mask(counts, present, dsel, zero)
    err = max_abs_err(torch, got, qd.selection_mask_plain(counts, present,
                                                          dsel, zero))
    ms = device_ms(torch, dev, lambda: qd.selection_mask(
        counts, present, dsel, zero), 20)
    amax = device_ms(torch, dev, lambda: torch.amax(counts), 20)
    nbytes = counts.nbytes + 3 * present.nbytes + got.nbytes
    plan = ""
    if dev.type == "cuda":
        vec, grid, bps = qd.selection_launch_plan(S, L, counts)
        plan = f"; V = {vec}, {bps} blocks an SM, grid {grid}"
    log(f"kernel selection_mask{tag} control selmin = 0: {ms:.4f} ms = "
        f"{counts.nbytes / ms / 1e9:.3f} TB/s of counts (bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms from {nbytes} bytes; "
        f"torch.amax(counts) {amax:.4f} ms = "
        f"{counts.nbytes / amax / 1e9:.3f} TB/s){plan}, max_abs_err {err}")
    if err:
        raise AssertionError(f"selection_mask{tag} disagrees with its plain "
                             "version on the selmin = 0 control")


def l2_control(name, tag, table, run, plain, cfg, torch, dev):
    """Kernel ``name`` (1, A or B) on its path's inputs against a table
    small enough for L2: 2^ctrl_log buckets at the index's load, built from
    a prefix of the host ``table``'s keys (kernel_times.control_table).  A
    time close to the real table's says the kernel is not bound by
    device-memory bytes.  ``run(t)`` and ``plain(t)`` launch the kernel and
    its plain version on table ``t``; they must agree exactly."""
    from metagraph_tpu_torch._u32 import np_words
    from metagraph_tpu_torch.scripts.kernel_times import control_table
    from metagraph_tpu_torch.succinct import ops
    W = table.shape[1] // ops.BUCKET - 1
    if W <= 8:
        host = control_table(table, cfg["ctrl_log"])
    else:
        # wide keys: at most about 24 MB of table, and the first buckets
        # whole, which land in the same buckets of the smaller table (no
        # bucket overflows, the load kept)
        log_b = cfg["ctrl_log"]
        while log_b > 6 and (table.shape[1] * 4) << log_b > 24 << 20:
            log_b -= 1
        slots = table[: 1 << log_b].reshape(-1, W + 1)
        slots = slots[slots[:, 0] != ops.EMPTY_WORD]
        host = ops.DeviceHashIndex._build(slots[:, :W], slots[:, W],
                                          1 << log_b).reshape(1 << log_b, -1)
    nbc = host.shape[0]
    keys = int((host.reshape(nbc, ops.BUCKET, W + 1)[:, :, 0]
                != ops.EMPTY_WORD).sum())
    ctab = np_words(host).to(dev)
    got = run(ctab)
    err = max_abs_err(torch, got, plain(ctab))
    ms = device_ms(torch, dev, lambda: run(ctab), 10)
    log(f"kernel {name}{tag} L2 control: {ms:.4f} ms on {keys} keys in "
        f"{nbc} buckets ({ctab.nbytes} B), {int((got > 0).sum())} hits, "
        f"max_abs_err {err}")
    if err:
        raise AssertionError(f"{name}{tag} disagrees with its plain version "
                             "on the control table")


def l2_control_counts(nodes, bitmap, tile_seq, S, L, offset, cfg, torch, dev,
                      tag):
    """Kernel 2 on the path's node ids remapped to rows 1..ctrl_rows (an
    offset fold kept), so that every row it reads stays in L2."""
    from metagraph_tpu_torch.query import device as qd
    base = torch.where(nodes > offset, nodes - offset, nodes) if offset \
        else nodes
    ctrl = torch.where(base > 0, (base - 1) % cfg["ctrl_rows"] + 1, 0)
    if offset:
        ctrl = torch.where(nodes > offset, ctrl + offset, ctrl)
    ctrl = ctrl.to(torch.int32)
    got = qd.label_counts(ctrl, bitmap, tile_seq, S, L, offset)
    want = qd.label_counts_plain(ctrl, bitmap, tile_seq, S, L,
                                 cfg["plain_chunks"][1], offset)
    err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    ms = device_ms(torch, dev, lambda: qd.label_counts(
        ctrl, bitmap, tile_seq, S, L, offset), 10)
    log(f"kernel label_counts{tag} L2 control: {ms:.4f} ms with rows "
        f"1..{cfg['ctrl_rows']} ({cfg['ctrl_rows'] * bitmap.shape[1] * 4} B "
        f"of bitmap), max_abs_err {err}")
    if err:
        raise AssertionError(f"label_counts{tag} disagrees with its plain "
                             "version on the control ids")


def max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def sw_phase(cfg, rng, torch, dev):
    """Kernel 4 through batch_local_align_scores at three shapes: the
    phase's 150 x 300 pairs (also held against the numpy oracle on a
    sample), 1,000 x 1,000 pairs, the largest P of one launch, and 2,000 x
    2,000 pairs, two query blocks with the carry between them; each held
    exactly against the plain version.  -> {shape name: (launches,
    entry)}."""
    from metagraph_tpu_torch.align.sw import (batch_local_align_scores,
                                              query_blocks,
                                              reference_local_align_score,
                                              sw_scores, sw_scores_plain)
    from metagraph_tpu_torch.scripts.kernel_times import sw_pairs
    # the INT32 pipe: 64 lanes an SM (half the float32 rate); not measured
    # in a rehearsal
    int32_ops_per_s = None
    if dev.type == "cuda":
        int32_ops_per_s = torch.cuda.get_device_properties(
            dev).multi_processor_count * 64 * max_sm_clock_hz()
    out = {}
    for name, (B, LQ, LR), oracle in (("", cfg["sw"], cfg["sw_oracle"]),
                                      ("/large", cfg["sw_big"], 0),
                                      ("/long", cfg["sw_long"], 0)):
        qs, rs = sw_pairs(rng, B, LQ, LR)

        def drive():
            t0 = time.perf_counter()
            res = batch_local_align_scores(qs, rs, device=dev)
            return res, time.perf_counter() - t0
        (scores, secs), launches = run_path(drive)
        q, r = torch.from_numpy(qs).to(dev), torch.from_numpy(rs).to(dev)
        want = sw_scores_plain(q, r, 2, -3, -6, -2)
        err = max_abs_err(torch, torch.from_numpy(scores).to(dev), want)
        pick = rng.choice(B, oracle, replace=False)
        if err or not np.array_equal(scores[pick], [
                reference_local_align_score(qs[b], rs[b]) for b in pick]):
            raise AssertionError(f"sw_scores{name} disagrees with its plain "
                                 "version or the oracle")
        ms = device_ms(torch, dev, lambda: sw_scores(q, r), 10)
        plain = device_ms(torch, dev, lambda: sw_scores_plain(
            q, r, 2, -3, -6, -2), 1)
        nbytes = (qs.nbytes + rs.nbytes + 4 * B)
        ops_ = 12 * B * LQ * LR       # int32 operations of the recurrence
        bound = max(nbytes / HBM_BYTES_PER_S,
                    ops_ / CUDA_CORE_OPS_PER_S) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S \
            > ops_ / CUDA_CORE_OPS_PER_S else "operations"
        int32 = "not measured" if int32_ops_per_s is None else \
            f"{ops_ / int32_ops_per_s * 1e3:.4f} ms"
        if dev.type == "cuda" and launches["sw_scores"] < 1:
            raise AssertionError(f"sw_scores{name} never launched in the SW "
                                 "phase")
        P, blocks = query_blocks(LQ)
        log(f"SW phase{name}: {B} pairs of {LQ} x {LR} (P = {P}, {blocks} "
            f"query block{'s' if blocks > 1 else ''}) in {secs:.3f} s through "
            f"batch_local_align_scores; kernel {ms:.4f} ms = "
            f"{B / ms * 1e3:.4g} pairs/s = {B * LQ * LR / ms / 1e9:.4g} "
            f"Gcells/s (plain {plain:.2f} ms, bound {bound:.4f} ms by "
            f"{bound_by}; the same operations at the INT32 pipe's rate "
            f"{int32}); {len(pick)} pairs equal to the oracle; launches "
            f"{launches['sw_scores']}")
        out[name] = launches["sw_scores"], dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=bound_by)
    return out


def gather_phase(cfg, torch, dev):
    """The gather micro-benchmark's sweep through the port's script, then
    kernels 5 and 6 against the plain version on the sweep's inputs and on
    the two controls."""
    from metagraph_tpu_torch._u32 import np_words
    from metagraph_tpu_torch.scripts import exp_gather as eg
    q_log, rows_logs, QB = cfg["gather"]
    argv = ["--device", dev.type, "--q-log", str(q_log), "--rows-log",
            *map(str, rows_logs), "--qb", str(QB)]
    _, launches = run_path(lambda: eg.main(argv))
    for name in ("gather_loop", "gather_take"):
        if dev.type == "cuda" and launches[name] < 1:
            raise AssertionError(f"{name} never launched in the sweep")
    rng = np.random.default_rng(eg.SEED)     # the sweep's inputs again
    Q, entries = 1 << q_log, {}
    n = Q // QB * QB
    if dev.type == "cuda":
        for form in ("loop", "take"):
            grid, _, smem, bps = eg.launch_plan(form, n, 32, dev)
            log(f"gather_{form} plan at W = 32: {bps} blocks an SM, grid "
                f"{grid}, {smem} B of dynamic shared memory")
    for rows_log in rows_logs:
        tab, idx = eg.make_inputs(rng, rows_log, Q)
        tab_d, idx_d = np_words(tab).to(dev), torch.from_numpy(idx).to(dev)
        want = eg.gather_rows_sum_plain(tab_d, idx_d, QB)
        plain = device_ms(torch, dev, lambda: eg.gather_rows_sum_plain(
            tab_d, idx_d, QB), 3)
        yard = device_ms(torch, dev, lambda: tab_d[idx_d].sum(0), 3)
        nbytes = n * 4 + tab.nbytes + want.nbytes
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"gather rows=2^{rows_log} ({tab.nbytes} B table, {n} indices "
            f"of {QB}): plain {plain:.3f} ms; yardstick tab[idx].sum(0) "
            f"{yard:.3f} ms (two calls, int64 sums: information only)")
        for name in ("gather_loop", "gather_take"):
            ms, err = gather_line(torch, dev, eg, name, tab_d, idx_d, QB,
                                  want, f"rows=2^{rows_log}", bound, nbytes)
            # the kernels line keeps the last (largest) table's numbers
            entries[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 bound_ms=bound, bound_by="bytes")
    gather_controls(cfg, torch, dev, eg, tab_d, Q, QB)
    return launches, entries


def gather_line(torch, dev, eg, name, tab, idx, QB, want, what, bound,
                nbytes):
    """Time kernel ``name`` and hold it exactly against ``want``."""
    fn = getattr(eg, name)
    err = max_abs_err(torch, fn(tab, idx, QB), want)
    ms = device_ms(torch, dev, lambda: fn(tab, idx, QB), 20)
    n, row_bytes = idx.shape[0] // QB * QB, tab.shape[1] * 4
    log(f"kernel {name} {what}: {ms:.4f} ms = {n / ms / 1e3:.1f} Mgather/s "
        f"(bound {bound:.4f} ms from {nbytes} bytes at 3.35 TB/s; gathered "
        f"{n * row_bytes} B = {n * row_bytes / ms / 1e9:.3f} TB/s), "
        f"max_abs_err {err}")
    if err:
        raise AssertionError(f"{name} {what} disagrees with its plain "
                             "version")
    return ms, err


def gather_controls(cfg, torch, dev, eg, tab_d, Q, QB):
    """Kernels 5 and 6 on two controls, each held exactly against the plain
    version: sequential indices i mod n_rows on the sweep's last table (the
    L2's rate for the same rows without randomness) and random indices into
    a table of 2^gather_big rows, larger than L2 (random 128 B rows from
    device memory)."""
    from metagraph_tpu_torch._u32 import np_words
    seq = (torch.arange(Q, device=dev) % tab_d.shape[0]).to(torch.int32)
    big_log = cfg["gather_big"]
    tab_b, idx_b = eg.make_inputs(np.random.default_rng(eg.SEED), big_log, Q)
    n = Q // QB * QB
    for what, tab, idx in (
            (f"sequential rows=2^{tab_d.shape[0].bit_length() - 1}", tab_d,
             seq),
            (f"out of L2 rows=2^{big_log}", np_words(tab_b).to(dev),
             torch.from_numpy(idx_b).to(dev))):
        want = eg.gather_rows_sum_plain(tab, idx, QB)
        nbytes = n * 4 + tab.nbytes + want.nbytes
        for name in ("gather_loop", "gather_take"):
            gather_line(torch, dev, eg, name, tab, idx, QB, want,
                        f"control {what}", nbytes / HBM_BYTES_PER_S * 1e3,
                        nbytes)


# --------------------------------------------------------------------------
# 8. align: the port's align command (kernel B11: align_wave, wave_dp)
# --------------------------------------------------------------------------

ALIGN_GAP = (-6, -2)           # the default gap open and extension
ALIGN_MATCH, ALIGN_MISMATCH, ALIGN_END_BONUS = 2, -3, 5


def align_reads(rng, refs, n, m):
    """``n`` reads of ``m`` bp from the DNA references: 5% random reads
    that hit nothing, a quarter of the rest error-free, the others with 1%
    substitutions and, a tenth of them, one indel of 1-3 bp; half of all
    reverse-complemented.  -> (sequences, kinds)."""
    letters = np.frombuffer(b"ACGT", np.uint8)
    seqs, kinds = [], []
    for i in range(n):
        u = rng.random()
        if u < 0.05:
            codes = rng.integers(0, 4, m).astype(np.uint8)
            kind = "random"
        else:
            r = refs[int(rng.integers(0, len(refs)))]
            a = int(rng.integers(0, len(r) - m - 3))
            codes = r[a: a + m + 3].copy()
            kind = "exact" if u < 0.05 + 0.95 / 4 else "errors"
            if kind == "errors":
                sub = rng.random(len(codes)) < 0.01
                codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
                if rng.random() < 0.1:
                    at, d = int(rng.integers(20, m - 20)), int(rng.integers(1, 4))
                    codes = np.concatenate(
                        [codes[:at], codes[at + d:]]) if rng.random() < 0.5 \
                        else np.concatenate([codes[:at], rng.integers(
                            0, 4, d).astype(np.uint8), codes[at:]])
                    kind = "indel"
            codes = codes[:m]
        if rng.random() < 0.5:
            codes = 3 - codes[::-1]
        seqs.append(letters[codes].tobytes())
        kinds.append(kind)
    return seqs, kinds


def revcomp(seq: bytes) -> bytes:
    return seq.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def align_cli(args):
    """The port's ``align`` (its ``main`` in this process): -> (stdout,
    wall s, the run's ALIGN_STATS)."""
    import contextlib
    import io
    from metagraph_tpu_torch import cli
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["align", *args])
    return out.getvalue(), time.perf_counter() - t0, dict(cli.ALIGN_STATS)


def oracle_alignment(query: bytes, fields, keys, k=K):
    """Hold one printed alignment to an oracle that shares no code with
    the port: its score recomputed from its CIGAR under the default config
    (match 2, mismatch -3, gap -6/-2, end bonus 5 each side unclipped), the
    CIGAR applied to the query in the alignment's orientation spelling the
    printed sequence, and every k-mer of that sequence (``k`` characters)
    a k-mer of the references.  -> (orientation, sequence, cigar)."""
    import re
    strand, seq, score, n_match, cigar, _offset = fields
    seq = seq.encode()
    q = revcomp(query) if strand == "-" else query
    ops = [(int(n), op) for n, op in re.findall(r"(\d+)([=XIDSG])", cigar)]
    qi = ri = got = matches = 0
    go, ge = ALIGN_GAP
    for n, op in ops:
        if op == "S":
            qi += n
        elif op in "=X":
            for _ in range(n):
                if (q[qi] == seq[ri]) != (op == "="):
                    raise AssertionError(f"align oracle: {cigar} does not "
                                         f"spell {seq[:40]}")
                got += ALIGN_MATCH if op == "=" else ALIGN_MISMATCH
                qi, ri = qi + 1, ri + 1
            matches += n if op == "=" else 0
        elif op in "IDG":
            got += go + (n - 1) * ge
            qi += n if op == "I" else 0
            ri += n if op == "D" else 0
    if qi != len(q) or ri != len(seq):
        raise AssertionError(f"align oracle: {cigar} covers {qi} of "
                             f"{len(q)} query and {ri} of {len(seq)} "
                             "sequence characters")
    got += ALIGN_END_BONUS * ((ops[0][1] != "S") + (ops[-1][1] != "S"))
    if got != int(score) or matches != int(n_match):
        raise AssertionError(f"align oracle: score {score} ({n_match} "
                             f"matches) of {cigar}, recomputed {got} "
                             f"({matches})")
    codes = np.frombuffer(seq, np.uint8)
    codes = np.select([codes == c for c in b"ACGT"], [0, 1, 2, 3], 4)
    wk, ok = window_keys(codes.astype(np.uint8), k)
    pos = np.minimum(np.searchsorted(keys, wk), len(keys) - 1)
    if not (ok.all() and np.array_equal(keys[pos], wk)):
        raise AssertionError("align oracle: the aligned sequence has k-mers "
                             "outside the references")
    return strand, seq, cigar


def align_phase(cfg, graph_path, refs, oracle, seed, torch, dev, work):
    """Phase 8: the port's ``align`` on the 3b graph (the basic references
    at k = 31) with reads from the seed's stream 12 (``align_reads``).  A
    calibration command aligns ``warm`` reads, which build the graph's
    lazy tables, then ``calibrate`` reads, whose file's seconds give the
    rate; the counted run aligns ``target`` reads, or as many as that
    rate puts in ``budget_s`` seconds where that is fewer, at least
    ``least``, with the launch counters
    read (one ``align_wave`` a wave, no ``wave_dp``) and every wave's
    written store rows and output held whole against ``align_wave_plain``
    on the card on the same store, the check's seconds left out of the
    rate; the bytes each wave copies (``WAVE_LOG``); the independent
    oracle on every printed alignment (``oracle_alignment``), every
    error-free read aligned end to end with an all-match CIGAR; the first
    ``cpu`` reads' bytes equal to a ``--torch-device cpu`` run's and the
    first ``par`` reads' to a ``-p par_procs`` run's; align_wave timed on
    the run's largest wave as it ran (``time_wave``), and wave_dp on its
    planes, through ``compute_wave`` once.  -> (launches, entries)."""
    from metagraph_tpu_torch.align import wave_extender as wx
    ac = cfg["align"]
    rng = np.random.default_rng([seed, 12])
    m = ac["read_len"]
    seqs, kinds = align_reads(rng, refs, ac["pool"], m)
    tdev = [] if dev.type == "cuda" else ["--torch-device", "cpu"]

    def fasta(name, idx):
        path = os.path.join(work, f"align_{name}.fa")
        with open(path, "w") as f:
            f.writelines(f">r{i} {kinds[i]}\n{seqs[i].decode()}\n"
                         for i in idx)
        return path

    warm, cal = ac["warm"], ac["calibrate"]
    tail = len(seqs) - warm - cal
    _, wall, st = align_cli(["-i", graph_path, *tdev,
                             fasta("warm", range(tail, tail + warm)),
                             fasta("calibrate", range(tail + warm,
                                                      len(seqs)))])
    (_, warm_s), (_, cal_s) = st["files"]
    rate = cal / cal_s
    n = int(min(max(min(rate * ac["budget_s"], ac["target"]), ac["least"]),
                tail))
    log(f"align calibration: {warm} reads in {warm_s:.2f} s (the graph's "
        f"tables built), then {cal} reads in {cal_s:.2f} s ({rate:.1f} "
        f"reads/s; the command {wall:.2f} s with the graph's load): {n} "
        "reads for the counted run")
    run_wave = wx.run_wave
    check = {"waves": 0, "err": 0, "seconds": 0.0, "largest": None}

    def checked(store, tables, pack_host, W, go, ge, out_host):
        """The engine's wave (one align_wave), then its written store rows
        and its output held whole against align_wave_plain on the card on
        the same store; the largest wave kept as a wave of its own."""
        views = run_wave(store, tables, pack_host, W, go, ge, out_host)
        t = time.perf_counter()
        pack = pack_host.to(dev)
        rows = pack[:, wx.PK_ROW].long()
        got = store[rows, :, :W].clone()
        want = torch.empty(out_host.shape, dtype=torch.int32, device=dev)
        wx.align_wave_plain(store, tables, pack, W, go, ge, want)
        check["err"] = max(check["err"],
                           max_abs_err(torch, got, store[rows, :, :W]),
                           max_abs_err(torch, out_host.to(dev), want))
        check["waves"] += 1
        big = check["largest"]
        if big is None or len(pack) > big["rows"]:
            check["largest"] = time_wave(torch, dev, wx, store, tables, pack,
                                         W, go, ge, out_host.numel())
        check["seconds"] += time.perf_counter() - t
        return views

    main_fa = fasta("main", range(n))
    wx.run_wave, wx.WAVE_LOG = checked, []
    try:
        (out, wall, st), launches = run_path(lambda: align_cli(
            ["-i", graph_path, "--device", *tdev, main_fa]))
        wave_log = wx.WAVE_LOG
    finally:
        wx.run_wave, wx.WAVE_LOG = run_wave, None
    lines = out.splitlines()
    if len(lines) != n:
        raise AssertionError(f"align printed {len(lines)} lines for {n} "
                             "reads")
    others = sum(v for k, v in launches.items() if k != "align_wave")
    if dev.type == "cuda" and (launches["align_wave"] != st["wave_waves"]
                               or not st["wave_waves"] or others):
        raise AssertionError(f"align: {launches['align_wave']} align_wave "
                             f"launches for {st['wave_waves']} waves, "
                             f"{others} other launches (wave_dp "
                             f"{launches['wave_dp']})")
    if check["waves"] != st["wave_waves"] or check["err"] \
            or len(wave_log) != st["wave_waves"]:
        raise AssertionError(f"align: {check['waves']} of "
                             f"{st['wave_waves']} waves checked, max_abs_err "
                             f"{check['err']} against align_wave_plain")
    wall_a = st["wall"] - check["seconds"]
    host = wall_a - st["seeding"] - st["wave_seconds"] - st["output"]
    log(f"align: {n} reads of {m} bp in {wall_a:.2f} s ({n / wall_a:.1f} "
        f"reads/s; the command {wall:.2f} s with the graph's load and "
        f"{check['seconds']:.2f} s of the waves' check): seeding "
        f"{st['seeding']:.2f} s, waves {st['wave_seconds']:.2f} s "
        f"({st['wave_waves']} waves, {st['wave_rows']} rows, "
        f"{st['wave_cells']} cells: the copies and align_wave), the "
        f"engine's host work {host:.2f} s, output {st['output']:.2f} s; "
        f"every wave equal to align_wave_plain")
    big = max(wave_log)
    W = st["wave_cells"] // max(st["wave_rows"], 1)
    log(f"align PCIe: {st['wave_bytes_up']} B up and "
        f"{st['wave_bytes_down']} B down over {len(wave_log)} waves "
        f"({st['wave_bytes_up'] / len(wave_log):.0f} / "
        f"{st['wave_bytes_down'] / len(wave_log):.0f} B a wave), finished "
        f"tables {st['wave_bytes_tables']} B down; the largest wave, "
        f"{big[0]} rows: {big[1]} B up, {big[2]} B down "
        f"({big[1] + big[2]} B; as four (N, W) planes up and three down, "
        f"compute_wave's path, {big[0] * (16 * W + 17)} B up and "
        f"{big[0] * 12 * W} B down)")
    # the independent oracle on every printed alignment
    keys = oracle["keys"]
    n_aln = exact_ok = 0
    for i, ln in enumerate(lines):
        f = ln.split("\t")
        if f[0] != f"r{i}" or f[1].encode() != seqs[i]:
            raise AssertionError(f"align: line {i} is not read {i}")
        alns = [f[j: j + 6] for j in range(2, len(f), 6)] \
            if f[2] != "*" else []
        got = [oracle_alignment(seqs[i], a, keys) for a in alns]
        n_aln += len(got)
        if kinds[i] == "exact":
            if not got or got[0][2] != f"{m}=":
                raise AssertionError(f"align: error-free read {i} aligned "
                                     f"as {got[:1]}")
            exact_ok += 1
    mapped = sum(1 for ln in lines if ln.split("\t")[2] != "*")
    log(f"align oracle: {n_aln} alignments of {mapped} mapped reads "
        f"({sum(k == 'random' for k in kinds[:n])} random reads) held; "
        f"{exact_ok} error-free reads all-match end to end")
    if mapped < 0.8 * n:
        raise AssertionError(f"align: only {mapped} of {n} reads mapped")
    # the plain versions on the CPU, and -p
    nc = ac["cpu"]
    cpu_out, cpu_wall, _ = align_cli(["-i", graph_path, "--torch-device",
                                      "cpu", fasta("cpu", range(nc))])
    if cpu_out.splitlines() != lines[:nc]:
        raise AssertionError("align: the CPU run's bytes differ")
    npar = ac["par"]
    par_out, par_wall, _ = align_cli(["-i", graph_path, "-p",
                                      str(ac["par_procs"]), *tdev,
                                      fasta("par", range(npar))])
    if par_out.splitlines() != lines[:npar]:
        raise AssertionError("align: the -p run's bytes differ")
    log(f"align: the first {nc} reads' bytes equal the --torch-device cpu "
        f"run's ({cpu_wall:.1f} s), the first {npar} reads' the -p "
        f"{ac['par_procs']} run's ({par_wall:.1f} s)")
    # the kernels on the largest wave of the run, timed as it ran
    big = check["largest"]
    entries = {}
    add_entry(entries, torch, " [align]", "align_wave", *big["entry"])
    log(f"align_wave [align]: the largest wave {big['rows']} x "
        f"{big['W']} ({big['parents']} parents, {big['slots']} branch "
        f"slots), device ms from the profiler {big['device_ms']} (a mean "
        f"of 10 calls); {check['waves']} waves, {launches['align_wave']} "
        "launches")
    # wave_dp on the same wave's planes through compute_wave's own entry
    planes, (go, ge) = big["planes"], big["gaps"]
    host = [a.cpu().numpy() for a in planes]
    res, wd = run_path(lambda: wx.compute_wave(*host, go, ge, dev))
    inputs = (*planes, go, ge)
    want = wx.wave_dp_plain(*inputs)
    if wd["wave_dp"] != (dev.type == "cuda") or any(
            max_abs_err(torch, torch.from_numpy(r).to(dev), w)
            for r, w in zip(res, want)):
        raise AssertionError(f"compute_wave: {wd['wave_dp']} wave_dp "
                             "launches or its output differs")
    CH, W = planes[0].shape
    nbytes = 7 * CH * W * 4 + CH * (4 * 4 + 1)
    add_entry(entries, torch, " [align]", "wave_dp",
              wx.wave_dp(*inputs), want,
              device_ms(torch, dev, lambda: wx.wave_dp(*inputs), 20),
              device_ms(torch, dev, lambda: wx.wave_dp_plain(*inputs), 3),
              nbytes)
    log(f"wave_dp [align]: the largest wave's {CH} x {W} planes through "
        f"compute_wave, {wd['wave_dp']} launch")
    return {"align_wave": launches["align_wave"],
            "wave_dp": wd["wave_dp"]}, entries


def time_wave(torch, dev, wx, store, tables, pack, W, go, ge, n_out):
    """Time one wave of the engine where it ran: align_wave again on the
    same store (it writes the same rows; the parents' rows stay), by
    events and by the profiler, and align_wave_plain, both outputs kept
    for add_entry, the launch counter left as the engine's run made it;
    the wave's planes for wave_dp.  -> dict."""
    CH = len(pack)
    slots = (n_out - CH * (wx.NSTAT + W)) // (2 * W)
    rows = pack[:, wx.PK_ROW].long()
    outs = [torch.empty(n_out, dtype=torch.int32, device=dev)
            for _ in range(2)]
    launches = wx.align_wave.launches     # these launches do not count

    def kernel():
        return wx.align_wave(store, tables, pack, W, go, ge, outs[0])

    def plain():
        return wx.align_wave_plain(store, tables, pack, W, go, ge, outs[1])

    ms = device_ms(torch, dev, kernel, 20)
    got = (store[rows, :, :W].clone(), outs[0].clone())
    plain_ms = device_ms(torch, dev, plain, 3)
    want = (store[rows, :, :W].clone(), outs[1].clone())
    dms = None
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kernel()
            outs[0].add_(0)       # a PyTorch op, so that the trace closes
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) or 0
                 for e in prof.key_averages() if "align_wave" in e.key)
        dms = us / 10 / 1e3 if us > 0 else None
    kernel()                      # the store as the kernel leaves it
    wx.align_wave.launches = launches
    parents = int(torch.unique(pack[:, wx.PK_PARENT]).numel())
    # each parent's S and F rows, each child's profile and partial-sum
    # rows, its packed vectors; S, E, F and S again written, the
    # statistics and the branch slots' rows
    nbytes = (parents * 2 * W + CH * 2 * W + CH * wx.NPACK) * 4 \
        + (CH * 4 * W + CH * wx.NSTAT + slots * 2 * W) * 4
    planes, _ = wx.wave_planes(store, tables, pack, W)
    return dict(rows=CH, W=W, parents=parents, slots=slots, device_ms=dms,
                entry=(got, want, ms, plain_ms, nbytes), planes=planes,
                gaps=(go, ge))


# --------------------------------------------------------------------------
# 8b. query-align: query --align and --batch-align (kernels B11, A, 2, 3,
# and D2 or D1-D4 for the batch graphs)
# --------------------------------------------------------------------------

QA_K = 21                      # the k of the device-route batch graphs


def seq_codes(seq: bytes) -> np.ndarray:
    """ACGT -> 0..3, any other byte 4."""
    a = np.frombuffer(seq, np.uint8)
    return np.select([a == c for c in b"ACGT"], [0, 1, 2, 3],
                     4).astype(np.uint8)


def query_align_config():
    """The ``AlignerConfig`` that ``query --align`` makes with its default
    flags, through the CLI's own parser and helper."""
    from metagraph_tpu_torch import cli
    from metagraph_tpu_torch.align.config import AlignerConfig
    a = cli.build_parser().parse_args(["query", "-i", "g", "-a", "a",
                                       "--align", "q.fa"])
    return AlignerConfig(min_exact_match=a.align_min_exact_match,
                         protein=False, **cli._aligner_scoring_kwargs(a))


def query_align_run(engine, seqs, acfg, batch_bp, batch_align, k):
    """``query --align --json`` through ``QueryEngine.query_records``:
    -> (JSON lines, the batches' summed seconds, batches, the batch
    graphs' trace lines, wall s)."""
    from metagraph_tpu_torch.seq_io.fasta import FastaRecord
    recs = [FastaRecord(f"r{i}", s) for i, s in enumerate(seqs)]
    graphs, tot, seen, nb, out = [], {}, None, 0, []
    engine.trace = lambda m: graphs.append(m) \
        if m.startswith("Batch graph") else None
    t0 = time.perf_counter()
    try:
        for res in engine.query_records(recs, "labels",
                                        batch_size_bp=batch_bp,
                                        aligner_config=acfg,
                                        batch_align=batch_align):
            st = engine.last_batch_seconds
            if st is not seen:
                seen, nb = st, nb + 1
                for key, v in st.items():
                    tot[key] = tot.get(key, 0.0) + v
            out.append(res.to_json(False, k))
    finally:
        engine.trace = None
    return out, tot, nb, graphs, time.perf_counter() - t0


def cigar_ops(cigar: str):
    import re
    return [(int(n), op) for n, op in re.findall(r"(\d+)([=XIDSG])", cigar)]


def check_aligned(query: bytes, score, cigar, orientation, seq: bytes,
                  keys, k):
    """One alignment (the sequence possibly led by its first node's
    prefix) held to ``oracle_alignment``."""
    ops = cigar_ops(cigar)
    ref_len = sum(n for n, op in ops if op in "=XD")
    off = len(seq) - ref_len
    if off < 0:
        raise AssertionError(f"query-align: {cigar} spells more than "
                             f"{seq[:40]}")
    n_match = sum(n for n, op in ops if op == "=")
    return oracle_alignment(query, ("-" if orientation else "+",
                                    seq[off:].decode(), score, n_match,
                                    cigar, off), keys, k)


def check_query_align(lines, seqs, kinds, o, k, batch_align, tag):
    """Every JSON line of a ``query --align`` run: the alignment held to
    the independent oracle (an unaligned read clipped whole and kept as
    it is), the respelled sequence's labels equal to the oracle's, and
    every error-free read all-match end to end, at least 80% of the reads
    aligned.  A basic graph's batch graph holds the reads' forward
    k-mers only (metagraph_tpu/query/batch_graph.py), so with
    ``batch_align`` that holds for the reads with a forward k-mer in the
    references, and the error-free reads among them.  -> (aligned,
    labelled, reads held to the share)."""
    if len(lines) != len(seqs):
        raise AssertionError(f"{tag}: {len(lines)} results for "
                             f"{len(seqs)} reads")
    aligned = labelled = eligible = 0
    for i, ln in enumerate(lines):
        r = json.loads(ln)
        seq = r["sequence"].encode()
        if r["seq_description"] != f"r{i}":
            raise AssertionError(f"{tag}: result {i} is not read {i}")
        if r["cigar"] == f"{len(seqs[i])}S":
            if r["score"] != 0 or seq != seqs[i]:
                raise AssertionError(f"{tag}: unaligned read {i} changed")
        else:
            check_aligned(seqs[i], r["score"], r["cigar"], r["orientation"],
                          seq, o["keys"], k)
            aligned += 1
        _, fwd = oracle_lookup(seq_codes(seqs[i]), o, 0)
        exact = kinds[i] == "exact" and (fwd.all() or not batch_align)
        eligible += bool(fwd.any()) or not batch_align
        if exact and r["cigar"] != f"{len(seqs[i])}=":
            raise AssertionError(f"{tag}: error-free read {i} aligned as "
                                 f"{r['cigar']}")
        got = [x["sample"] for x in r["results"]]
        if got != oracle_payload(seq_codes(seq), "labels", o):
            raise AssertionError(f"{tag}: read {i}'s labels differ from "
                                 "the oracle's")
        labelled += bool(got)
    if aligned < 0.8 * eligible:
        raise AssertionError(f"{tag}: only {aligned} of {eligible} reads "
                             "aligned")
    return aligned, labelled, eligible


def k21_deployment(refs, labels, dev):
    """The first references at k = 21: the port's graph
    (``DBGSuccinct.build``, the device route D1-D4) and its query index
    (``convert.from_graph``, as ``query`` makes it) with the oracle's
    labels on its node ids.  -> (index, oracle, graph)."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    keys_of = lambda codes: window_keys(codes, QA_K)     # noqa: E731
    keys = [keys_of(r)[0] for r in refs]
    labs = np.concatenate([np.full(len(kk), i, np.int64)
                           for i, kk in enumerate(keys)])
    o = make_oracle(np.concatenate(keys), labs, len(refs), QA_K, keys_of)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    g = DBGSuccinct.build([letters[r].tobytes() for r in refs], QA_K,
                          device=dev)
    return convert.from_graph(g, graph_annotation(g, o, labels)), o, g


def query_align_phase(cfg, graph_path, refs, anno, oracle, seed, torch,
                      dev):
    """Phase 8b: ``query --align`` and ``--batch-align`` on the port
    (``QueryEngine.query_records`` with the config that the CLI makes,
    each result written as ``--json`` writes it), on the 3b graph loaded
    from its mmap layout and its index (``convert.from_graph``, as
    ``query`` makes it, with 3b's annotation of the graph's node ids);
    150 bp reads of ``align_reads`` from the seed's stream 13.  A warm run
    builds the graph's lazy tables, a calibration run gives the rate;
    then, each under the launch counters:

    1. ``target`` reads at ``batch_bp`` a batch (fewer where the rate puts
       fewer in ``budget_s``, at least ``least``);
    2. the same reads with ``--batch-align`` (k = 31: every batch graph on
       the general route, its sorts through D2);
    3. ``k21_reads`` reads of the first ``k21_refs`` references with
       ``--batch-align`` against their k = 21 graph (``k21_deployment``;
       the batch graph on the device route, D1-D4).

    Each: one ``align_wave`` a wave and no ``wave_dp``; kernels A, 2 and 3
    on the respelled batches (no wire route); D2 (or D1-D4) for every
    batch graph; every result held to the oracles (``check_query_align``);
    the first ``cpu`` reads' lines (1) or the first batch's (2, 3) equal
    to a run of the plain versions on the CPU.  -> (the 3b graph, the
    reads and their kinds), for the server's /align."""
    from metagraph_tpu_torch import convert
    from metagraph_tpu_torch.align.wave_extender import STATS
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    qc = cfg["query_align"]
    m = cfg["align"]["read_len"]
    rng = np.random.default_rng([seed, 13])
    seqs, kinds = align_reads(rng, refs, qc["pool"], m)
    acfg = query_align_config()
    t0 = time.perf_counter()
    g = DBGSuccinct.load(graph_path)
    index = convert.from_graph(g, anno)
    engine = QueryEngine(index, device=dev, graph=g)
    cpu_engine = QueryEngine(index, device="cpu", graph=g)
    warm, cal = qc["warm"], qc["calibrate"]
    query_align_run(engine, seqs[-warm:], acfg, qc["batch_bp"], False, K)
    *_, cal_s = query_align_run(engine, seqs[-warm - cal: -warm], acfg,
                                qc["batch_bp"], False, K)
    rate = cal / cal_s
    n = int(min(max(min(rate * qc["budget_s"], qc["target"]), qc["least"]),
                len(seqs) - warm - cal))
    log(f"query-align: the 3b graph ({g.num_nodes()} k-mers), its index "
        f"(convert.from_graph with 3b's annotation) and engines on the card "
        f"and the CPU in {time.perf_counter() - t0:.1f} s; {warm} warm "
        f"reads, then {cal} reads in {cal_s:.2f} s "
        f"({rate:.1f} reads/s): {n} reads for the counted runs")
    per_batch = -(-qc["batch_bp"] // m)

    def step(name, eng, cpu_eng, sq, kd, o, k, batch_align, n_cpu,
             dep_kernels):
        waves0 = STATS["waves"]
        (lines, st, nb, graphs, wall), launches = run_path(
            lambda: query_align_run(eng, sq, acfg, qc["batch_bp"],
                                    batch_align, k))
        waves = STATS["waves"] - waves0
        aligned, labelled, eligible = check_query_align(
            lines, sq, kd, o, k, batch_align, f"query-align {name}")
        query_s = st["pack"] + st["device"] + st["collect"]
        log(f"query-align {name}: {len(sq)} reads of {m} bp in {nb} "
            f"batches, {wall:.2f} s ({len(sq) / wall:.1f} reads/s): "
            f"seeding {st['seeding']:.2f} s, alignment (seeding, waves and "
            f"the engine's host work) {st['align']:.2f} s, batch graphs "
            f"{st['batch_graph']:.2f} s ({len(graphs)}), query {query_s:.2f}"
            f" s; {aligned} aligned ({eligible} held to 80%), {labelled} "
            "labelled, every alignment and label set held to the oracles")
        for ln in graphs:
            log(f"  {ln}")
        log(f"  launches {launches} for {waves} waves")
        if dev.type == "cuda":
            bad = []
            if launches["align_wave"] != waves or not waves \
                    or launches["wave_dp"]:
                bad.append("align_wave a wave, no wave_dp")
            for kname in ("key_lookup", "label_counts", "selection_mask"):
                if launches[kname] < nb:
                    bad.append(f"{kname} on every respelled batch")
            if launches["wire_lookup"] or launches["codes_lookup"]:
                bad.append("no fused route")
            if batch_align and len(graphs) < nb:
                bad.append(f"a batch graph a batch ({len(graphs)})")
            for kname in dep_kernels:
                if launches[kname] < len(graphs):
                    bad.append(f"{kname} for every batch graph")
            others = set(BUILD_KERNELS) - set(dep_kernels)
            if any(launches[kname] for kname in others):
                bad.append(f"only {dep_kernels} of the build kernels")
            if bad:
                raise AssertionError(f"query-align {name}: launches "
                                     f"{launches}: expected " +
                                     "; ".join(bad))
        t = time.perf_counter()
        cpu_lines, *_ = query_align_run(cpu_eng, sq[:n_cpu], acfg,
                                        qc["batch_bp"], batch_align, k)
        if cpu_lines != lines[:n_cpu]:
            raise AssertionError(f"query-align {name}: the CPU run's lines "
                                 "differ")
        log(f"  the first {n_cpu} reads' lines equal the plain versions' on "
            f"the CPU ({time.perf_counter() - t:.1f} s)")
        return launches

    main_seqs, main_kinds = seqs[:n], kinds[:n]
    step("full graph", engine, cpu_engine, main_seqs, main_kinds, oracle,
         K, False, min(qc["cpu"], n), ())
    step("batch graph, k = 31", engine, cpu_engine, main_seqs, main_kinds,
         oracle, K, True, min(per_batch, n), ("radix_sort",))
    # 3. the first references at k = 21
    t = time.perf_counter()
    nr = qc["k21_refs"]
    index21, o21, g21 = k21_deployment(refs[:nr], [f"ref{i}"
                                                   for i in range(nr)], dev)
    e21 = QueryEngine(index21, device=dev, graph=g21)
    c21 = QueryEngine(index21, device="cpu", graph=g21)
    rng21 = np.random.default_rng([seed, 14])
    s21, k21 = align_reads(rng21, refs[:nr], qc["k21_reads"], m)
    log(f"query-align k = 21: {g21.num_nodes()} k-mers of the first {nr} "
        f"references, graph, index and engines in "
        f"{time.perf_counter() - t:.1f} s")
    step("batch graph, k = 21", e21, c21, s21, k21, o21, QA_K, True,
         min(per_batch, len(s21)), BUILD_KERNELS)
    del e21, c21, index21, g21, engine, cpu_engine, index
    return g, seqs[n: n + 2 * qc["server_reads"]], \
        kinds[n: n + 2 * qc["server_reads"]]


SOURCES = {
    "wire_lookup": ("metagraph_tpu_torch/csrc/wire_lookup.cu",
                    "metagraph_tpu/succinct/ops.py:439"),
    "label_counts": ("metagraph_tpu_torch/csrc/label_counts.cu",
                     "metagraph_tpu/query/device.py:107"),
    "selection_mask": ("metagraph_tpu_torch/csrc/selection_mask.cu",
                       "metagraph_tpu/query/device.py:168"),
    "sw_scores": ("metagraph_tpu_torch/csrc/sw_scores.cu",
                  "metagraph_tpu/align/pallas_sw.py:35"),
    "gather_loop": ("metagraph_tpu_torch/csrc/gather_rows.cu",
                    "scripts/exp_pallas_gather.py:54"),
    "gather_take": ("metagraph_tpu_torch/csrc/gather_rows.cu",
                    "scripts/exp_pallas_gather.py:82"),
    "key_lookup": ("metagraph_tpu_torch/csrc/key_lookup.cu",
                   "metagraph_tpu/succinct/ops.py:433"),
    "codes_lookup": ("metagraph_tpu_torch/csrc/codes_lookup.cu",
                     "metagraph_tpu/query/device.py:297"),
    "sparse_label_counts": ("metagraph_tpu_torch/csrc/sparse_counts.cu",
                            "metagraph_tpu/annotation/sparse_device.py:268"),
    "overflow_counts": ("metagraph_tpu_torch/csrc/sparse_counts.cu",
                        "metagraph_tpu/annotation/sparse_device.py:304"),
    "brwt_row_words": ("metagraph_tpu_torch/csrc/row_words.cu",
                       "metagraph_tpu/annotation/device_matrix.py:338"),
    "rowdiff_row_words": ("metagraph_tpu_torch/csrc/row_words.cu",
                          "metagraph_tpu/annotation/device_matrix.py:190"),
    "build_windows": ("metagraph_tpu_torch/csrc/build_windows.cu",
                      "metagraph_tpu/succinct/device_build.py:190"),
    "radix_sort": ("metagraph_tpu_torch/csrc/radix_sort.cu",
                   "metagraph_tpu/succinct/device_build.py:194"),
    "build_join": ("metagraph_tpu_torch/csrc/build_join.cu",
                   "metagraph_tpu/succinct/device_build.py:195"),
    "build_emit": ("metagraph_tpu_torch/csrc/build_emit.cu",
                   "metagraph_tpu/succinct/device_build.py:253"),
    "wave_dp": ("metagraph_tpu_torch/csrc/wave_dp.cu",
                "metagraph_tpu/align/batch.py:91"),
    "align_wave": ("metagraph_tpu_torch/csrc/wave_dp.cu",
                   "metagraph_tpu/align/batch.py:91"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chip_smoke"))
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "chip_smoke_work"),
                    help="where the many-labels and words annotation files go "
                         "(a few hundred MB)")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU with the plain versions; "
                         "exits 2 without a result")
    ap.add_argument("--only-build", action="store_true",
                    help="the card, the kernels' build and the build phases "
                         "alone; exits 3 without a result")
    args = ap.parse_args(argv)
    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    cfg = TINY if args.rehearse else FULL
    if args.rehearse:
        # tiny shapes gain nothing from threads, and a thread team that
        # waits on its slowest member stalls when other processes load
        # the CPU (the test suite runs this beside its own workers)
        torch.set_num_threads(1)
    dev = torch.device("cpu" if args.rehearse else "cuda")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.work, exist_ok=True)
    t_start = time.perf_counter()
    phases = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t
        return out

    card, _ = timed("card and build", card_and_build, args.rehearse,
                    args.out)
    # the device construction (kernels D1-D4): a pan-genome and a read set,
    # then a canonical pan-genome, a counted read set and a bounded-RAM
    # protein build
    builds = build_phase(cfg, args.seed, torch, dev, args.work, timed)
    if args.only_build:
        for dep, (bl, be) in builds.items():
            for name, e in be.items():
                log(f"{name}/{dep}: launches {bl[name]}, " + json.dumps(e))
        log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in phases.items()))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print("build phase only: no result", file=sys.stderr)
        return 3
    rng = np.random.default_rng(args.seed)
    refs, index, oracle = timed("basic index", make_index, cfg, rng)
    log(f"index: {index.num_rows} k-mers (k = {K}), {len(index.labels)} "
        f"labels; hash table {index.table.shape} = {index.table.nbytes} B, "
        f"bitmap {index.device_anno.shape} = {index.device_anno.nbytes} B; "
        f"made in "
        f"{phases['basic index']:.1f} s")
    engine = timed("uploads", QueryEngine, index, device=dev)
    seqs, codes, period = timed("batches", make_batch, cfg, rng, refs)
    # the first path_reads reads and the long sequence (3b takes them all)
    cut = cfg["path_reads"]
    seqs_c, codes_c = seqs[:cut] + seqs[-1:], codes[:cut] + codes[-1:]
    launches = timed("query paths and oracle", main_path, engine, seqs_c,
                     codes_c, period, oracle, cfg, rng, torch, dev)
    entries = timed("kernel checks", kernel_checks, engine, seqs_c, cfg,
                    torch, dev)
    # -p: the same batch in par_batches batches, par_threads in flight
    timed("parallel", parallel_phase, engine, seqs_c, cfg, torch, dev)
    del engine

    # A10: the JAX package's own workload (DeviceQueryPipeline, the older
    # epochs and the dedup epoch: kernels A, 2 and D2) on the basic
    # references, built by the port, and the basic batch's reads
    *a10, a10_g, a10_anno = a10_phase(
        cfg, refs, oracle, index.labels, seqs, codes,
        np.random.default_rng([args.seed, 10]), torch, dev, timed)
    # 8. align: the port's align command on the 3b graph, saved in the
    # mmap layout, with reads of the basic references from the seed
    a10_path = os.path.join(args.work, "a10")
    timed("align", a10_g.save, a10_path, mmap_layout=True)
    del a10_g
    align = timed("align", align_phase, cfg, a10_path + ".dbg.npz", refs,
                  oracle, args.seed, torch, dev, args.work)
    # 8b. query --align and --batch-align on the same graph and its index;
    # the graph and more reads go on to the server's /align
    qa_graph, qa_seqs, qa_kinds = timed(
        "query-align", query_align_phase, cfg, a10_path + ".dbg.npz", refs,
        a10_anno, oracle, args.seed, torch, dev)
    del a10_anno

    # build --graph, --suffix and a KMC input through the port's CLI; the
    # graphs without a BOSS that it writes (the basic k-mers as a bitmap
    # graph, the wide DNA references as a canonical hash graph and a basic
    # sshash graph) then load through DBGSuccinct.load and take the map
    # route (kernels A, 2, 3)
    wide = timed("batches", wide_inputs, cfg, args.seed)
    rng7 = np.random.default_rng([args.seed, 7])
    maps = timed("graph-types indexes", kmer_graph_maps, oracle,
                 index.annotation, wide)
    paths, last_flags = graph_build_phase(cfg, maps, refs, wide, args.work,
                                          torch, dev, timed)
    last_flags["suffix"] = suffix_phase(cfg, wide, args.work, torch, dev,
                                        timed)
    last_flags["kmc"] = kmc_phase(cfg, wide, args.work, torch, dev, timed,
                                  np.random.default_rng([args.seed, 11]))
    deployments = timed("graph-types indexes", load_kmer_graphs, maps,
                        paths)
    del maps
    more_graphs = graph_types_phase(cfg, deployments, seqs, codes, rng7,
                                    torch, dev, timed)
    del deployments
    # the basic index behind the port's HTTP server (the wire route) with
    # the 3b graph of its k-mers (/align), requests from two client threads
    timed("server", server_phase, cfg, index, qa_graph, seqs, codes,
          oracle, torch, dev, qa_seqs, qa_kinds)
    del qa_graph

    # many-labels: the basic table and batch with a converted 4,096-label
    # annotation past the dense budget (block-sparse: kernels 1, S1, S2, 3)
    os.environ["METAGRAPH_DENSE_ANNO_BUDGET"] = str(cfg["anno_budget"])
    rng4 = np.random.default_rng([args.seed, 4])
    index_m, oracle_m, msecs, cols_m = timed(
        "many-labels index", make_many_labels, cfg, rng4, oracle, index,
        args.work)
    sp = index_m.device_anno
    log(f"many-labels index: {len(index_m.labels)} labels, block-sparse "
        f"entries {sp.entries.shape} = {sp.entries.nbytes} B (tau {sp.tau}), "
        f"dmap {sp.dmap.nbytes} B, dense8 {sp.dense8.shape}; the dense "
        f"bitmap would be {index_m.num_rows * (-(-sp.num_labels // 32)) * 4}"
        " B; " + ", ".join(f"{k} {v:.1f} s" for k, v in msecs.items()))
    engine = timed("uploads", QueryEngine, index_m, device=dev)
    log(f"many-labels on the card: row records "
        f"{tuple(engine.annotation.record.shape)} = "
        f"{engine.annotation.record.nbytes} B")
    ml_launches = timed(
        "query paths and oracle", main_path, engine, seqs_c, codes_c,
        period, oracle_m, cfg, rng4, torch, dev,
        "many-labels (block-sparse)", modes=("labels", "matches"),
        kernels=("wire_lookup", "sparse_label_counts", "overflow_counts",
                 "selection_mask"))
    ml_entries = timed("kernel checks", sparse_checks, engine, seqs_c, cfg,
                       torch, dev, " [many-labels]")
    del engine, sp
    for name in ("sparse_label_counts", "overflow_counts"):
        launches[name], entries[name] = ml_launches[name], ml_entries.pop(name)

    # words-brwt and words-rowdiff: the many-labels columns past a budget
    # that the overflow patterns pass (the words route: kernels 1, W1 or
    # W2, 2, 3), on the first words_reads reads and reference 0 once
    os.environ["METAGRAPH_DENSE_ANNO_BUDGET"] = str(cfg["words_budget"])
    words_idx, wsecs = timed("words indexes", make_words, cfg, refs,
                             oracle_m, index_m, cols_m, args.work)
    del cols_m
    log("words indexes: " + ", ".join(f"{k} {v:.1f} s"
                                      for k, v in wsecs.items()))
    nw = cfg["words_reads"]
    wseqs = seqs[:nw] + [np.frombuffer(b"ACGTN", np.uint8)[refs[0]]
                         .tobytes()]
    wcodes = codes[:nw] + [refs[0]]
    rng5 = np.random.default_rng([args.seed, 5])
    words_more = {}
    for name, idx in words_idx.items():
        walk = idx.device_anno
        tree = getattr(walk, "inner", walk)
        log(f"{name} index: tree of {tree.nodes.shape[0]} nodes and "
            f"{tree.words.shape[0]} words ({tree.nodes.nbytes} + "
            f"{tree.words.nbytes} B), stack {tree.stack_cap} runs a warp"
            + (f"; walk of at most {walk.max_depth} steps"
               if walk is not tree else ""))
        kern = "brwt_row_words" if name == "words-brwt" \
            else "rowdiff_row_words"
        engine = timed("uploads", QueryEngine, idx, device=dev)
        wl = timed("query paths and oracle", main_path, engine, wseqs,
                   wcodes, 0, oracle_m, cfg, rng5, torch, dev, name,
                   modes=("labels", "matches"),
                   kernels=("wire_lookup", kern, "label_counts",
                            "selection_mask"), check_last=True)
        we = timed("kernel checks", words_checks, engine, wseqs, cfg, torch,
                   dev, f" [{name}]")
        launches[kern], entries[kern] = wl[kern], we.pop(kern)
        words_more[name.replace("-", "_")] = (wl, we)
        del engine
    del words_idx, index_m, oracle_m

    # the primary graph (the basic index's k-mers queried through
    # CanonicalDBG: canon 2) and the canonical graph (both strands: canon
    # 1), with traffic from both strands, from a second stream of the seed
    rng2 = np.random.default_rng([args.seed, 2])
    seqs2, codes2, period2 = timed(
        "batches", make_batch, dict(cfg, n_reads=cfg["path_reads"]), rng2,
        refs, rc_share=0.5, long_rc=True)
    engine = timed("uploads", QueryEngine, dataclasses.replace(
        index, canon=2), device=dev)
    # kernels 1-3 once more for each deployment, under "<kernel>/<name>"
    more = {"many_labels": (ml_launches, ml_entries), **words_more,
            **more_graphs, **builds, **last_flags, "a10": a10,
            "align": align}
    more["primary"] = (
        timed("query paths and oracle", main_path, engine, seqs2, codes2,
              period2, oracle, cfg, rng2, torch, dev,
              "primary graph (canon 2)"),
        timed("kernel checks", kernel_checks, engine, seqs2, cfg, torch, dev,
              " [canon 2]"))
    del engine
    index_c, oracle_c = timed("canonical index", make_canonical_index, refs,
                              index.labels)
    log(f"canonical index: {index_c.num_rows} k-mers (both strands), hash "
        f"table {index_c.table.shape} = {index_c.table.nbytes} B, bitmap "
        f"{index_c.device_anno.shape} = {index_c.device_anno.nbytes} B; "
        f"made in "
        f"{phases['canonical index']:.1f} s")
    engine = timed("uploads", QueryEngine, index_c, device=dev)
    more["canonical"] = (
        timed("query paths and oracle", main_path, engine, seqs2, codes2,
              period2, oracle_c, cfg, rng2, torch, dev,
              "canonical graph (canon 1)", modes=("labels",)),
        timed("kernel checks", kernel_checks, engine, seqs2, cfg, torch, dev,
              " [canon 1]"))
    del engine, index_c, oracle_c

    # k = 41 over the same references (the codes route: kernels B, 2, 3),
    # the basic batch's reads and a long sequence for k = 41
    index41, oracle41 = timed("k41 index", make_wide_index, refs,
                              index.labels)
    log(f"k41 index: {index41.num_rows} k-mers, hash table "
        f"{index41.table.shape} = {index41.table.nbytes} B, bitmap "
        f"{index41.device_anno.shape} = {index41.device_anno.nbytes} B; "
        f"made in "
        f"{phases['k41 index']:.1f} s")
    long41 = long_sequence(cfg, refs[0], K41)
    seqs41 = seqs[:cut] + [np.frombuffer(b"ACGTN", np.uint8)[long41]
                           .tobytes()]
    codes41 = codes[:cut] + [long41]
    engine = timed("uploads", QueryEngine, index41, device=dev)
    more["k41"] = (
        timed("query paths and oracle", main_path, engine, seqs41, codes41,
              len(refs[0]), oracle41, cfg, rng, torch, dev,
              "k41 graph (codes route)",
              modes=("labels", "counts-sum", "coords"),
              kernels=("codes_lookup", "label_counts", "selection_mask")),
        timed("kernel checks", codes_checks, engine, seqs41, cfg, torch, dev,
              " [k41]"))
    del engine
    # the same index with a .seqs mapping (the map route: kernel A)
    more["seqs"] = timed("seqs", seqs_phase, cfg, index41, oracle41, refs,
                         seqs41, codes41, rng, torch, dev, args.work)
    del index41, oracle41

    # Protein at k = 20 (8-bit keys: the map route, kernel A, then kernels
    # 2 and 3), from a third stream of the seed
    rng3 = np.random.default_rng([args.seed, 3])
    prefs, index_p, oracle_p = timed("protein index", make_protein_index,
                                     cfg, rng3, index.labels)
    log(f"protein index: {index_p.num_rows} k-mers, hash table "
        f"{index_p.table.shape} = {index_p.table.nbytes} B, bitmap "
        f"{index_p.device_anno.shape} = {index_p.device_anno.nbytes} B; "
        f"made in "
        f"{phases['protein index']:.1f} s")
    pseqs, pcodes = timed("batches", make_protein_batch,
                          dict(cfg, n_reads=cfg["path_reads"]), rng3, prefs)
    engine = timed("uploads", QueryEngine, index_p, device=dev)
    more["protein"] = (
        timed("query paths and oracle", main_path, engine, pseqs, pcodes, 0,
              oracle_p, cfg, rng3, torch, dev, "protein graph (map route)",
              modes=("labels", "matches"),
              kernels=("key_lookup", "label_counts", "selection_mask")),
        timed("kernel checks", key_checks, engine, pseqs, cfg, torch, dev,
              " [protein]"))
    del engine, index_p, oracle_p

    # keys wider than 8 words: DNA k = 70 (codes and map routes), Protein
    # k = 40 and 80 (the second past kernel A's block form)
    more.update(wide_phase(cfg, torch, dev, wide, timed))

    sw = timed("SW phase", sw_phase, cfg, rng, torch, dev)
    launches["sw_scores"], entries["sw_scores"] = sw.pop("")
    gl, ge = timed("gather phase", gather_phase, cfg, torch, dev)
    for name in ("gather_loop", "gather_take"):
        launches[name], entries[name] = gl[name], ge[name]
    rows = [(name, launches[name], entries[name]) for name in SOURCES
            if name in entries]
    for dep, (dl, de) in more.items():
        rows += [(f"{name}/{dep}", dl[name], e) for name, e in de.items()]
    rows += [(f"sw_scores{shape}", n, e) for shape, (n, e) in sw.items()]
    kernels = []
    for name, n, e in rows:
        source, replaces = SOURCES[name.split("/")[0]]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"],
                        "library_ms": e.get("library_ms")})
    log("kernels: " + ", ".join(
        f"{k['name']} launches={k['launches']} "
        f"match={'exact' if k['max_abs_err'] == 0 else 'NO'}"
        for k in kernels))
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phases.items()))
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
