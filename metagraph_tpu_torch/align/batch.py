"""Lockstep batch alignment; own copy of metagraph_tpu/align/batch.py
(``drive_batch``, :26).

Runs many per-read alignment generators (DBGAligner.align_gen) in lockstep
at EXTENSION granularity: each generator yields ("extend", job) requests;
``drive_batch`` collects one job per active read and runs them all concurrently
through the flat wave engine (flat.py) — one stacked column-DP call (kernel
B11 ``align_wave`` over the engine's store on the card: it takes the place
of the JAX package's ``_compute_wave_device`` and native ``align_wave``)
and one batched graph-traversal call per global wave, across every read's
current extension.  Per-read results are
byte-identical to the sequential path: the generators encapsulate all
per-read control flow (seed order, aggregator cutoffs, convergence-filter
reuse across seeds).
"""

from __future__ import annotations

from typing import List

from .flat import FlatEngine, _group_key


def drive_batch(gens: List, device, max_window: int = 0) -> List:
    """Advance alignment generators with continuous batching; returns their
    results.

    Generators yield ("extend", (extender, seed, min_path_score,
    force_fixed_seed)) requests.  Every pending extension — across all
    reads — runs in ONE shared flat-engine wave pool; when a read's
    extension completes, its generator resumes immediately and its next
    extension joins the pool mid-flight, so the pool stays dense instead of
    draining round by round (the continuous-batching analog of the
    reference's work-stealing thread pool, ref dbg_aligner.cpp:358-385)."""
    results = [None] * len(gens)
    engines = {}
    owner = {}                  # (group key, slot) -> generator index

    def get_engine(ext, seed):
        key = _group_key(ext)
        eng = engines.get(key)
        if eng is None:
            W = max(max_window,
                    len(ext.query) - seed.get_clipping() + 1)
            eng = FlatEngine(ext.graph, ext.config, ext.profile_chars,
                             ext.char_idx, W, device)
            engines[key] = eng
        return eng, key

    def feed(i, value):
        """Resume generator i with ``value``; admit its next job (looping
        over empty-seed requests, which resolve to [] synchronously)."""
        while True:
            try:
                tag, req = gens[i].send(value)
            except StopIteration as st:
                results[i] = st.value
                return
            assert tag == "extend"
            ext, seed, mps, ffs = req
            if seed.empty():
                value = []
                continue
            eng, key = get_engine(ext, seed)
            owner[(key, eng.add_job(ext, seed, mps, ffs))] = i
            return

    for i in range(len(gens)):
        feed(i, None)
    while True:
        ran = False
        for key, eng in engines.items():
            if not eng.active:
                continue
            ran = True
            done = eng.step()
            eng.fetch_tables(done)      # one copy for the step's tables
            for slot in done:
                feed(owner.pop((key, slot)), eng.finalize(slot))
        if not ran:
            break
    return results
