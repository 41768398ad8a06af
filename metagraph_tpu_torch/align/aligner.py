"""The aligner; own copy of metagraph_tpu/align/aligner.py
(``AlignmentAggregator``, ``DBGAligner``, ``format_alignments_tsv``; ref
src/graph/alignment/dbg_aligner.{hpp,cpp}).

align_batch per query: seed -> extend (forward), then reverse-complement each
local alignment and re-extend on the other strand (ref align_both_directions,
dbg_aligner.cpp:534-760); results aggregated into the top
num_alternative_paths by LocalAlignmentLess.  The aligner holds the torch
device that its extension waves run on (kernel B11 ``align_wave`` on
the card, its plain version on the CPU).  On a canonical wrapper graph
(``CanonicalDBG``) the suffix seeds walk the base graph's BOSS.  Labeled
alignment waits for ROADMAP A13.3c.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from .alignment import Alignment, revcomp
from .config import NINF, AlignerConfig
from .extender import DefaultColumnExtender
from .seeder import UniMEMSeeder, make_suffix_seeder

# seconds in seeding (node mapping, the batched range walk, the seeders),
# which ``align -v`` prints
SEED_SECONDS = [0.0]

SuffixUniMEMSeeder = make_suffix_seeder(UniMEMSeeder)
# pickle-by-reference identity (the worker-pool initargs carry this class)
SuffixUniMEMSeeder.__module__ = __name__
SuffixUniMEMSeeder.__qualname__ = SuffixUniMEMSeeder.__name__ = \
    "SuffixUniMEMSeeder"


class AlignmentAggregator:
    """Top-k alignments with per-label buckets (ref aligner_aggregator.hpp:
    labeled alignments are kept in one capped queue per label column, sharing
    the alignment objects; the unlabeled queue doubles as a global-best
    tracker once labeled alignments arrive)."""

    def __init__(self, config: AlignerConfig):
        self.config = config
        self.unlabeled: List[Alignment] = []          # sorted best-first
        self.path_queue: dict = {}                    # label -> [Alignment]

    @staticmethod
    def _same(a: Alignment, b: Alignment) -> bool:
        return (a.score == b.score and a.cigar == b.cigar
                and a.nodes == b.nodes and a.orientation == b.orientation)

    def _push(self, queue: List[Alignment], aln: Alignment) -> bool:
        """ref aligner_aggregator.hpp:86-104 push_to_queue."""
        cfg = self.config
        for existing in queue:
            if self._same(existing, aln):
                return cfg.post_chain_alignments
        if cfg.post_chain_alignments \
                or len(queue) < cfg.num_alternative_paths:
            queue.append(aln)
            queue.sort(key=lambda a: a.sort_key())
            return True
        if aln.sort_key() >= queue[-1].sort_key():
            return False
        queue[-1] = aln
        queue.sort(key=lambda a: a.sort_key())
        return True

    def add(self, aln: Alignment) -> bool:
        labels = list(getattr(aln, "label_columns", ()) or ())
        if not self.unlabeled:
            self.unlabeled.append(aln)
            for c in labels:
                self.path_queue.setdefault(c, []).append(aln)
            return True
        if not self.config.post_chain_alignments \
                and aln.score < self.get_global_cutoff():
            return False
        if not labels:
            return self._push(self.unlabeled, aln)
        if not self.path_queue and len(self.unlabeled) > 1:
            # first labeled alignment: shrink the unlabeled queue to the
            # global-max tracker (ref aligner_aggregator.hpp:110-120)
            self.unlabeled = [self.unlabeled[0]]
        added = False
        for c in labels:
            added |= self._push(self.path_queue.setdefault(c, []), aln)
        if not added:
            return False
        if aln.sort_key() < self.unlabeled[0].sort_key():
            self.unlabeled[0] = aln
        return True

    def get_global_cutoff(self) -> int:
        if not self.unlabeled:
            return NINF
        cur_max = self.unlabeled[0].score
        return int(cur_max * self.config.rel_score_cutoff) \
            if cur_max > 0 else cur_max

    def get_score_cutoff(self, labels) -> int:
        """ref aligner_aggregator.hpp:152-166: min over the seed's labels of
        each label queue's cutoff, floored by the global cutoff."""
        if not labels:
            return self.get_global_cutoff()
        global_min = self.get_global_cutoff()
        min_score = None
        for c in labels:
            q = self.path_queue.get(c)
            cut = NINF if (q is None
                           or len(q) < self.config.num_alternative_paths
                           or self.config.post_chain_alignments) \
                else q[-1].score
            min_score = cut if min_score is None else min(min_score, cut)
            if min_score < global_min:
                return global_min
        return min_score

    def get_alignments(self) -> List[Alignment]:
        seen = []
        out = []
        for q in self.path_queue.values():
            for a in q:
                if not any(a is s for s in seen):
                    seen.append(a)
                    out.append(a)
        for a in self.unlabeled:
            if not any(a is s for s in seen):
                seen.append(a)
                out.append(a)
        out.sort(key=lambda a: a.sort_key())
        return out


class DBGAligner:
    def __init__(self, graph, config: Optional[AlignerConfig] = None,
                 seeder_class=None, device=None):
        self.graph = graph
        # where the extension waves run: the card unless "cpu"
        self.device = resolve_device(device)
        from dataclasses import replace as _dc_replace
        # private copy: clamp_to_k and the DNA_CASE override below must not
        # mutate a config object the caller may reuse for other graphs
        self.config = _dc_replace(config) if config is not None \
            else AlignerConfig()
        self.config.clamp_to_k(graph.k)
        if graph.alphabet == "DNA_CASE":
            # the byte-level revcomp used by the rc re-extension pass does
            # not case-flip; align forward-only on the case-sensitive
            # alphabet (its complement flips case across strands)
            self.config.forward_and_reverse_complement = False
        if seeder_class is None:
            # ref DBGAligner<SuffixSeeder<UniMEMSeeder>> default
            seeder_class = (SuffixUniMEMSeeder
                            if self.config.min_seed_length < graph.k
                            else UniMEMSeeder)
        self.seeder_class = seeder_class

    def _make_seeder(self, query: bytes, orientation: bool, pre=None):
        t0 = time.perf_counter()
        try:
            return self._seeder(query, orientation, pre)
        finally:
            SEED_SECONDS[0] += time.perf_counter() - t0

    def _seeder(self, query: bytes, orientation: bool, pre):
        if pre is not None and "nodes" in pre:
            nodes = pre["nodes"]
        else:
            nodes = self.graph.map_to_nodes_sequentially(query)
        if pre is not None and "ranges" in pre:
            return self.seeder_class(self.graph, query, orientation, nodes,
                                     self.config,
                                     precomputed_ranges=pre["ranges"])
        return self.seeder_class(self.graph, query, orientation, nodes,
                                 self.config)

    def align(self, query: bytes) -> List[Alignment]:
        """One read: a batch of one, its waves on ``self.device``."""
        return self.align_batch([query])[0]

    def align_batch(self, queries: List[bytes],
                    processes: int = 1) -> List[List[Alignment]]:
        """Lockstep batch alignment: every query's extension waves are
        computed together — one batched compute_wave per global step (the
        batched replacement for the reference's per-thread align loop,
        ref dbg_aligner.cpp:358; a read's results do not depend on the
        other reads of its batch).
        ``processes`` > 1 runs worker processes over read chunks (the
        host-parallel analog of the reference's -p OpenMP loop,
        ref cli/align.cpp:305)."""
        if processes > 1 and len(queries) > 1:
            return self._align_batch_pool(queries, processes)
        from .batch import drive_batch
        t0 = time.perf_counter()
        pres = self._preseed_batch(queries)
        SEED_SECONDS[0] += time.perf_counter() - t0
        max_window = max((len(q) + 1 for q in queries), default=1)
        return drive_batch(
            [self.align_gen(q, pre=pre) for q, pre in zip(queries, pres)],
            self.device, max_window=max_window)

    _pool = None
    _pool_procs = 0

    def _get_pool(self, processes: int):
        """Persistent forkserver worker pool.  forkserver re-execs a clean
        Python for its server process, so workers never inherit the
        parent's threads, locks or CUDA context; each worker opens its own.
        The graph and config ship to each worker once, through the pool
        initializer; the kernel library is built here first, so that the
        workers load it and never race nvcc."""
        if self._pool is not None and self._pool_procs == processes:
            return self._pool
        if self._pool is not None:
            self._pool.terminate()
        import multiprocessing as mp
        if self.device.type == "cuda":
            from .. import _build
            _build.build_all(("wave_dp",))
        ctx = mp.get_context("forkserver")
        # the server imports the aligner (and torch) once; each worker
        # forks from it instead of importing them anew
        ctx.set_forkserver_preload([__name__])
        self._pool = ctx.Pool(
            processes, initializer=_pool_init,
            initargs=(self.graph, self.config, self.seeder_class,
                      str(self.device)))
        self._pool_procs = processes
        return self._pool

    def close_pool(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None
            self._pool_procs = 0
            # the forkserver outlives its pools, and after its parent
            # exits it lingers while it unloads torch: stop it and wait,
            # so that a command leaves no process behind (a later pool
            # starts a new one)
            from multiprocessing import forkserver
            forkserver._forkserver._stop()

    def __del__(self):
        try:
            self.close_pool()
        except Exception:
            pass

    def _align_batch_pool(self, queries, processes):
        """Process-pool data parallelism over reads: each worker holds its
        own copy of the graph (shipped once at pool init) and aligns a
        strided chunk — the parent aligns chunk 0, so the pool needs n-1
        workers.  Byte-identical to the single-process batch: chunking
        does not change per-read results."""
        n = min(int(processes), len(queries))
        if n < 2:
            return self.align_batch(queries)
        pool = self._get_pool(n - 1)
        chunks = [list(range(i, len(queries), n)) for i in range(n)]
        jobs = [pool.apply_async(
            _pool_align, ([queries[i] for i in idx],))
            for idx in chunks[1:]]
        out: List = [None] * len(queries)
        for i, res in zip(chunks[0],
                          self.align_batch([queries[i] for i in chunks[0]])):
            out[i] = res
        for idx, job in zip(chunks[1:], jobs):
            for i, res in zip(idx, job.get()):
                out[i] = res
        return out

    def _fold_query(self, query: bytes) -> bytes:
        if self.graph.alphabet != "DNA_CASE":
            return bytes(query).upper()
        return bytes(query)

    def _preseed_batch(self, queries: List[bytes]):
        """Cross-read batched seeder precompute: ONE BOSS lockstep
        longest-prefix range walk over every (read, orientation) replaces the
        per-read walks (ref SuffixSeeder ctor work, aligner_seeder_methods
        .cpp:152-208 — same values, batched)."""
        cfg = self.config
        k = self.graph.k
        dbg = self.graph
        base = dbg.graph if hasattr(dbg, "get_base_node") else dbg
        want_ranges = (cfg.min_seed_length < k and hasattr(base, "boss")
                       and getattr(self.seeder_class, "is_suffix_seeder",
                                   False))
        both = cfg.forward_and_reverse_complement
        per_seq = []          # (read_idx, orientation, folded seq)
        for qi, q in enumerate(queries):
            fq = self._fold_query(q)
            per_seq.append((qi, False, fq))
            if both:
                per_seq.append((qi, True, revcomp(fq)))
        pres = [dict() for _ in queries]
        # batched node mapping: one native lookup over every (read,
        # orientation) replaces per-read map_to_nodes_sequentially calls
        if per_seq and hasattr(dbg, "map_to_nodes_sequentially_batch"):
            node_lists = dbg.map_to_nodes_sequentially_batch(
                [s for _, _, s in per_seq])
            for (qi, orient, _s), nl in zip(per_seq, node_lists):
                pres[qi].setdefault(orient, {})["nodes"] = nl
        if not want_ranges:
            return pres
        enc_parts = []
        meta = []             # (qi, orientation, base_off, n_pos, lens)
        off = 0
        ex = base.extractor
        for qi, orient, s in per_seq:
            if len(s) < cfg.min_seed_length:
                continue
            n_pos = len(s) - cfg.min_seed_length + 1
            pos = np.arange(n_pos, dtype=np.int64)
            lens = np.minimum(min(cfg.max_seed_length, k - 1), len(s) - pos)
            enc_parts.append(ex.encode(s))
            meta.append((qi, orient, off, n_pos, lens))
            off += len(s)
        if not meta:
            return pres
        codes = np.concatenate(enc_parts)
        starts = np.concatenate(
            [m[2] + np.arange(m[3], dtype=np.int64) for m in meta])
        lens_all = np.concatenate([m[4] for m in meta])
        firsts, lasts, matcheds = base.boss.index_range_batch(
            codes, starts, lens_all)
        p = 0
        for (qi, orient, _off, n_pos, lens) in meta:
            pres[qi].setdefault(orient, {})["ranges"] = (
                firsts[p: p + n_pos], lasts[p: p + n_pos],
                matcheds[p: p + n_pos])
            p += n_pos
        return pres

    def align_gen(self, query: bytes, pre=None):
        """Generator producing flat-engine extension requests; returns
        alignments.  ``pre`` optionally carries batched seeder precompute
        (orientation -> dict, see _preseed_batch)."""
        # case folds to the canonical form — except for the case-sensitive
        # alphabet, where case is part of the character
        query = self._fold_query(query)
        aggregator = AlignmentAggregator(self.config)

        def add_alignment(aln: Alignment):
            aggregator.add(aln)

        def get_min_path_score(aln: Alignment) -> int:
            # labeled seeds are pruned against their own label buckets
            # (ref dbg_aligner.cpp:277-281)
            labels = getattr(aln, "label_columns", None)
            cutoff = aggregator.get_score_cutoff(labels) if labels \
                else aggregator.get_global_cutoff()
            return max(self.config.min_path_score, cutoff)

        fwd_seeder = self._make_seeder(query, False,
                                       pre.get(False) if pre else None)
        fwd_extender = DefaultColumnExtender(self.graph, self.config, query)

        if not self.config.forward_and_reverse_complement:
            yield from self._align_core(fwd_seeder, fwd_extender,
                                        add_alignment, get_min_path_score,
                                        False)
        else:
            query_rc = revcomp(query)
            rc_seeder = self._make_seeder(query_rc, True,
                                          pre.get(True) if pre else None)
            rc_extender = DefaultColumnExtender(self.graph, self.config,
                                                query_rc)
            yield from self._align_both(query, query_rc, fwd_seeder,
                                        rc_seeder, fwd_extender, rc_extender,
                                        add_alignment, get_min_path_score)

        if self.config.post_chain_alignments:
            # chain collected partial alignments, then re-rank normally
            # (ref dbg_aligner.cpp:328-340)
            from dataclasses import replace
            from .chainer import chain_alignments
            query_rc = revcomp(query)
            chains = chain_alignments(aggregator.get_alignments(), query,
                                      query_rc, self.config,
                                      self.graph.k - 1)
            final = AlignmentAggregator(
                replace(self.config, post_chain_alignments=False))
            for c in chains:
                final.add(c)
            return final.get_alignments()

        return aggregator.get_alignments()

    # ------------------------------------------------------------ internals
    @staticmethod
    def _get_extensions_gen(extender, seed, min_path_score, force_fixed_seed):
        """Yield one extension job, which drive_batch runs in the flat
        engine's waves across reads; receive its extensions."""
        exts = yield ("extend", (extender, seed, min_path_score,
                                 force_fixed_seed))
        return exts

    def _align_core(self, seeder, extender, callback, get_min_path_score,
                    force_fixed_seed):
        """ref align_core (dbg_aligner.cpp:358-385)."""
        seeds = seeder.get_alignments()
        for i in range(len(seeds)):
            if seeds[i].empty():
                continue
            min_path_score = get_min_path_score(seeds[i])
            exts = yield from self._get_extensions_gen(
                extender, seeds[i], min_path_score, force_fixed_seed)
            for ext in exts:
                callback(ext)
            for j in range(i + 1, len(seeds)):
                if seeds[j].size() and not extender.check_seed(seeds[j]):
                    seeds[j] = Alignment()

    def _align_both(self, query, query_rc, fwd_seeder, rc_seeder,
                    fwd_extender, rc_extender, callback, get_min_path_score):
        """ref align_both_directions (dbg_aligner.cpp:640-755), no-chain path.

        Our RC re-extension aligns the reverse complement of each local
        alignment on the opposite strand (equivalent observable protocol to
        the reference's RCDBG backwards extension for basic graphs).
        """
        cfg = self.config

        def aln_both(q, q_rc, seeder, f_ext, b_ext):
            seeds = seeder.get_alignments()
            for i in range(len(seeds)):
                if seeds[i].empty():
                    continue
                extensions = yield from self._get_extensions_gen(
                    f_ext, seeds[i], cfg.min_cell_score, False)
                rc_alignments = []
                for path in extensions:
                    if path.score >= get_min_path_score(path):
                        callback(_copy_alignment(path))
                    if not path.get_clipping() or path.offset:
                        continue
                    rc = _copy_alignment(path)
                    rc.reverse_complement(self.graph, q_rc)
                    if rc.empty():
                        continue
                    rc_alignments.append(rc)
                for rc_seed in rc_alignments:
                    exts = yield from self._get_extensions_gen(
                        b_ext, rc_seed, get_min_path_score(rc_seed), True)
                    for path in exts:
                        callback(path)
                for j in range(i + 1, len(seeds)):
                    if seeds[j].size() and not f_ext.check_seed(seeds[j]):
                        seeds[j] = Alignment()

        fwd_matches = fwd_seeder.get_num_matches()
        bwd_matches = rc_seeder.get_num_matches()
        if fwd_matches >= bwd_matches:
            yield from aln_both(query, query_rc, fwd_seeder, fwd_extender,
                                rc_extender)
            if bwd_matches >= fwd_matches * cfg.rel_score_cutoff:
                yield from aln_both(query_rc, query, rc_seeder, rc_extender,
                                    fwd_extender)
        else:
            yield from aln_both(query_rc, query, rc_seeder, rc_extender,
                                fwd_extender)
            if fwd_matches >= bwd_matches * cfg.rel_score_cutoff:
                yield from aln_both(query, query_rc, fwd_seeder, fwd_extender,
                                    rc_extender)


_worker_aligner = None


def _pool_init(graph, config, seeder_class, device):
    """Worker-side pool initializer: build the per-process aligner once
    (runs in a clean forkserver child)."""
    global _worker_aligner
    _worker_aligner = DBGAligner(graph, config, seeder_class, device)


def _pool_align(queries):
    return _worker_aligner.align_batch(queries)


def _copy_alignment(a: Alignment) -> Alignment:
    return Alignment(query=a.query, nodes=list(a.nodes), sequence=a.sequence,
                     score=a.score, cigar=a.cigar.copy(),
                     orientation=a.orientation, offset=a.offset,
                     extra_score=a.extra_score,
                     label_columns=list(a.label_columns))


def format_alignments_tsv(header: str, query: bytes,
                          alignments: List[Alignment],
                          min_path_score: int = 0) -> str:
    """ref cli/align.cpp format_alignment (:254-290)."""
    out = f"{header}\t{query.decode()}"
    if not alignments:
        out += f"\t*\t*\t{min_path_score}\t*\t*\t*\n"
    else:
        for a in alignments:
            out += "\t" + a.format_tsv()
        out += "\n"
    return out
