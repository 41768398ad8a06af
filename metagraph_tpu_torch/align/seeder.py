"""Seeders; own copy of metagraph_tpu/align/seeder.py (ref
src/graph/alignment/aligner_seeder_methods.{hpp,cpp}).

ExactSeeder: one seed per matching k-mer window.
MEMSeeder/UniMEMSeeder: maximal exact matches split at graph junctions.
SuffixSeeder (``make_suffix_seeder``): seeds shorter than k through BOSS
suffix ranges.
The low-complexity (sdust) filter is applied per seed window, through the
JAX package's numpy path (its native ``dust_low_complexity`` agrees with
it).  On a canonical wrapper graph (``CanonicalDBG``, which ``query
--align`` and the server's ``/align`` align on for a primary graph) the
suffix seeder walks the base graph's BOSS and also matches the reverse
complement of the query.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

from .alignment import Alignment, seed_to_alignment
from .config import AlignerConfig


def num_exact_matching(query_nodes: np.ndarray, k: int) -> int:
    """#query chars covered by any matching k-mer (ref :49-65)."""
    num_matching = 0
    last_match_count = 0
    n = len(query_nodes)
    i = 0
    while i < n:
        if query_nodes[i]:
            j = i + 1
            while j < n and query_nodes[j]:
                j += 1
            num_matching += k + (j - i) - 1 - last_match_count
            last_match_count = k
            i = j
        else:
            if last_match_count:
                last_match_count -= 1
            i += 1
    return num_matching


_NT4 = {65: 0, 67: 1, 71: 2, 84: 3, 97: 0, 99: 1, 103: 2, 116: 3}


@functools.lru_cache(maxsize=1 << 16)
def is_low_complexity(window: bytes, T: int = 20, W: int = 64) -> bool:
    """Symmetric DUST low-complexity check (Morgulis et al. 2006; the
    reference calls sdust with T=20, W=64, ref aligner_seeder_methods.cpp:22).

    A window is low-complexity iff some interval of at most W-2 triplets has
    DUST score sum_t c_t(c_t-1)/2 > T/10 * (l-1).  Non-ACGT characters reset
    the triplet stream (as in sdust).
    """
    if len(window) < 3:
        return False
    # triplet codes per maximal ACGT run
    runs: List[List[int]] = [[]]
    t = 0
    valid = 0
    for ch in window:
        b = _NT4.get(ch)
        if b is None:
            if runs[-1]:
                runs.append([])
            valid = 0
            continue
        t = ((t << 2) | b) & 63
        valid += 1
        if valid >= 3:
            runs[-1].append(t)
    max_span = W - 2
    for trips in runs:
        n = len(trips)
        for i in range(n):
            counts = [0] * 64
            pairs = 0
            for j in range(i, min(i + max_span, n)):
                c = counts[trips[j]]
                pairs += c
                counts[trips[j]] = c + 1
                l = j - i + 1
                if l > 1 and pairs * 10 > T * (l - 1):
                    return True
    return False


class Seeder:
    """Base: holds query, nodes, and match statistics."""

    def __init__(self, graph, query: bytes, orientation: bool,
                 nodes: np.ndarray, config: AlignerConfig):
        self.graph = graph
        self.query = query
        self.orientation = orientation
        self.nodes = nodes
        self.config = config
        self.num_matching = num_exact_matching(nodes, graph.k)

    def get_num_matches(self) -> int:
        return self.num_matching

    def get_seeds(self) -> List[tuple]:
        raise NotImplementedError

    def get_alignments(self) -> List[Alignment]:
        out = []
        for (start, length, nodes, offset) in self.get_seeds():
            out.append(seed_to_alignment(self.query, start, length, nodes,
                                         self.orientation, offset, self.config))
        return out


class ExactSeeder(Seeder):
    def get_seeds(self) -> List[tuple]:
        k = self.graph.k
        cfg = self.config
        if self.num_matching < cfg.min_exact_match * len(self.query):
            return []
        if cfg.max_seed_length < k:
            return []
        seeds = []
        for i in range(len(self.nodes)):
            if self.nodes[i]:
                window = self.query[i: i + k]
                if not cfg.seed_complexity_filter or not is_low_complexity(window):
                    seeds.append((i, k, [int(self.nodes[i])], 0))
        return seeds


class MEMSeeder(ExactSeeder):
    def is_terminus(self, node: int) -> bool:
        raise NotImplementedError

    def get_seeds(self) -> List[tuple]:
        k = self.graph.k
        cfg = self.config
        if k >= cfg.max_seed_length:
            return ExactSeeder.get_seeds(self)
        if self.num_matching < cfg.min_exact_match * len(self.query):
            return []

        n = len(self.nodes)
        flags = np.zeros(n, dtype=np.uint8)
        nodes_arr = np.asarray(self.nodes, dtype=np.int64)
        present = nodes_arr != 0
        nz = np.flatnonzero(present)
        term = np.zeros(n, dtype=bool)
        if len(nz):
            if (type(self).is_terminus is UniMEMSeeder.is_terminus
                    and hasattr(self.graph, "has_single_incoming_batch")):
                # one vectorized rank/select pass over all seed nodes
                nn = nodes_arr[nz]
                term[nz] = self.graph.has_multiple_outgoing_batch(nn) \
                    | ~self.graph.has_single_incoming_batch(nn)
            else:
                for i in nz:
                    term[i] = self.is_terminus(int(nodes_arr[i]))
        next_missing = np.ones(n, dtype=bool)
        next_missing[:-1] = nodes_arr[1:] == 0
        flags[present] = 2
        flags[present & (next_missing | term)] |= 1

        seeds = []
        i = 0
        while i < n:
            if not (flags[i] & 2):
                i += 1
                continue
            j = i
            while j < n and (flags[j] & 2) and not (flags[j] & 1):
                j += 1
            if j < n and (flags[j] & 2):
                j += 1
            mem_length = (j - i) + k - 1
            if mem_length >= cfg.min_seed_length:
                seeds.append((i, mem_length,
                              [int(x) for x in self.nodes[i:j]], 0))
            i = j
        return seeds


class UniMEMSeeder(MEMSeeder):
    def is_terminus(self, node: int) -> bool:
        return (self.graph.has_multiple_outgoing(node)
                or not self.graph.has_single_incoming(node))


def make_suffix_seeder(base_cls):
    """SuffixSeeder<Base> (ref aligner_seeder_methods.cpp:152-358): adds
    sub-k seeds via BOSS suffix-range matching when min_seed_length < k."""

    class SuffixSeeder(base_cls):
        # marker for the batched preseed (aligner._preseed_batch) — name
        # checks break when the class is renamed for pickling
        is_suffix_seeder = True

        def __init__(self, *args, precomputed_ranges=None, **kwargs):
            super().__init__(*args, **kwargs)
            self._seeds = None
            self._pre_ranges = precomputed_ranges
            self._generate()

        def _base_graph(self):
            g = self.graph
            return g.graph if hasattr(g, "get_base_node") else g

        def _generate(self):
            cfg = self.config
            k = self.graph.k
            if len(self.query) < cfg.min_seed_length:
                self._seeds = []
                return
            if cfg.min_seed_length >= k:
                self._seeds = base_cls.get_seeds(self)
                return
            dbg_succ = self._base_graph()
            if not hasattr(dbg_succ, "boss"):
                self._seeds = base_cls.get_seeds(self)
                return

            n_pos = len(self.query) - cfg.min_seed_length + 1
            suffix_seeds = [[] for _ in range(n_pos)]
            min_len = [cfg.min_seed_length] * n_pos

            for seed in base_cls.get_seeds(self):
                i, length, nodes, offset = seed
                n_nodes = len(nodes)
                for j in range(n_nodes):
                    if i + j < n_pos:
                        min_len[i + j] = k
                if i + n_nodes < n_pos:
                    min_len[i + n_nodes] = k
                suffix_seeds[i].append(seed)

            def append_suffix_seed(i, alt_node, seed_length):
                if seed_length > min_len[i]:
                    suffix_seeds[i].clear()
                min_len[i] = seed_length
                suffix_seeds[i].append(
                    (i, seed_length, [alt_node], k - seed_length))
                j = i + 1
                sl = seed_length
                while j < n_pos and sl > min_len[j]:
                    min_len[j] = sl
                    sl -= 1
                    suffix_seeds[j].clear()
                    j += 1

            last_full = len(self.query) - k + 1 if len(self.query) >= k \
                else n_pos
            # lockstep longest-prefix range walk over all positions
            # (ref boss.hpp:720-764, batched; acceptance checks stay per-pos)
            boss = dbg_succ.boss
            pos_arr = np.arange(n_pos, dtype=np.int64)
            lens = np.minimum(min(cfg.max_seed_length, k - 1),
                              len(self.query) - pos_arr)
            if self._pre_ranges is not None:
                firsts, lasts, matcheds = self._pre_ranges
            else:
                enc_q = dbg_succ.extractor.encode(self.query)
                firsts, lasts, matcheds = boss.index_range_batch(
                    enc_q, pos_arr, lens)
            # batched range enumeration over a static superset of the
            # positions the loop below can reach (min_len only grows, so
            # min_len-now is a lower bound for min_len-at-loop-time)
            ml0 = np.array(min_len, dtype=np.int64)
            elig = ((lens >= ml0) & (np.asarray(matcheds) >= ml0)
                    & (np.asarray(firsts) != 0))
            epos = np.flatnonzero(elig)
            enodes = dbg_succ.nodes_in_suffix_ranges_batch(
                np.asarray(firsts)[epos], np.asarray(lasts)[epos],
                cfg.max_num_seeds_per_locus)
            pre_nodes = dict(zip(epos.tolist(), enodes))
            for i in range(n_pos):
                seed_length = int(matcheds[i])
                if lens[i] < min_len[i] or seed_length < min_len[i] \
                        or not firsts[i]:
                    # ineligible either way; skipping the complexity filter
                    # here only saves work (both checks `continue`)
                    continue
                if cfg.seed_complexity_filter and is_low_complexity(
                        self.query[i: i + min_len[i]]):
                    continue
                nodes = pre_nodes[i]
                if (i >= last_full and len(nodes) == 1 and last_full >= 1
                        and min_len[last_full - 1] == k
                        and len(suffix_seeds[last_full - 1]) == 1
                        and nodes[0] == suffix_seeds[last_full - 1][0][2][0]):
                    continue
                for alt in nodes:
                    append_suffix_seed(i, alt, seed_length)

            if hasattr(self.graph, "get_base_node"):
                self._rc_suffix_seeds(dbg_succ, n_pos, min_len,
                                      append_suffix_seed)

            # aggregate (ref :316-358)
            seeds = []
            self.num_matching = 0
            last_end = 0
            for i in range(n_pos):
                pos_seeds = suffix_seeds[i]
                if not pos_seeds:
                    continue
                if pos_seeds[0][3] == 0:
                    seeds.append(pos_seeds[0])
                elif len(pos_seeds) <= cfg.max_num_seeds_per_locus:
                    seeds.extend(pos_seeds)
                else:
                    continue
                begin = seeds[-1][0]
                end = begin + seeds[-1][1]
                if begin < last_end:
                    self.num_matching += max(end - last_end, 0)
                else:
                    self.num_matching += end - begin
                last_end = end
            self._seeds = seeds

        def _rc_suffix_seeds(self, dbg_succ, n_pos, min_len,
                             append_suffix_seed):
            """A canonical wrapper graph: sub-k matches of the query's
            reverse complement, each seeded at the reverse complement of
            every node whose k-mer prefix it is."""
            from .alignment import revcomp
            cfg = self.config
            k = self.graph.k
            query_rc = revcomp(self.query)
            boss = dbg_succ.boss
            for i in range(0, len(query_rc) - cfg.min_seed_length + 1):
                max_len = min(cfg.max_seed_length, k - 1,
                              len(self.query) - i)
                j_min = len(query_rc) - i - max_len
                j_max = len(query_rc) - i - cfg.min_seed_length
                while j_min <= j_max and j_min < n_pos \
                        and min_len[j_min] > max_len:
                    j_min += 1
                    max_len -= 1
                if j_min > j_max:
                    continue
                enc = dbg_succ.extractor.encode(query_rc[i: i + max_len])
                if (enc >= boss.alph_size).any():
                    continue
                first, last, seed_length = boss.index_range_host(enc)
                j = len(query_rc) - i - seed_length
                if (seed_length < cfg.min_seed_length or j >= n_pos
                        or seed_length < min_len[j]
                        or (cfg.seed_complexity_filter and is_low_complexity(
                            self.query[j: j + seed_length]))):
                    continue
                begin = int(boss.pred_last(np.array([first - 1]))[0]) + 1
                matches = _suffix_to_prefix(dbg_succ, begin, last,
                                            seed_length,
                                            cap=cfg.max_num_seeds_per_locus)
                if matches is None:
                    # an overloaded locus is dropped without propagating
                    # min_len, as the forward overflow is
                    continue
                for match in matches:
                    append_suffix_seed(
                        j, int(self.graph.reverse_complement_node(match)),
                        seed_length)

        def get_seeds(self):
            return self._seeds

    SuffixSeeder.__name__ = f"SuffixSeeder[{base_cls.__name__}]"
    return SuffixSeeder


def _suffix_to_prefix(dbg_succ, first, last, seed_length, cap=2 ** 63):
    """Nodes whose k-mer PREFIX equals the matched string (ref
    aligner_seeder_methods.cpp:196-253 suffix_to_prefix); None when there
    are more than ``cap`` (the seed budget of a locus)."""
    boss = dbg_succ.boss
    out = []
    stack = [(first, last, seed_length)]
    while stack:
        if len(out) > cap:
            return None
        f, l, slen = stack.pop()
        if slen == boss.k:
            for e in range(f, l + 1):
                if dbg_succ._valid_node(e):
                    out.append(e)
            continue
        for s in range(1, boss.alph_size):
            fa, la, ok = boss.tighten_range(
                np.array([f]), np.array([l]), np.array([s]),
                np.array([True]))
            if ok[0]:
                stack.append((int(fa[0]), int(la[0]), slen + 1))
    return out
