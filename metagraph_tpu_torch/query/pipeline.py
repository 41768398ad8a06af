"""The annotated batch query (``metagraph query --device``) on the port.

Own copy of the device routes of metagraph_tpu/query/pipeline.py:
``query_records`` (:961-1096) batches the records and each batch takes the
route that ``query_batch_fused`` (:607-668) and ``_wire_ok`` (:128-143)
choose:

* **wire** (DNA graphs, 2 <= k <= 31; basic, canonical and primary):
  ``tile_pack2`` on the host, then kernels 1-3 (``device.wire_epoch``);
* **codes** (basic DNA graphs, k >= 32): ``tile_pack2``, then kernels B,
  2 and 3 (``device.codes_epoch``, the counterpart of
  ``query_epoch_codes2``);
* **map** (graphs without a BOSS: hash, bitmap and sshash, :619-627;
  DNA5, DNA_CASE and Protein graphs, canonical or primary DNA
  graphs with k >= 32, and basic ones on a BRWT or row-diff device
  annotation): ``map_batch`` (:208-264) maps the windows, packed
  on the host (canonicalised on the host for a canonical graph, a
  reverse-complement pass for the misses of a primary one), through kernel
  A; ``execute_batch`` (:577-605) counts and selects on the host-tiled
  annotation rows with kernels 2 and 3 (``device.count_route``).

Each route counts on the index's device annotation: kernel 2 on a dense
bitmap, kernels S1 and S2 on a block-sparse one (``query/device.py::
count_labels``; the JAX package sends a block-sparse batch to
``execute_batch``, whose counts are the same), and on a BRWT or row-diff
one W1 or W2, then kernel 2 on the words they write (the JAX words route:
the wire epoch with a ``words_fn``, or ``make_tiled_count_epoch`` after
``execute_batch``, which also takes a basic DNA graph with k >= 32).  The
selection mask comes back to the host; ``_hits_from_mask`` (:466) and
``_payloads_from_hits`` (:808) build the per-sequence payloads of the six
modes there, from the bitmap and the column annotation's values, or
through a converted annotation's row queries (:835-906).  Per-window node
ids are downloaded only for the modes that need positions.  The JAX
package sends a sequence of 2^24 or more windows to the host counters,
because its fused fold is a float32 matmul; the port's fold is integer,
so such a sequence stays on its route.

With a ``.seqs`` mapping (a ``CoordToHeader``) every batch takes
``map_batch`` (kernel A), whatever the alphabet, k and canon, and then the
per-sequence aggregation of ``_cth_aggregate`` (``annotated_dbg.
cth_aggregate``, on the host), as the JAX package does (pipeline.py:587,
:619): no wire or codes epoch runs.

``query_records(..., n_threads=N)`` keeps up to N batches in flight on a
thread pool and yields their results in submission order (:1066-1093), so
the output is the sequential run's.  Each batch's host seconds travel with
it (``last_batch_seconds`` is set as its results are yielded), and the
kernels build before the first batch is submitted.

With an ``aligner_config`` (``query --align``, metagraph_tpu/query/
pipeline.py:925-1027) each batch is first aligned to the succinct graph
that the engine was given (``graph``; a primary one seen through
``CanonicalDBG``), by ``DBGAligner.align_batch`` (seeding on the host,
every wave one launch of kernel B11 ``align_wave``), or with
``batch_align`` to the batch graph of ``batch_graph.py`` (mapped through
kernel A, built through D1-D4 or D2); each read is replaced by its best
alignment's spelling and the respelled batch goes through ``map_batch``
and ``execute_batch`` (kernels A, 2 and 3), as the JAX package takes it.
The engine's one aligner is shared by the ``-p`` workers behind a lock,
since its column store lives on the card.

Scope: graphs of every type, alphabet and k with a column annotation
(either codec, or the reference format) or any annotation that
``transform_anno`` writes, at every budget; ``--align`` on succinct
graphs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Sequence

import numpy as np
import torch

from .. import _build
from .._u32 import np_words, words_np
from ..annotation.annotated_dbg import (HeaderIndex, _top_n_sorted,
                                        cth_aggregate, graph_to_anno_index,
                                        row_multiset)
from ..annotation.device_matrix import FlatBRWT, FlatRowDiff, device_words
from ..annotation.matrix import StaticAnnotation
from ..annotation.ops import DeviceAnnotation
from ..annotation.sparse_device import DeviceBlockSparseAnno, SparseOnDevice
from ..convert import QueryIndex
from ..device import resolve_device
from ..kmer.alphabets import ALPHABETS
from ..kmer.extractor import KmerExtractor, _rows_greater
from ..kmer.packing import boss_priority_order
from ..succinct.ops import (DeviceHashIndex, key_lookup, pack_codes32,
                            pack_kmers32)
from .device import (TILE, _thresholds, codes_epoch, count_route,
                     tile_layout, untile_nodes, wire_epoch,
                     wire_words_layout)
from .results import (KIND_FOR_MODE, Alignment, QuerySequence,
                      SeqSearchResult)
from .tile_pack import tile_pack2

MODES = tuple(KIND_FOR_MODE)
_PACK_CHUNK = 1 << 22       # windows packed into keys per numpy pass


def _check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown query mode {mode!r}")


def _seconds() -> dict:
    """A batch's host seconds: packing, device (uploads, kernels,
    downloads) and payload assembly."""
    return {"pack": 0.0, "device": 0.0, "collect": 0.0}


def route_of(index: QueryIndex) -> str:
    """'wire', 'codes' or 'map': the route of query_batch_fused's choice
    for the index's graph and device annotation (see the module
    docstring)."""
    if index.graph_type != "succinct":
        return "map"
    if index.alphabet == "DNA":
        if index.k <= 31:
            return "wire"
        if index.canon == 0 and not isinstance(index.device_anno,
                                               (FlatBRWT, FlatRowDiff)):
            return "codes"
    return "map"


class QueryEngine:
    def __init__(self, index: QueryIndex, device=None, coord_to_header=None,
                 graph=None):
        """``graph``: the succinct graph that ``query --align`` aligns to
        (a primary one through ``CanonicalDBG``), None without it."""
        self.device = resolve_device(device)
        self.index = index
        self.graph = graph
        self._aligner = None
        self._aligner_lock = threading.Lock()
        self.k = index.k
        self.labels = index.labels
        # with a .seqs mapping every batch is mapped, then aggregated per
        # sequence on the host
        self.headers = None
        if coord_to_header is not None:
            self.headers = HeaderIndex(coord_to_header)
            if hasattr(index.annotation, "row_index"):
                index.annotation.row_index()    # built once, before threads
        self.route = "map" if self.headers is not None else route_of(index)
        self.extractor = KmerExtractor(ALPHABETS[index.alphabet])
        self.hash_index = DeviceHashIndex.from_table(index.table, self.device)
        # the device annotation the epochs count on: the (R, Lw) bitmap
        # tensor, the block-sparse tensors, or a BRWT's or row-diff's
        dev_anno = index.device_anno
        if isinstance(dev_anno, DeviceBlockSparseAnno):
            self.annotation = SparseOnDevice.from_host(dev_anno, self.device)
        elif isinstance(dev_anno, (FlatBRWT, FlatRowDiff)):
            self.annotation = device_words(dev_anno, self.device)
        else:
            self.annotation = DeviceAnnotation.from_bitmap(
                dev_anno, len(index.labels), self.device).bitmap
        # payloads through the annotation's row queries (a converted
        # annotation) rather than the bitmap and column values
        self._by_rows = isinstance(index.annotation, StaticAnnotation)
        # host seconds (_seconds) of the last batch returned or yielded
        self.last_batch_seconds = {}
        # called with a progress line per batch when set (the CLI's -v)
        self.trace = None

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------ batches
    def query_batch(self, seqs: List[bytes], mode: str, num_top_labels: int,
                    discovery_fraction: float,
                    presence_fraction: float) -> list:
        """Per-sequence payloads for one batch of raw sequences, on the
        index's route."""
        out, self.last_batch_seconds = self._query_batch(
            seqs, mode, num_top_labels, discovery_fraction,
            presence_fraction)
        return out

    def _query_batch(self, seqs, mode, num_top_labels, discovery_fraction,
                     presence_fraction, st=None, fused=True):
        """-> (payloads, the batch's seconds); ``fused=False`` takes
        ``map_batch`` and ``execute_batch`` whatever the index's route."""
        st = _seconds() if st is None else st
        out = self._fused(seqs, mode, num_top_labels, discovery_fraction,
                          presence_fraction, st) if fused else None
        if out is not None:                            # None: the map route
            return out, st
        nodes_list = self._map(seqs, st)
        if self.headers is None:
            return self._execute(nodes_list, mode, num_top_labels,
                                 discovery_fraction, presence_fraction,
                                 st), st
        t0 = time.perf_counter()
        out = cth_aggregate(self.index.annotation, self.headers, nodes_list,
                            mode, num_top_labels, discovery_fraction,
                            presence_fraction, self.index.offset)
        st["collect"] += time.perf_counter() - t0
        return out, st

    def query_batch_fused(self, seqs: List[bytes], mode: str,
                          num_top_labels: int, discovery_fraction: float,
                          presence_fraction: float):
        """Per-sequence payloads for one batch on the wire or codes route;
        None when the index takes the map route."""
        st = _seconds()
        out = self._fused(seqs, mode, num_top_labels, discovery_fraction,
                          presence_fraction, st)
        self.last_batch_seconds = st
        return out

    def _fused(self, seqs, mode, num_top_labels, discovery_fraction,
               presence_fraction, st):
        _check_mode(mode)
        if self.route == "map":
            return None
        if not seqs:
            return []
        k = self.k
        t0 = time.perf_counter()
        S, L = len(seqs), len(self.labels)
        tiles2, validb, tile_seq, nwins = tile_pack2(seqs, k, TILE)
        dsel, selmin = _thresholds(nwins, discovery_fraction,
                                   presence_fraction)
        if self.route == "wire":
            words, vwords = wire_words_layout(tiles2, validb, k, TILE,
                                              len(tiles2))
        t1 = time.perf_counter()
        if self.route == "wire":
            mask, counts, _, nodes_t = wire_epoch(
                self.hash_index.table, self.annotation,
                np_words(words).to(self.device),
                np_words(vwords).to(self.device), self._up(tile_seq),
                self._up(dsel), self._up(selmin), S, L, k, TILE,
                self.index.canon, self.index.offset)
        else:
            mask, counts, _, nodes_t = codes_epoch(
                self.hash_index.table, self.annotation,
                self._up(tiles2), self._up(validb), self._up(tile_seq),
                self._up(dsel), self._up(selmin), S, L, k, TILE)
        mask = words_np(mask)
        t2 = time.perf_counter()
        rows, cols, vals = self._hits_from_mask(mask, counts, L, mode)
        nodes_cache = {}

        def nodes_of(i):
            # downloaded once, and only by the modes that need positions
            if "nl" not in nodes_cache:
                nodes_cache["nl"] = untile_nodes(nodes_t.cpu().numpy(),
                                                 nwins)
            return nodes_cache["nl"][i]

        out = self._payloads_from_hits(rows, cols, vals, nodes_of, nwins,
                                       mode, num_top_labels)
        st["pack"] += t1 - t0
        st["device"] += t2 - t1
        st["collect"] += time.perf_counter() - t2
        return out

    def map_batch(self, seqs: List[bytes],
                  seconds: dict = None) -> List[np.ndarray]:
        """Each sequence's windows -> (nwin,) int64 node ids (0 = miss),
        in one lookup of the batch's valid windows through kernel A; the
        host seconds go to ``seconds`` where given, else to
        ``last_batch_seconds``."""
        if seconds is None:
            seconds = self.last_batch_seconds = _seconds()
        return self._map(seqs, seconds)

    def _map(self, seqs, seconds):
        t0 = time.perf_counter()
        k, ex = self.k, self.extractor
        canon, offset = self.index.canon, self.index.offset
        codes_list = [ex.encode(s) for s in seqs]
        sep = np.array([ex.invalid], dtype=np.uint8)
        cat = np.concatenate([np.concatenate([c, sep]) for c in codes_list]) \
            if codes_list else sep[:0]
        if len(cat) < k:
            return [np.zeros(0, dtype=np.int64) for _ in seqs]
        wins = np.lib.stride_tricks.sliding_window_view(cat, k)
        bad = np.concatenate([[0], np.cumsum(cat >= ex.invalid)])
        valid = (bad[k:] - bad[:-k]) == 0
        nodes_flat = np.zeros(len(wins), dtype=np.int64)
        if canon:
            comp = ex.extended_complement_table()
            rc_wins = np.lib.stride_tricks.sliding_window_view(
                comp[cat[::-1]], k)[::-1]
        if valid.any():
            sub = wins[valid]
            if canon == 1:
                # a canonical graph holds the strand first in BOSS order
                order = boss_priority_order(k)
                rc = rc_wins[valid]
                take_rc = _rows_greater(
                    pack_codes32(sub, order, self.index.bits),
                    pack_codes32(rc, order, self.index.bits))
                sub = np.where(take_rc[:, None], rc, sub)
            seconds["pack"] += time.perf_counter() - t0
            nodes_flat[valid] = self._map_windows(sub, seconds)
            if canon == 2:
                # CanonicalDBG: a forward miss is looked up on the reverse
                # complement, and its hit is reported as id + offset
                miss = valid & (nodes_flat == 0)
                if miss.any():
                    rc_nodes = self._map_windows(rc_wins[miss], seconds)
                    nodes_flat[miss] = np.where(rc_nodes > 0,
                                                rc_nodes + offset, 0)
        t1 = time.perf_counter()
        out, at = [], 0
        for c in codes_list:
            nwin = max(len(c) - k + 1, 0)
            out.append(nodes_flat[at: at + nwin])
            at += len(c) + 1
        seconds["pack"] += time.perf_counter() - t1
        return out

    def _map_windows(self, sub: np.ndarray, seconds: dict) -> np.ndarray:
        """(n, k) window codes -> (n,) int64 ids: keys packed on the host
        in chunks, then one kernel A launch."""
        t0 = time.perf_counter()
        bits = self.index.bits
        keys = np.concatenate([pack_kmers32(sub[lo: lo + _PACK_CHUNK], bits)
                               for lo in range(0, len(sub), _PACK_CHUNK)])
        t1 = time.perf_counter()
        ids = key_lookup(np_words(keys).to(self.device),
                         self.hash_index.table).cpu().numpy()
        seconds["pack"] += t1 - t0
        seconds["device"] += time.perf_counter() - t1
        return ids.astype(np.int64)

    def execute_batch(self, nodes_list, mode: str,
                      num_top_labels: int = 2 ** 63,
                      discovery_fraction: float = 0.7,
                      presence_fraction: float = 0.0) -> list:
        """Mapped node arrays -> per-sequence payloads: the annotation rows
        + 1 tiled on the host (count_epoch_tiled's input), kernels 2 and 3
        on the device, payloads from the hit rows."""
        self.last_batch_seconds = _seconds()
        return self._execute(nodes_list, mode, num_top_labels,
                             discovery_fraction, presence_fraction,
                             self.last_batch_seconds)

    def _execute(self, nodes_list, mode, num_top_labels, discovery_fraction,
                 presence_fraction, st):
        _check_mode(mode)
        t0 = time.perf_counter()
        S, L = len(nodes_list), len(self.labels)
        if not S:
            return []
        nk_list = [len(n) for n in nodes_list]
        flat = np.concatenate(nodes_list)
        seq_ids = np.repeat(np.arange(S, dtype=np.int32), nk_list)
        rows1 = np.where(flat > 0, graph_to_anno_index(
            np.maximum(flat, 1), self.index.offset) + 1, 0).astype(np.int32)
        tiles, tile_seq = tile_layout(rows1, seq_ids, S, fill=0)
        dsel, selmin = _thresholds(nk_list, discovery_fraction,
                                   presence_fraction)
        t1 = time.perf_counter()
        mask, counts, _ = count_route(
            self.annotation, self._up(tiles), self._up(tile_seq),
            self._up(dsel), self._up(selmin), S, L)
        mask = words_np(mask)
        t2 = time.perf_counter()
        rows, cols, vals = self._hits_from_mask(mask, counts, L, mode)
        out = self._payloads_from_hits(rows, cols, vals,
                                       lambda i: nodes_list[i], nk_list,
                                       mode, num_top_labels)
        st["pack"] += t1 - t0
        st["device"] += t2 - t1
        st["collect"] += time.perf_counter() - t2
        return out

    def _hits_from_mask(self, mask: np.ndarray, counts: torch.Tensor, L: int,
                        mode: str):
        """Hit coordinates (sorted by row) from the (S, Lw) selection mask;
        the count values are gathered on the device at the hits only, for
        the modes that print them."""
        bits = np.unpackbits(np.ascontiguousarray(mask).view(np.uint8),
                             axis=1, bitorder="little")
        rows, cols = np.nonzero(bits[:, :L])
        vals = np.zeros(0, dtype=np.int64)
        if mode not in ("labels", "counts-sum") and len(rows):
            flat = rows.astype(np.int64) * L + cols
            idx = torch.from_numpy(flat).to(counts.device)
            vals = counts.reshape(-1)[idx].cpu().numpy().astype(np.int64)
        return rows, cols, vals

    def _label_rows(self, rows: np.ndarray, c: int) -> np.ndarray:
        """Which of ``rows`` carry label c, from the host bitmap."""
        return ((self.index.device_anno[rows, c >> 5] >> np.uint32(c & 31))
                & np.uint32(1)).astype(bool)

    def _row_multiset_of(self, nodes: np.ndarray):
        return row_multiset(graph_to_anno_index(nodes[nodes > 0],
                                                self.index.offset))

    def _count_sums(self, nodes: np.ndarray, csel) -> list:
        """counts-sum: [(label, sum over the sequence's rows of the row's
        value times its multiplicity)] for the selected labels, as
        IntMatrix::sum_row_values sums them (the presence-filtered value
        sums of metagraph_tpu's payloads, :834-841), in int64."""
        anno = self.index.annotation
        pairs = self._row_multiset_of(nodes)
        rows = np.array([r for r, _ in pairs], dtype=np.int64)
        mult = np.array([m for _, m in pairs], dtype=np.int64)
        if self._by_rows:
            sums = np.zeros(len(self.labels), dtype=np.int64)
            for m, row_vals in zip(mult, anno.get_row_values(rows)):
                for c, v in row_vals:
                    sums[c] += v * m
            return [(int(c), int(sums[c])) for c in csel]
        out = []
        for c in csel:
            has = self._label_rows(rows, int(c))
            total = 0
            if anno is not None and has.any():
                total = int((anno.values_of(rows[has], int(c))
                             * mult[has]).sum())
            out.append((int(c), total))
        return out

    def _payloads_from_hits(self, hit_rows, hit_cols, hit_vals, nodes_of,
                            nk_list, mode, num_top_labels):
        """Per-sequence payloads from the selected hits, byte-identical to
        metagraph_tpu's (empty rows failed their thresholds)."""
        dec = self.labels
        anno = self.index.annotation
        starts = np.searchsorted(hit_rows, np.arange(len(nk_list) + 1))
        out = []
        for i, nk in enumerate(nk_list):
            lo, hi = int(starts[i]), int(starts[i + 1])
            if lo == hi:
                out.append([])
                continue
            csel = hit_cols[lo:hi]
            if mode == "labels":
                out.append([dec[c] for c in csel])
                continue
            if mode == "counts-sum":
                selected = self._count_sums(nodes_of(i), csel)
            else:
                selected = [(int(c), int(v))
                            for c, v in zip(csel, hit_vals[lo:hi])]
            _top_n_sorted(selected, num_top_labels)
            if mode in ("matches", "counts-sum"):
                out.append([(dec[c], n) for c, n in selected])
                continue
            if not selected:
                out.append([])
                continue
            nodes = nodes_of(i)
            pos = np.flatnonzero(nodes > 0)
            rows = graph_to_anno_index(nodes[pos], self.index.offset)
            if self._by_rows:
                out.append(self._payload_by_rows(mode, selected, rows, pos,
                                                 nk))
                continue
            result = []
            for c, n in selected:
                if mode == "coords":
                    co = [[] for _ in range(nk)]
                    if anno is not None:
                        lo_c, hi_c = anno.coord_spans(rows, c)
                        crd = anno.coords_of(c) if (hi_c > lo_c).any() \
                            else None
                        for j in np.flatnonzero(hi_c > lo_c):
                            co[pos[j]] = crd[lo_c[j]:hi_c[j]].tolist()
                    result.append((dec[c], n, co))
                    continue
                has = self._label_rows(rows, c)
                if mode == "signature":
                    bits = np.zeros(nk, dtype=bool)
                    bits[pos[has]] = True
                    result.append((dec[c], n, bits))
                else:
                    ab = np.zeros(nk, dtype=np.int64)
                    if anno is not None:
                        ab[pos[has]] = anno.values_of(rows[has], c)
                    result.append((dec[c], n, ab))
            out.append(result)
        return out

    def _payload_by_rows(self, mode, selected, rows, pos, nk):
        """signature, counts or coords payload of one sequence through the
        converted annotation's row queries (metagraph_tpu's
        _payloads_from_hits, :872-906); a mode whose values or coordinates
        the representation lacks raises its ValueError."""
        anno, dec = self.index.annotation, self.labels
        if mode == "signature":
            mask = anno.get_rows_mask(rows)
            out = []
            for c, n in selected:
                bits = np.zeros(nk, dtype=bool)
                bits[pos[mask[:, c]]] = True
                out.append((dec[c], n, bits))
            return out
        if mode == "counts":
            per_row = anno.get_row_values(rows)
            by_c = {c: np.zeros(nk, dtype=np.int64) for c, _ in selected}
        else:
            per_row = anno.get_row_tuples(rows)
            by_c = {c: [[] for _ in range(nk)] for c, _ in selected}
        for j, row in enumerate(per_row):
            for c, v in row:
                slot = by_c.get(c)
                if slot is not None:
                    slot[pos[j]] = v
        return [(dec[c], n, by_c[c]) for c, n in selected]

    # ---------------------------------------------------------- alignment
    def _get_aligner(self, aligner_config):
        """The engine's aligner for ``aligner_config`` (built again only
        for another config object), on the engine's device."""
        if self.graph is None:
            raise ValueError("query --align needs the engine's graph")
        if self._aligner is None \
                or self._aligner._orig_config is not aligner_config:
            from ..align.aligner import DBGAligner
            aligner = DBGAligner(self.graph, aligner_config,
                                 device=self.device)
            aligner._orig_config = aligner_config
            self._aligner = aligner
        return self._aligner

    def _spell_best(self, seq: bytes, alns, cfg):
        """The query replaced by its best alignment's graph spelling (ref
        query.cpp:1181-1209 align_sequence): -> (new sequence,
        ``Alignment``)."""
        max_score = cfg.match_score(seq) + cfg.left_end_bonus \
            + cfg.right_end_bonus
        if not alns:
            return seq, Alignment(0, max_score, f"{len(seq)}S", False,
                                  seq.decode())
        m = alns[0]
        new_seq = m.sequence
        if m.offset:
            new_seq = self.graph.get_node_sequence(m.nodes[0])[: m.offset] \
                + m.sequence
        return new_seq, Alignment(m.score, max_score, m.cigar.to_string(),
                                  m.orientation, new_seq.decode())

    def align_sequence(self, seq: bytes, aligner_config):
        """One sequence aligned and respelled: -> (new sequence,
        ``Alignment``)."""
        with self._aligner_lock:
            aligner = self._get_aligner(aligner_config)
            return self._spell_best(seq, aligner.align(seq), aligner.config)

    def _align_batch(self, batch, aligner_config, batch_align, hull, st):
        """Each (id, name, seq) of the batch respelled by its best
        alignment: -> (the respelled batch, its ``Alignment`` list).  The
        batch's seconds get "batch_graph" (the batch graph's mapping and
        build) and "align" (seeding, waves and the engine's host work)."""
        from ..align import aligner as _aligner
        from ..align.aligner import DBGAligner
        with self._aligner_lock:
            aligner = self._get_aligner(aligner_config)
            t0 = time.perf_counter()
            if batch_align:
                from .batch_graph import construct_batch_graph
                small, bstats = construct_batch_graph(
                    self, [seq for _, _, seq in batch], seconds=st, **hull)
                if small is not None:
                    if self.trace is not None:
                        self.trace(
                            f"Batch graph: {bstats.num_query_kmers} query "
                            f"k-mers ({bstats.num_matched_kmers} matched), "
                            f"{bstats.num_hull_contigs} hull contigs "
                            f"({bstats.num_hull_chars} chars)")
                    aligner = DBGAligner(small, aligner.config,
                                         device=self.device)
            t1 = time.perf_counter()
            seed0 = _aligner.SEED_SECONDS[0]
            alns_list = aligner.align_batch([seq for _, _, seq in batch])
            st["seeding"] = _aligner.SEED_SECONDS[0] - seed0
            st["batch_graph"] = t1 - t0
            st["align"] = time.perf_counter() - t1
            new_batch, alignments = [], []
            for (sid, name, seq), alns in zip(batch, alns_list):
                new_seq, aln = self._spell_best(seq, alns, aligner.config)
                new_batch.append((sid, name, new_seq))
                alignments.append(aln)
        return new_batch, alignments

    # -------------------------------------------------------------- query
    def query_records(self, records: Sequence, mode: str,
                      num_top_labels: int = 2 ** 63,
                      discovery_fraction: float = 0.7,
                      presence_fraction: float = 0.0,
                      fwd_and_reverse: bool = False,
                      batch_size_bp: int = 100_000_000,
                      n_threads: int = 1, aligner_config=None,
                      batch_align: bool = False, max_hull_forks: int = 4,
                      max_hull_depth=None,
                      max_nodes_per_seq_char: float = 5.0
                      ) -> Iterable[SeqSearchResult]:
        """Query FASTA records; yields per-sequence (per-strand) results.
        With fwd_and_reverse each record is queried on both strands as two
        result lines, forward first.  With n_threads > 1 (-p) up to that
        many batches run at once on a thread pool, their results yielded
        in submission order.  With an ``aligner_config`` each batch is
        aligned first and its reads replaced by their best alignments'
        spellings (with ``batch_align``, against the batch graph that
        ``max_hull_forks``, ``max_hull_depth`` and
        ``max_nodes_per_seq_char`` bound)."""
        _check_mode(mode)
        kind = KIND_FOR_MODE[mode]
        hull = dict(max_hull_forks=max_hull_forks,
                    max_hull_depth=max_hull_depth,
                    max_nodes_per_seq_char=max_nodes_per_seq_char)

        def process(batch, batch_bp):
            t0 = time.perf_counter()
            st = _seconds()
            alignments = [None] * len(batch)
            if aligner_config is not None:
                batch, alignments = self._align_batch(
                    batch, aligner_config, batch_align, hull, st)
            payloads, st = self._query_batch(
                [s for _, _, s in batch], mode, num_top_labels,
                discovery_fraction, presence_fraction, st,
                fused=aligner_config is None)
            if self.trace is not None:
                dt = max(time.perf_counter() - t0, 1e-9)
                self.trace(f"Batch of {batch_bp} bp queried in {dt:.5f} "
                           f"sec, {batch_bp / dt:.1f} bp/s")
            return [SeqSearchResult(QuerySequence(sid, name, seq.decode()),
                                    kind, payload, alignment=aln)
                    for (sid, name, seq), payload, aln
                    in zip(batch, payloads, alignments)], st

        def batches():
            seq_id, batch, batch_bp = 0, [], 0
            for rec in records:
                seqs = [(rec.name, rec.seq)]
                if fwd_and_reverse:
                    seqs.append((rec.name, _revcomp(rec.seq)))
                for name, seq in seqs:
                    batch.append((seq_id, name, seq))
                    seq_id += 1
                    batch_bp += len(seq)
                if batch_bp >= max(batch_size_bp, 1):
                    yield batch, batch_bp
                    batch, batch_bp = [], 0
            if batch:
                yield batch, batch_bp

        def results(done):
            res, self.last_batch_seconds = done
            return res

        if n_threads <= 1:
            for b, bp in batches():
                yield from results(process(b, bp))
            return
        if self.device.type == "cuda":
            _build.build_all()      # the kernels build before any batch
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            pending = deque()
            for b, bp in batches():
                pending.append(pool.submit(process, b, bp))
                while len(pending) > n_threads:
                    yield from results(pending.popleft().result())
            while pending:
                yield from results(pending.popleft().result())


# seqtk-style complement: case-preserving, IUPAC degenerate codes included
_REVCOMP_TAB = bytes.maketrans(
    b"ACGTUacgtuRYKMBVDHrykmbvdh",
    b"TGCAAtgcaaYRMKVBHDyrmkvbhd")


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(_REVCOMP_TAB)[::-1]
