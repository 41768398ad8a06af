"""The annotated batch query (``metagraph query --device``) on the port.

Own copy of the fused device route of metagraph_tpu/query/pipeline.py:
``query_records`` (:961-1096) batches the records, ``query_batch_fused``
(:607-668) packs one batch, runs the wire epoch (kernels 1-3,
query/device.py) and downloads the selection mask, and ``_hits_from_mask``
(:466) and ``_payloads_from_hits`` (:808) build the per-sequence payloads
on the host.  Per-window node ids are downloaded only for the counts and
signature modes.

Scope: basic, canonical and primary DNA graphs (a primary graph is queried
through ``CanonicalDBG``, as the JAX CLI does) with 2 <= k <= 31 and a
dense annotation, in the labels, matches, counts and signature modes.  Everything else raises
NotImplementedError and names the ROADMAP item that will port it.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from .._u32 import np_words, words_np
from ..annotation.annotated_dbg import _top_n_sorted, graph_to_anno_index
from ..annotation.ops import DeviceAnnotation
from ..convert import QueryIndex
from ..device import resolve_device
from ..succinct.ops import DeviceHashIndex
from .device import (TILE, _thresholds, untile_nodes, wire_epoch,
                     wire_words_layout)
from .results import QuerySequence, SeqSearchResult
from .tile_pack import tile_pack2

MODES = ("labels", "matches", "counts", "signature")


def _check_mode(mode: str):
    if mode not in MODES:
        raise NotImplementedError(
            f"query mode {mode!r} is not ported yet (ROADMAP A7); the port "
            f"serves {', '.join(MODES)}")


class QueryEngine:
    def __init__(self, index: QueryIndex, device=None):
        self.device = resolve_device(device)
        self.index = index
        self.k = index.k
        self.labels = index.labels
        self.hash_index = DeviceHashIndex.from_table(index.table, self.device)
        self.annotation = DeviceAnnotation.from_bitmap(
            index.bitmap, len(index.labels), self.device)
        # host seconds of the last batch: packing, device (upload, kernels,
        # mask download) and payload assembly
        self.last_batch_seconds = {}

    # ------------------------------------------------------------ batches
    def query_batch_fused(self, seqs: List[bytes], mode: str,
                          num_top_labels: int, discovery_fraction: float,
                          presence_fraction: float) -> list:
        """Per-sequence payloads for one batch of raw sequences."""
        _check_mode(mode)
        if not seqs:
            return []
        k, dev = self.k, self.device
        t0 = time.perf_counter()
        S, L = len(seqs), len(self.labels)
        tiles2, validb, tile_seq, nwins = tile_pack2(seqs, k, TILE)
        n = len(tiles2)
        words, vwords = wire_words_layout(tiles2, validb, k, TILE, n)
        dsel, selmin = _thresholds(nwins, discovery_fraction,
                                   presence_fraction)
        t1 = time.perf_counter()
        up = lambda a: torch.from_numpy(a).to(dev)
        mask, counts, present, nodes_t = wire_epoch(
            self.hash_index.table, self.annotation.bitmap,
            np_words(words).to(dev), np_words(vwords).to(dev), up(tile_seq),
            up(dsel), up(selmin), S, L, k, TILE, self.index.canon,
            self.index.offset)
        mask = words_np(mask)
        t2 = time.perf_counter()
        rows, cols, vals = self._hits_from_mask(mask, counts, L,
                                                need_vals=mode != "labels")
        nodes_cache = {}

        def nodes_of(i):
            # downloaded once, and only by the modes that need positions
            if "nl" not in nodes_cache:
                nodes_cache["nl"] = untile_nodes(nodes_t.cpu().numpy(),
                                                 nwins)
            return nodes_cache["nl"][i]

        out = self._payloads_from_hits(rows, cols, vals, nodes_of, nwins,
                                       mode, num_top_labels)
        self.last_batch_seconds = {"pack": t1 - t0, "device": t2 - t1,
                                   "collect": time.perf_counter() - t2}
        return out

    def _hits_from_mask(self, mask: np.ndarray, counts: torch.Tensor, L: int,
                        need_vals: bool):
        """Hit coordinates (sorted by row) from the (S, Lw) selection mask;
        the count values are gathered on the device at the hits only."""
        bits = np.unpackbits(np.ascontiguousarray(mask).view(np.uint8),
                             axis=1, bitorder="little")
        rows, cols = np.nonzero(bits[:, :L])
        vals = np.zeros(0, dtype=np.int64)
        if need_vals and len(rows):
            flat = rows.astype(np.int64) * L + cols
            idx = torch.from_numpy(flat).to(counts.device)
            vals = counts.reshape(-1)[idx].cpu().numpy().astype(np.int64)
        return rows, cols, vals

    def _label_rows(self, rows: np.ndarray, c: int) -> np.ndarray:
        """Which of ``rows`` carry label c, from the host bitmap."""
        return ((self.index.bitmap[rows, c >> 5] >> np.uint32(c & 31))
                & np.uint32(1)).astype(bool)

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
            selected = [(int(c), int(v))
                        for c, v in zip(csel, hit_vals[lo:hi])]
            _top_n_sorted(selected, num_top_labels)
            if mode == "matches":
                out.append([(dec[c], n) for c, n in selected])
                continue
            if not selected:
                out.append([])
                continue
            nodes = nodes_of(i)
            pos = np.flatnonzero(nodes > 0)
            rows = graph_to_anno_index(nodes[pos], self.index.offset)
            result = []
            for c, n in selected:
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

    # -------------------------------------------------------------- query
    def query_records(self, records: Sequence, mode: str,
                      num_top_labels: int = 2 ** 63,
                      discovery_fraction: float = 0.7,
                      presence_fraction: float = 0.0,
                      fwd_and_reverse: bool = False,
                      batch_size_bp: int = 100_000_000
                      ) -> Iterable[SeqSearchResult]:
        """Query FASTA records; yields per-sequence (per-strand) results.
        With fwd_and_reverse each record is queried on both strands as two
        result lines, forward first."""
        _check_mode(mode)

        def process(batch):
            payloads = self.query_batch_fused(
                [s for _, _, s in batch], mode, num_top_labels,
                discovery_fraction, presence_fraction)
            return [SeqSearchResult(QuerySequence(sid, name, seq.decode()),
                                    mode, payload)
                    for (sid, name, seq), payload in zip(batch, payloads)]

        seq_id = 0
        batch: List[Tuple[int, str, bytes]] = []
        batch_bp = 0
        for rec in records:
            seqs = [(rec.name, rec.seq)]
            if fwd_and_reverse:
                seqs.append((rec.name, _revcomp(rec.seq)))
            for name, seq in seqs:
                batch.append((seq_id, name, seq))
                seq_id += 1
                batch_bp += len(seq)
            if batch_bp >= max(batch_size_bp, 1):
                yield from process(batch)
                batch, batch_bp = [], 0
        if batch:
            yield from process(batch)


# seqtk-style complement: case-preserving, IUPAC degenerate codes included
_REVCOMP_TAB = bytes.maketrans(
    b"ACGTUacgtuRYKMBVDHrykmbvdh",
    b"TGCAAtgcaaYRMKVBHDyrmkvbhd")


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(_REVCOMP_TAB)[::-1]
