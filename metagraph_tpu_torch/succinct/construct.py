"""The BOSS table from a sorted set of k-mers: the host construction.

Own copy of metagraph_tpu/succinct/construct.py: ``BossArrays``
(:30-46), ``_node_key``/``_target_key`` (:49-60),
``generate_dummy_kmers`` (:63-131), ``emit_boss`` (:134-195) and
``build_boss_arrays`` (:252-278), and ``empty_boss_arrays``, the table of
no k-mers.  The JAX package runs them in numpy; here each runs where its
input lies, as tensors: numpy inputs go to ``device`` (the card unless
"cpu") and the results come back as numpy.  Each row sort is
``packing.lexsort_rows`` (kernel D2: the target keys of
``generate_dummy_kmers`` and the stream of ``build_boss_arrays``); the
set algebra is a sort of both sets (``packing.rows_in_sorted``) and the
emission tensor ops, with the arrays of the JAX functions.

The edge string has K = k + 1 characters: s[0..K-2] is the source node,
s[K-1] the edge label.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kmer import packing
from ..utils.timer import PhaseTimer


@dataclass
class BossArrays:
    """Row 0 is the sentinel zero row (ref boss_chunk.cpp:60-62)."""

    k: int                      # BOSS node length (dbg k - 1)
    alph_size: int              # sentinel-included alphabet size (5 for DNA)
    W: np.ndarray               # (M,) uint8, values in [0, 2 * alph_size)
    last: np.ndarray            # (M,) uint8 in {0, 1}
    F: np.ndarray               # (alph_size,) int64
    valid: np.ndarray           # (M,) uint8: 1 iff a real (non-dummy) edge
    weights: np.ndarray | None = None   # (M,) uint64 or None

    @property
    def num_edges(self) -> int:
        return len(self.W) - 1

    @classmethod
    def from_arrays(cls, other) -> "BossArrays":
        """Any object with the fields of a BossArrays (the JAX package's,
        in the tests) -> the port's, its arrays as numpy arrays."""
        w = getattr(other, "weights", None)
        return cls(int(other.k), int(other.alph_size), np.asarray(other.W),
                   np.asarray(other.last), np.asarray(other.F),
                   np.asarray(other.valid),
                   None if w is None else np.asarray(w))


def empty_boss_arrays(K: int, alph_size: int = 5) -> BossArrays:
    """The host pipeline's table of no edge k-mers of length K: the all-$
    row alone, emitted behind the zero row (construct.py:252-279 with
    N = 0)."""
    F = np.ones(alph_size, dtype=np.int64)
    F[0] = 0
    return BossArrays(k=K - 1, alph_size=alph_size,
                      W=np.zeros(2, np.uint8), last=np.array([0, 1], np.uint8),
                      F=F, valid=np.zeros(2, np.uint8))


def _chars(kmers, device) -> torch.Tensor:
    if isinstance(kmers, torch.Tensor):
        return kmers
    from ..device import resolve_device
    return torch.from_numpy(np.ascontiguousarray(kmers, dtype=np.uint8)).to(
        resolve_device(device))


def _counts(counts, dev) -> torch.Tensor | None:
    """uint64 counts (numpy) or int64 bit patterns -> int64 on ``dev``."""
    if counts is None or isinstance(counts, torch.Tensor):
        return counts
    return packing.to_device(np.asarray(counts, dtype=np.uint64)[:, None],
                             dev)[:, 0]


def _node_key(chars, bits: int = 4):
    """Packed co-lex key of the source node s[0..K-2] of each edge
    string."""
    K = chars.shape[1]
    return packing.pack_rows(lambda j: chars[:, j],
                             packing.colex_priority_order(K - 1), bits)


def _target_key(chars, bits: int = 4):
    """Packed co-lex key of the target node s[1..K-1]."""
    K = chars.shape[1]
    return packing.pack_rows(lambda j: chars[:, j + 1],
                             packing.colex_priority_order(K - 1), bits)


def _dollar(nodes: torch.Tensor) -> torch.Tensor:
    """'$' + each node."""
    return torch.cat([nodes.new_zeros((nodes.shape[0], 1)), nodes], dim=1)


def generate_dummy_kmers(kmers, bits: int = 4, device=None):
    """The dummy edges of the BOSS table of ``kmers``, the (N, K) distinct
    real edge strings in BOSS order -> (D, K) dummy edge strings in the
    JAX function's order, without the all-$ edge: a sink v + '$' for each
    target node v without an outgoing edge (by target key), a level-1
    source '$' + n for each source node n without an incoming edge (by
    source key), then levels 2..k, '$' prepended to the nodes of the level
    before, deduped by node in the order of their first row (ref
    boss_chunk_construct.cpp:42-171, 380-397).  numpy in, numpy out;
    a tensor stays where it lies."""
    if not isinstance(kmers, torch.Tensor):
        return generate_dummy_kmers(_chars(kmers, device), bits).cpu().numpy()
    K = kmers.shape[1]
    # BOSS order sorts the source keys already: their distinct rows are an
    # adjacent dedupe; only the target keys need a sort
    src_keys = _node_key(kmers, bits)
    src_first = torch.nonzero(packing.new_rows(src_keys)).squeeze(1)
    src_keys_u = src_keys.index_select(0, src_first)
    del src_keys
    tgt_key_all = _target_key(kmers, bits)
    t_idx = packing.lexsort_rows(tgt_key_all)
    ts = tgt_key_all.index_select(0, t_idx)
    del tgt_key_all
    t_new = packing.new_rows(ts)
    tgt_first, tgt_keys_u = t_idx[t_new], ts[t_new]
    del ts, t_idx
    sink_nodes = kmers[tgt_first[~packing.rows_in_sorted(src_keys_u,
                                                         tgt_keys_u)], 1:]
    src1_nodes = kmers[src_first[~packing.rows_in_sorted(tgt_keys_u,
                                                         src_keys_u)], :K - 1]
    dummies = [torch.cat([sink_nodes, sink_nodes.new_zeros(
        (sink_nodes.shape[0], 1))], dim=1)]
    level = _dollar(src1_nodes)
    dummies.append(level)
    for _ in range(2, K):
        if not len(level):
            break                    # every later level is empty too
        nodes = level[:, : K - 1]
        keys = _node_key(level, bits)
        perm = packing.lexsort_rows(keys)
        first = perm[packing.new_rows(keys.index_select(0, perm))]
        level = _dollar(nodes.index_select(0, torch.sort(first).values))
        dummies.append(level)
    return torch.cat(dummies)


def emit_boss(stream, alph_size: int, counts=None, bits_per_count: int = 8,
              device=None) -> BossArrays:
    """The BOSS arrays of ``stream``, (M, K) edge strings in BOSS order
    from the all-$ row, ``counts`` their multiplicities (0 for dummies):
    redundant dummy sinks dropped, the minus flags of each label's
    repeated targets, last, F, valid, and the weights capped at
    2^bits_per_count - 1 and 0 on dummy rows (ref boss_chunk.cpp:33-133)."""
    stream = _chars(stream, device)
    counts = _counts(counts, stream.device)
    M, K = stream.shape
    labels = stream[:, K - 1].long()
    node_last = stream[:, K - 2].long()
    first_char = stream[:, 0].long()
    bits = packing.bits_for_alphabet(alph_size)
    node_keys = _node_key(stream, bits)
    same_node_next = torch.zeros(M, dtype=torch.bool, device=stream.device)
    if M > 1:
        same_node_next[:-1] = (node_keys[1:] == node_keys[:-1]).all(dim=1)
    del node_keys
    # redundant dummy sinks: label $, a node not ending in $, the next row
    # of the same node
    keep = ~(same_node_next & (labels == 0) & (node_last > 0))
    # minus flags: a row of label c > 0 whose target node is the previous
    # label-c row's
    tkeys = _target_key(stream, bits)
    minus = torch.zeros(M, dtype=torch.bool, device=stream.device)
    for c in range(1, alph_size):
        idx = torch.nonzero(keep & (labels == c)).squeeze(1)
        if idx.numel() > 1:
            t = tkeys.index_select(0, idx)
            minus[idx[1:]] = (t[1:] == t[:-1]).all(dim=1)
    del tkeys
    kept = torch.nonzero(keep).squeeze(1)
    zero = labels.new_zeros(1)

    def rows(x):
        return torch.cat([zero, x.index_select(0, kept).long()]) \
            .to(torch.uint8).cpu().numpy()

    lab_k, first_k = labels[kept], first_char[kept]
    nlc = node_last[kept].contiguous()
    F = torch.searchsorted(nlc, torch.arange(alph_size, device=nlc.device))
    weights = None
    if counts is not None:
        w = counts.index_select(0, kept)
        if bits_per_count < 64:
            cap = (1 << bits_per_count) - 1
            w = torch.where((w < 0) | (w > cap), cap, w)  # unsigned min
        w = torch.where((lab_k == 0) | (first_k == 0), 0, w)
        weights = packing.to_host(torch.cat([w.new_zeros(1), w]))
    return BossArrays(
        k=K - 1, alph_size=alph_size,
        W=rows(labels + torch.where(minus, alph_size, 0)),
        last=rows(~same_node_next), F=F.cpu().numpy().astype(np.int64),
        valid=rows((labels > 0) & (first_char > 0)), weights=weights)


def build_boss_arrays(kmers, alph_size: int = 5, counts=None,
                      bits_per_count: int = 8, device=None) -> BossArrays:
    """Sorted distinct real edge k-mers (N, K) -> the BOSS arrays
    (construct_boss_chunk, ref boss_chunk_construct.cpp:341-462): the
    dummy edges, the stream of the all-$ row, the k-mers and the dummies
    sorted in BOSS order (kernel D2), the emission."""
    kmers = _chars(kmers, device)
    counts = _counts(counts, kmers.device)
    N, K = kmers.shape
    bits = packing.bits_for_alphabet(alph_size)
    with PhaseTimer("dummy k-mers"):
        dummies = generate_dummy_kmers(kmers, bits)
    with PhaseTimer("stream sort"):
        stream = torch.cat([kmers.new_zeros((1, K)), kmers, dummies])
        sort_idx = packing.lexsort_rows(packing.pack_rows(
            lambda j: stream[:, j], packing.boss_priority_order(K), bits))
        stream = stream.index_select(0, sort_idx)
        stream_counts = None
        if counts is not None:
            stream_counts = torch.cat([
                counts.new_zeros(1), counts,
                counts.new_zeros(dummies.shape[0])]).index_select(0, sort_idx)
        del dummies, sort_idx
    with PhaseTimer("emit BOSS"):
        return emit_boss(stream, alph_size, stream_counts, bits_per_count)
