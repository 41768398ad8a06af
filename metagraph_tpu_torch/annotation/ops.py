"""The dense annotation bitmap on the device, and the per-sequence label
counts of flat windows.

Own copy of metagraph_tpu/annotation/ops.py: ``pack_annotation_bitmap``
(:26-36), a ``DeviceAnnotation`` (:84-112: ``from_column_annotation``,
``from_bitmap``) that keeps plain ``(R, Lw)`` rows (bit ``c % 32`` of word
``c // 32`` of row r is set iff row r carries label c; the JAX package's
row-packed layout, :39-80, served the TPU's gather unit and is not
copied), and the three counts of flat (Q,) node ids and sequence ids:
``count_labels`` (:168), ``count_labels_sorted`` (:115) and
``count_labels_matmul`` (:144).

Each count is a wrapper: on a CPU tensor it runs its plain version, which
mirrors its JAX body (a segment sum; a prefix sum with boundary gathers;
a one-hot product) in integers; on a CUDA tensor it lays the windows out
in tiles of one sequence each (``flat_tiles``: a stable D2 sort by
sequence where the ids are not sorted) and counts them with kernel 2
(``query/device.label_counts``).  Counts are exact int32 where the JAX
package's one-hot product folds in float32 (exact below 2^24 only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._u32 import np_words, to_u64


def pack_annotation_bitmap(anno, num_rows: int | None = None) -> np.ndarray:
    """ColumnMajorAnnotation -> (num_rows, ceil(L/32)) uint32 bitmap."""
    R = num_rows or anno.num_rows
    L = anno.num_labels
    bitmap = np.zeros((R, max((L + 31) // 32, 1)), dtype=np.uint32)
    for c in range(L):
        bitmap[anno.column_rows(c), c // 32] |= np.uint32(1 << (c % 32))
    return bitmap


@dataclass
class DeviceAnnotation:
    # (R, Lw) int32 bit patterns of the uint32 words: a view of rows padded
    # to a multiple of 4 words, so that each row starts 16-byte aligned
    bitmap: torch.Tensor
    num_labels: int

    @classmethod
    def from_bitmap(cls, bitmap: np.ndarray, num_labels: int,
                    device) -> "DeviceAnnotation":
        Lw = bitmap.shape[1]
        pad = -Lw % 4
        if pad:
            bitmap = np.pad(bitmap, ((0, 0), (0, pad)))
        return cls(np_words(bitmap).to(device)[:, :Lw], num_labels)

    @classmethod
    def from_column_annotation(cls, anno, num_rows: int | None = None,
                               device=None) -> "DeviceAnnotation":
        """A column annotation's bitmap on ``device`` (the card unless
        "cpu")."""
        from ..device import resolve_device
        return cls.from_bitmap(pack_annotation_bitmap(anno, num_rows),
                               anno.num_labels, resolve_device(device))


def gather_anno_rows(bitmap: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(..., ) row ids -> (..., Lw) annotation words."""
    return bitmap[rows]


# --------------------------------------------------------------------------
# plain versions (the JAX bodies, in integers)
# --------------------------------------------------------------------------

def _hit_bits(bitmap, nodes, num_labels):
    """(Q,) node ids -> ((Q, L) int64 label bits of the hit rows, (Q,)
    bool hits)."""
    hit = nodes > 0
    rows = torch.where(hit, nodes - 1, 0).long()
    words = to_u64(gather_anno_rows(bitmap, rows)) * hit[:, None]
    shifts = torch.arange(32, device=bitmap.device)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(len(nodes), -1)
    return bits[:, :num_labels], hit


def count_labels_plain(bitmap, nodes, seq_ids, num_seqs, num_labels,
                       chunk: int = 1 << 14):
    """Plain ``count_labels``: segment sums of the hit rows' label bits and
    of the hits (ids outside [0, num_seqs) dropped, as segment_sum drops
    them), ``chunk`` windows at a time."""
    dev = nodes.device
    counts = torch.zeros((num_seqs, num_labels), dtype=torch.int64,
                         device=dev)
    present = torch.zeros(num_seqs, dtype=torch.int64, device=dev)
    for lo in range(0, len(nodes), chunk):
        bits, hit = _hit_bits(bitmap, nodes[lo: lo + chunk], num_labels)
        sid = seq_ids[lo: lo + chunk].long()
        keep = (sid >= 0) & (sid < num_seqs)
        counts.index_add_(0, sid[keep], bits[keep])
        present.index_add_(0, sid[keep], hit[keep].long())
    return counts.to(torch.int32), present.to(torch.int32)


def count_labels_sorted_plain(bitmap, nodes, seq_ids, num_seqs, num_labels):
    """Plain ``count_labels_sorted``: prefix sums of the label bits and
    hits, read at each sequence's last window (searchsorted right - 1)."""
    dev = nodes.device
    bits, hit = _hit_bits(bitmap, nodes, num_labels)
    zero = torch.zeros((1, num_labels), dtype=torch.int64, device=dev)
    ps = torch.cat([zero, torch.cumsum(bits, 0)])
    ph = torch.cat([zero[:, 0], torch.cumsum(hit.long(), 0)])
    ends = torch.searchsorted(seq_ids.contiguous(),
                              torch.arange(num_seqs, dtype=seq_ids.dtype,
                                           device=dev), right=True) - 1
    at, at_h = ps[ends + 1], ph[ends + 1]
    prev = torch.cat([zero, at[:-1]])
    prev_h = torch.cat([zero[:, 0], at_h[:-1]])
    return (at - prev).to(torch.int32), (at_h - prev_h).to(torch.int32)


def count_labels_matmul_plain(bitmap, nodes, seq_ids, num_seqs, num_labels,
                              chunk: int = 1 << 14):
    """Plain ``count_labels_matmul``: a one-hot (S, Q) x (Q, L) product in
    int64 (the JAX bfloat16 operands with float32 sums), ``chunk`` windows
    at a time."""
    dev = nodes.device
    counts = torch.zeros((num_seqs, num_labels), dtype=torch.int64,
                         device=dev)
    present = torch.zeros(num_seqs, dtype=torch.int64, device=dev)
    seqs = torch.arange(num_seqs, device=dev)
    for lo in range(0, len(nodes), chunk):
        bits, hit = _hit_bits(bitmap, nodes[lo: lo + chunk], num_labels)
        onehot = (seq_ids[lo: lo + chunk, None].long()
                  == seqs[None, :]).long()
        counts += onehot.T @ bits
        present += onehot.T @ hit.long()
    return counts.to(torch.int32), present.to(torch.int32)


# --------------------------------------------------------------------------
# the wrappers: kernel 2 on the card
# --------------------------------------------------------------------------

def flat_tiles(nodes: torch.Tensor, seq_ids: torch.Tensor, num_seqs: int,
               tile: int):
    """(Q,) node ids and sequence ids -> ((N, tile) int32 node ids, 0
    padding, each tile one sequence's windows in input order; (N,) int32
    tile_seq): ``query/device.tile_layout`` on the device.  Ids outside
    [0, num_seqs) are dropped; unsorted ids are first sorted (a stable D2
    sort)."""
    from ..succinct.device_build import radix_sort
    dev = nodes.device
    sid = seq_ids.long()
    keep = (sid >= 0) & (sid < num_seqs)
    if not bool(keep.all()):
        nodes, sid = nodes[keep], sid[keep]
    if len(sid) > 1 and not bool((sid[1:] >= sid[:-1]).all()):
        perm = torch.arange(len(sid), dtype=torch.int64, device=dev)
        sid, perm = radix_sort(sid, max(int(num_seqs - 1).bit_length(), 1),
                               perm)
        nodes = nodes.index_select(0, perm)
    nwin = torch.bincount(sid, minlength=num_seqs)
    ntiles = (nwin + tile - 1) // tile
    tile_end = torch.cumsum(ntiles, 0)
    seq_end = torch.cumsum(nwin, 0)
    idx = torch.arange(len(sid), device=dev) - (seq_end - nwin)[sid]
    flat = ((tile_end - ntiles)[sid] + idx // tile) * tile + idx % tile
    N = int(tile_end[-1]) if num_seqs else 0
    out = torch.zeros(N * tile, dtype=torch.int32, device=dev)
    out[flat] = nodes.to(torch.int32)
    tile_seq = torch.repeat_interleave(
        torch.arange(num_seqs, dtype=torch.int32, device=dev), ntiles)
    return out.view(N, tile), tile_seq


def _counts(plain, bitmap, nodes, seq_ids, num_seqs, num_labels):
    if nodes.device.type == "cpu":
        return plain(bitmap, nodes, seq_ids, num_seqs, num_labels)
    from ..query.device import TILE, label_counts
    tiles, tile_seq = flat_tiles(nodes, seq_ids, num_seqs, TILE)
    return label_counts(tiles, bitmap, tile_seq, num_seqs, num_labels)


def count_labels(bitmap: torch.Tensor, nodes: torch.Tensor,
                 seq_ids: torch.Tensor, num_seqs: int, num_labels: int):
    """(Q,) int32 node ids (0 = miss) and sequence ids -> ((S, L) int32
    label counts, (S,) int32 present): the JAX ``count_labels``.  A CPU
    tensor takes the plain version; a CUDA tensor, tiles and kernel 2."""
    return _counts(count_labels_plain, bitmap, nodes, seq_ids, num_seqs,
                   num_labels)


def count_labels_sorted(bitmap: torch.Tensor, nodes: torch.Tensor,
                        seq_ids: torch.Tensor, num_seqs: int,
                        num_labels: int):
    """``count_labels`` for sorted ``seq_ids`` (the JAX
    ``count_labels_sorted``)."""
    return _counts(count_labels_sorted_plain, bitmap, nodes, seq_ids,
                   num_seqs, num_labels)


def count_labels_matmul(bitmap: torch.Tensor, nodes: torch.Tensor,
                        seq_ids: torch.Tensor, num_seqs: int,
                        num_labels: int):
    """The JAX ``count_labels_matmul``, whose float32 counts become exact
    int32 here."""
    return _counts(count_labels_matmul_plain, bitmap, nodes, seq_ids,
                   num_seqs, num_labels)
