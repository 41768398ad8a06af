"""The compressed device annotations, and kernels W1 and W2 that read them.

Past ``METAGRAPH_DENSE_ANNO_BUDGET``, where the block-sparse form does not
fit either (its overflow patterns pass the budget), the JAX package keeps a
BRWT or a RowDiff annotation compressed on the device and reads each
window's label words from it (metagraph_tpu/annotation/device_matrix.py).
Own numpy copies of its host half:

* ``flatten_brwt`` (:295-335), the tree level by level;
* ``FlatBRWT.from_brwt``, what ``DynDeviceBRWT.from_host`` (:407-426) makes
  of it, in the port's layout: one node table in breadth-first order (a
  node's word offset, its label if it is a leaf, its first child and its
  number of children; a node's children are a contiguous run, because
  ``flatten_brwt`` appends them in parent order) and one word array (each
  32 bits of a node's bitmap beside the node's exclusive rank directory);
  a label whose leaf is missing has no bits (the host ``get_rows_mask``'s
  answer; ``BRWT.from_columns`` gives every label a leaf when it is given
  a column a label, as ``transform_anno`` gives it);
* ``FlatRowDiff.from_row_diff``, ``DeviceRowDiff.from_host`` (:172-187):
  the fixpoint that bounds the walk (``max_depth``, and the error on a
  cycle), with ``succ`` and ``anchors`` folded into one successor array
  (-1 where the walk stops after the row); its inner rows from a
  ``FlatBRWT`` or a dense (R, Lw) bitmap.

``BRWTOnDevice`` and ``RowDiffOnDevice`` hold them as tensors.  The XLA
programs that read them become two hand-written kernels
(``csrc/row_words.cu``), each with a plain PyTorch version that CPU tensors
take; ids are node ids (0 = miss) or rows + 1, an id above canon 2's
``offset`` folds to id - offset, and row = id - 1:

* W1 ``brwt_row_words`` <- ``dyn_brwt_descend`` (:338): the (Q, Lw) label
  words of the rows, by a descent that visits only live nodes.  JAX's
  ``DeviceBRWT``/``brwt_row_words`` (:33, :123), the static-shape descent,
  computes the same function; the port has one descent, and the tests hold
  it against both;
* W2 ``rowdiff_row_words`` <- ``rowdiff_row_words`` (:190) with
  ``rowdiff_dyn_brwt_words_fn`` (:435) or ``rowdiff_dense_words_fn``
  (:227): the XOR of the inner rows along the successor walk, at most
  ``max_depth`` steps.

``query/device.py::words_count_epoch`` counts on their words a chunk of
windows at a time (``make_tiled_count_epoch``, :240).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from .. import _build
from .._u32 import to_i32, to_u64
from ..succinct.bitrank import popcount64
from .ops import DeviceAnnotation

WARP_SMEM = 96 << 10     # shared memory of a block of W1 or W2, at most
MAX_WARPS = 8            # warps a block
SLOTS = 8                # windows a warp of W1 or W2 descends at once, at most
LIBRARY = "row_words"    # W1's and W2's library ("row_words_split": the
#                          descent's load-wait counters, kernel_times.py)


# --------------------------------------------------------------------------
# host halves
# --------------------------------------------------------------------------

def flatten_brwt(brwt):
    """Host BRWT -> per level (words uint32, exclusive rank directory
    int32, node word offsets int32, parent index int32), and per label its
    leaf's level and node (-1: no leaf); the JAX function's arrays."""
    levels = [[(brwt.root, -1)]]
    while True:
        nxt = [(ch, pi) for pi, (node, _) in enumerate(levels[-1])
               for ch in node.children]
        if not nxt:
            break
        levels.append(nxt)
    leaf_level = np.full(max(brwt.num_labels, 1), -1, np.int32)
    leaf_node = np.full(max(brwt.num_labels, 1), -1, np.int32)
    flat = []
    for li, level in enumerate(levels):
        words, offs, pars = [], [], []
        woff = 0
        for ni, (node, pi) in enumerate(level):
            nw = max((node.bv.n + 31) // 32, 1)
            # the BitRank's uint64 words, little-endian: the same bits
            words.append(node.bv.words.view(np.uint32)[:nw])
            offs.append(woff)
            pars.append(pi)
            woff += nw
            if not node.children and node.labels:
                leaf_level[node.labels[0]] = li
                leaf_node[node.labels[0]] = ni
        w = np.concatenate(words)
        pc = popcount64(w.astype(np.uint64))
        rdir = np.concatenate(
            [np.cumsum(pc[o: o + len(x)]) - pc[o: o + len(x)]
             for o, x in zip(offs, words)])
        flat.append((w, rdir.astype(np.int32), np.array(offs, np.int32),
                     np.array(pars, np.int32)))
    return flat, leaf_level, leaf_node


@dataclass
class FlatBRWT:
    nodes: np.ndarray       # (n, 4) int32: word offset, label, first child,
    #                         children (a leaf: label >= 0, no children)
    words: np.ndarray       # (W, 2) int32: bitmap word, exclusive rank
    num_rows: int
    num_labels: int
    stack_cap: int          # stack runs a warp of SLOTS windows
    #                         (csrc/row_words.cu)

    @classmethod
    def from_brwt(cls, brwt) -> "FlatBRWT":
        flat, leaf_level, leaf_node = flatten_brwt(brwt)
        L = brwt.num_labels
        labels = np.arange(len(leaf_level))[:L]
        has = leaf_level[:L] >= 0
        return cls.from_levels(
            [f[0] for f in flat], [f[1] for f in flat], [f[2] for f in flat],
            [f[3] for f in flat], leaf_level[:L][has], leaf_node[:L][has],
            labels[has], brwt.num_rows, L)

    @classmethod
    def from_levels(cls, words, rdir, offs, parent, leaf_level, leaf_node,
                    leaf_label, num_rows: int, num_labels: int) -> "FlatBRWT":
        """Per-level arrays (flatten_brwt's, or a JAX DynDeviceBRWT's) and
        each leaf's level, node and label -> the node table and word
        array.  Raises ValueError where a level's parents are not in order
        (children would not be contiguous) or a leaf is out of place."""
        n_l = [len(o) for o in offs]
        node_base = np.concatenate([[0], np.cumsum(n_l)]).astype(np.int64)
        word_base = np.concatenate(
            [[0], np.cumsum([len(w) for w in words])]).astype(np.int64)
        n, W = int(node_base[-1]), int(word_base[-1])
        if W >= 2 ** 31 or n >= 2 ** 31:
            raise ValueError(f"BRWT of {n} nodes and {W} words passes "
                             "int32 offsets")
        nodes = np.zeros((n, 4), np.int32)
        nodes[:, 1] = -1
        inner = []
        for l in range(len(offs)):
            lo, hi = node_base[l], node_base[l + 1]
            nodes[lo:hi, 0] = word_base[l] + np.asarray(offs[l], np.int64)
            if l + 1 < len(offs):
                par = np.asarray(parent[l + 1], np.int64)
                if len(par) and (np.any(np.diff(par) < 0) or par[0] < 0
                                 or par[-1] >= n_l[l]):
                    raise ValueError(f"BRWT level {l + 1}: parents out of "
                                     "order")
                cnt = np.bincount(par, minlength=n_l[l])
                first = node_base[l + 1] + np.cumsum(cnt) - cnt
                nodes[lo:hi, 2] = np.where(cnt > 0, first, 0)
                nodes[lo:hi, 3] = cnt
                inner.append(int((cnt > 0).sum()))
        ll = np.asarray(leaf_level, np.int64)
        ln = np.asarray(leaf_node, np.int64)
        if len(ll) and (ll.min() < 0 or ll.max() >= len(offs)
                        or ln.min() < 0
                        or np.any(ln >= np.asarray(n_l)[ll])):
            raise ValueError("BRWT leaf outside its level")
        g = node_base[ll] + ln
        if np.any(nodes[g, 3] > 0):
            raise ValueError("BRWT leaf with children")
        nodes[g, 1] = np.asarray(leaf_label, np.int32)
        wr = np.zeros((W, 2), np.int32)
        wr[:, 0] = np.concatenate(words).view(np.int32) if W else []
        wr[:, 1] = np.concatenate(rdir) if W else []
        # the SLOTS roots' virtual runs, then at most 32 runs a depth and
        # no more than SLOTS x the inner nodes there (csrc/row_words.cu)
        cap = SLOTS + sum(min(32, SLOTS * c) for c in inner)
        return cls(nodes, wr, int(num_rows), int(num_labels), cap)


@dataclass
class FlatRowDiff:
    next_row: np.ndarray    # (R,) int32: succ, -1 where the walk stops
    max_depth: int
    inner: Union[FlatBRWT, np.ndarray]   # or an (R, Lw) uint32 bitmap
    num_labels: int

    @property
    def num_rows(self) -> int:
        return len(self.next_row)

    @classmethod
    def from_row_diff(cls, rd, inner) -> "FlatRowDiff":
        """A host RowDiff (succ, anchors) and its inner rows' form ->
        the walk, bounded by the longest successor chain to an anchor,
        found by fixpoint iteration; a cycle raises ValueError."""
        succ = np.asarray(rd.succ, dtype=np.int32)
        anchors = np.asarray(rd.anchors, dtype=bool)
        stop = anchors | (succ < 0)
        depth = np.zeros(len(succ), np.int64)
        for _ in range(len(succ) + 1):
            nd = np.where(stop, 0, depth[np.maximum(succ, 0)] + 1)
            if np.array_equal(nd, depth):
                break
            depth = nd
        else:
            raise ValueError("row-diff routing does not terminate")
        return cls(np.where(stop, -1, succ).astype(np.int32),
                   int(depth.max(initial=0)) + 1, inner, rd.num_labels)


def check_words_annotation(dev, num_labels: int):
    """Raise ValueError unless a FlatBRWT or FlatRowDiff fits
    ``num_labels`` labels: the shapes and types, every node's words and
    children inside the arrays, the leaf labels below L, the successors
    inside the rows and the inner rows as many, which W1 and W2 index
    with."""
    L = num_labels
    if dev.num_labels != L:
        raise ValueError(f"device annotation of {dev.num_labels} labels "
                         f"does not fit {L} labels")
    if isinstance(dev, FlatRowDiff):
        nx, R = dev.next_row, dev.num_rows
        if nx.dtype != np.int32 or nx.ndim != 1 or dev.max_depth < 0 or (
                R and not -1 <= int(nx.min()) <= int(nx.max()) < R):
            raise ValueError("row-diff successors outside the rows")
        inner = dev.inner
        if isinstance(inner, FlatBRWT):
            if inner.num_rows != R:
                raise ValueError(f"row-diff inner BRWT of {inner.num_rows} "
                                 f"rows under {R} rows")
            return check_words_annotation(inner, L)
        if not isinstance(inner, np.ndarray) or inner.dtype != np.uint32 \
                or inner.shape != (R, max((L + 31) // 32, 1)):
            raise ValueError(f"row-diff inner bitmap "
                             f"{getattr(inner, 'shape', None)} does not fit")
        return
    nodes, words = dev.nodes, dev.words
    if nodes.dtype != np.int32 or nodes.ndim != 2 or nodes.shape[1] != 4 \
            or words.dtype != np.int32 or words.ndim != 2 \
            or words.shape[1] != 2 or not len(nodes) or dev.stack_cap < 1:
        raise ValueError("BRWT node table or word array has a bad shape")
    off, lab, first, cnt = nodes.T.astype(np.int64)
    if off.min() < 0 or off.max() >= max(len(words), 1) \
            or words[:, 1].min(initial=0) < 0:
        raise ValueError("BRWT word offsets or ranks outside the words")
    inner = cnt > 0
    if cnt.min() < 0 or cnt.max() >= 2 ** 28 or np.any(first[inner] < 1) \
            or np.any(first[inner] + cnt[inner] > len(nodes)):
        raise ValueError("BRWT children outside the node table")
    if lab.min() < -1 or lab.max() >= L or np.any(inner & (lab >= 0)):
        raise ValueError("BRWT leaf labels outside [0, L)")


# --------------------------------------------------------------------------
# on the device
# --------------------------------------------------------------------------

@dataclass
class BRWTOnDevice:
    nodes: torch.Tensor     # (n, 4) int32
    words: torch.Tensor     # (W, 2) int32
    num_rows: int
    num_labels: int
    stack_cap: int

    @classmethod
    def from_host(cls, flat: FlatBRWT, device) -> "BRWTOnDevice":
        return cls(torch.from_numpy(np.require(flat.nodes, np.int32, "CW"))
                   .to(device),
                   torch.from_numpy(np.require(flat.words, np.int32, "CW"))
                   .to(device),
                   flat.num_rows, flat.num_labels, flat.stack_cap)


@dataclass
class RowDiffOnDevice:
    next_row: torch.Tensor  # (R,) int32
    max_depth: int
    # a BRWTOnDevice, or the (R, Lw) int32 bitmap (rows padded to a
    # multiple of 4 words, as DeviceAnnotation pads them)
    inner: Union[BRWTOnDevice, torch.Tensor]
    num_labels: int

    @property
    def num_rows(self) -> int:
        return self.next_row.shape[0]

    @classmethod
    def from_host(cls, flat: FlatRowDiff, device) -> "RowDiffOnDevice":
        inner = BRWTOnDevice.from_host(flat.inner, device) \
            if isinstance(flat.inner, FlatBRWT) else \
            DeviceAnnotation.from_bitmap(flat.inner, flat.num_labels,
                                         device).bitmap
        return cls(torch.from_numpy(np.require(flat.next_row, np.int32, "CW"))
                   .to(device), flat.max_depth, inner, flat.num_labels)


WordsOnDevice = (BRWTOnDevice, RowDiffOnDevice)


def device_words(flat, device):
    """A FlatBRWT or FlatRowDiff -> its tensors on ``device``."""
    if isinstance(flat, FlatBRWT):
        return BRWTOnDevice.from_host(flat, device)
    return RowDiffOnDevice.from_host(flat, device)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of uint32 values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _rows_of(ids: torch.Tensor, offset: int, num_rows: int) -> torch.Tensor:
    """ids (0 = miss; above ``offset``, reverse-complement hits) -> int64
    rows, -1 for a miss; a row past the annotation raises."""
    ids = ids.long()
    if offset:
        ids = torch.where(ids > offset, ids - offset, ids)
    if ids.numel() and int(ids.max()) > num_rows:
        raise ValueError(f"id {int(ids.max())} past {num_rows} rows")
    return torch.where(ids > 0, ids - 1, -1)


def _descend_plain(tree: BRWTOnDevice, rows: torch.Tensor,
                   visited: dict | None = None) -> torch.Tensor:
    """rows (Q,) int64 (-1 = miss) -> (Q, Lw) int64 label words, by the
    output-sensitive descent: level by level over the live nodes only.
    ``visited`` collects the node and word indices read (under "nodes"
    and "words"), for a count of the bytes the data needs."""
    Q, L = rows.shape[0], tree.num_labels
    Lw = max((L + 31) // 32, 1)
    dev = rows.device
    acc = torch.zeros(Q * Lw, dtype=torch.int64, device=dev)
    q = torch.nonzero(rows >= 0).reshape(-1)
    r = rows[q]
    node = torch.zeros_like(q)
    nodes = tree.nodes.long()
    while q.numel():
        nd = nodes[node]
        widx = nd[:, 0] + (r >> 5)
        if visited is not None:
            visited.setdefault("nodes", []).append(node)
            visited.setdefault("words", []).append(widx)
        w = to_u64(tree.words[widx, 0])
        live = ((w >> (r & 31)) & 1) == 1
        q, r, nd, w, widx = q[live], r[live], nd[live], w[live], widx[live]
        leaf = nd[:, 1] >= 0
        lab = nd[leaf, 1]
        # a label has one leaf: each (query, label) bit is set once
        acc.index_add_(0, q[leaf] * Lw + (lab >> 5),
                       torch.ones_like(lab) << (lab & 31))
        go = ~leaf & (nd[:, 3] > 0)
        rg = r[go]
        below = w[go] & ((torch.ones_like(rg) << (rg & 31)) - 1)
        rank = tree.words[widx[go], 1].long() + popcount32(below)
        cnt = nd[go, 3]
        at = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        node = torch.repeat_interleave(nd[go, 2], cnt) \
            + torch.arange(int(cnt.sum()), device=dev) - at
        q = torch.repeat_interleave(q[go], cnt)
        r = torch.repeat_interleave(rank, cnt)
    return acc.view(Q, Lw)


def brwt_row_words_plain(tree: BRWTOnDevice, ids: torch.Tensor,
                         offset: int = 0,
                         visited: dict | None = None) -> torch.Tensor:
    """Plain version of W1: (Q,) ids -> (Q, Lw) int32 bit patterns."""
    return to_i32(_descend_plain(tree, _rows_of(ids, offset, tree.num_rows),
                                 visited))


def dense_row_words_plain(bitmap: torch.Tensor, rows: torch.Tensor
                          ) -> torch.Tensor:
    """rows (Q,) int64 (-1 = miss) -> (Q, Lw) int64 words of the dense
    bitmap (``rowdiff_dense_words_fn``'s inner source)."""
    w = to_u64(bitmap[rows.clamp(min=0)])
    return torch.where((rows >= 0)[:, None], w, 0)


def rowdiff_row_words_plain(rd: RowDiffOnDevice, ids: torch.Tensor,
                            offset: int = 0,
                            visited: dict | None = None) -> torch.Tensor:
    """Plain version of W2: (Q,) ids -> (Q, Lw) int32 bit patterns, the
    inner rows XORed along each window's walk.  ``visited`` collects the
    rows stepped on ("rows") and the inner tree's reads, as W1's does."""
    cur = _rows_of(ids, offset, rd.num_rows)
    Lw = max((rd.num_labels + 31) // 32, 1)
    acc = torch.zeros((cur.shape[0], Lw), dtype=torch.int64,
                      device=ids.device)
    nxt = rd.next_row.long()
    for _ in range(rd.max_depth):
        on = torch.nonzero(cur >= 0).reshape(-1)
        if not on.numel():
            break
        rows = cur[on]
        if visited is not None:
            visited.setdefault("rows", []).append(rows)
        if isinstance(rd.inner, torch.Tensor):
            w = dense_row_words_plain(rd.inner, rows)
        else:
            w = _descend_plain(rd.inner, rows, visited)
        acc[on] ^= w
        cur[on] = nxt[rows]
    return to_i32(acc)


# --------------------------------------------------------------------------
# kernels W1 and W2
# --------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _plan(Lw: int, cap: int) -> tuple[int, int]:
    """-> (warps a block, windows a warp) of W1 or W2 on a tree of ``cap``
    stack runs (0: W2's dense inner rows, no shared memory): MAX_WARPS
    warps of as many windows as fit WARP_SMEM, at most SLOTS, or fewer
    warps of one window."""
    if cap == 0:
        return MAX_WARPS, SLOTS
    for slots in range(min(SLOTS, cap), 0, -1):
        if MAX_WARPS * (slots * Lw + 3 * cap) * 4 <= WARP_SMEM:
            return MAX_WARPS, slots
    per = (Lw + 3 * cap) * 4
    if per > 227 << 10:
        raise ValueError(f"a warp's row of {Lw} words and stack of {cap} "
                         "runs pass an SM's shared memory")
    return max(1, min(MAX_WARPS, WARP_SMEM // per)), 1


def _prepare(ids: torch.Tensor, num_labels: int, out):
    """Check ids and the output buffer: -> (out, ld).  ``out`` (Q, Lw)
    int32 may be a view of rows ld >= Lw words apart (a padded buffer)."""
    if ids.dtype != torch.int32 or ids.ndim != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous (Q,) int32 tensor")
    Q, Lw = ids.shape[0], max((num_labels + 31) // 32, 1)
    if out is None:
        out = torch.empty((Q, Lw), dtype=torch.int32, device=ids.device)
    if out.dtype != torch.int32 or out.device != ids.device \
            or out.shape != (Q, Lw) or out.stride(1) != 1 \
            or (Q > 1 and out.stride(0) < Lw):
        raise ValueError(f"out must be a ({Q}, {Lw}) int32 tensor on "
                         f"{ids.device} with rows of contiguous words")
    return out, out.stride(0)


def _tree_args(tree):
    if tree is None:
        return [None, 0, None, 0, 1]
    return [tree.nodes.data_ptr(), tree.nodes.shape[0],
            tree.words.data_ptr(), tree.words.shape[0], tree.stack_cap]


def brwt_row_words(tree: BRWTOnDevice, ids: torch.Tensor, offset: int = 0,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """W1.  (Q,) int32 ids (0 = miss; above ``offset`` > 0, canon 2's
    reverse-complement hits) -> (Q, Lw) int32 bit patterns of the rows'
    label words, into ``out`` when given.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/row_words.cu`` or raise."""
    out, ld = _prepare(ids, tree.num_labels, out)
    if tree.nodes.device != ids.device:
        raise ValueError(f"the tree is on {tree.nodes.device}, the ids on "
                         f"{ids.device}")
    if not 0 <= offset < 2 ** 31:
        raise ValueError(f"offset {offset} out of range")
    if ids.device.type == "cpu":
        out.copy_(brwt_row_words_plain(tree, ids, offset))
        return out
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    Q, Lw = out.shape
    if Q == 0:
        return out
    fn = _build.function(LIBRARY, "mg_brwt_row_words",
                         [_P, _L, _P, _L, _I, _P, _L, _I, _L, _I, _I, _P, _L,
                          _I, _I, _P])
    warps, slots = _plan(Lw, tree.stack_cap)
    _build.check(fn(*_tree_args(tree), ids.data_ptr(), Q, offset,
                    tree.num_rows, tree.num_labels, Lw, out.data_ptr(), ld,
                    slots, warps,
                    torch.cuda.current_stream(ids.device).cuda_stream),
                 "brwt_row_words")
    _build.count(brwt_row_words)
    return out


brwt_row_words.launches = 0


def rowdiff_row_words(rd: RowDiffOnDevice, ids: torch.Tensor,
                      offset: int = 0,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """W2.  (Q,) int32 ids (as W1 takes them) -> (Q, Lw) int32 bit
    patterns: the inner rows (a BRWT descent or the dense bitmap's rows)
    XORed along each window's successor walk, at most ``max_depth`` steps.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/row_words.cu`` or raise."""
    out, ld = _prepare(ids, rd.num_labels, out)
    if rd.next_row.device != ids.device:
        raise ValueError(f"the walk is on {rd.next_row.device}, the ids on "
                         f"{ids.device}")
    if not 0 <= offset < 2 ** 31:
        raise ValueError(f"offset {offset} out of range")
    dense = isinstance(rd.inner, torch.Tensor)
    R = rd.num_rows
    if dense and (rd.inner.dtype != torch.int32
                  or rd.inner.shape != (R, out.shape[1])
                  or rd.inner.stride(1) != 1):
        raise ValueError("the inner bitmap must be (R, Lw) int32 rows of "
                         "contiguous words")
    if ids.device.type == "cpu":
        out.copy_(rowdiff_row_words_plain(rd, ids, offset))
        return out
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    Q, Lw = out.shape
    if Q == 0:
        return out
    if Q >= 2 ** 31:
        raise ValueError(f"rowdiff_row_words takes fewer than 2^31 windows, "
                         f"got {Q}")
    fn = _build.function(LIBRARY, "mg_rowdiff_row_words",
                         [_P, _L, _P, _L, _I, _P, _L, _I, _P, _I, _P, _L, _I,
                          _L, _I, _I, _P, _L, _P, _L, _I, _I, _P])
    tree = None if dense else rd.inner
    warps, slots = _plan(Lw, 0 if dense else tree.stack_cap)
    # two counts, the tails' chain rows (2 a window; a tail whose chain
    # does not fit is walked by one warp), the tails, a flag byte a window
    list_cap = 2 * Q
    scratch = torch.empty(16 + 8 * list_cap + 5 * Q, dtype=torch.uint8,
                          device=ids.device)
    _build.check(fn(*_tree_args(tree), rd.inner.data_ptr() if dense else None,
                    rd.inner.stride(0) if dense else 0, int(dense),
                    rd.next_row.data_ptr(), rd.max_depth, ids.data_ptr(), Q,
                    offset, R, rd.num_labels, Lw, out.data_ptr(), ld,
                    scratch.data_ptr(), list_cap, slots, warps,
                    torch.cuda.current_stream(ids.device).cuda_stream),
                 "rowdiff_row_words")
    _build.count(rowdiff_row_words)
    return out


rowdiff_row_words.launches = 0


def row_words(anno, ids: torch.Tensor, offset: int = 0,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """W1 on a BRWTOnDevice, W2 on a RowDiffOnDevice."""
    if isinstance(anno, BRWTOnDevice):
        return brwt_row_words(anno, ids, offset, out)
    return rowdiff_row_words(anno, ids, offset, out)
