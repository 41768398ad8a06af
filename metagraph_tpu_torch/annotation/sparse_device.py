"""The block-sparse annotation, and kernels S1 and S2 that count on it.

Own copy of metagraph_tpu/annotation/sparse_device.py:
``DeviceBlockSparseAnno`` (:46) with ``from_matrix`` (:84),
``from_columns`` (:165), ``save`` and ``load`` (:243-258),
``_rows_words`` (:62, here ``rows_words``) and ``_popcount_rows`` (:261),
on numpy arrays; a ``.devsparse.npz`` that either package writes loads
in the other.  Per row, up to ``tau`` label ids sit in one (R+1, tau)
uint32 table (label L marks an empty slot; row 0 is the miss row); a row
with more labels maps through ``dmap`` to one of the deduplicated overflow
patterns, the rows 1.. of the (Rd+1, L) int8 ``dense8`` (row 0 is all
zero).

``sparse_count_epoch`` (:268-307), the XLA program that counts on it,
becomes two hand-written kernels (``csrc/sparse_counts.cu``), each with a
plain PyTorch version (int64 ``index_add_``) that CPU tensors take:

* S1 ``sparse_label_counts``: the windows' label ids and present counts,
  and per (sequence, overflow pattern) the multiplicity of the windows
  whose row has that pattern;
* S2 ``overflow_counts``: the multiplicities times the patterns, added to
  the counts in integers.  The JAX package's f32 product rounds past
  2^24.

``sparse_count_epoch`` chains them.  It keeps the multiplicities as a
dense (sequences, Rd+1) buffer of at most ``MULT_BYTES``, one chunk of
sequences at a time.  On the card the label ids and slots sit in one row
record a row (``row_records``; ``SparseOnDevice.entries`` and ``dmap`` are
views of it), and S1 tallies each block's run of tiles in shared memory as
``label_count_plan`` lays it out.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .._u32 import np_words, to_u64

MULT_BYTES = 1 << 28     # multiplicity buffer of one chunk of sequences
S1_THREADS = 256         # kernel S1's largest block
DENSE_BINS = 8192        # L + P past this: S1 tallies in a hash table
S1_SMEM = 200 << 10      # S1's shared memory a block, at most


@dataclass
class DeviceBlockSparseAnno:
    entries: np.ndarray     # (R+1, tau) uint32 label ids; num_labels = pad
    dmap: np.ndarray        # (R+1,) int32 index into dense8 (0 = sparse row)
    dense8: np.ndarray      # (Rd+1, L) int8 expanded overflow patterns
    tau: int
    num_labels: int

    @property
    def num_rows(self) -> int:
        return self.entries.shape[0] - 1

    @classmethod
    def from_matrix(cls, matrix, R: int | None = None, tau: int | None = None,
                    chunk: int = 1 << 15,
                    max_dense_bytes: int | None = None):
        """Any host matrix with get_rows_mask / get_rows_words -> the
        structure, row chunk by row chunk.  ``tau`` None takes the 90th
        percentile of the first 16,384 rows' label counts, clipped to
        [4, 16].  None when the overflow patterns would pass
        ``max_dense_bytes``."""
        L = matrix.num_labels
        Rm = matrix.num_rows
        R = Rm if R is None else R
        Lw = max(-(-L // 32), 1)
        chunk = int(min(chunk, max((256 << 20) // (Lw * 4), 1024)))
        w0 = np.zeros((0, Lw), np.uint32)
        if tau is None:
            w0 = rows_words(matrix, np.arange(min(Rm, 1 << 14)), Lw)
            nl0 = _popcount_rows(w0)
            tau = int(np.clip(np.percentile(nl0, 90) if len(nl0) else 8,
                              4, 16))
            # the sample's own overflow patterns may already pass the
            # budget: then so do all the rows' (they only add patterns)
            if max_dense_bytes is not None and R >= Rm and len(np.unique(
                    w0[nl0 > tau], axis=0)) * L > max_dense_bytes:
                return None
        ids = np.full((R + 1, tau), L, np.uint32)
        dmap = np.zeros(R + 1, np.int32)
        dense_rows = []                      # distinct overflow patterns
        dense_pat = {}                       # pattern bytes -> slot
        bitpos = np.arange(32, dtype=np.uint32)
        for lo in range(0, min(R, Rm), chunk):
            hi = min(lo + chunk, Rm)
            n0 = max(min(hi, len(w0)), lo)   # the sample's rows, not
            words = w0[lo:n0]                # decoded again
            if n0 < hi:
                rest = rows_words(matrix, np.arange(n0, hi), Lw)
                words = np.concatenate([words, rest]) if n0 > lo else rest
            nl = _popcount_rows(words)
            sparse = nl <= tau
            si = np.flatnonzero(sparse & (nl > 0))
            if len(si):
                rr, ww = np.nonzero(words[si] != 0)
                labs = (words[si][rr, ww][:, None] >> bitpos) & 1
                eb, bb = np.nonzero(labs)
                lab_ids = (ww[eb] * 32 + bb).astype(np.uint32)
                owner = rr[eb]
                # slot within each row = running count per owner
                slot = np.zeros(len(owner), np.int64)
                if len(owner):
                    first = np.concatenate(
                        [[True], owner[1:] != owner[:-1]])
                    idxs = np.arange(len(owner))
                    slot = idxs - np.maximum.accumulate(
                        np.where(first, idxs, 0))
                ids[lo + si[owner] + 1, slot] = lab_ids
            di = np.flatnonzero(~sparse)
            if len(di):
                upat, inv = np.unique(words[di], axis=0,
                                      return_inverse=True)
                slots = np.array([_pattern_slot(dense_pat, dense_rows, p)
                                  for p in upat], np.int32)
                dmap[lo + di + 1] = slots[inv.reshape(-1)]
            if max_dense_bytes is not None \
                    and len(dense_rows) * L > max_dense_bytes:
                return None
        return cls(ids, dmap, _dense8(dense_rows, L), tau, L)

    @classmethod
    def from_columns(cls, columns, num_rows: int, num_labels: int,
                     tau: int | None = None,
                     max_dense_bytes: int | None = None):
        """Per-label sorted row arrays -> the structure, by one sort of the
        (row, label) pairs (``transform_anno --anno-type devsparse``)."""
        L, R = num_labels, num_rows
        prs, pcs = [], []
        for i, c in enumerate(columns):
            c = np.asarray(c, dtype=np.int64)
            prs.append(c)
            pcs.append(np.full(len(c), i, np.int64))
        pr = np.concatenate(prs) if prs else np.zeros(0, np.int64)
        pc = np.concatenate(pcs) if pcs else np.zeros(0, np.int64)
        del prs, pcs
        order = np.argsort(pr, kind="stable")
        pr, pc = pr[order], pc[order]
        nl = np.bincount(pr, minlength=R)
        if tau is None:
            nz = nl[nl > 0]
            tau = int(np.clip(np.percentile(nz, 90) if len(nz) else 8,
                              4, 16))
        ids = np.full((R + 1, tau), L, np.uint32)
        dmap = np.zeros(R + 1, np.int32)
        starts = np.concatenate([[0], np.cumsum(nl)])
        sparse_row = nl <= tau
        sp_pair = sparse_row[pr]
        slot = np.arange(len(pr)) - starts[pr]
        ids[pr[sp_pair] + 1, slot[sp_pair]] = pc[sp_pair].astype(np.uint32)
        dense_rows_idx = np.flatnonzero(~sparse_row)
        dense_rows, dense_pat = [], {}
        Lw = max(-(-L // 32), 1)
        DCH = max(1, (256 << 20) // (Lw * 4))
        for d0 in range(0, len(dense_rows_idx), DCH):
            dr = dense_rows_idx[d0: d0 + DCH]
            words = np.zeros((len(dr), Lw), np.uint32)
            n = nl[dr]
            local = np.repeat(np.arange(len(dr)), n)
            labs = pc[np.repeat(starts[dr] - np.cumsum(n) + n, n)
                      + np.arange(n.sum())]
            np.bitwise_or.at(
                words, (local, labs // 32),
                (np.uint32(1) << (labs % 32).astype(np.uint32)))
            upat, inv = np.unique(words, axis=0, return_inverse=True)
            slots = np.array([_pattern_slot(dense_pat, dense_rows, p)
                              for p in upat], np.int32)
            dmap[dr + 1] = slots[inv.reshape(-1)]
            if max_dense_bytes is not None \
                    and len(dense_rows) * L > max_dense_bytes:
                return None
        return cls(ids, dmap, _dense8(dense_rows, L), tau, L)

    def save(self, path: str):
        np.savez_compressed(path, entries=self.entries, dmap=self.dmap,
                            dense8=self.dense8, tau=self.tau,
                            num_labels=self.num_labels)

    @classmethod
    def load(cls, path: str) -> "DeviceBlockSparseAnno":
        with np.load(path) as z:
            return cls(z["entries"], z["dmap"], z["dense8"], int(z["tau"]),
                       int(z["num_labels"]))


def check_block_sparse(sp: DeviceBlockSparseAnno, num_labels: int):
    """Raise ValueError unless ``sp`` fits ``num_labels`` labels: the
    shapes and types, every label id at most the sentinel L and every
    ``dmap`` slot a row of ``dense8``, which kernel S1 indexes with them."""
    L = num_labels
    e, d, p = sp.entries, sp.dmap, sp.dense8
    if sp.num_labels != L or e.dtype != np.uint32 or e.ndim != 2 \
            or not np.issubdtype(d.dtype, np.integer) \
            or d.shape != (e.shape[0],) \
            or p.ndim != 2 or p.shape[1] != L:
        raise ValueError(f"block-sparse annotation {e.shape} does not fit "
                         f"{L} labels")
    if e.size and int(e.max()) > L:
        raise ValueError(f"block-sparse label id {int(e.max())} past {L}")
    if d.size and not (0 <= int(d.min()) and int(d.max()) < p.shape[0]):
        raise ValueError(f"block-sparse dmap slots [{int(d.min())}, "
                         f"{int(d.max())}] outside {p.shape[0]} patterns")


def rows_words(matrix, rows, Lw):
    """(n, Lw) uint32 packed rows of a host matrix: its packed interface
    when it has one (RowDiff's ``get_rows_words``), else packbits over
    ``get_rows_mask`` (the bool mask is 8x the bytes)."""
    if hasattr(matrix, "get_rows_words"):
        w = np.asarray(matrix.get_rows_words(rows))
        if w.shape[1] < Lw:
            w = np.concatenate(
                [w, np.zeros((len(w), Lw - w.shape[1]), np.uint32)], axis=1)
        return w
    mask = np.asarray(matrix.get_rows_mask(rows), dtype=bool)
    pad = Lw * 32 - mask.shape[1]
    if pad:
        mask = np.concatenate([mask, np.zeros((len(mask), pad), bool)],
                              axis=1)
    return np.packbits(mask.reshape(len(mask), Lw, 32), axis=2,
                       bitorder="little").view(np.uint32)[:, :, 0]


def _pattern_slot(dense_pat: dict, dense_rows: list, pattern) -> int:
    """The slot (1-based) of an overflow pattern, new ones appended."""
    key = pattern.tobytes()
    slot = dense_pat.get(key)
    if slot is None:
        slot = dense_pat[key] = len(dense_rows) + 1
        dense_rows.append(pattern)
    return slot


def _dense8(dense_rows, L):
    """Packed overflow patterns -> (Rd+1, L) int8 with a zero row 0."""
    if not dense_rows:
        return np.zeros((1, L), np.int8)
    bits = np.unpackbits(np.stack(dense_rows).view(np.uint8), axis=1,
                         bitorder="little")[:, :L]
    return np.concatenate([np.zeros((1, L), np.uint8), bits],
                          axis=0).astype(np.int8)


def _popcount_rows(words: np.ndarray) -> np.ndarray:
    """Total set bits per row of a (n, Lw) uint32 matrix."""
    return np.unpackbits(words.view(np.uint8), axis=1).sum(axis=1)


@dataclass
class SparseOnDevice:
    """A DeviceBlockSparseAnno's arrays as tensors: ``record`` (R+1, W)
    int32 row records (``row_records``), which kernel S1 reads; ``entries``
    (R+1, tau) int32 bit patterns of the uint32 label ids and ``dmap``
    (R+1,) int32 are views of it; ``dense8`` (Rd+1, L) int8."""
    entries: torch.Tensor
    dmap: torch.Tensor
    dense8: torch.Tensor
    num_labels: int
    record: torch.Tensor

    @classmethod
    def from_host(cls, sp: DeviceBlockSparseAnno, device) -> "SparseOnDevice":
        record = row_records(
            np_words(sp.entries),
            torch.from_numpy(np.require(sp.dmap, np.int32, ["C", "W"]))
        ).to(device)
        tau = sp.entries.shape[1]
        return cls(record[:, :tau], record[:, tau],
                   torch.from_numpy(np.require(
                       sp.dense8, np.int8, ["C", "W"])).to(device),
                   sp.num_labels, record)


def row_records(entries: torch.Tensor, dmap: torch.Tensor) -> torch.Tensor:
    """(R+1, tau) label ids and (R+1,) pattern slots (int32) -> the (R+1, W)
    int32 row records that kernel S1 reads: W = 8 ceil((tau + 1) / 8)
    words, the tau label ids, then the slot, then zeros, so that a row of
    tau <= 7 is one 32-byte sector (the ids and the slot apart are two)."""
    n, tau = entries.shape
    rec = torch.zeros((n, 8 * -(-(tau + 1) // 8)), dtype=torch.int32,
                      device=entries.device)
    rec[:, :tau] = entries
    rec[:, tau] = dmap
    return rec


def _record_of(entries: torch.Tensor, dmap: torch.Tensor):
    """The row records that ``entries`` and ``dmap`` are views of, as
    SparseOnDevice holds them, or None."""
    tau, W = entries.shape[1], entries.stride(0)
    if entries.stride(1) == 1 and W % 8 == 0 and W > tau \
            and dmap.stride(0) == W \
            and dmap.data_ptr() == entries.data_ptr() + 4 * tau \
            and entries.data_ptr() % 32 == 0:
        return entries.as_strided((entries.shape[0], W), (W, 1))
    return None


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def sparse_label_counts_plain(nodes, tile_seq, entries, dmap, counts,
                              present, mult, seq_lo: int = 0,
                              offset: int = 0, chunk: int = 64):
    """Plain version of S1, ``chunk`` tiles at a time, in int64."""
    S, L = counts.shape
    P = mult.shape[1]
    dev = nodes.device
    c64 = torch.zeros(S * (L + 1), dtype=torch.int64, device=dev)
    p64 = torch.zeros(S, dtype=torch.int64, device=dev)
    m64 = torch.zeros(mult.numel(), dtype=torch.int64, device=dev)
    T = nodes.shape[1]
    for lo in range(0, nodes.shape[0], chunk):
        ids = nodes[lo: lo + chunk].long().reshape(-1)
        if offset:
            ids = torch.where(ids > offset, ids - offset, ids)
        seq = tile_seq[lo: lo + chunk].long().repeat_interleave(T)
        p64.index_add_(0, seq, (ids > 0).long())
        key = seq[:, None] * (L + 1) + to_u64(entries[ids])
        c64.index_add_(0, key.reshape(-1), torch.ones_like(key.reshape(-1)))
        d = dmap[ids].long()
        keep = d > 0
        mkey = (seq[keep] - seq_lo) * P + d[keep]
        m64.index_add_(0, mkey, torch.ones_like(mkey))
    counts += c64.view(S, L + 1)[:, :L].to(torch.int32)
    present += p64.to(torch.int32)
    mult += m64.view(mult.shape).to(torch.int32)


def overflow_counts_plain(counts, mult, dense8, seq_lo: int = 0):
    """Plain version of S2: the non-zero multiplicities times their
    patterns, summed in int64, 4,096 pairs at a time."""
    chunk = 1 << 12
    nz = mult.nonzero()
    rows, at = torch.unique(nz[:, 0], return_inverse=True)
    add = torch.zeros((len(rows), counts.shape[1]), dtype=torch.int64,
                      device=counts.device)
    for lo in range(0, nz.shape[0], chunk):
        s, d = nz[lo: lo + chunk, 0], nz[lo: lo + chunk, 1]
        add.index_add_(0, at[lo: lo + chunk],
                       mult[s, d].long()[:, None] * dense8[d].long())
    counts[seq_lo + rows] += add.to(torch.int32)


def sparse_counts_plain(anno: SparseOnDevice, nodes, tile_seq,
                        num_seqs: int, offset: int = 0):
    """Plain version of ``sparse_count_epoch``: S1's and S2's plain
    versions over all sequences at once."""
    dev = nodes.device
    counts = torch.zeros((num_seqs, anno.num_labels), dtype=torch.int32,
                         device=dev)
    present = torch.zeros(num_seqs, dtype=torch.int32, device=dev)
    mult = torch.zeros((num_seqs, anno.dense8.shape[0]), dtype=torch.int32,
                       device=dev)
    sparse_label_counts_plain(nodes, tile_seq, anno.entries, anno.dmap,
                              counts, present, mult, offset=offset)
    overflow_counts_plain(counts, mult, anno.dense8)
    return counts, present


# --------------------------------------------------------------------------
# kernels S1 and S2
# --------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _check(dev, dtype, contiguous=True, **tensors):
    for name, t in tensors.items():
        if t.dtype != dtype or t.device != dev \
                or contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be a {'contiguous ' * contiguous}"
                             f"{dtype} tensor on {dev}")


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(
        _device_index(dev)).multi_processor_count


@dataclass(frozen=True)
class LabelCountPlan:
    """Kernel S1's tally a block: ``threads`` windows a step, each bringing
    at most ``tau`` + 1 keys (``step_keys`` a step).  Dense (``hashed``
    False): ``slots`` = L + P counts indexed by key.  Hashed: a table of
    ``slots`` (a power of two) keys and counts, flushed before a step could
    take it past 3/4 full.  ``smem``: dynamic shared memory bytes (counts,
    keys when hashed, and a uint16 list of the slots in use)."""
    threads: int
    hashed: bool
    slots: int
    step_keys: int
    smem: int


def label_count_plan(T: int, tau: int, L: int, P: int) -> LabelCountPlan:
    """S1's plan for tiles of T windows, rows of tau label ids, L labels
    and P pattern slots: dense when L + P <= DENSE_BINS, else hashed with
    the most threads (a multiple of 32, at most min(T, S1_THREADS)) whose
    table fits S1_SMEM."""
    if T < 32 or T % 32 or tau < 1 or L < 0 or P < 1:
        raise ValueError(f"bad S1 plan: T {T}, tau {tau}, L {L}, P {P}")
    threads = min(T, S1_THREADS)
    if L + P <= DENSE_BINS:
        return LabelCountPlan(threads, False, L + P, threads * (tau + 1),
                              (L + P) * 6)
    while threads >= 32:
        step = threads * (tau + 1)
        slots = 1 << (-(-step * 4 // 3) - 1).bit_length()
        if slots * 10 <= S1_SMEM:
            return LabelCountPlan(threads, True, slots, step, slots * 10)
        threads -= 32
    raise ValueError(f"S1 cannot tally rows of {tau} label ids in "
                     f"{S1_SMEM} bytes")


@functools.lru_cache(maxsize=32)
def _s1_blocks_per_sm(hashed: bool, threads: int, smem: int,
                      device_index: int) -> int:
    fn = _build.function("sparse_counts", "mg_sparse_label_counts_occupancy",
                         [_I, _I, _I, ctypes.POINTER(ctypes.c_int32)])
    blocks = ctypes.c_int32(0)
    with torch.cuda.device(device_index):
        _build.check(fn(int(hashed), threads, smem, ctypes.byref(blocks)),
                     "sparse_label_counts occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"sparse_label_counts: no block of {threads} "
                           f"threads and {smem} B fits an SM")
    return blocks.value


def sparse_label_counts(nodes, tile_seq, entries, dmap, counts, present,
                        mult, seq_lo: int = 0, offset: int = 0):
    """S1.  (N, T) int32 node ids (0 = miss; with canon 2's ``offset`` > 0
    ids above it fold to id - offset), (N,) tile_seq, (R+1, tau) entries,
    (R+1,) dmap -> adds into (S, L) counts, (S,) present and, at row
    seq - ``seq_lo``, the (rows, Rd+1) multiplicities ``mult`` (all int32).
    The kernel drops the windows of sequences outside [seq_lo, seq_lo +
    rows), label ids past L and slots past Rd; the plain version raises on
    them.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/sparse_counts.cu`` or raise.  On the card ``entries`` and
    ``dmap`` must be the views of row records that a SparseOnDevice holds
    (``row_records``): the kernel reads a window's record whole."""
    dev = nodes.device
    _check(dev, torch.int32, nodes=nodes, tile_seq=tile_seq, counts=counts,
           present=present, mult=mult)
    _check(dev, torch.int32, False, entries=entries, dmap=dmap)
    N, T = nodes.shape
    S, L = counts.shape
    if T % 32 or tile_seq.shape != (N,) or entries.ndim != 2 \
            or dmap.shape != (entries.shape[0],) or present.shape != (S,) \
            or mult.ndim != 2 or not 0 <= seq_lo <= S - mult.shape[0]:
        raise ValueError(f"bad shapes: nodes {tuple(nodes.shape)} entries "
                         f"{tuple(entries.shape)} counts {tuple(counts.shape)}"
                         f" mult {tuple(mult.shape)} at {seq_lo}")
    if not 0 <= offset < 2 ** 31:
        raise ValueError(f"offset {offset} out of range")
    if dev.type == "cpu":
        return sparse_label_counts_plain(nodes, tile_seq, entries, dmap,
                                         counts, present, mult, seq_lo,
                                         offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if N == 0:
        return
    tau, P = entries.shape[1], mult.shape[1]
    if L + P >= 2 ** 31 - 1:
        raise ValueError(f"{L} labels and {P} patterns pass S1's keys")
    plan = label_count_plan(T, tau, L, P)
    grid = min(N, _sms(dev) * _s1_blocks_per_sm(
        plan.hashed, plan.threads, plan.smem, _device_index(dev)))
    rec = _record_of(entries, dmap)
    if rec is None:
        raise ValueError("on the card, entries and dmap must be views of "
                         "row records (SparseOnDevice, row_records)")
    fn = _build.function("sparse_counts", "mg_sparse_label_counts",
                         [_P, _L, _I, _P, _P, _L, _I, _I, _P, _I, _P, _P, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])
    _build.check(fn(nodes.data_ptr(), N, T, tile_seq.data_ptr(),
                    rec.data_ptr(), rec.shape[0], rec.shape[1], tau,
                    counts.data_ptr(), L, present.data_ptr(),
                    mult.data_ptr(), P, seq_lo, seq_lo + mult.shape[0],
                    offset, int(plan.hashed), plan.slots, plan.step_keys,
                    plan.threads, plan.smem, grid,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "sparse_label_counts")
    _build.count(sparse_label_counts)


sparse_label_counts.launches = 0


def overflow_counts(counts, mult, dense8, seq_lo: int = 0):
    """S2.  counts[seq_lo + s, l] += sum_d mult[s, d] * dense8[d, l], in
    int32, in place: (S, L) counts, (rows, Rd+1) int32 mult, (Rd+1, L) int8
    dense8.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/sparse_counts.cu`` or raise."""
    dev = counts.device
    _check(dev, torch.int32, counts=counts, mult=mult)
    _check(dev, torch.int8, dense8=dense8)
    S, L = counts.shape
    rows, P = mult.shape
    if dense8.shape != (P, L) or not 0 <= seq_lo <= S - rows:
        raise ValueError(f"bad shapes: counts {tuple(counts.shape)} mult "
                         f"{tuple(mult.shape)} at {seq_lo} dense8 "
                         f"{tuple(dense8.shape)}")
    if dev.type == "cpu":
        return overflow_counts_plain(counts, mult, dense8, seq_lo)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if rows == 0:
        return
    fn = _build.function("sparse_counts", "mg_overflow_counts",
                         [_P, _I, _P, _L, _I, _P, _L, _I, _I, _P])
    vec = L % 16 == 0 and counts.data_ptr() % 16 == 0 \
        and dense8.data_ptr() % 16 == 0
    # a warp a row, 8 warps a block, at most 8 blocks an SM
    grid = min(-(-rows // 8), 8 * _sms(dev))
    _build.check(fn(counts.data_ptr(), L, mult.data_ptr(), rows, P,
                    dense8.data_ptr(), seq_lo, int(vec), grid,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "overflow_counts")
    _build.count(overflow_counts)


overflow_counts.launches = 0


def sparse_count_epoch(anno: SparseOnDevice, nodes: torch.Tensor,
                       tile_seq: torch.Tensor, num_seqs: int,
                       offset: int = 0):
    """(N, T) node ids (or annotation rows + 1), (N,) tile_seq -> ((S, L)
    int32 counts, (S,) int32 present) on the block-sparse annotation: S1,
    then S2 where there are overflow patterns, a chunk of sequences at a
    time so that the multiplicities stay within MULT_BYTES."""
    dev = nodes.device
    L, P = anno.num_labels, anno.dense8.shape[0]
    counts = torch.zeros((num_seqs, L), dtype=torch.int32, device=dev)
    present = torch.zeros(num_seqs, dtype=torch.int32, device=dev)
    step = max(1, MULT_BYTES // (4 * P))
    bounds = list(range(0, num_seqs, step)) + [num_seqs]
    tiles = torch.searchsorted(
        tile_seq, torch.tensor(bounds, dtype=torch.int32, device=dev)).tolist()
    for s0, s1, t0, t1 in zip(bounds, bounds[1:], tiles, tiles[1:]):
        mult = torch.zeros((s1 - s0, P), dtype=torch.int32, device=dev)
        sparse_label_counts(nodes[t0:t1], tile_seq[t0:t1], anno.entries,
                            anno.dmap, counts, present, mult, s0, offset)
        if P > 1:
            overflow_counts(counts, mult, anno.dense8, s0)
    return counts, present
