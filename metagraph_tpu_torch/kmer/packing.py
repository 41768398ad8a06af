"""The BOSS comparison order of k-mer characters, the key code width and
the uint64 row packing of the host construction.

Own copy of metagraph_tpu/kmer/packing.py: ``boss_priority_order``,
``colex_priority_order`` (:27-34), ``pack_codes`` (:37-66, numpy only:
the JAX package's native row packer gives the same words),
``unpack_codes``, ``rows_lex_lt``/``rows_lex_gt``, ``lexsort_rows``,
``sort_rows``, ``unique_rows`` (with count sums), ``searchsorted_rows``,
``rows_in``, ``rows_equal_adjacent``, ``reverse_complement`` (:70-196) and
``_void_view`` (:122-125).  A row is W uint64 words, 4 bits a code below
16 symbols, else 8, most significant first.

Every sort of the host construction goes through ``lexsort_rows``: the
rows go to ``device`` (the card unless "cpu") as int64 bit patterns and
kernel D2 (``succinct/device_build.radix_sort``) sorts them, one stable
64-bit pass set a word, the last word first, each carrying an int64
permutation; on the CPU its plain version does.  ``unique_rows`` dedupes
and sums counts where the rows were sorted, counts as int64 (sums wrap
mod 2^64, as numpy's uint64 sums do).  ``pack_rows``, ``unpack_rows`` and
``rows_in_sorted`` are the tensor forms that the construction runs on the
device; the JAX package's native ``pack_rows64``/``argsort_rows64`` have
no counterpart.  ``sort_rows``, ``searchsorted_rows``, ``rows_in``,
``rows_equal_adjacent`` and ``reverse_complement`` have no caller in the
construction, which uses the tensor forms: they complete the copy of the
JAX module's row helpers, and the parity tests hold each to its JAX
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch


def boss_priority_order(K: int) -> np.ndarray:
    """Column order (most significant first) of the BOSS edge-k-mer
    comparison: s[K-2], s[K-3], ..., s[0], then the edge label s[K-1]."""
    return np.array(list(range(K - 2, -1, -1)) + [K - 1], dtype=np.int64)


def colex_priority_order(K: int) -> np.ndarray:
    """Column order of the plain co-lex comparison (node strings)."""
    return np.arange(K - 1, -1, -1, dtype=np.int64)


def pack_codes(chars: np.ndarray, order: np.ndarray | None = None,
               bits: int = 4) -> np.ndarray:
    """(N, K) uint8 codes -> (N, W) uint64 words, ``bits`` bits a code,
    columns taken in ``order`` (most significant first; default left to
    right), word 0 most significant, the first code of a word in its top
    slot: comparing packed rows compares the code rows."""
    chars = np.asarray(chars)
    if chars.ndim == 1:
        chars = chars[None, :]
    if order is not None:
        chars = chars[:, order]
    N, K = chars.shape
    per = 64 // bits
    out = np.zeros((N, (K + per - 1) // per), dtype=np.uint64)
    for j in range(K):
        w, slot = divmod(j, per)
        out[:, w] |= chars[:, j].astype(np.uint64) \
            << np.uint64(64 - bits - bits * slot)
    return out


def unpack_codes(packed: np.ndarray, K: int, order: np.ndarray | None = None,
                 bits: int = 4) -> np.ndarray:
    """Inverse of ``pack_codes``: (N, W) uint64 -> (N, K) uint8 codes."""
    packed = np.asarray(packed, dtype=np.uint64)
    if packed.ndim == 1:
        packed = packed[None, :]
    per = 64 // bits
    mask = np.uint64((1 << bits) - 1)
    chars = np.empty((packed.shape[0], K), dtype=np.uint8)
    for j in range(K):
        w, slot = divmod(j, per)
        chars[:, j] = ((packed[:, w] >> np.uint64(64 - bits - bits * slot))
                       & mask).astype(np.uint8)
    if order is not None:
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        chars = chars[:, inv]
    return chars


def rows_lex_lt(a, b):
    """Lexicographic a < b over the trailing word axis; ``b`` broadcasts
    (one cut row or the same shape)."""
    lt = np.zeros(a.shape[:-1], dtype=bool)
    decided = np.zeros(a.shape[:-1], dtype=bool)
    for w in range(a.shape[-1]):
        aw, bw = a[..., w], b[..., w]
        lt = lt | (~decided & (aw < bw))
        decided = decided | (aw != bw)
    return lt


def rows_lex_gt(a, b):
    """Lexicographic a > b over the trailing word axis (see rows_lex_lt)."""
    gt = np.zeros(a.shape[:-1], dtype=bool)
    decided = np.zeros(a.shape[:-1], dtype=bool)
    for w in range(a.shape[-1]):
        aw, bw = a[..., w], b[..., w]
        gt = gt | (~decided & (aw > bw))
        decided = decided | (aw != bw)
    return gt


def bits_for_alphabet(alph_size: int) -> int:
    """Bits a packed key spends on a code: 4 when every code, the invalid
    one (== alph_size) included, fits a nibble, else 8."""
    return 4 if alph_size < 16 else 8


def _void_view(packed: np.ndarray) -> np.ndarray:
    """(N, W) uint64 rows as opaque keys that compare bytewise as the rows
    do."""
    be = np.ascontiguousarray(packed.astype(">u8"))
    return be.view(f"V{be.shape[1] * 8}").ravel()


# --------------------------------------------------------------------------
# rows on a device: int64 tensors holding the uint64 words' bit patterns
# --------------------------------------------------------------------------

def to_device(packed: np.ndarray, device=None) -> torch.Tensor:
    """(N, W) uint64 rows -> an int64 tensor of their bit patterns on
    ``device`` (the card unless "cpu")."""
    from ..device import resolve_device
    a = np.ascontiguousarray(packed, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(a.copy() if not a.flags.writeable else a).to(
        resolve_device(device))


def to_host(t: torch.Tensor) -> np.ndarray:
    """int64 bit patterns -> host uint64 words."""
    return t.cpu().contiguous().numpy().view(np.uint64)


def pack_rows(cols, order, bits: int) -> torch.Tensor:
    """``pack_codes`` on a device: ``cols(j)`` -> column j of the (N, K)
    codes (any integer dtype) -> (N, W) int64 words; a column is read once,
    so no (N, K) matrix need exist."""
    K = len(order)
    per = 64 // bits
    out = None
    for p, j in enumerate(order):
        w, slot = divmod(p, per)
        c = cols(int(j)).to(torch.int64) << (64 - bits - bits * slot)
        if out is None:
            out = torch.zeros((c.shape[0], (K + per - 1) // per),
                              dtype=torch.int64, device=c.device)
        out[:, w] |= c
    return out


def unpack_rows(words: torch.Tensor, K: int, order, bits: int):
    """``unpack_codes`` on a device: (N, W) int64 words -> (N, K) uint8."""
    per = 64 // bits
    mask = (1 << bits) - 1
    chars = torch.empty((words.shape[0], K), dtype=torch.uint8,
                        device=words.device)
    for p, j in enumerate(order):
        w, slot = divmod(p, per)
        chars[:, int(j)] = ((words[:, w] >> (64 - bits - bits * slot))
                            & mask).to(torch.uint8)
    return chars


def new_rows(s: torch.Tensor) -> torch.Tensor:
    """Sorted (N, W) rows -> (N,) bool: row i differs from row i - 1 (row
    0 always)."""
    new = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    if s.shape[0] > 1:
        new[1:] = (s[1:] != s[:-1]).any(dim=1)
    return new


def rows_in_sorted(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``rows_in`` of two sorted sets of distinct rows on a device: one
    stable sort of both (``a`` first, so an equal ``q`` row follows its
    ``a`` row) -> (len(q),) bool."""
    na = a.shape[0]
    both = torch.cat([a, q])
    perm = lexsort_rows(both)
    s = both.index_select(0, perm)
    hit = torch.zeros(both.shape[0], dtype=torch.bool, device=a.device)
    if both.shape[0] > 1:
        hit[1:] = (s[1:] == s[:-1]).all(dim=1) & (perm[:-1] < na)
    out = torch.zeros(both.shape[0], dtype=torch.bool, device=a.device)
    out[perm] = hit
    return out[na:]


# --------------------------------------------------------------------------
# sorts, dedupe and search (packing.py:128-196)
# --------------------------------------------------------------------------

def lexsort_rows(packed, device=None):
    """Stable argsort of (N, W) rows in lexicographic (word 0 first)
    order of their unsigned words.

    A numpy uint64 array goes to ``device`` (the card unless "cpu") and
    its permutation comes back as numpy int64; an int64 tensor of bit
    patterns is sorted where it lies and its permutation stays there.
    Kernel D2 sorts: one stable 64-bit pass set a word, the last word
    first, the permutation as its payload (its plain version for a CPU
    tensor)."""
    if isinstance(packed, np.ndarray):
        return lexsort_rows(to_device(packed, device)).cpu().numpy()
    from ..succinct.device_build import radix_sort
    N, W = packed.shape
    perm = torch.arange(N, dtype=torch.int64, device=packed.device)
    for w in range(W - 1, -1, -1):
        col = packed[:, w].contiguous() if w == W - 1 \
            else packed[:, w].index_select(0, perm)
        _, perm = radix_sort(col, 64, perm)
    return perm


def sort_rows(packed, device=None):
    """The rows in ``lexsort_rows`` order (no caller in the construction;
    see the module's docstring)."""
    return packed[lexsort_rows(packed, device)]


def unique_rows(packed, counts=None, device=None):
    """Sort and dedupe rows; with ``counts``, sum the counts of equal rows.
    -> (unique sorted rows, summed counts or None).

    numpy uint64 rows (and uint64 counts) are sorted and deduped on
    ``device`` (the card unless "cpu") and come back as numpy uint64;
    int64 tensors stay where they lie."""
    if isinstance(packed, np.ndarray):
        if packed.shape[0] == 0:
            return packed, (counts if counts is None else counts[:0])
        t = to_device(packed, device)
        c = None if counts is None else to_device(
            np.asarray(counts, dtype=np.uint64)[:, None], t.device)[:, 0]
        u, sums = unique_rows(t, c)
        return to_host(u), None if sums is None else to_host(sums)
    if packed.shape[0] == 0:
        return packed, (counts if counts is None else counts[:0])
    perm = lexsort_rows(packed)
    s = packed.index_select(0, perm)
    new = new_rows(s)
    if counts is None:
        return s[new], None
    starts = torch.nonzero(new).squeeze(1)
    csum = torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts.index_select(0, perm), 0)])
    ends = torch.cat([starts[1:], starts.new_full((1,), s.shape[0])])
    return s[new], csum[ends] - csum[starts]


def searchsorted_rows(sorted_packed: np.ndarray, query_packed: np.ndarray,
                      side: str = "left") -> np.ndarray:
    """``np.searchsorted`` over multiword row keys (``rows_in``'s)."""
    return np.searchsorted(_void_view(sorted_packed),
                           _void_view(query_packed), side=side)


def rows_in(sorted_packed: np.ndarray, query_packed: np.ndarray):
    """Membership of query rows in sorted unique rows (bool mask); no
    caller in the construction, which uses ``rows_in_sorted``."""
    if sorted_packed.shape[0] == 0:
        return np.zeros(query_packed.shape[0], dtype=bool)
    pos = searchsorted_rows(sorted_packed, query_packed, side="left")
    pos_c = np.minimum(pos, sorted_packed.shape[0] - 1)
    return (pos < sorted_packed.shape[0]) & np.all(
        sorted_packed[pos_c] == query_packed, axis=1)


def rows_equal_adjacent(packed: np.ndarray) -> np.ndarray:
    """For sorted rows: mask[i] = (row[i] == row[i+1]); the last False
    (no caller in the construction)."""
    out = np.zeros(packed.shape[0], dtype=bool)
    if packed.shape[0] > 1:
        np.all(packed[1:] == packed[:-1], axis=1, out=out[:-1])
    return out


def reverse_complement(chars: np.ndarray, complement_table: np.ndarray):
    """(N, K) codes -> their reverse complements (no caller in the
    construction)."""
    return complement_table[chars[:, ::-1]]
