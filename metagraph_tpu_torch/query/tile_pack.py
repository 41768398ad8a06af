"""Encode, tile and 2-bit pack a query batch for the device.

A vectorised numpy copy of what metagraph_tpu's native ``tile_pack2``
returns (metagraph_tpu/native/__init__.py:285-314, native/fastio.cpp:878),
byte for byte.  Each sequence is cut into tiles of T windows, TK = T+K-1
characters with a K-1 overlap.  Per tile row:

* ``packed2``: TKp/4 bytes of 2-bit codes (A=0 C=1 G=2 T/U=3; position j at
  bits 2*(j%4) of byte j//4), TKp = TK rounded up to a multiple of 4;
  positions past the sequence end or holding an invalid byte are 0;
* ``validb``: ceil(TK/8) bytes, bit j (little-endian) set iff position j
  holds a valid character inside the sequence;
* ``tile_seq``: the owning sequence.
"""

from __future__ import annotations

import numpy as np

from ..kmer.alphabets import SIGMA, dna_encode_table

_CHUNK = 1 << 14      # tile rows packed per numpy pass


def tile_pack2(seqs, K: int, T: int):
    """-> (packed2 (N, TKp/4) uint8, validb (N, ceil(TK/8)) uint8,
    tile_seq (N,) int32, nwins list)."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    nwins = np.maximum(lens - K + 1, 0)
    ntiles = -(-nwins // T)
    N = int(ntiles.sum())
    TK = T + K - 1
    TKp = (TK + 3) & ~3
    packed2 = np.zeros((N, TKp // 4), dtype=np.uint8)
    validb = np.zeros((N, (TK + 7) // 8), dtype=np.uint8)
    tile_seq = np.repeat(np.arange(len(seqs), dtype=np.int32), ntiles)
    if N == 0:
        return packed2, validb, tile_seq, nwins.tolist()
    table = dna_encode_table()
    valid_tab = ((table >= 1) & (table < SIGMA)).astype(np.uint8)
    code_tab = np.where(valid_tab == 1, table - 1, 0).astype(np.uint8)
    cat = np.frombuffer(b"".join(bytes(s) for s in seqs), dtype=np.uint8)
    codes, valid = code_tab[cat], valid_tab[cat]
    seq_start = np.concatenate([[0], np.cumsum(lens)])
    tile_base = np.concatenate([[0], np.cumsum(ntiles)])
    t_in_seq = np.arange(N, dtype=np.int64) - tile_base[tile_seq]
    starts = seq_start[tile_seq] + t_in_seq * T
    ends = seq_start[tile_seq.astype(np.int64) + 1]
    col = np.arange(TKp, dtype=np.int64)
    for lo in range(0, N, _CHUNK):
        hi = min(lo + _CHUNK, N)
        idx = starts[lo:hi, None] + col
        inside = (idx < ends[lo:hi, None]) & (col < TK)
        idx = np.minimum(idx, len(cat) - 1)
        c = np.where(inside, codes[idx], 0)
        packed2[lo:hi] = c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) \
            | (c[:, 3::4] << 6)
        v = np.where(inside, valid[idx], 0)[:, :TK]
        validb[lo:hi] = np.packbits(v, axis=1, bitorder="little")
    return packed2, validb, tile_seq, nwins.tolist()
