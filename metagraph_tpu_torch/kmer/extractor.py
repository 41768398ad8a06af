"""K-mer extraction: the query's host window encoding and the host
construction's collectors.

Own copy of metagraph_tpu/kmer/extractor.py: the per-alphabet encode
table (``KmerExtractor.__init__``/``encode``), the complement table
extended to the invalid code (``extended_complement_table``),
``_rows_greater``, and the collectors of the host construction:
``_packed_windows`` (:126-172) in the "basic" and "both" modes with
window weights, ``extract`` (:96-124) with counts and ``extract_disk``
(:175-212).  The windows are packed and sorted on ``device`` (the card
unless "cpu"; ``packing.lexsort_rows``); ``extract_tensors`` leaves its
results there for the construction.  ``distinct_kmers`` and
``extract_codes`` give the distinct k-mers in left-to-right code order,
without counts, from which the sshash graph rebuilds.
"""

from __future__ import annotations

import numpy as np
import torch

from . import packing
from .alphabets import DNA, Alphabet, dna_encode_table
from .packing import bits_for_alphabet

# the catch-all character that unknown bytes encode to, per alphabet
_CATCH_ALL = {"DNA5": "N", "DNA_CASE": "N", "Protein": "X"}


class KmerExtractor:
    def __init__(self, alphabet: Alphabet = DNA):
        self.alphabet = alphabet
        if alphabet.name == "DNA":
            enc = dna_encode_table()
        else:
            enc = alphabet.encode_table
            catch = _CATCH_ALL.get(alphabet.name)
            if catch is not None:
                enc[enc == alphabet.sigma] = enc[ord(catch)]
            if alphabet.name == "DNA5":
                enc[ord("U")] = enc[ord("u")] = enc[ord("T")]
            elif alphabet.name == "DNA_CASE":
                enc[ord("U")], enc[ord("u")] = enc[ord("T")], enc[ord("t")]
        self._enc = enc
        self.invalid = alphabet.sigma
        self.bits = bits_for_alphabet(alphabet.sigma)

    def encode(self, seq: bytes | str) -> np.ndarray:
        if isinstance(seq, str):
            seq = seq.encode()
        return self._enc[np.frombuffer(seq, dtype=np.uint8)]

    def extended_complement_table(self) -> np.ndarray:
        """The complement map with the invalid code mapping to itself."""
        return np.concatenate(
            [self.alphabet.complement_table,
             np.arange(self.alphabet.sigma, self.invalid + 1)]).astype(
                 np.uint8)

    def _concat_codes(self, seqs) -> np.ndarray:
        """The encoded sequences, each followed by the invalid code."""
        sep = np.array([self.invalid], dtype=np.uint8)
        parts = [p for s in seqs for p in (self.encode(s), sep)]
        return np.concatenate(parts) if parts else sep[:0]

    # ------------------------------------------------------------------
    # the sshash graph's k-mer sets
    # ------------------------------------------------------------------

    def distinct_kmers(self, seqs, K: int, mode: str = "basic"):
        """The distinct valid k-mers of ``seqs`` -> (N, K) uint8 codes,
        sorted (codes compared left to right).  ``mode``: 'basic' (forward
        windows) or 'both' (both strands, as a canonical graph holds
        them)."""
        return self.extract_codes(self._concat_codes(seqs), K, mode)

    def extract_codes(self, codes: np.ndarray, K: int,
                      mode: str = "basic") -> np.ndarray:
        """``distinct_kmers`` of encoded sequences, each followed by the
        invalid code."""
        if mode not in ("basic", "both"):
            raise ValueError(f"unknown mode {mode!r}")
        if len(codes) < K:
            return np.zeros((0, K), dtype=np.uint8)
        bad = np.concatenate([[0], np.cumsum(codes >= self.invalid)])
        valid = (bad[K:] - bad[:-K]) == 0
        wins = np.lib.stride_tricks.sliding_window_view(codes, K)[valid]
        if mode == "both":
            # the reverse complement of window j is window n-K-j of the
            # reverse-complemented codes
            rc = np.lib.stride_tricks.sliding_window_view(
                self.extended_complement_table()[codes[::-1]], K)[::-1][valid]
            wins = np.concatenate([wins, rc])
        wins = np.ascontiguousarray(wins)
        if not len(wins):
            return wins
        uniq = np.unique(wins.view(f"V{K}").ravel())
        return np.frombuffer(uniq.tobytes(), np.uint8).reshape(-1, K)

    # ------------------------------------------------------------------
    # the host construction's collectors (extractor.py:96-212)
    # ------------------------------------------------------------------

    def _words(self, K: int) -> int:
        per = 64 // self.bits
        return (K + per - 1) // per

    def _packed_windows(self, seqs, K: int, mode: str, window_weights=None,
                        device=None):
        """Every valid window of ``seqs`` (and, in mode 'both', its reverse
        complement after them) as a packed BOSS-order key on ``device`` ->
        ((n, W) int64 bit patterns, (n,) int64 weights or None).  The
        weights: ``window_weights[i][j]`` for window j of sequence i, in
        the JAX package's alignment (a separator slot after each
        sequence; its error where a sequence has fewer weights than
        windows), doubled in mode 'both'."""
        from ..device import resolve_device
        if mode not in ("basic", "both"):
            raise ValueError(f"unknown mode {mode!r}")
        dev = resolve_device(device)
        codes = self._concat_codes(seqs)
        n = len(codes) - K + 1
        bad = np.concatenate([[0], np.cumsum(codes >= self.invalid)])
        valid = (bad[K:] - bad[:-K]) == 0 if n > 0 else np.zeros(0, bool)
        if not valid.any():
            return (torch.zeros((0, self._words(K)), dtype=torch.int64,
                                device=dev),
                    None if window_weights is None else
                    torch.zeros(0, dtype=torch.int64, device=dev))
        weights = None
        if window_weights is not None:
            w_all = np.zeros(n, dtype=np.uint64)
            off = 0
            for s, w in zip(seqs, window_weights):
                L = len(s)
                nwin = max(L - K + 1, 0)
                if nwin:
                    w_all[off: off + nwin] = np.asarray(w[:nwin],
                                                        dtype=np.uint64)
                off += L + 1
            weights = packing.to_device(w_all[valid][:, None], dev)[:, 0]
        codes_t = torch.from_numpy(codes).to(dev)
        at = torch.from_numpy(np.flatnonzero(valid)).to(dev)
        order = packing.boss_priority_order(K)
        packed = packing.pack_rows(lambda j: codes_t[at + j], order,
                                   self.bits)
        if mode == "both":
            comp = torch.from_numpy(self.extended_complement_table()).to(dev)
            rc = packing.pack_rows(
                lambda j: comp[codes_t[at + (K - 1 - j)].long()], order,
                self.bits)
            packed = torch.cat([packed, rc])
            if weights is not None:
                weights = torch.cat([weights, weights])
        return packed, weights

    def extract_tensors(self, seqs, K: int, mode: str = "basic",
                        with_counts: bool = False, window_weights=None,
                        device=None):
        """``extract`` with its results left on ``device``: -> ((N, K)
        uint8 codes, (N,) int64 counts (uint64 bit patterns) or None)."""
        packed, weights = self._packed_windows(seqs, K, mode, window_weights,
                                               device)
        if with_counts and weights is None:
            weights = torch.ones(packed.shape[0], dtype=torch.int64,
                                 device=packed.device)
        upacked, counts = packing.unique_rows(
            packed, weights if with_counts else None)
        return packing.unpack_rows(upacked, K, packing.boss_priority_order(K),
                                   self.bits), counts

    def extract(self, seqs, K: int, mode: str = "basic",
                with_counts: bool = False, window_weights=None, device=None):
        """The distinct valid k-mers of ``seqs`` -> ((N, K) uint8 codes in
        BOSS order, their uint64 multiplicities (summed window weights
        where given) or None).  ``mode``: 'basic' (forward windows) or
        'both' (both strands)."""
        chars, counts = self.extract_tensors(seqs, K, mode, with_counts,
                                             window_weights, device)
        return chars.cpu().numpy(), \
            None if counts is None else packing.to_host(counts)

    def extract_disk(self, seqs, K: int, mode: str = "basic",
                     with_counts: bool = False, window_weights=None,
                     ram_cap_bytes: int = 1 << 28, tmp_dir: str | None = None,
                     batch_bp: int = 1 << 24, device=None):
        """Bounded-RAM ``extract``: sequence batches go into a
        ``SortedSetDisk``, which spills sorted chunks under ``tmp_dir`` and
        k-way merges them.  A batch ends at ``batch_bp`` bp, as in the JAX
        package, or where its windows' keys (and counts) fill
        ``ram_cap_bytes``, so that each batch spills a chunk.  -> the same
        (codes, counts) as ``extract``."""
        from ..utils.timer import trace
        from .disk_sort import SortedSetDisk
        row = (8 * self._words(K) + (8 if with_counts else 0)) \
            * (2 if mode == "both" else 1)
        sink = SortedSetDisk(ram_cap_bytes=ram_cap_bytes, tmp_dir=tmp_dir,
                             with_counts=with_counts, device=device)
        try:
            batch, bp, nbytes, woff = [], 0, 0, 0
            ww = window_weights

            def flush(batch, woff):
                w = ww[woff: woff + len(batch)] if ww is not None else None
                packed, weights = self._packed_windows(batch, K, mode, w,
                                                       device)
                if len(packed):
                    sink.insert(packing.to_host(packed),
                                packing.to_host(weights)
                                if with_counts and weights is not None
                                else None)

            for s in seqs:
                batch.append(s)
                bp += len(s)
                nbytes += max(len(s) - K + 1, 0) * row
                if bp >= batch_bp or nbytes >= sink.ram_cap:
                    flush(batch, woff)
                    woff += len(batch)
                    batch, bp, nbytes = [], 0, 0
            if batch:
                flush(batch, woff)
            upacked, counts = sink.merge_all()
            trace(f"disk sort: {sink.num_chunks} chunks spilled, "
                  f"{sink.spilled_bytes} B")
        finally:
            sink.cleanup()
        if upacked.shape[0] == 0:
            return (np.zeros((0, K), dtype=np.uint8),
                    np.zeros(0, np.uint64) if with_counts else None)
        return packing.unpack_codes(upacked, K, packing.boss_priority_order(K),
                                    bits=self.bits), counts


def _rows_greater(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic a > b per row over the trailing word axis."""
    return packing.rows_lex_gt(a, b)
