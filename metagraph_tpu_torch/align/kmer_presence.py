"""BIGSI-style scoring of k-mer presence masks, for the signature output.

Own copy of metagraph_tpu/align/kmer_presence.py.
"""

from __future__ import annotations

import numpy as np


def autocorrelate(bits: np.ndarray, offset: int = 3) -> np.ndarray:
    """out[i] = AND of bits[i : i+offset] (out-of-range treated as set)."""
    n = len(bits)
    if n < offset:
        return bits.copy()
    out = bits.astype(bool).copy()
    for j in range(1, offset):
        shifted = np.ones(n, dtype=bool)
        shifted[: n - j] = bits[j:]
        out &= shifted
    return out


def _tabulate_runs(bits: np.ndarray):
    """Run lengths per value with +1 correction on all runs but the last."""
    table = ([], [])
    n = len(bits)
    if n == 0:
        return table
    change = np.flatnonzero(bits[1:] != bits[:-1])
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [n]])
    for i, (s, e) in enumerate(zip(starts, ends)):
        corr = 1 if i + 1 < len(starts) else 0
        table[int(bits[s])].append(int(e - s) + corr)
    return table


def score_kmer_presence_mask(k: int, mask: np.ndarray,
                             match_score: int = 1,
                             mismatch_score: int = 2) -> int:
    mask = np.asarray(mask, dtype=bool)
    if mask.size == 0:
        return 0
    kmer_adjust = 3
    sequence_length = mask.size + k - 1
    snp_t = k + kmer_adjust

    zeros, ones = _tabulate_runs(autocorrelate(mask, kmer_adjust))
    score = float(sum(ones) * match_score)
    if score == 0:
        return 0
    if not zeros:
        return int(score * sequence_length / mask.size)
    for count in zeros:
        min_n = count / snp_t
        max_n = max(count - snp_t + 1, min_n)
        mean_n = max_n * 0.05 + min_n
        mean_penalty = mean_n * mismatch_score
        score += (count - mean_penalty) * match_score - mean_penalty
    return int(max(score * sequence_length / mask.size, 0.0))
