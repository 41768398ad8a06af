"""32-bit word helpers for the plain PyTorch versions of the kernels.

This PyTorch has no ``>>``, ``<<`` or ``%`` on ``torch.uint32``, so the plain
versions carry each word as int64 masked to its low 32 bits.  A product of
two such words fits int64 only up to 2^63, but a wrapped int64 product still
holds the right low 32 bits, which is all a 32-bit multiply keeps.  Device
tensors store words as int32 bit patterns (the kernels read them as
``uint32``); ``to_u64``/``to_i32`` convert between the two views.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def to_u64(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the uint32 value."""
    return t.to(torch.int64) & MASK32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 bit patterns."""
    t = t & MASK32
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for uint32 values held in int64."""
    return (a * c) & MASK32


def np_words(a: np.ndarray) -> torch.Tensor:
    """Host uint32 array -> int32 bit-pattern tensor (shares a writable
    contiguous array's memory, else copies)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32))


def words_np(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> host uint32 array."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
