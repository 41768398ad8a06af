"""The dense annotation bitmap on the device.

Own copy of metagraph_tpu/annotation/ops.py:26-36 (``pack_annotation_bitmap``)
plus a ``DeviceAnnotation`` that keeps plain ``(R, Lw)`` rows: bit ``c % 32``
of word ``c // 32`` of row r is set iff row r carries label c.  The JAX
package's row-packed layout (ops.py:39-80) served the TPU's gather unit and
is not copied.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._u32 import np_words


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


def gather_anno_rows(bitmap: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(..., ) row ids -> (..., Lw) annotation words."""
    return bitmap[rows]
