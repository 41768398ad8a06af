"""The npz files of the graphs without a BOSS and of the suffix chunks."""

from __future__ import annotations

import zipfile

import numpy as np


def savez(path: str, **arrays):
    """``path`` (ending in .npz) in the layout of ``np.savez_compressed``,
    which the JAX package writes: a zip of one deflated ``.npy`` member an
    array, which ``np.load`` reads the same; deflated at zlib level 1,
    which writes k-mer code arrays several times faster than numpy's
    level 6 for files about an eighth larger."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as z:
        for name, value in arrays.items():
            with z.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(value),
                                          allow_pickle=False)
