"""De Bruijn graphs from the JAX package's artifacts: ``DBGSuccinct.load``.

Own copy of the loading part of metagraph_tpu/graph/dbg_succinct.py:611-655
for every layout it reads:

* the reference-format ``.dbg`` (not a zip file), through
  ``seq_io/refformat.py::load_reference_boss``;
* the mmap layout (``<base>.meta.npz`` beside raw ``.npy`` arrays), where
  it exists and ``mmap`` is asked for (``DEFAULT_MMAP``, which ``--mmap``
  sets) or no ``<base>.npz`` is there;
* a ``.dbg.npz`` whose ``graph_type`` is not ``succinct``: the hash,
  bitmap or sshash graph that ``GRAPH_CLASSES`` names, rebuilt from its
  k-mers (``hash_graph._KmerGraphBase.load_generic``);
* the npz BOSS, of every alphabet (``_alphabet_of``: the recorded name, or
  the alphabet of the table's sigma) and every k.
"""

from __future__ import annotations

import os

import numpy as np

from ..kmer.alphabets import ALPHABETS, DNA
from ..kmer.extractor import KmerExtractor
from ..succinct.boss import BOSS

DEFAULT_MMAP = False


class DBGSuccinct:
    def __init__(self, boss: BOSS, k: int, mode: str = "basic",
                 alphabet: str = DNA.name, masked: bool = True):
        self.boss = boss
        self.k = k                      # dbg k (= boss.k + 1)
        self.mode = mode
        self.alphabet = alphabet        # an ALPHABETS name
        self.masked = masked            # dummy edges hidden

    @property
    def extractor(self) -> KmerExtractor:
        return KmerExtractor(ALPHABETS[self.alphabet])

    def num_nodes(self) -> int:
        return self.boss.num_valid if self.masked else self.boss.num_edges

    def max_index(self) -> int:
        return self.boss.num_edges

    @classmethod
    def load(cls, path: str, mode: str | None = None,
             mmap: bool | None = None):
        """-> a DBGSuccinct, or the graph of a non-succinct artifact."""
        if mmap is None:
            mmap = DEFAULT_MMAP
        if path.endswith(".dbg") and os.path.exists(path):
            with open(path, "rb") as f:
                if f.read(2) != b"PK":         # not an npz: reference format
                    from ..seq_io.refformat import load_reference_boss
                    return load_reference_boss(path)
        base = path[:-4] if path.endswith(".npz") else path
        if os.path.exists(base + ".meta.npz") and (
                mmap or not os.path.exists(base + ".npz")):
            boss = BOSS.load(path, mmap=mmap)
            with np.load(base + ".meta.npz") as meta:
                m = str(meta["mode"]) if "mode" in meta.files else "basic"
                msk = bool(meta["masked"]) if "masked" in meta.files \
                    else True
                alphabet = _alphabet_of(meta, boss)
            return cls(boss, boss.k + 1, mode or m, alphabet, msk)
        npz = path if path.endswith(".npz") else path + ".npz"
        with np.load(npz) as z:
            if "graph_type" in z.files \
                    and str(z["graph_type"]) != "succinct":
                from .hash_graph import _KmerGraphBase
                return _KmerGraphBase.load_generic(z)
            if mode is None:
                mode = str(z["mode"]) if "mode" in z.files else "basic"
            msk = bool(z["masked"]) if "masked" in z.files else True
            boss = BOSS.load(npz)
            return cls(boss, boss.k + 1, mode, _alphabet_of(z, boss), msk)


def _alphabet_of(z, boss: BOSS) -> str:
    """The alphabet recorded in the artifact; an older one's by sigma."""
    if "alphabet" in z.files:
        return str(z["alphabet"])
    return next((a.name for a in ALPHABETS.values()
                 if a.sigma == boss.alph_size), DNA.name)
