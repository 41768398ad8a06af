"""De Bruijn graphs: ``DBGSuccinct.build``, ``save`` and ``load``.

Own copy of the parts of metagraph_tpu/graph/dbg_succinct.py the port uses:

* ``build`` (:38-89), on one of two routes chosen from its arguments
  alone (``build_route``):

  - the device route, the builds that fit the card's 2-bit construction
    (``succinct/device_build.py``, kernels D1-D4): the DNA alphabet, 3 <=
    k <= 21, no counts, window weights, disk swap or memory cap, in mode
    basic (the JAX device construction, with its dummy-node limit),
    primary (JAX builds it from the basic collector: basic's arrays) or
    canonical (both strands: D1's strand mode); the last two are JAX
    host builds, which have no dummy-node limit;
  - the general route, every other build: the host construction
    (``kmer/extractor.py``, ``kmer/disk_sort.py`` for ``disk_swap`` or
    ``mem_cap_bytes``, ``succinct/construct.py``), every row sort on
    the card through kernel D2;

* ``save`` (:602-609), in the npz or the mmap layout;
* ``load`` (:611-655), for every layout it reads:

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
DEVICE_K = (3, 21)          # the k the device construction takes
COLLECTOR = {"basic": "basic", "canonical": "both", "primary": "basic"}


def not_ported(what: str, item: str = "A12.3") -> NotImplementedError:
    """The refusal of a build the port does not make yet: A12.3 is
    ``--graph``, ``--suffix``, ``--index-ranges`` and KMC inputs, A15 the
    mesh."""
    return NotImplementedError(f"build: {what} is not ported yet (ROADMAP "
                               f"{item})")


def build_route(k: int, mode: str = "basic", alphabet=DNA.name,
                with_counts: bool = False, window_weights=None,
                disk_swap: str | None = None,
                mem_cap_bytes: int | None = None) -> str:
    """"device" where the build fits the card's 2-bit construction (DNA,
    3 <= k <= 21, no counts, weights, disk swap or memory cap, any mode),
    else "general"."""
    if mode not in COLLECTOR:
        raise ValueError(f"unknown mode {mode!r}")
    name = getattr(alphabet, "name", alphabet)
    if name == DNA.name and DEVICE_K[0] <= k <= DEVICE_K[1] \
            and not with_counts and window_weights is None \
            and disk_swap is None and mem_cap_bytes is None:
        return "device"
    return "general"


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

    @classmethod
    def build(cls, sequences, k: int, mode: str = "basic",
              alphabet=DNA.name, with_counts: bool = False,
              bits_per_count: int = 8, mask_dummy: bool = True,
              window_weights=None, disk_swap: str | None = None,
              mem_cap_bytes: int | None = None,
              device=None) -> "DBGSuccinct":
        """The graph of ``sequences`` (bytes or str), built on ``device``
        (the card unless "cpu"): the arrays of the JAX
        ``DBGSuccinct.build`` with the same arguments, ``device=True`` or
        not.  ``window_weights``: per sequence, a count a window, summed
        into the k-mer counts in place of occurrences; ``disk_swap`` and
        ``mem_cap_bytes``: the bounded-RAM build's spill directory and
        buffer size (1 << 28 where only the directory is given)."""
        from ..device import resolve_device
        from ..utils.timer import PhaseTimer, trace
        name = getattr(alphabet, "name", alphabet)
        alph = ALPHABETS[name]
        route = build_route(k, mode, name, with_counts, window_weights,
                            disk_swap, mem_cap_bytes)
        dev = resolve_device(device)
        trace(f"build route: {route} ({mode} mode, {name}, k = {k})")
        if route == "device":
            from ..succinct.construct import empty_boss_arrays
            from ..succinct.device_build import device_build_boss_arrays
            seqs = [s if isinstance(s, bytes) else s.encode()
                    for s in sequences]
            arrays = device_build_boss_arrays(
                seqs, k, device=dev,
                strands=2 if COLLECTOR[mode] == "both" else 1,
                bounded=mode == "basic")
            if arrays is None:
                arrays = empty_boss_arrays(k)
        else:
            from ..succinct.construct import build_boss_arrays
            ex = KmerExtractor(alph)
            with PhaseTimer("extract k-mers"):
                if disk_swap is not None or mem_cap_bytes is not None:
                    kmers, counts = ex.extract_disk(
                        sequences, k, mode=COLLECTOR[mode],
                        with_counts=with_counts,
                        window_weights=window_weights,
                        ram_cap_bytes=mem_cap_bytes or (1 << 28),
                        tmp_dir=disk_swap or None, device=dev)
                else:
                    kmers, counts = ex.extract_tensors(
                        sequences, k, COLLECTOR[mode], with_counts,
                        window_weights, dev)
            arrays = build_boss_arrays(kmers, alph.sigma,
                                       counts if with_counts else None,
                                       bits_per_count, device=dev)
        with PhaseTimer("BOSS indexes"):
            boss = BOSS.from_arrays(arrays)
        boss.count_width = bits_per_count
        return cls(boss, k, mode, name, mask_dummy)

    def save(self, path: str, mmap_layout: bool = False):
        """``<path>.dbg.npz`` (or ``path`` itself if it ends in .npz), or
        the mmap layout beside that name."""
        out = path if path.endswith(".npz") else path + ".dbg.npz"
        save = self.boss.save_mmap if mmap_layout else self.boss.save
        save(out, mode=self.mode, masked=self.masked, alphabet=self.alphabet)

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
