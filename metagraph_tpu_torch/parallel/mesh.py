"""A device mesh over torch.distributed ranks: the port's counterpart of
``jax.sharding.Mesh`` and ``shard_map`` for parallel/sharding.py.

A ``Mesh`` names its axes and their sizes (row-major: rank r sits at
``np.unravel_index(r, sizes)``, as ``np.array(devs).reshape(data, model)``
places devices, JAX sharding.py:37) and holds one process group for every
axis and every tuple of axes, made by every rank in the same order
(``dist.new_group`` is collective).  Each rank runs the same program on its
own blocks; ``pmax`` is the query steps' one collective, and ``record``
lists every collective a step ran (kind, axes, count, bytes), which
``collective_counts`` counts as the JAX helper counts HLO ops.

The backend is explicit: "gloo" for CPU tensors, "nccl" for one card a
rank.  Ranks that share a card run gloo over CUDA tensors (NCCL refuses
two ranks on one device); gloo's all-reduce takes CUDA tensors and stages
them through the host itself (checked on an H100 with two ranks).
Rendezvous is a ``FileStore`` in a directory the launcher
(``parallel/launch.py``) makes; no rank reads a cluster's environment.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "all-to-all", "collective-permute",
         "reduce-scatter")
BACKENDS = ("gloo", "nccl")


@dataclass
class Collective:
    kind: str           # one of KINDS
    axes: tuple         # the mesh axes it spans
    count: int          # ranks in its group
    nbytes: int         # bytes of this rank's operand


@dataclass
class Mesh:
    axis_names: tuple
    sizes: tuple
    rank: int
    backend: str
    device: torch.device
    groups: dict = field(default_factory=dict)   # axes tuple -> group
    host_group: object = None    # gloo over every rank (gathers to rank 0)
    record: list = field(default_factory=list)

    @classmethod
    def create(cls, shape: dict, rank: int, backend: str,
               device) -> "Mesh":
        """Every rank of an initialised default group calls this with the
        same ``shape`` ({axis: size}, in mesh order)."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        if dist.get_backend() != backend:
            raise ValueError(f"the default group runs {dist.get_backend()}, "
                             f"not {backend}")
        names, sizes = tuple(shape), tuple(int(s) for s in shape.values())
        world = int(np.prod(sizes))
        if dist.get_world_size() != world:
            raise ValueError(f"mesh {shape} needs {world} ranks, the group "
                             f"has {dist.get_world_size()}")
        mesh = cls(names, sizes, rank, backend, torch.device(device))
        grid = np.arange(world).reshape(sizes)
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), n):
                rest = [a for a in range(len(names)) if a not in axes]
                # one group a combination of the other axes' coordinates
                moved = np.moveaxis(grid, rest + list(axes),
                                    range(len(names)))
                for ranks in moved.reshape(-1, int(np.prod(
                        [sizes[a] for a in axes]))):
                    g = dist.new_group([int(r) for r in ranks],
                                       backend=backend)
                    if rank in ranks:
                        mesh.groups[tuple(names[a] for a in axes)] = g
        mesh.host_group = dist.group.WORLD if backend == "gloo" \
            else dist.new_group(list(range(world)), backend="gloo")
        return mesh

    # -- shape -------------------------------------------------------------
    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def coords(self) -> dict:
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank,
                                                          self.sizes))))

    def _axes(self, axes) -> tuple:
        """An axis name or tuple -> the tuple in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not axes or set(axes) - set(self.axis_names):
            raise ValueError(f"axes {axes} not of the mesh {self.shape}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def index(self, axes) -> int:
        """This rank's place along ``axes`` (row-major over them), as
        ``jax.lax.axis_index`` of a tuple."""
        axes = self._axes(axes)
        return int(np.ravel_multi_index(
            [self.coords[a] for a in axes], [self.shape[a] for a in axes]))

    def block(self, a, axes, dim: int = 0):
        """This rank's block of ``a`` split evenly along ``dim`` over
        ``axes`` (a ``PartitionSpec`` entry); the length must divide."""
        n, i = self.size(axes), self.index(axes)
        if a.shape[dim] % n:
            raise ValueError(f"{a.shape[dim]} rows do not split over "
                             f"{self._axes(axes)} ({n})")
        per = a.shape[dim] // n
        sl = [slice(None)] * a.ndim
        sl[dim] = slice(i * per, (i + 1) * per)
        return a[tuple(sl)]

    # -- collectives -------------------------------------------------------
    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks along ``axes``, in
        place (``jax.lax.pmax``): one all-reduce, recorded."""
        axes = self._axes(axes)
        if t.device != self.device:
            raise ValueError(f"pmax of a tensor on {t.device}, the mesh's "
                             f"device is {self.device}")
        g = self.groups[axes]
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
        self.record.append(Collective("all-reduce", axes, self.size(axes),
                                      t.numel() * t.element_size()))
        return t

    def gather_to_root(self, obj):
        """Every rank's ``obj`` (picklable) -> the list by rank on rank 0,
        None elsewhere, over the gloo host group; a helper outside the
        steps, not recorded."""
        out = [None] * int(np.prod(self.sizes)) if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.host_group)
        return out


def collective_counts(mesh_or_record) -> dict:
    """Collectives by kind (the five kinds of the JAX helper, sharding.py
    :219) from a mesh's record or a list of ``Collective``."""
    rec = getattr(mesh_or_record, "record", mesh_or_record)
    return {kind: sum(1 for c in rec if c.kind == kind) for kind in KINDS}


def record_bytes(mesh_or_record) -> int:
    rec = getattr(mesh_or_record, "record", mesh_or_record)
    return sum(c.nbytes for c in rec)


def assemble(blocks: list, sizes: tuple, axis_names: tuple, spec: tuple):
    """Blocks of every rank (by rank) of an output sharded by ``spec`` (a
    ``PartitionSpec`` as a tuple: per dimension an axis, a tuple of axes or
    None) -> the global numpy array.  Axes the spec leaves out hold copies;
    their first rank's block is taken."""
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    names = list(axis_names)
    dims = [(d,) if isinstance(d, str) else tuple(d or ()) for d in spec]
    used = {a for d in dims for a in d}
    fixed = {names.index(a): 0 for a in names if a not in used}
    out = None
    for r in grid.reshape(-1):
        c = np.unravel_index(int(r), sizes)
        if any(c[a] != v for a, v in fixed.items()):
            continue
        b = np.asarray(blocks[int(r)])
        if out is None:
            shape = [b.shape[i] * int(np.prod([sizes[names.index(a)]
                                               for a in d]))
                     for i, d in enumerate(dims)] + list(b.shape[len(dims):])
            out = np.zeros(shape, dtype=b.dtype)
        sl = []
        for i, d in enumerate(dims):
            j = int(np.ravel_multi_index([c[names.index(a)] for a in d],
                                         [sizes[names.index(a)] for a in d])
                    ) if d else 0
            sl.append(slice(j * b.shape[i], (j + 1) * b.shape[i]))
        out[tuple(sl)] = b
    return out
