"""The sharded query of metagraph_tpu/parallel/sharding.py on a
torch.distributed mesh (``parallel/mesh.py``).

The k-mer index is range-partitioned over the 'model' axis (the hash table
by bucket range, the sorted dictionary by key range), query batches over
'data', annotation labels over 'model'.  Each rank runs the same step on
its blocks: its shard's probe answers 0 outside its range, one ``pmax``
over 'model' (over ('host', 'model') on the host mesh) combines the
disjoint hits, then the label counts of its label range.  Every function
keeps its JAX name and contract (line numbers of the JAX module beside
each); where JAX returns a globally sharded array, the port returns this
rank's block, and ``gather_counts`` assembles the global (S, L) counts and
(S,) present on rank 0.

Kernels: each shard's hash probe is kernel A with a shard window
(``succinct/ops.key_lookup``), its dictionary search K1 (``kmer_lookup``),
the counts kernel 2 (``annotation/ops.count_labels``), the compressed
step's label words W1 and W2 (``annotation/device_matrix``) on each
shard's Multi-BRWT.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..annotation.device_matrix import (BRWTOnDevice, FlatBRWT,
                                        RowDiffOnDevice, brwt_row_words,
                                        flatten_brwt, popcount32,
                                        rowdiff_row_words)
from ..annotation.ops import DeviceAnnotation, count_labels
from .._u32 import np_words
from ..succinct.ops import key_lookup, kmer_lookup
from .mesh import Mesh, assemble, collective_counts  # noqa: F401 (re-export)

_ONES = np.uint32(0xFFFFFFFF)     # padding key words and empty table slots


def make_mesh_shape(n_devices: int, model_axis: int | None = None) -> dict:
    """{"data": n / model, "model": model} as ``make_mesh`` (:29) lays out
    n devices: model 2 where n is even, else 1."""
    if model_axis is None:
        model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return {"data": n_devices // model_axis, "model": model_axis}


def make_host_mesh_shape(n_devices: int, host_axis: int = 2,
                         data_axis: int = 2) -> dict:
    """{"host", "data", "model"} as ``make_host_mesh`` (:145) lays out n
    devices."""
    model_axis = n_devices // (host_axis * data_axis)
    if model_axis < 1:
        raise ValueError(f"need >= {host_axis * data_axis} devices, have "
                         f"{n_devices}")
    return {"host": host_axis, "data": data_axis, "model": model_axis}


def make_mesh(backend: str, device, n_devices: int | None = None,
              model_axis: int | None = None) -> Mesh:
    """``make_mesh`` (:29) in a rank of an initialised default group: a
    ("data", "model") mesh over every rank (``n_devices``, if given, must be
    their number)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    if n_devices not in (None, n):
        raise ValueError(f"{n_devices} devices: the group has {n} ranks")
    return Mesh.create(make_mesh_shape(n, model_axis), dist.get_rank(),
                       backend, device)


def make_host_mesh(backend: str, device, host_axis: int = 2,
                   data_axis: int = 2) -> Mesh:
    """``make_host_mesh`` (:145) in a rank: ("host", "data", "model") over
    every rank, whose number host_axis x data_axis must divide."""
    import torch.distributed as dist
    n = dist.get_world_size()
    shape = make_host_mesh_shape(n, host_axis, data_axis)
    if int(np.prod(list(shape.values()))) != n:
        raise ValueError(f"{n} ranks do not fill a host mesh {shape}")
    return Mesh.create(shape, dist.get_rank(), backend, device)


def pad_rows(a: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    """``pad_rows`` (:41): rows of ``fill`` up to a multiple."""
    n = a.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return a
    pad = np.full((target - n,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def shard_kmer_index(keys: np.ndarray, ids: np.ndarray, mesh: Mesh):
    """``shard_kmer_index`` (:50): the sorted (N, W) uint32 keys and their
    ids range-partitioned over 'model', padded with all-ones keys (they
    sort last and match no real query) of id 0 -> this rank's (keys, ids)
    int32 tensors."""
    m = mesh.shape["model"]
    keys = pad_rows(np.asarray(keys, np.uint32), m, fill=_ONES)
    ids = pad_rows(np.asarray(ids).astype(np.int32), m, fill=0)
    return (np_words(mesh.block(keys, "model")).to(mesh.device),
            torch.from_numpy(np.array(mesh.block(ids, "model")))
            .to(mesh.device))


def _shard_table(table: np.ndarray, mesh: Mesh, axes):
    m = mesh.size(axes)
    n_buckets = table.shape[0]
    table = pad_rows(np.asarray(table, np.uint32), m, fill=_ONES)
    return (np_words(mesh.block(table, axes)).to(mesh.device),
            table.shape[0] // m, n_buckets)


def shard_hash_table(table: np.ndarray, mesh: Mesh):
    """``shard_hash_table`` (:64): the (n_buckets, BUCKET (W + 1)) table by
    bucket range over 'model' -> (this rank's rows, rows_per_shard,
    n_buckets).  ``n_buckets`` is the TRUE bucket count: queries hash
    modulo it, not the padded rows_per_shard x m."""
    return _shard_table(table, mesh, "model")


def shard_hash_table_host(table: np.ndarray, mesh: Mesh):
    """``shard_hash_table_host`` (:167): by bucket range over ('host',
    'model')."""
    return _shard_table(table, mesh, ("host", "model"))


def shard_annotation(bitmap: np.ndarray, mesh: Mesh):
    """``shard_annotation`` (:78): the (R, Lw) uint32 bitmap by label words
    over 'model' (padded with zero words) -> (this rank's (R, Lw / m) int32
    rows, each padded to 4 words as ``DeviceAnnotation`` pads them,
    labels_per_shard)."""
    m = mesh.shape["model"]
    Lw = bitmap.shape[1]
    target = -(-Lw // m) * m
    per = target // m
    lo = mesh.index("model") * per
    block = np.zeros((bitmap.shape[0], per), np.uint32)
    if lo < Lw:
        block[:, : min(per, Lw - lo)] = bitmap[:, lo: lo + per]
    return (DeviceAnnotation.from_bitmap(block, per * 32, mesh.device).bitmap,
            per * 32)


def _check_batch(mesh: Mesh, num_seqs: int):
    if num_seqs % mesh.shape["data"]:
        raise ValueError(
            f"num_seqs={num_seqs} must be a multiple of the data axis "
            f"({mesh.shape['data']}); pad the sequence batch")


def _probe(mesh: Mesh, table_shard, queries, n_hash: int, shard_axes):
    """This shard's hits (kernel A over its window), combined by one pmax
    over ``shard_axes`` -> (Q,) int32 node ids."""
    rows = table_shard.shape[0]
    out = key_lookup(queries, table_shard, n_hash=n_hash,
                     row0=mesh.index(shard_axes) * rows)
    return mesh.pmax(out, shard_axes)


def sharded_annotated_query_fn(mesh: Mesh, rows_per_shard: int,
                               labels_per_shard: int, num_seqs: int,
                               n_buckets: int | None = None):
    """``sharded_annotated_query_fn`` (:91): -> step(table_shard,
    bitmap_shard, queries, seq_ids), this rank's blocks (queries (Q, W)
    int32 key words and their seq_ids, the data block) -> (its (S / data,
    labels_per_shard) int32 counts, (S / data,) int32 present).

    Contract: ``num_seqs`` divides evenly over 'data', and ``seq_ids`` are
    SHARD-LOCAL (0 .. num_seqs / data - 1); ids outside are dropped."""
    _check_batch(mesh, num_seqs)
    n_hash = n_buckets if n_buckets is not None \
        else rows_per_shard * mesh.shape["model"]
    S = num_seqs // mesh.shape["data"]

    def step(table_shard, bitmap_shard, queries, seq_ids):
        nodes = _probe(mesh, table_shard, queries, n_hash, "model")
        return count_labels(bitmap_shard, nodes, seq_ids, S,
                            labels_per_shard)

    return step


def sharded_annotated_query_fn_host(mesh: Mesh, rows_per_shard: int,
                                    labels_per_shard: int, num_seqs: int,
                                    n_buckets: int):
    """``sharded_annotated_query_fn_host`` (:177): index buckets over
    ('host', 'model'), labels over 'model', queries over 'data'; one pmax
    over ('host', 'model') is the step's only collective."""
    _check_batch(mesh, num_seqs)
    S = num_seqs // mesh.shape["data"]

    def step(table_shard, bitmap_shard, queries, seq_ids):
        nodes = _probe(mesh, table_shard, queries, n_buckets,
                       ("host", "model"))
        return count_labels(bitmap_shard, nodes, seq_ids, S,
                            labels_per_shard)

    return step


def sharded_lookup_fn(mesh: Mesh):
    """``sharded_lookup_fn`` (:233): -> lookup(keys, ids, queries) of this
    rank's key range and data block: K1 on the shard, then one pmax over
    'model' -> (Q,) int32 ids."""

    def lookup(keys, ids, queries):
        return mesh.pmax(kmer_lookup(keys, ids, queries), "model")

    return lookup


def gather_counts(mesh: Mesh, counts: torch.Tensor, present: torch.Tensor):
    """Every rank's (counts, present) blocks of a step -> on rank 0 the
    global (S, L) counts (out spec ('data', 'model')) and (S,) present
    (('data',)) as numpy arrays; None elsewhere."""
    blocks = mesh.gather_to_root((counts.cpu().numpy(),
                                  present.cpu().numpy()))
    if blocks is None:
        return None
    return (assemble([b[0] for b in blocks], mesh.sizes, mesh.axis_names,
                     ("data", "model")),
            assemble([b[1] for b in blocks], mesh.sizes, mesh.axis_names,
                     ("data",)))


# ----------------------------------------------------- compressed annotations

@dataclass
class ShardedBRWT:
    """One Multi-BRWT per label range of ``labels_per_shard`` labels
    (``ShardedBRWT``, :259): ``shards[i]`` is shard i's ``flatten_brwt``
    levels and its leaves' level and node per LOCAL label (-1: none), for
    the shards built.  JAX stacks the shards into uniform padded arrays,
    one SPMD program for all; each rank here holds its own shard in the
    port's layout (``device_arrays``)."""

    shards: dict
    labels_per_shard: int
    num_labels: int
    num_rows: int

    @property
    def depth(self) -> int:
        return max((len(s[0]) for s in self.shards.values()), default=0)

    def flat(self, i: int):
        """Shard i's ``FlatBRWT`` (W1's layout), None for an empty range."""
        levels, ll, ln = self.shards[i]
        if not levels:
            return None
        has = ll >= 0
        return FlatBRWT.from_levels(
            [f[0] for f in levels], [f[1] for f in levels],
            [f[2] for f in levels], [f[3] for f in levels], ll[has], ln[has],
            np.flatnonzero(has), self.num_rows, self.labels_per_shard)

    def device_arrays(self, mesh: Mesh):
        """This rank's shard (its 'model' index) on the mesh's device: a
        ``BRWTOnDevice``, or None where its label range is empty."""
        flat = self.flat(mesh.index("model"))
        return None if flat is None else \
            BRWTOnDevice.from_host(flat, mesh.device)


def shard_brwt_annotation(columns, num_rows: int, num_labels: int,
                          mesh) -> ShardedBRWT:
    """``shard_brwt_annotation`` (:296): a Multi-BRWT
    (``BRWT.from_columns``, greedy linkage) over each range of ceil(L / m)
    labels -> ``ShardedBRWT``.  ``mesh`` is a Mesh (this rank's 'model'
    range is built) or the model axis's size m (every range is built, on
    the host)."""
    from ..annotation.matrix import BRWT
    if isinstance(mesh, Mesh):
        m, which = mesh.shape["model"], [mesh.index("model")]
    else:
        m, which = int(mesh), range(int(mesh))
    Ls = -(-num_labels // m)
    shards = {}
    for i in which:
        lo, hi = i * Ls, min((i + 1) * Ls, num_labels)
        ll = np.full(Ls, -1, np.int32)
        ln = np.full(Ls, -1, np.int32)
        levels = []
        if hi > lo:
            cols = [np.asarray(columns[c], dtype=np.int64)
                    for c in range(lo, hi)]
            brwt = BRWT.from_columns(cols, num_rows, hi - lo)
            levels, fll, fln = flatten_brwt(brwt)
            ll[: hi - lo] = fll[: hi - lo]
            ln[: hi - lo] = fln[: hi - lo]
        shards[i] = (levels, ll, ln)
    return ShardedBRWT(shards, Ls, num_labels, num_rows)


def _sharded_brwt_words(words_l, rdir_l, offs_l, par_l, leaf_level,
                        leaf_node, rows: torch.Tensor, Ls: int):
    """Plain version of ``_sharded_brwt_words`` (:349) for one shard's
    level arrays (numpy, as ``flatten_brwt`` or one row of JAX's stacked
    arrays gives them; -1 marks a pad node or label): (Q,) int64 rows (-1
    = miss) -> (Q, ceil(Ls / 32)) int64 label words, the static-shape
    descent level by level.  The step reads the same words with W1."""
    dev = rows.device
    Q, D = rows.shape[0], len(words_l)
    Lw = max(-(-Ls // 32), 1)
    if D == 0:
        return torch.zeros((Q, Lw), dtype=torch.int64, device=dev)

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)
    state = torch.where(rows[:, None] >= 0, rows[:, None], -1)
    n_allmax = max(len(o) for o in offs_l)
    bits_levels = []
    for l in range(D):
        offs = t(offs_l[l])
        alive = (state >= 0) & (offs[None, :] >= 0)
        r = state.clamp(min=0)
        widx = offs.clamp(min=0)[None, :] + (r >> 5)
        wl = t(words_l[l])
        widx = widx.clamp(max=len(wl) - 1)       # XLA's gather clips
        w = wl[widx]
        bitpos = r & 31
        bit = (((w >> bitpos) & 1) == 1) & alive
        below = w & ((torch.ones_like(bitpos) << bitpos) - 1)
        rank_excl = t(rdir_l[l])[widx] + popcount32(below)
        bits_levels.append(torch.cat(
            [bit, torch.zeros((Q, n_allmax - bit.shape[1]), dtype=torch.bool,
                              device=dev)], dim=1))
        if l + 1 < D:
            nxt = torch.where(bit, rank_excl, -1)
            par = t(par_l[l + 1])
            taken = nxt[:, par.clamp(min=0)]
            state = torch.where(par[None, :] >= 0, taken, -1)
    bits_all = torch.stack(bits_levels)                # (D, Q, n_allmax)
    ll, ln = t(leaf_level), t(leaf_node)
    lbits = bits_all[ll.clamp(min=0), :, ln.clamp(min=0)] \
        & (ll >= 0)[:, None]                           # (Ls, Q)
    lbits = lbits.T.long()
    pad = Lw * 32 - Ls
    if pad:
        lbits = torch.cat([lbits, torch.zeros((Q, pad), dtype=torch.int64,
                                              device=dev)], dim=1)
    return (lbits.view(Q, Lw, 32)
            << torch.arange(32, device=dev)).sum(dim=2)


def _counts_from_words(words: torch.Tensor, hit: torch.Tensor,
                       seq_ids: torch.Tensor, num_seqs: int, Ls: int):
    """``_counts_from_words`` (:396): (Q, Lw) int32 label words (0 where no
    hit) and the hits -> (S, Ls) int32 counts, (S,) int32 present.  The
    words count as a bitmap whose row i + 1 is window i
    (``annotation/ops.count_labels``: kernel 2 on the card)."""
    place = torch.arange(1, words.shape[0] + 1, dtype=torch.int32,
                         device=words.device)
    return count_labels(words, torch.where(hit, place, 0), seq_ids,
                        num_seqs, Ls)


def sharded_annotated_query_compressed_fn(
        mesh: Mesh, rows_per_shard: int, labels_per_shard: int,
        num_seqs: int, n_buckets: int, depth: int,
        row_diff: bool = False, rd_max_depth: int = 0):
    """``sharded_annotated_query_compressed_fn`` (:409): -> step(
    table_shard, tree, [succ, anchors,] queries, seq_ids) with ``tree``
    this rank's ``ShardedBRWT.device_arrays`` and, with ``row_diff``, the
    replicated (R,) int32 successors and bool anchors -> this rank's (S /
    data, labels_per_shard) counts in global label order and (S / data,)
    present.  The hash probe and pmax are the dense step's; the label words
    come from W1 on the shard's tree, or with ``row_diff`` from W2: the
    inner rows XORed along each row's successor walk, which stops after
    ``rd_max_depth`` steps as JAX's fori_loop does, even where a chain goes
    on.  ``depth`` (the forest's levels) shapes JAX's specs; the port's
    descent needs no depth."""
    _check_batch(mesh, num_seqs)
    Ls = labels_per_shard
    S = num_seqs // mesh.shape["data"]
    Lw = max(-(-Ls // 32), 1)
    ld = -(-Lw // 4) * 4          # rows padded as DeviceAnnotation pads them

    def step(table_shard, tree, *rest):
        if row_diff:
            succ, anchors, queries, seq_ids = rest
        else:
            queries, seq_ids = rest
        nodes = _probe(mesh, table_shard, queries, n_buckets, "model")
        hit = nodes > 0
        Q = nodes.shape[0]
        buf = torch.zeros((Q, ld), dtype=torch.int32, device=nodes.device)
        words = buf[:, :Lw]
        if tree is not None:
            if row_diff:
                stop = anchors.bool() | (succ < 0)
                walk = RowDiffOnDevice(
                    torch.where(stop, -1, succ).to(torch.int32).contiguous(),
                    int(rd_max_depth), tree, Ls)
                rowdiff_row_words(walk, nodes, out=words)
            else:
                brwt_row_words(tree, nodes, out=words)
        return _counts_from_words(words, hit, seq_ids, S, Ls)

    return step
