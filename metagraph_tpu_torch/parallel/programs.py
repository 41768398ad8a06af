"""Rank programs of the sharded query, for ``parallel/launch.launch``.

``sharded_query(mesh, ...)`` runs on every rank of a mesh the steps of
``parallel/sharding.py`` that its inputs ask for, on the global arrays
each rank maps read-only (it shards them itself): the dense annotated step
(``table``, ``bitmap``, ``queries``, ``seq_ids``; on a mesh with a 'host'
axis the host step), the sharded lookup (``keys``, ``ids``,
``lookup_queries``) and the compressed step on a Multi-BRWT of the columns
(``col_ptr``, ``col_rows``: CSR by label) and with row-diff on one of the
diff columns (``diff_ptr``, ``diff_rows``) behind ``succ`` and
``anchors``, ``rd_max_depth`` steps.  Each step runs once, with the
kernels' launch counters at 0.  Rank 0 returns the global results
(``gather_counts``); every rank returns its collectives and launches a
step, the host seconds of its BRWT builds, and its shard's window of
table rows (``row0``, ``rows``, ``n_hash``: kernel A's arguments for its
probe).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..annotation import device_matrix as dm
from ..query import device as qd
from ..succinct import ops
from . import sharding as sh
from .mesh import collective_counts, record_bytes

# the wrappers whose launches a step reports
COUNTED = (ops.key_lookup, ops.kmer_lookup, qd.label_counts,
           dm.brwt_row_words, dm.rowdiff_row_words)


def _zero():
    for w in COUNTED:
        w.launches = 0


def _launches():
    return {w.__name__: w.launches for w in COUNTED if w.launches}


def _run(mesh, name, fn, out):
    """fn() once under the counters: its record and launches kept ->
    fn()'s result."""
    mesh.record.clear()
    _zero()
    res = fn()
    out["collectives"][name] = collective_counts(mesh)
    out["collective_bytes"][name] = record_bytes(mesh)
    out["launches"][name] = _launches()
    return res


def _cols(ptr, rows):
    return [np.asarray(rows[ptr[c]: ptr[c + 1]]) for c in range(len(ptr) - 1)]


def sharded_query(mesh, queries=None, seq_ids=None, num_seqs=0,
                  table=None, bitmap=None, keys=None, ids=None,
                  lookup_queries=None, col_ptr=None, col_rows=None,
                  diff_ptr=None, diff_rows=None, succ=None, anchors=None,
                  rd_max_depth=0, num_labels=0, num_rows=0):
    """See the module docstring.  ``queries`` (Q, W) uint32 key words and
    ``seq_ids`` (Q,) are global, Q a multiple of 'data', the ids local to
    each data block; ``num_seqs`` the global number of sequences."""
    dev = mesh.device
    out = {"collectives": {}, "collective_bytes": {}, "launches": {},
           "seconds": {}, "rank": mesh.rank, "coords": mesh.coords}
    host = "host" in mesh.axis_names
    q = s = None
    if queries is not None:
        q = torch.from_numpy(np.array(mesh.block(queries, "data"))
                             .view(np.int32)).to(dev)
        s = torch.from_numpy(np.array(mesh.block(seq_ids, "data"),
                                      dtype=np.int32)).to(dev)
    if table is not None:
        shard_table = sh.shard_hash_table_host if host \
            else sh.shard_hash_table
        tshard, rows_per, n_buckets = shard_table(table, mesh)
        axes = ("host", "model") if host else "model"
        out["window"] = dict(row0=mesh.index(axes) * rows_per,
                             rows=rows_per, n_hash=n_buckets)
    if bitmap is not None:
        bshard, Ls = sh.shard_annotation(bitmap, mesh)
        make = sh.sharded_annotated_query_fn_host if host \
            else sh.sharded_annotated_query_fn
        step = make(mesh, rows_per, Ls, num_seqs, n_buckets)
        res = _run(mesh, "dense", lambda: step(tshard, bshard, q, s), out)
        out["dense"] = sh.gather_counts(mesh, *res)
    if keys is not None:
        kk, ki = sh.shard_kmer_index(keys, ids, mesh)
        lq = torch.from_numpy(np.array(mesh.block(lookup_queries, "data"))
                              .view(np.int32)).to(dev)
        lookup = sh.sharded_lookup_fn(mesh)
        got = _run(mesh, "lookup", lambda: lookup(kk, ki, lq), out)
        blocks = mesh.gather_to_root(got.cpu().numpy())
        if blocks is not None:
            out["lookup"] = sh.assemble(blocks, mesh.sizes, mesh.axis_names,
                                        ("data",))
    for name, ptr, rows_c, walk in (("brwt", col_ptr, col_rows, None),
                                    ("row_diff", diff_ptr, diff_rows,
                                     (succ, anchors))):
        if ptr is None:
            continue
        t0 = time.perf_counter()
        sb = sh.shard_brwt_annotation(_cols(ptr, rows_c), num_rows,
                                      num_labels, mesh)
        tree = sb.device_arrays(mesh)
        out["seconds"][name + "_build"] = time.perf_counter() - t0
        step = sh.sharded_annotated_query_compressed_fn(
            mesh, rows_per, sb.labels_per_shard, num_seqs, n_buckets,
            sb.depth, row_diff=walk is not None, rd_max_depth=rd_max_depth)
        rest = (q, s)
        if walk is not None:
            rest = (torch.from_numpy(np.asarray(succ, np.int32)).to(dev),
                    torch.from_numpy(np.asarray(anchors, bool)).to(dev)) \
                + rest
        res = _run(mesh, name, lambda: step(tshard, tree, *rest), out)
        out[name] = sh.gather_counts(mesh, *res)
    return out


def mesh_layouts(mesh):
    """``make_mesh`` and ``make_host_mesh`` over the launched ranks -> their
    shapes and this rank's coordinates in each."""
    flat = sh.make_mesh(mesh.backend, mesh.device)
    host = sh.make_host_mesh(mesh.backend, mesh.device)
    return {"mesh": (flat.shape, flat.coords),
            "host_mesh": (host.shape, host.coords)}
