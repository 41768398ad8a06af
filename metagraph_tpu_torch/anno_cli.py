"""The port's ``annotate`` and ``transform_anno`` subcommands.

``python -m metagraph_tpu_torch annotate -i G.dbg -o OUT refs.fa`` takes
the command line of ``metagraph_tpu.cli annotate`` (metagraph_tpu/cli/
main.py:1428-1452) and follows its ``cmd_annotate`` and
``_annotate_files`` (:429-528): a primary graph is annotated through
``CanonicalDBG`` (the rows its base graph's), each record's label its
header (``--anno-header``), ``--anno-label`` or its file's path; with
``--coordinates`` each label's coordinates advance by the record's window
count, with ``--count-kmers`` each k-mer's count is scaled by the
record's ``ka:f:``/``km:f:`` abundance; ``--index-header-coords`` writes
the ``.seqs`` mapping (and overrides ``--separately``, which annotates
each input on its own into ``OUT/<basename>``, ``-p`` at a time);
``--disk-swap``/``--mem-cap-gb`` bound the builder's RAM; ``--anno-codec``
picks the column codec.  The output is ``OUT.column.annodbg.npz`` with the
JAX file's members.  The records of a file map in batches of
``BATCH_BP`` characters, each batch one launch of kernel A
(``map_to_nodes_batch``), and the columns sort on the card through kernel
D2 (``ColumnBuilder.freeze``), unless ``--torch-device cpu``.

``python -m metagraph_tpu_torch transform_anno --anno-type T -o OUT
A.annodbg ...`` takes the command line of ``metagraph_tpu.cli
transform_anno`` (:1575-1609) and follows its ``cmd_transform_anno``
(:594-789) branch by branch: ``devsparse`` (the block-sparse device form,
written to ``-o`` as it is given), ``--to-ref-format``,
``--dump-text-anno``, ``--rename-cols``, ``--compute-overlap``,
``--aggregate-columns``, the staged row-diff pipeline
(``--row-diff-stage 0/1/2`` with its ``.rd_succ``/``.anchors`` files
beside the graph) and every other target through ``convert_annotation``,
over one or many inputs (merged, ``_load_merged_columns`` :531-591).  The
row-diff routing's pointer doubling runs on the card as tensor ops unless
``--torch-device cpu``.  ``--greedy`` and ``--linkage`` are accepted.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np

# characters of records a batch of annotate: one kernel A launch each
BATCH_BP = 1 << 24

# the last annotate run's records, k-mers, batches, largest batch's keys,
# disk swap spills and seconds (wall, read, map, add, freeze, save), which
# -v prints and chip_smoke.py reads
ANNOTATE_STATS: dict = {}
# the last transform_anno run's seconds (wall; routing for stages 0, 1)
TRANSFORM_STATS: dict = {}
_stats_lock = threading.Lock()


def _trace(msg: str):
    print(f"[trace] {msg}", file=sys.stderr)


def _graph_for_annotation(path: str, device):
    """-> (the graph to map through, the annotation's rows): a primary
    graph through ``CanonicalDBG``, its rows taken before the wrap."""
    from .graph.canonical import CanonicalDBG
    from .graph.dbg_succinct import DBGSuccinct
    g = DBGSuccinct.load(path)
    base_rows = g.max_index()
    g.use_device(device)
    if g.mode == "primary":
        g = CanonicalDBG(g)
    return g, base_rows


def cmd_annotate(args):
    from .device import resolve_device
    device = resolve_device(args.torch_device)
    g, base_rows = _graph_for_annotation(args.infile_base, device)
    t0 = time.perf_counter()
    ANNOTATE_STATS.clear()
    ANNOTATE_STATS.update(records=0, kmers=0, batches=0, largest_batch=0,
                          spills=0, read=0.0, map=0.0, add=0.0,
                          freeze=0.0, save=0.0)
    if args.separately and not args.index_header_coords:
        from concurrent.futures import ThreadPoolExecutor
        os.makedirs(args.out, exist_ok=True)
        outs = [os.path.join(args.out, os.path.basename(f))
                for f in args.input]
        if len(set(outs)) != len(outs):
            raise SystemExit("[error] --separately requires unique input "
                             "file basenames")
        from .graph.hash_graph import key_table
        key_table(getattr(g, "graph", g))     # built before threads share it
        with ThreadPoolExecutor(max_workers=max(args.parallel, 1)) as pool:
            list(pool.map(lambda fo: _annotate_files(
                g, base_rows, args, [fo[0]], fo[1], device),
                zip(args.input, outs)))
    else:
        _annotate_files(g, base_rows, args, list(args.input), args.out,
                        device)
    st = ANNOTATE_STATS
    st["wall"] = time.perf_counter() - t0
    if args.verbose:
        _trace(f"annotate: {st['records']} records, {st['kmers']} k-mers "
               f"in {st['batches']} batches, {st['wall']:.3f} sec ("
               + ", ".join(f"{k} {st[k]:.3f}" for k in
                           ("read", "map", "add", "freeze", "save"))
               + " sec)")


def _batches(recs):
    """Runs of records of at most BATCH_BP characters (at least one)."""
    lo, bp = 0, 0
    for i, r in enumerate(recs):
        if i > lo and bp + len(r.seq) > BATCH_BP:
            yield recs[lo:i]
            lo, bp = i, 0
        bp += len(r.seq)
    if lo < len(recs):
        yield recs[lo:]


def _annotate_files(g, base_rows, args, files, out_base, device):
    """Annotate ``files`` into one annotation at ``out_base``."""
    from .annotation.annotated_dbg import AnnotatedDBG
    from .annotation.column import ColumnBuilder
    from .seq_io.fasta import parse_abundance, read_fasta
    st = ANNOTATE_STATS
    anno = ColumnBuilder(base_rows, device)
    if args.disk_swap is not None or args.mem_cap_gb is not None:
        cap_gb = 0.25 if args.mem_cap_gb is None else args.mem_cap_gb
        anno.enable_disk_swap(args.disk_swap, int(cap_gb * (1 << 30)))
    ag = AnnotatedDBG(g, anno)
    k = g.k
    coord_offsets, header_index = {}, {}
    for f in files:
        t = time.perf_counter()
        recs = read_fasta(f)
        with _stats_lock:
            st["read"] += time.perf_counter() - t
        for batch in _batches(recs):
            labels, starts, abundances = [], [], []
            for rec in batch:
                label = args.anno_label or (rec.name if args.anno_header
                                            else f)
                labels.append([label])
                if args.coordinates:
                    off = coord_offsets.get(label, 0)
                    starts.append(off)
                    coord_offsets[label] = off + max(len(rec.seq) - k + 1, 0)
                if args.count_kmers:
                    ab = parse_abundance(rec.comment) if rec.comment \
                        else None
                    abundances.append(ab or 1)
                if args.index_header_coords and len(rec.seq) >= k:
                    header_index.setdefault(label, []).append(
                        (rec.name, len(rec.seq) - k + 1))
            t = time.perf_counter()
            nodes = g.map_to_nodes_batch([r.seq for r in batch])
            t1 = time.perf_counter()
            ag.add_batch(nodes, labels,
                         starts if args.coordinates else None,
                         abundances if args.count_kmers else None)
            nk = sum(len(n) for n in nodes)
            with _stats_lock:
                st["map"] += t1 - t
                st["add"] += time.perf_counter() - t1
                st["records"] += len(batch)
                st["kmers"] += nk
                st["batches"] += 1
                st["largest_batch"] = max(st["largest_batch"], nk)
    with _stats_lock:
        st["spills"] += len(anno._spills)
    t = time.perf_counter()
    frozen = anno.freeze()
    t1 = time.perf_counter()
    frozen.save(out_base + ".column.annodbg", codec=args.anno_codec)
    with _stats_lock:
        st["freeze"] += t1 - t
        st["save"] += time.perf_counter() - t1
    if args.index_header_coords:
        from .annotation.coord_to_header import CoordToHeader
        cols = frozen.labels
        CoordToHeader(
            [[h for h, _ in header_index.get(lab, [])] for lab in cols],
            [[n for _, n in header_index.get(lab, [])] for lab in cols]
        ).save(out_base)
        print(f"CoordToHeader mapping serialized to {out_base}.seqs",
              file=sys.stderr)
    print(f"annotated: {frozen.num_labels} labels", file=sys.stderr)


def add_annotate_parser(sub, add_common, add_torch_device):
    p = sub.add_parser("annotate")
    add_common(p)
    p.add_argument("-i", "--infile-base", required=True)
    p.add_argument("--anno-header", action="store_true")
    p.add_argument("--anno-filename", action="store_true")
    p.add_argument("--anno-label", default=None)
    p.add_argument("--anno-type", default="column")
    p.add_argument("--anno-codec", default="sorted",
                   choices=["sorted", "smallest"])
    p.add_argument("--count-kmers", action="store_true")
    p.add_argument("--coordinates", action="store_true")
    p.add_argument("--index-header-coords", action="store_true")
    p.add_argument("--separately", action="store_true")
    p.add_argument("--disk-swap", default=None, metavar="DIR")
    p.add_argument("--mem-cap-gb", type=float, default=None)
    add_torch_device(p)
    p.add_argument("input", nargs="+")
    p.set_defaults(func=cmd_annotate)


def add_transform_anno_parser(sub, add_common, add_torch_device):
    p = sub.add_parser("transform_anno")
    add_common(p)
    p.add_argument("-i", "--infile-base", default=None)
    p.add_argument("--anno-type", default="column")
    p.add_argument("--to-ref-format", action="store_true")
    p.add_argument("--compute-overlap", default=None)
    p.add_argument("--aggregate-columns", action="store_true")
    p.add_argument("--count-kmers", action="store_true")
    p.add_argument("--min-count", type=int, default=1)
    p.add_argument("--max-count", type=int, default=None)
    p.add_argument("--min-value", type=int, default=1)
    p.add_argument("--max-value", type=int, default=None)
    p.add_argument("--anno-label", default=None)
    p.add_argument("--row-diff-stage", type=int, default=None)
    p.add_argument("--max-path-length", type=int, default=100)
    p.add_argument("--greedy", action="store_true",
                   help="accepted as the JAX CLI accepts it")
    p.add_argument("--rename-cols", default=None, metavar="FILE")
    p.add_argument("--dump-text-anno", action="store_true")
    p.add_argument("--linkage", action="store_true",
                   help="accepted as the JAX CLI accepts it")
    add_torch_device(p)
    p.add_argument("input", nargs="+")
    p.set_defaults(func=cmd_transform_anno)


def _load_as_column(path, device):
    """Any annotation as a frozen column annotation: a column file as it
    is (``path`` + ".npz" first, as the JAX loader reads it), any other
    scanned a block of rows at a time."""
    from .annotation.column import ColumnBuilder, ColumnMajorAnnotation
    from .annotation.matrix import load_annotation
    npz = path if path.endswith(".npz") else path + ".npz"
    if os.path.exists(npz):
        return ColumnMajorAnnotation.load(npz)
    a = load_annotation(path)
    if isinstance(a, ColumnMajorAnnotation):
        return a
    out = ColumnBuilder(a.num_rows, device)
    for c in range(a.num_labels):
        out.add_labels(np.zeros(0, np.int64), [a.encoder.decode(c)])
    CHUNK = 1 << 16
    for lo in range(0, a.num_rows, CHUNK):
        mask = a.get_rows_mask(np.arange(lo, min(lo + CHUNK, a.num_rows)))
        for c in range(a.num_labels):
            hit = np.flatnonzero(mask[:, c])
            if len(hit):
                out.add_labels(lo + hit, [a.encoder.decode(c)])
    return out.freeze()


def _merge_columns(annos, device):
    """The columns (and counts) of several column annotations in one."""
    from .annotation.column import ColumnBuilder
    merged = None
    for a in annos:
        if merged is None:
            merged = ColumnBuilder(a.num_rows, device)
        elif a.num_rows != merged.num_rows:
            raise SystemExit("[error] annotations to merge must have the "
                             "same number of rows")
        for c in range(a.num_labels):
            rows, label = a.column_rows(c), a.labels[c]
            merged.add_labels(rows, [label])
            if a.has_values:
                vals = a._values[c]
                nz = vals > 0
                if nz.any():
                    merged.add_label_counts(rows[nz], vals[nz], [label])
    return merged.freeze()


def _load_merged_columns(paths, device):
    """One or many annotation files as one column annotation."""
    if len(paths) == 1:
        return _load_as_column(paths[0], device)
    return _merge_columns([_load_as_column(p, device) for p in paths],
                          device)


def cmd_transform_anno(args):
    from .annotation.column import ColumnBuilder, ColumnMajorAnnotation
    from .annotation.matrix import (RowDiff, StaticAnnotation,
                                    _row_diff_inner, convert_annotation,
                                    load_annotation)
    from .device import resolve_device
    from .graph.dbg_succinct import DBGSuccinct
    from .utils.npz import savez
    device = resolve_device(args.torch_device)
    TRANSFORM_STATS.clear()
    t0 = time.perf_counter()
    if args.anno_type == "devsparse":
        from .annotation.sparse_device import DeviceBlockSparseAnno
        from .utils.timer import PhaseTimer
        anno = load_annotation(args.input[0])
        if not isinstance(anno, ColumnMajorAnnotation):
            raise SystemExit("ERROR: --anno-type devsparse streams COLUMN "
                             "annotations (convert the compressed matrix's "
                             "source columns)")
        with PhaseTimer("devsparse conversion"):
            sp = DeviceBlockSparseAnno.from_columns(
                (anno.column_rows(c) for c in range(anno.num_labels)),
                anno.num_rows, anno.num_labels)
        sp.save(args.out)
        nbytes = (sp.entries.size + sp.dmap.size) * 4 + sp.dense8.size
        print(f"device sparse annotation written to {args.out} "
              f"({nbytes/1e6:.0f} MB, tau {sp.tau}, "
              f"{sp.dense8.shape[0]-1} dense patterns)", file=sys.stderr)
        TRANSFORM_STATS["wall"] = time.perf_counter() - t0
        return
    if args.to_ref_format:
        from .seq_io.refwrite import save_reference_column_annotation
        anno = load_annotation(args.input[0])
        if not isinstance(anno, ColumnMajorAnnotation):
            raise SystemExit("ERROR: --to-ref-format requires a column "
                             "(ColumnMajor) annotation input")
        out = save_reference_column_annotation(anno, args.out)
        print(f"reference-format annotation written to {out}",
              file=sys.stderr)
        return
    if args.dump_text_anno:
        anno = load_annotation(args.input[0])
        R = anno.num_rows
        for j in range(anno.num_labels):
            if hasattr(anno, "column_rows"):
                rows = np.asarray(anno.column_rows(j))
            elif hasattr(getattr(anno, "matrix", None), "get_column"):
                rows = np.asarray(anno.matrix.get_column(j))
            else:
                raise SystemExit("[error] Dumping columns for this type "
                                 "not implemented")
            with open(f"{args.out}.{j}.text.annodbg", "w") as f:
                f.write(f"{R} {len(rows)}\n")
                f.write("".join(f"{int(r)}\n" for r in rows))
        print(f"dumped {anno.num_labels} text columns", file=sys.stderr)
        return
    if args.rename_cols:
        with open(args.rename_cols) as f:
            toks = f.read().split()
        if len(toks) % 2:
            raise SystemExit(f"[error] Wrong format of the rules for "
                             f"renaming annotation columns passed in file "
                             f"'{args.rename_cols}'")
        mapping = dict(zip(toks[::2], toks[1::2]))
        anno = load_annotation(args.input[0])
        try:
            anno.encoder.rename(mapping)
        except ValueError as e:
            raise SystemExit(f"[error] {e}")
        anno.save(args.out + (".column.annodbg"
                              if isinstance(anno, ColumnMajorAnnotation)
                              else f".{anno.representation}.annodbg"))
        print(f"renamed {len(mapping)} labels", file=sys.stderr)
        return
    if args.compute_overlap:
        base = load_annotation(args.compute_overlap)
        for f in args.input:
            other = load_annotation(f)
            for c in range(base.num_labels):
                rows = base.column_rows(c) if hasattr(base, "column_rows") \
                    else np.flatnonzero(base.get_rows_mask(
                        np.arange(base.num_rows))[:, c])
                row_sum = other.sum_rows([(int(r), 1) for r in rows],
                                         max(args.min_count, 1))
                line = (f"({args.compute_overlap}<{base.encoder.decode(c)}>"
                        f", {f}<*>):")
                for j, total in row_sum:
                    line += f"\t<{other.encoder.decode(j)}>:{total}"
                print(line)
        return
    if args.aggregate_columns:
        _aggregate(args, device)
        return

    stage = args.row_diff_stage
    if stage is not None and args.anno_type.startswith("row_diff"):
        graph = DBGSuccinct.load(args.infile_base)
        base = args.infile_base
        if stage in (0, 1):
            t = time.perf_counter()
            succ, anchors = RowDiff.build_routing(
                graph, args.max_path_length, device)
            TRANSFORM_STATS["routing"] = time.perf_counter() - t
            name, key, what = ("rd_succ", "succ", "successors") \
                if stage == 0 else ("anchors", "anchors", "anchors")
            savez(f"{base}.{name}.npz",
                  **{key: succ if stage == 0 else anchors})
            os.replace(f"{base}.{name}.npz", f"{base}.{name}")
            print(f"row-diff {what} serialized to {base}.{name}",
                  file=sys.stderr)
            TRANSFORM_STATS["wall"] = time.perf_counter() - t0
            return
        succ = np.load(base + ".rd_succ")["succ"]
        anchors = np.load(base + ".anchors")["anchors"]
        anno = _load_merged_columns(args.input, device)
        m = RowDiff.from_annotation(
            [anno.column_rows(c) for c in range(anno.num_labels)],
            anno.num_rows, anno.num_labels, routing=(succ, anchors),
            external_routing=True, inner_type=_row_diff_inner(
                args.anno_type))
        StaticAnnotation(m, anno.encoder, args.anno_type).save(
            f"{args.out}.{args.anno_type}.annodbg")
        print(f"converted to {args.anno_type} (staged): "
              f"{m.num_labels} labels", file=sys.stderr)
        TRANSFORM_STATS["wall"] = time.perf_counter() - t0
        return

    anno = _load_merged_columns(args.input, device)
    graph = DBGSuccinct.load(args.infile_base) if args.infile_base else None
    m = convert_annotation(anno, args.anno_type, graph=graph,
                           out_base=args.out,
                           max_path_length=args.max_path_length,
                           device=device)
    StaticAnnotation(m, anno.encoder, args.anno_type).save(
        f"{args.out}.{args.anno_type}.annodbg")
    print(f"converted to {args.anno_type}: {m.num_labels} labels",
          file=sys.stderr)
    TRANSFORM_STATS["wall"] = time.perf_counter() - t0


def _aggregate(args, device):
    """``--aggregate-columns``: the rows whose count (labels, or with
    value filters or ``--count-kmers`` the labels or counts that pass)
    over all inputs lies in [--min-count, --max-count], as one column."""
    from .annotation.column import ColumnBuilder, ColumnMajorAnnotation
    top = np.iinfo(np.int64).max
    total = None
    min_value = max(args.min_value, 1)
    filter_values = min_value > 1 or (args.max_value is not None
                                      and args.max_value < 2 ** 63)
    max_value = top if args.max_value is None else min(args.max_value, top)
    for path in args.input:
        anno = ColumnMajorAnnotation.load(
            path if path.endswith(".npz") else path + ".npz")
        num_rows = anno.num_rows
        if total is None:
            total = np.zeros(num_rows, dtype=np.int64)
        elif len(total) != num_rows:
            raise SystemExit("[error] aggregated annotations must have the "
                             "same number of rows")
        if (filter_values or args.count_kmers) and not anno.has_values:
            raise SystemExit("[error] value filters/--count-kmers require "
                             "annotations built with k-mer counts")
        for c in range(anno.num_labels):
            rows = anno.column_rows(c)
            if filter_values or args.count_kmers:
                vals = anno._values[c]
                keep = (vals >= min_value) & (vals <= max_value)
                total[rows[keep]] += vals[keep] if args.count_kmers else 1
            else:
                total[rows] += 1
    max_count = min(args.max_count, top) if args.max_count is not None \
        else top
    mask = (total >= max(args.min_count, 1)) & (total <= max_count)
    out = ColumnBuilder(num_rows, device)
    out.add_labels(np.flatnonzero(mask), [args.anno_label or "mask"])
    out.save(args.out + ".column.annodbg")
    print(f"aggregated {anno.num_labels} columns -> "
          f"{int(mask.sum())} rows", file=sys.stderr)
