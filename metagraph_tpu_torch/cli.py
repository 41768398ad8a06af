"""Command line interface of the port: ``query`` and ``server_query``.

``python -m metagraph_tpu_torch query -i G.dbg -a A.column.annodbg --device
reads.fa`` takes the command lines of ``metagraph_tpu.cli query``
(metagraph_tpu/cli/main.py:1454-1483, ``_add_common`` :16-27, the align
scoring flags :30-45) and prints the bytes of its ``--device`` query
(:792-853) for graphs of every type (succinct in any layout: npz, the
reference format, the mmap layout; hash, bitmap, sshash), alphabet and k
(a primary graph is queried through ``CanonicalDBG``, :800-802) and column
annotations (either codec, or the reference format) or the
annotations that ``transform_anno`` writes (a staged row-diff with its
``.rd_succ``/``.anchors`` sidecars beside the graph), in the six query
modes, with per-sequence results where a ``.seqs`` mapping sits beside the
annotation (unless ``--no-coord-mapping``), and with up to ``-p`` batches
in flight.  Past ``METAGRAPH_DENSE_ANNO_BUDGET`` a BRWT or row-diff
annotation takes the block-sparse device form, cached beside it in
``<annotation>.devsparse.npz`` as the JAX CLI caches it.  ``--device``
is a flag, as there: the port always runs on the card, unless
``--torch-device cpu`` asks for the CPU, which runs the plain PyTorch
versions of the kernels.  ``-o`` is accepted and unused; ``--mmap`` reads
a graph's mmap layout where it has one (``DEFAULT_MMAP``, as
cli/main.py:1664-1666 sets it); ``-v`` prints progress lines on stderr.

``python -m metagraph_tpu_torch server_query -i G.dbg -a A.annodbg
--device --port P`` takes the command line of ``metagraph_tpu.cli
server_query`` (:1547-1559) and serves the JAX server's HTTP contract
(``server/server.py``) from the same device routes, on the card unless
``--torch-device cpu``.  The error contract is JAX ``main``'s
(:1675-1686).
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time


def _trace(msg: str):
    print(f"[trace] {msg}", file=sys.stderr)


def cmd_query(args):
    from .annotation.coord_to_header import CoordToHeader
    from .convert import load
    from .device import resolve_device
    from .query.pipeline import QueryEngine
    from .seq_io.fasta import read_fasta

    device = resolve_device(args.torch_device)   # before the index is built
    # the graph, the annotation and the .seqs mapping load in that order,
    # as in the JAX cmd_query (cli/main.py:799-815): a missing file is
    # reported before any refusal
    index = load(args.infile_base, args.annotation)
    cth = None
    if not args.no_coord_mapping:
        base = args.annotation
        for ext in (".column.annodbg.npz", ".column.annodbg",
                    ".annodbg.npz", ".annodbg"):
            if base.endswith(ext):
                base = base[: -len(ext)]
                break
        if os.path.exists(base + ".seqs"):
            cth = CoordToHeader.load(base + ".seqs")
    if args.align or args.batch_align:
        raise NotImplementedError("--align and --batch-align are not ported "
                                  "yet (ROADMAP A13)")
    engine = QueryEngine(index, device=device, coord_to_header=cth)
    if args.verbose:
        engine.trace = _trace
    out = sys.stdout
    num_top = args.num_top_labels if args.num_top_labels is not None \
        else 2 ** 63
    for f in args.input:
        for res in engine.query_records(
                read_fasta(f), args.query_mode, num_top,
                args.min_kmers_fraction_label, args.min_kmers_fraction_graph,
                fwd_and_reverse=args.fwd_and_reverse,
                batch_size_bp=args.batch_size,
                n_threads=max(args.parallel, args.parallel_each)):
            if args.json:
                out.write(res.to_json(args.verbose_output, index.k) + "\n")
            else:
                out.write(res.to_string(":", args.suppress_unlabeled,
                                        args.verbose_output, index.k) + "\n")


def cmd_server_query(args):
    from .convert import load_annotation_for
    from .device import resolve_device
    from .graph.canonical import CanonicalDBG
    from .graph.dbg_succinct import DBGSuccinct
    from .server.server import MetaGraphServer

    device = resolve_device(args.torch_device)
    # the graph, then the annotation, as the JAX cmd_server_query loads
    # them (cli/main.py:1113-1128)
    g = DBGSuccinct.load(args.infile_base)
    if g.mode == "primary":
        g = CanonicalDBG(g)
    anno = load_annotation_for(args.infile_base, args.annotation)
    server = MetaGraphServer(g, anno, device=device)
    print(f"[Server] listening on {args.host}:{args.port}", file=sys.stderr)
    server.serve(args.host, args.port)


def _add_common(p):
    p.add_argument("-o", "--outfile-base", dest="out", default="graph")
    p.add_argument("-p", "--parallel", type=int, default=1)
    p.add_argument("--parallel-each", type=int, default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--mmap", action="store_true")


def _add_torch_device(p):
    p.add_argument("--torch-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run; the CPU runs their plain "
                        "PyTorch versions")


def _add_align_scoring_flags(p):
    # accepted as metagraph_tpu's query accepts them; --align is not ported
    for name, kind, default in (
            ("match-score", int, 2), ("mm-transition-penalty", int, 3),
            ("mm-transversion-penalty", int, 3), ("gap-open-penalty", int, 6),
            ("gap-extension-penalty", int, 2), ("end-bonus", int, 5),
            ("xdrop", int, 27), ("max-nodes-per-seq-char", float, 5.0),
            ("max-num-seeds-per-locus", int, 1000), ("max-ram", float, 200.0),
            ("rel-score-cutoff", float, 0.95)):
        p.add_argument(f"--align-{name}", type=kind, default=default)
    p.add_argument("--align-no-seed-complexity-filter", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="metagraph-tpu-torch")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("query")
    _add_common(p)
    p.add_argument("-i", "--infile-base", required=True)
    p.add_argument("-a", "--annotation", required=True)
    p.add_argument("--query-mode", default="labels",
                   choices=["labels", "matches", "counts", "counts-sum",
                            "signature", "coords"])
    p.add_argument("--min-kmers-fraction-label", type=float, default=0.7)
    p.add_argument("--min-kmers-fraction-graph", type=float, default=0.0)
    p.add_argument("--no-coord-mapping", action="store_true")
    p.add_argument("--num-top-labels", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=100_000_000)
    p.add_argument("--fwd-and-reverse", action="store_true")
    p.add_argument("--align", action="store_true")
    p.add_argument("--align-min-exact-match", type=float, default=0.7)
    _add_align_scoring_flags(p)
    p.add_argument("--batch-align", action="store_true")
    p.add_argument("--max-hull-forks", type=int, default=4)
    p.add_argument("--max-hull-depth", type=int, default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("--suppress-unlabeled", action="store_true")
    p.add_argument("--verbose-output", action="store_true")
    p.add_argument("--device", action="store_true",
                   help="the device query (the port always runs it)")
    _add_torch_device(p)
    p.add_argument("input", nargs="+")
    p.set_defaults(func=cmd_query)

    p = sub.add_parser("server_query")
    _add_common(p)
    p.add_argument("-i", "--infile-base", required=True)
    p.add_argument("-a", "--annotation", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--address", dest="host",
                   help="interface to listen on (alias of --host)")
    p.add_argument("--port", type=int, default=5555)
    p.add_argument("--threads-each", type=int, default=1,
                   help="accepted as the JAX CLI accepts it")
    p.add_argument("--device", action="store_true",
                   help="the device query (the port always runs it)")
    _add_torch_device(p)
    p.set_defaults(func=cmd_server_query)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .graph import dbg_succinct
    dbg_succinct.DEFAULT_MMAP = args.mmap
    t0 = time.perf_counter()
    try:
        ret = args.func(args)
        if args.verbose:
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            _trace(f"{args.command}: finished in "
                   f"{time.perf_counter() - t0:.3f} sec, peak RSS "
                   f"{rss / 1e6:.0f} MB")
        return ret
    except BrokenPipeError:
        sys.exit(0)
    except FileNotFoundError as e:
        path = getattr(e, "filename", None) or str(e)
        print(f"[error] File not found: {path}", file=sys.stderr)
        sys.exit(1)
    except PermissionError as e:
        path = getattr(e, "filename", None) or str(e)
        print(f"[error] Permission denied, cannot read: {path}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    sys.exit(main())
