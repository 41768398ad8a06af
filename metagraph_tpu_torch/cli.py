"""Command line interface of the port: ``query``.

``python -m metagraph_tpu_torch query -i G.dbg -a A.column.annodbg
[--device cuda|cpu] reads.fa`` mirrors ``metagraph_tpu.cli query --device``
(metagraph_tpu/cli/main.py:792-853) for basic, canonical and primary DNA
graphs (a primary graph is queried through ``CanonicalDBG``, main.py:800-802)
and column annotations, and prints the same bytes.
"""

from __future__ import annotations

import argparse
import os
import sys


def cmd_query(args):
    from .convert import load
    from .device import resolve_device
    from .query.pipeline import QueryEngine
    from .seq_io.fasta import read_fasta

    if args.parallel > 1:
        raise NotImplementedError("-p above 1 is not ported yet (ROADMAP A7)")
    if args.align:
        raise NotImplementedError("--align is not ported yet (ROADMAP A13)")
    if not args.no_coord_mapping:
        base = args.annotation
        for ext in (".column.annodbg.npz", ".column.annodbg",
                    ".annodbg.npz", ".annodbg"):
            if base.endswith(ext):
                base = base[: -len(ext)]
                break
        if os.path.exists(base + ".seqs"):
            raise NotImplementedError(
                "the .seqs coordinate-to-header mapping is not ported yet "
                "(ROADMAP A7); pass --no-coord-mapping")
    device = resolve_device(args.device)     # before the index is built
    index = load(args.infile_base, args.annotation)
    engine = QueryEngine(index, device=device)
    out = sys.stdout
    num_top = args.num_top_labels if args.num_top_labels is not None \
        else 2 ** 63
    for f in args.input:
        for res in engine.query_records(
                read_fasta(f), args.query_mode, num_top,
                args.min_kmers_fraction_label, args.min_kmers_fraction_graph,
                fwd_and_reverse=args.fwd_and_reverse,
                batch_size_bp=args.batch_size):
            if args.json:
                out.write(res.to_json(args.verbose_output, index.k) + "\n")
            else:
                out.write(res.to_string(":", args.suppress_unlabeled,
                                        args.verbose_output, index.k) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="metagraph-tpu-torch")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("query")
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
    p.add_argument("--json", action="store_true")
    p.add_argument("--suppress-unlabeled", action="store_true")
    p.add_argument("--verbose-output", action="store_true")
    p.add_argument("-p", "--parallel", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run; the CPU runs their plain "
                        "PyTorch versions")
    p.add_argument("input", nargs="+")
    p.set_defaults(func=cmd_query)
    args = ap.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
