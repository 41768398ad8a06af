"""Command line interface of the port: ``build``, ``query``,
``server_query`` and ``align``.

``python -m metagraph_tpu_torch build --device -k K -o OUT in.fa`` takes
the command line of ``metagraph_tpu.cli build`` (metagraph_tpu/cli/
main.py:1369-1412, ``_add_common`` :16-27) and follows its ``cmd_build``
(:80-240): read the inputs and, with ``--count-kmers``, their weights
(a ``.kmer_counts.npz`` sidecar, else ``ka:f:``/``km:f:`` header
abundances, ones for a sequence without one), construct, set the state
tag, save (``--mmap`` or ``--state fast``: the mmap layout), print
``graph built: k=K nodes=N`` on stderr.  With or without ``--device``
the graph is built on the card, unless ``--torch-device cpu``: on the
device route (DNA, 3 <= k <= 21, no counts, disk swap or memory cap, any
mode) or the general route (every other alphabet, k, ``--count-kmers``,
``--count-width``, ``--disk-swap``, ``--mem-cap-gb``), with the arrays of
the JAX ``build`` either way (``DBGSuccinct.build``).  KMC databases
(``.kmc_pre``/``.kmc_suf``) set k and give each k-mer a sequence (and,
with ``--count-kmers``, its count as weight); ``--suffix`` writes the
chunk of k-mers ending in the suffix, ``--graph`` a hash, bitmap or sshash
graph (DNA, as the JAX CLI builds it), both with the JAX files' arrays
(``utils/npz.py``), ``--index-ranges L`` the suffix-range index beside
the graph.  ``--mesh-shards`` is refused once
the inputs are read, naming ROADMAP A15.  ``-v`` prints the route and the
build's phases on stderr.

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
``<annotation>.devsparse.npz`` as the JAX CLI caches it.  ``--align``
(:826-848) first replaces each read by its best alignment's spelling on
a succinct graph (a primary one seen through ``CanonicalDBG``), with the
align scoring flags; ``--batch-align`` aligns each batch to its batch
graph (``query/batch_graph.py``, bounded by ``--max-hull-forks``,
``--max-hull-depth`` and ``--align-max-nodes-per-seq-char``) and without
``--align`` changes nothing, as in the JAX CLI; ``--align`` on a graph
that is not succinct is refused once the graph and the annotation have
loaded, naming ROADMAP A13.3e.  ``--device`` is a flag, as there: the
port always runs on the card, unless ``--torch-device cpu`` asks for the
CPU, which runs the plain PyTorch versions of the kernels.  ``-o`` is
accepted and unused; ``--mmap`` reads a graph's mmap layout where it has
one (``DEFAULT_MMAP``, as cli/main.py:1664-1666 sets it); ``-v`` prints
progress lines on stderr, and under ``--batch-align`` each batch graph's
size.

``python -m metagraph_tpu_torch server_query -i G.dbg -a A.annodbg
--device --port P`` takes the command line of ``metagraph_tpu.cli
server_query`` (:1547-1559) and serves the JAX server's HTTP contract
(``server/server.py``: ``/search`` from the same device routes,
``/align`` through the aligner), on the card unless ``--torch-device
cpu``.  The error contract is JAX ``main``'s (:1675-1686).

``python -m metagraph_tpu_torch align -i G.dbg reads.fa`` takes the
command line of ``metagraph_tpu.cli align`` (:1611-1646, ``_add_common``
and the align scoring flags) and prints the bytes of its ``cmd_align``
(:856-1040) on succinct graphs of every alphabet and mode: the TSV or
``--json`` lines of ``DBGAligner.align_batch`` (every flag of seeding,
extension, scoring and ``--align-post-chain``; ``-p N`` aligns in N
processes), and ``--map`` (``--count-kmers``, ``--query-presence``,
``--filter-present``, ``--align-length``).  The extension waves run on
the card (kernel B11 ``align_wave``) with or without ``--device``, unless
``--torch-device cpu``.  ``-a`` and ``-o *.gfa`` are refused once the
graph and the inputs have loaded, naming ROADMAP A13.3 (c and d); ``-v``
prints the reads a second, the seconds of seeding and of the waves and the
bytes the waves copy to and from the card.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

import numpy as np


# the last align run's reads, seconds (wall, seeding, waves, output),
# waves, rows and cells, and (reads, seconds) an input file, which -v
# prints and chip_smoke.py reads
ALIGN_STATS: dict = {}


def _trace(msg: str):
    print(f"[trace] {msg}", file=sys.stderr)


def _count_weights(f, recs, k):
    """The JAX ``cmd_build``'s window weights of one input under
    ``--count-kmers`` (cli/main.py:116-143): its count sidecar, else its
    header abundances (a comment's, else the name's) where any record has
    one; None for a record without."""
    from .seq_io.fasta import parse_abundance, read_kmer_counts
    counts = read_kmer_counts(f)
    if counts is not None:
        return counts
    rec_w = []
    for r in recs:
        ab = parse_abundance(r.comment or r.name)
        rec_w.append(None if ab is None else np.full(
            max(len(r.seq) - k + 1, 0), ab, dtype=np.uint64))
    return rec_w if any(w is not None for w in rec_w) else None


def _suffix_chunk(args, seqs, device):
    """``--suffix``: the collector's k-mers whose node ends in the suffix
    (JAX cmd_build, cli/main.py:146-168), written to
    ``<out>.<suffix>.chunk.npz``; a ``$`` in the suffix gives an empty
    chunk."""
    from .graph.dbg_succinct import COLLECTOR
    from .kmer.alphabets import ALPHABETS
    from .kmer.extractor import KmerExtractor
    from .utils.npz import savez
    from .utils.timer import PhaseTimer
    ex = KmerExtractor(ALPHABETS[args.alphabet])
    with PhaseTimer("extract k-mers"):
        kmers, _ = ex.extract(seqs, args.k, mode=COLLECTOR[args.mode],
                              device=device)
    if "$" in args.suffix:
        kmers = kmers[:0]
    else:
        scodes = ex.encode(args.suffix)
        L = len(scodes)
        keep = np.all(kmers[:, args.k - 1 - L: args.k - 1]
                      == scodes[None, :], axis=1)
        kmers = kmers[keep]
    with PhaseTimer("serialize"):
        savez(f"{args.out}.{args.suffix}.chunk.npz", kmers=kmers, k=args.k,
              mode=args.mode, alphabet=args.alphabet)
    print(f"chunk {args.suffix}: {len(kmers)} k-mers", file=sys.stderr)


def cmd_build(args):
    from .device import resolve_device
    from .graph.dbg_succinct import DBGSuccinct, not_ported
    from .seq_io.fasta import read_fasta
    from .seq_io.kmc import KMCDatabase, is_kmc_file, read_kmers
    from .utils.timer import PhaseTimer

    device = resolve_device(args.torch_device)
    with PhaseTimer("parse input"):
        # a KMC database fixes k: the first one sets it before any input
        # is parsed (JAX's pre-pass, cli/main.py:87-98)
        for f in args.input:
            if is_kmc_file(f):
                kmc_k = KMCDatabase(f).k
                if kmc_k != args.k:
                    print(f"warning: using k={kmc_k} from KMC database",
                          file=sys.stderr)
                    args.k = kmc_k
                break
        seqs, weights, have_weights = [], [], False
        for f in args.input:
            if is_kmc_file(f):
                # each k-mer a sequence, its count the weight of its one
                # window; both strands unless the graph is canonical
                chars, counts, _ = read_kmers(
                    f, both_from_canonical=args.mode != "canonical")
                k = chars.shape[1]
                assert k == args.k          # resolved in the pre-pass
                flat = chars.tobytes()
                seqs.extend(flat[i: i + k]
                            for i in range(0, len(flat), k))
                if args.count_kmers:
                    have_weights = True
                    weights.extend(counts[:, None])
                else:
                    weights.extend([None] * len(chars))
                continue
            recs = read_fasta(f)
            seqs.extend(r.seq for r in recs)
            w = _count_weights(f, recs, args.k) if args.count_kmers \
                else None
            have_weights |= w is not None
            weights.extend([None] * len(recs) if w is None else w)
        if have_weights:
            weights = [np.asarray(w, dtype=np.uint64) if w is not None
                       else np.ones(max(len(s) - args.k + 1, 0), np.uint64)
                       for s, w in zip(seqs, weights)]
    if args.suffix is not None:
        _suffix_chunk(args, seqs, device)
        return
    if args.graph != "succinct":
        from .graph import build_graph
        # without an alphabet, as the JAX CLI calls it: a DNA graph
        with PhaseTimer("construct graph"):
            g = build_graph(args.graph, seqs, args.k, mode=args.mode,
                            device=device)
        with PhaseTimer("serialize"):
            g.save(args.out)
        print(f"graph built: k={args.k} nodes={g.num_nodes()}",
              file=sys.stderr)
        return
    if args.mesh_shards:
        raise not_ported("--mesh-shards", "A15")
    if args.alphabet == "Protein" and args.mode != "basic":
        raise SystemExit("[error] canonical/primary modes are not "
                         "supported for the Protein alphabet")
    with PhaseTimer("construct BOSS"):
        g = DBGSuccinct.build(
            seqs, args.k, mode=args.mode, alphabet=args.alphabet,
            with_counts=args.count_kmers, bits_per_count=args.count_width,
            mask_dummy=args.mask_dummy,
            window_weights=weights if have_weights else None,
            disk_swap=args.disk_swap,
            mem_cap_bytes=None if args.mem_cap_gb is None
            else int(args.mem_cap_gb * (1 << 30)), device=device)
    g.boss.state = args.state
    if args.index_ranges:
        with PhaseTimer("index suffix ranges"):
            g.boss.index_suffix_ranges(args.index_ranges)
    with PhaseTimer("serialize"):
        g.save(args.out, mmap_layout=args.mmap or args.state == "fast")
    print(f"graph built: k={args.k} nodes={g.num_nodes()}", file=sys.stderr)


def _aligner_scoring_kwargs(args):
    """The ``AlignerConfig`` keywords of the scoring flags that ``align``
    and ``query --align`` share (cli/main.py:48-65)."""
    return dict(
        match_score_val=args.align_match_score,
        transition=-args.align_mm_transition_penalty,
        transversion=-args.align_mm_transversion_penalty,
        gap_opening_penalty=-args.align_gap_open_penalty,
        gap_extension_penalty=-args.align_gap_extension_penalty,
        left_end_bonus=args.align_end_bonus,
        right_end_bonus=args.align_end_bonus,
        xdrop=args.align_xdrop,
        max_nodes_per_seq_char=args.align_max_nodes_per_seq_char,
        max_num_seeds_per_locus=args.align_max_num_seeds_per_locus,
        max_ram_per_alignment=args.align_max_ram,
        rel_score_cutoff=args.align_rel_score_cutoff,
        seed_complexity_filter=not args.align_no_seed_complexity_filter,
        edit_distance=getattr(args, "align_edit_distance", False))


def cmd_query(args):
    from .annotation.coord_to_header import CoordToHeader
    from .convert import from_graph, load_annotation_for
    from .device import resolve_device
    from .graph.canonical import CanonicalDBG
    from .graph.dbg_succinct import DBGSuccinct
    from .query.pipeline import QueryEngine
    from .seq_io.fasta import read_fasta

    device = resolve_device(args.torch_device)   # before the index is built
    # the graph, the annotation and the .seqs mapping load in that order,
    # as in the JAX cmd_query (cli/main.py:799-815): a missing file is
    # reported before any refusal
    graph = DBGSuccinct.load(args.infile_base)
    index = from_graph(graph, load_annotation_for(args.infile_base,
                                                  args.annotation),
                       cache=args.annotation + ".devsparse.npz")
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
    aligner_config = None
    if args.align:
        if not hasattr(graph, "boss"):
            raise NotImplementedError(
                "query --align: graphs that are not succinct are not "
                "ported yet (ROADMAP A13.3e)")
        from .align.config import AlignerConfig
        # a primary graph aligns as canonical, as the JAX cmd_query wraps
        # it (cli/main.py:800-802)
        if graph.mode == "primary":
            graph = CanonicalDBG(graph)
        aligner_config = AlignerConfig(
            min_exact_match=args.align_min_exact_match,
            protein=graph.alphabet == "Protein",
            **_aligner_scoring_kwargs(args))
    engine = QueryEngine(index, device=device, coord_to_header=cth,
                         graph=graph if args.align else None)
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
                n_threads=max(args.parallel, args.parallel_each),
                aligner_config=aligner_config,
                batch_align=args.batch_align,
                max_hull_forks=args.max_hull_forks,
                max_hull_depth=args.max_hull_depth,
                max_nodes_per_seq_char=args.align_max_nodes_per_seq_char):
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


def _map_records(args, g):
    """``align --map``: each record's k-mers (or, with ``--align-length``
    below k, its sub-k windows through BOSS suffix ranges) mapped to nodes
    (metagraph_tpu/cli/main.py:863-900)."""
    from .seq_io.fasta import read_fasta
    for f in args.input:
        for rec in read_fasta(f):
            L = args.align_length or g.k
            if L == g.k:
                nodes = g.map_to_nodes(rec.seq)
            else:
                nodes = []
                for i in range(len(rec.seq) - L + 1):
                    hits, _ = \
                        g.call_nodes_with_suffix_matching_longest_prefix(
                            rec.seq[i: i + L], L)
                    nodes.append(hits[0] if hits else 0)
                nodes = np.array(nodes, dtype=np.int64)
            matched = int((nodes > 0).sum())
            if args.query_presence:
                min_disc = len(nodes) - int(
                    len(nodes) * (1 - args.align_min_kmers_fraction))
                found = matched >= min_disc
                if args.filter_present:
                    if found:
                        sys.stdout.write(f">{rec.name}\n{rec.seq.decode()}\n")
                else:
                    print(int(found))
            elif args.count_kmers:
                uniq = len(set(nodes[nodes > 0].tolist()))
                print(f"{rec.name}\t{matched}/{len(nodes)}/{uniq}")
            else:
                s = rec.seq.decode()
                for i, n in enumerate(nodes):
                    print(f"{s[i: i + L]}: {int(n)}")


def _alignment_json(rec, alns) -> str:
    """One GA4GH-style JSON line an alignment (cli/main.py:1008-1037)."""
    import json
    if not alns:
        return json.dumps({"name": rec.name, "read_mapped": False}) + "\n"
    lines = []
    for rank, a in enumerate(alns):
        obj = {
            "name": rec.name,
            "sequence": rec.seq.decode(),
            "annotation": {"ref_sequence": a.sequence.decode(),
                           "cigar": a.cigar.to_string()},
            "score": int(a.score),
            "identity": a.cigar.get_num_matches()
            / max(len(a.query_view()), 1),
            "read_mapped": True,
        }
        if a.get_clipping():
            obj["query_position"] = int(a.get_clipping())
            obj["soft_clipped"] = True
        if rank:
            obj["is_secondary"] = True
        if a.orientation:
            obj["read_on_reverse_strand"] = True
        lines.append(json.dumps(obj) + "\n")
    return "".join(lines)


def cmd_align(args):
    from .align import aligner as _aligner
    from .align.aligner import DBGAligner, format_alignments_tsv
    from .align.config import AlignerConfig
    from .align.wave_extender import STATS
    from .convert import load_annotation_for
    from .device import resolve_device
    from .graph.dbg_succinct import DBGSuccinct
    from .seq_io.fasta import read_fasta

    device = resolve_device(args.torch_device)
    g = DBGSuccinct.load(args.infile_base)
    if not hasattr(g, "boss"):
        raise NotImplementedError("align: graphs that are not succinct are "
                                  "not ported yet (ROADMAP A13.3e)")
    if args.map:
        _map_records(args, g)
        return
    if args.out and args.out.endswith(".gfa"):
        for f in args.input:
            read_fasta(f)
        raise NotImplementedError("align -o *.gfa (query paths in GFA) is "
                                  "not ported yet (ROADMAP A13.3d)")
    cfg = AlignerConfig(
        min_exact_match=args.align_min_exact_match,
        min_seed_length=args.align_min_seed_length,
        max_seed_length=args.align_max_seed_length,
        min_path_score=args.align_min_path_score,
        num_alternative_paths=args.align_alternative_alignments,
        forward_and_reverse_complement=not args.align_only_forwards,
        post_chain_alignments=args.align_post_chain,
        protein=g.alphabet == "Protein",
        **_aligner_scoring_kwargs(args))
    if args.align_chain and not args.annotation:
        print("ERROR: Chaining only supported for seeds with coordinates. "
              "Skipping seed chaining.", file=sys.stderr)
        raise SystemExit(1)
    if args.annotation:
        load_annotation_for(args.infile_base, args.annotation)
        for f in args.input:
            read_fasta(f)
        raise NotImplementedError("align -a (labeled and chained alignment) "
                                  "is not ported yet (ROADMAP A13.3c)")
    aligner = DBGAligner(g, cfg, device=device)
    out = sys.stdout
    seed0, waves0 = _aligner.SEED_SECONDS[0], dict(STATS)
    n_reads, t0 = 0, time.perf_counter()
    t_out = 0.0
    files = []
    try:
        for f in args.input:
            t_file = time.perf_counter()
            recs = read_fasta(f)
            n_reads += len(recs)
            alns = aligner.align_batch([r.seq for r in recs],
                                       processes=max(args.parallel, 1))
            t1 = time.perf_counter()
            for rec, a in zip(recs, alns):
                out.write(_alignment_json(rec, a) if args.json
                          else format_alignments_tsv(rec.name, rec.seq, a,
                                                     cfg.min_path_score))
            t_out += time.perf_counter() - t1
            files.append((len(recs), time.perf_counter() - t_file))
    finally:
        aligner.close_pool()
    st = ALIGN_STATS
    st.clear()
    st.update(reads=n_reads, wall=time.perf_counter() - t0, files=files,
              seeding=_aligner.SEED_SECONDS[0] - seed0, output=t_out,
              **{f"wave_{k}": v - waves0[k] for k, v in STATS.items()})
    if args.verbose:
        _trace(f"align: {n_reads} reads in {st['wall']:.3f} sec "
               f"({n_reads / max(st['wall'], 1e-9):.1f} reads/s); seeding "
               f"{st['seeding']:.3f} sec, {st['wave_waves']} waves of "
               f"{st['wave_rows']} rows ({st['wave_cells']} cells) "
               f"{st['wave_seconds']:.3f} sec ({st['wave_bytes_up']} B up, "
               f"{st['wave_bytes_down']} B down, finished tables "
               f"{st['wave_bytes_tables']} B down), output {t_out:.3f} sec "
               f"(in this process: with -p, the workers' seeding and "
               f"waves are not counted)")


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
    # the scoring flags of align and query --align
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
    p = sub.add_parser("build")
    _add_common(p)
    p.add_argument("-k", type=int, required=True)
    p.add_argument("--mode", choices=["basic", "canonical", "primary"],
                   default="basic")
    p.add_argument("--graph", default="succinct",
                   choices=["succinct", "bitmap", "hash", "hashfast",
                            "hashstr", "sshash"])
    p.add_argument("--count-kmers", action="store_true")
    p.add_argument("--count-width", type=int, default=8)
    p.add_argument("--mask-dummy", action="store_true")
    p.add_argument("--in-ram", action="store_true")
    p.add_argument("--state", default="stat",
                   choices=["stat", "small", "fast", "dynamic"])
    p.add_argument("--alphabet", default="DNA",
                   choices=["DNA", "DNA5", "Protein", "DNA_CASE"])
    p.add_argument("--suffix", default=None)
    p.add_argument("--disk-swap", default=None, metavar="DIR")
    p.add_argument("--index-ranges", type=int, default=0, metavar="L")
    p.add_argument("--mesh-shards", type=int, default=0, metavar="N")
    p.add_argument("--mem-cap-gb", type=float, default=None)
    p.add_argument("--device", action="store_true",
                   help="accepted as the JAX CLI accepts it: the port "
                        "builds on the card either way")
    _add_torch_device(p)
    p.add_argument("input", nargs="+")
    p.set_defaults(func=cmd_build)

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

    p = sub.add_parser("align")
    _add_common(p)
    p.add_argument("-i", "--infile-base", required=True)
    p.add_argument("-a", "--annotation", default=None)
    p.add_argument("--align-only-forwards", action="store_true")
    p.add_argument("--align-min-exact-match", type=float, default=0.7)
    p.add_argument("--align-min-seed-length", type=int, default=19)
    p.add_argument("--align-max-seed-length", type=int, default=2 ** 63)
    p.add_argument("--align-min-path-score", type=int, default=0)
    p.add_argument("--align-alternative-alignments", type=int, default=1)
    p.add_argument("--align-edit-distance", action="store_true")
    _add_align_scoring_flags(p)
    p.add_argument("--align-post-chain", action="store_true")
    p.add_argument("--align-chain", action="store_true")
    p.add_argument("--no-coord-mapping", action="store_true")
    p.add_argument("--map", action="store_true")
    p.add_argument("--align-length", type=int, default=None)
    p.add_argument("--count-kmers", action="store_true")
    p.add_argument("--query-presence", action="store_true")
    p.add_argument("--filter-present", action="store_true")
    p.add_argument("--align-min-kmers-fraction",
                   "--min-kmers-fraction-label", type=float, default=0.7)
    p.add_argument("--json", action="store_true")
    p.add_argument("--compacted", action="store_true")
    p.add_argument("--device", action="store_true",
                   help="accepted as the JAX CLI accepts it: the waves run "
                        "on the card either way")
    _add_torch_device(p)
    p.add_argument("input", nargs="+")
    p.set_defaults(func=cmd_align)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .graph import dbg_succinct
    from .utils.timer import set_trace
    dbg_succinct.DEFAULT_MMAP = args.mmap
    set_trace(args.verbose)
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
