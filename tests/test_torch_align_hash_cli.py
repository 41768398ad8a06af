"""The port's ``align`` family on graphs that are not succinct against the
JAX CLI's, byte for byte.

The JAX CLI builds hash, hashfast, hashstr, bitmap and sshash graphs
(k = 15) in basic, canonical and primary mode from seeded random
references, one of them a copy of another with a substitution every 97
characters, and annotates some of them by header (``--anno-header``) and
with coordinates.  Every command line runs through the JAX CLI in this
process and through the port's CLI (``--torch-device cpu``: kernel A's
and B11's plain versions) in one subprocess without JAX; stdout, exit
code and uncaught error must be equal: ``align`` (TSV on every graph;
``--json``, ``-p 2``, ``--align-alternative-alignments 2``,
``--align-only-forwards``, seeds below k, ``--align-post-chain``),
``--map`` in its four forms, ``-a``, ``--align-chain`` with coordinates,
``query --align`` and ``--batch-align``.  ``-o x.gfa`` and ``--map
--align-length`` other than k raise JAX's AttributeError at the same
point (the first before the reads are read, so a missing read file does
not show, and no ``.path.gfa`` is written; the second after the records
shorter than the length have printed).  One ``/align`` request, and a
``/search``, go to the JAX ``MetaGraphServer`` and the port's over the
same graph and annotation (a primary graph through ``CanonicalDBG``).
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_parity import (detour_references_and_reads, jax_cli, run_jax,
                          run_port, write_fasta)

TYPES = ("hash", "hashfast", "hashstr", "bitmap", "sshash")
MODES = ("basic", "canonical", "primary")
K = 15

# case -> (graph, flags, annotation or None); {tmp} names the directory
CASES = {f"tsv-{t}-{m}": (f"{t}-{m}", [], None) for t in TYPES
         for m in MODES}
CASES.update({
    "json": ("hash-basic", ["--json"], None),
    "json-canonical": ("bitmap-canonical", ["--json"], None),
    "parallel": ("hash-basic", ["-p", "2"], None),
    "parallel-sshash": ("sshash-primary", ["-p", "2", "--json"], None),
    "alternatives": ("hash-basic", ["--align-alternative-alignments", "2"],
                     None),
    "forwards": ("bitmap-basic", ["--align-only-forwards"], None),
    "seed-below-k": ("sshash-basic", ["--align-min-seed-length", "9"],
                     None),
    "post-chain": ("hash-canonical", ["--align-post-chain"], None),
    "device": ("hashstr-basic", ["--device"], None),
    "map-kmers": ("hash-basic", ["--map"], None),
    "map-count": ("hash-basic", ["--map", "--count-kmers"], None),
    "map-count-canonical": ("hash-canonical", ["--map", "--count-kmers"],
                            None),
    "map-count-bitmap": ("bitmap-canonical", ["--map", "--count-kmers"],
                         None),
    "map-count-sshash": ("sshash-canonical", ["--map", "--count-kmers"],
                         None),
    "map-presence": ("bitmap-basic", ["--map", "--query-presence",
                                      "--align-min-kmers-fraction", "0.6"],
                     None),
    "map-filter": ("sshash-basic", ["--map", "--query-presence",
                                    "--filter-present"], None),
    "gfa": ("hash-basic", ["-o", "{tmp}/x.gfa"], None),
    "gfa-compacted": ("bitmap-basic", ["-o", "{tmp}/y.gfa", "--compacted"],
                      None),
    "map-length-below-k": ("hash-basic", ["--map", "--align-length", "10"],
                           None),
    "map-length-above-k": ("sshash-basic", ["--map", "--align-length",
                                            "70"], None),
    "labels": ("hash-basic", [], "a"),
    "labels-canonical": ("bitmap-canonical", [], "a"),
    "labels-primary": ("sshash-primary", [], "a"),
    "labels-json-p2": ("hashfast-basic", ["--json", "-p", "2"], "a"),
    "chain": ("hash-basic", ["--align-chain"], "c"),
    "chain-sshash": ("sshash-basic", ["--align-chain"], "c"),
})
# the cases where both CLIs raise AttributeError
RAISES = {"gfa", "gfa-compacted", "map-length-below-k", "map-length-above-k",
          "gfa-missing-reads"}

# query --align: case -> (graph, flags)
QUERY = {
    "query-align-hash": ("hash-basic", ["--align"]),
    "query-align-bitmap-canonical": ("bitmap-canonical", ["--align"]),
    "query-align-sshash-primary": ("sshash-primary", ["--align"]),
    "query-align-json": ("hashfast-basic", ["--align", "--json"]),
    "batch-align-hash": ("hash-basic", ["--align", "--batch-align"]),
    "batch-align-canonical": ("sshash-canonical",
                              ["--align", "--batch-align"]),
    "batch-align-primary": ("hashstr-primary",
                            ["--align", "--batch-align"]),
}
ANNOTATED = sorted({g for g, _, a in CASES.values() if a}
                   | {g for g, _ in QUERY.values()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The graphs, annotations and reads, and the port's output for every
    command line, from one subprocess."""
    tmp = tmp_path_factory.mktemp("align_hash_cli")
    rng = np.random.default_rng(23)
    refs, reads = detour_references_and_reads(rng, n_refs=4, length=400,
                                              n_reads=14, read_len=90)
    reads += [refs[0][:40], refs[1][:8], ""]
    write_fasta(tmp / "refs.fa", [(f"ref{i}", s)
                                  for i, s in enumerate(refs)])
    write_fasta(tmp / "q.fa", [(f"q{i} read {i}", s)
                               for i, s in enumerate(reads)])
    for t in TYPES:
        for m in MODES:
            jax_cli("build", "--graph", t, "--mode", m, "-k", K, "-o",
                    tmp / f"{t}-{m}", tmp / "refs.fa")
    for g in ANNOTATED:
        jax_cli("annotate", "-i", tmp / f"{g}.dbg", "--anno-header", "-o",
                tmp / f"a-{g}", tmp / "refs.fa")
    for g in sorted({g for g, _, a in CASES.values() if a == "c"}):
        jax_cli("annotate", "-i", tmp / f"{g}.dbg", "--anno-header",
                "--coordinates", "-o", tmp / f"c-{g}", tmp / "refs.fa")
    lines = {}
    for case, (g, flags, anno) in CASES.items():
        flags = [f.format(tmp=tmp) for f in flags]
        if anno:
            flags = ["-a", tmp / f"{anno}-{g}.column.annodbg"] + flags
        lines[case] = ["align", "-i", tmp / f"{g}.dbg", *flags, tmp / "q.fa"]
    lines["gfa-missing-reads"] = ["align", "-i", tmp / "hash-basic.dbg",
                                  "-o", tmp / "z.gfa", tmp / "none.fa"]
    lines["labels-missing-reads"] = [
        "align", "-i", tmp / "hash-basic.dbg", "-a",
        tmp / "a-hash-basic.column.annodbg", tmp / "none.fa"]
    for case, (g, flags) in QUERY.items():
        lines[case] = ["query", "-i", tmp / f"{g}.dbg", "-a",
                       tmp / f"a-{g}.column.annodbg", *flags, tmp / "q.fa"]
    keys = list(lines)
    got = run_port(tmp, [lines[k] for k in keys], stderr=True)
    gfa = {n: os.path.exists(tmp / f"{n}.path.gfa") for n in "xyz"}
    return dict(tmp=tmp, lines=lines, got=dict(zip(keys, got)), gfa=gfa,
                reads=reads)


@pytest.mark.parametrize("case", sorted(CASES) + ["gfa-missing-reads"])
def test_align_bytes_equal_jax(runs, case):
    line = [str(a) for a in runs["lines"][case]]
    got = runs["got"][case][:3]
    want = run_jax(line)
    assert got[:2] == want[:2]
    if case in RAISES:
        # the uncaught error, its type and message
        assert want[1] == 1 and want[2].startswith("AttributeError")
        assert got[2] == want[2]
        return
    assert got == want and want[1] == 0
    if not case.startswith("map-"):
        # most reads align (a CIGAR with matches)
        assert sum("=" in ln for ln in want[0].splitlines()) >= 10, want[0]


def test_gfa_writes_no_file(runs):
    """Neither CLI writes a .path.gfa on a graph without a BOSS: the JAX
    one raises before it opens the file."""
    assert not any(runs["gfa"].values())
    tmp = runs["tmp"]
    for n in "xyz":
        assert not os.path.exists(tmp / f"{n}.path.gfa")


def test_labels_missing_reads_reports_the_file(runs):
    """``-a`` with the read file missing: the JAX CLI's ``[error] File
    not found`` line and exit 1, after the graph and the annotation
    load."""
    line = [str(a) for a in runs["lines"]["labels-missing-reads"]]
    want = run_jax(line, stderr=True)
    got = runs["got"]["labels-missing-reads"]
    assert got[:3] == want[:3] and want[1] == 1
    err = [ln for ln in want[3].splitlines() if ln.startswith("[error]")]
    assert err and err[-1] in got[3]


@pytest.mark.parametrize("case", sorted(QUERY))
def test_query_align_bytes_equal_jax(runs, case):
    line = [str(a) for a in runs["lines"][case]]
    want = run_jax(line)
    assert runs["got"][case][:3] == want and want[1] == 0
    assert want[0].count("\n") == len(runs["reads"])


def _request(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, json.loads(f.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("graph", ("bitmap-basic", "hashstr-primary"))
def test_server_align_equals_jax(runs, graph):
    """``/align`` (with ``max_alternative_alignments``) and ``/search`` on
    the JAX server and the port's (``device="cpu"``) over a graph without
    a BOSS: the same status and bodies."""
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.matrix import load_annotation as jax_anno
    from metagraph_tpu.graph.canonical import CanonicalDBG as JaxCanonical
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
    from metagraph_tpu.server.server import MetaGraphServer as JaxServer
    from metagraph_tpu_torch.annotation.matrix import load_annotation
    from metagraph_tpu_torch.graph.canonical import CanonicalDBG
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu_torch.server.server import MetaGraphServer
    tmp = runs["tmp"]
    jax_cli("annotate", "-i", tmp / f"{graph}.dbg", "--anno-header", "-o",
            tmp / f"s-{graph}", tmp / "refs.fa")
    jg = JaxDBG.load(str(tmp / f"{graph}.dbg"))
    pg = DBGSuccinct.load(str(tmp / f"{graph}.dbg"))
    if graph.endswith("primary"):
        jg, pg = JaxCanonical(jg), CanonicalDBG(pg)
    path = str(tmp / f"s-{graph}.column.annodbg")
    servers = [JaxServer(AnnotatedDBG(jg, jax_anno(path)), use_device=True),
               MetaGraphServer(pg, load_annotation(path), device="cpu")]
    for s in servers:
        s.serve("127.0.0.1", 0, background=True)
    fasta = "".join(f">q{i}\n{s}\n" for i, s in enumerate(runs["reads"]))
    try:
        replies = {}
        for path, body in (("align", {"FASTA": fasta,
                                      "max_alternative_alignments": 2}),
                           ("search", {"FASTA": fasta,
                                       "discovery_fraction": 0.3})):
            want, got = (_request(s._httpd.server_address[1], path, body)
                         for s in servers)
            assert got == want and want[0] == 200
            replies[path] = want[1]
        assert sum(bool(r["alignments"]) for r in replies["align"]) >= 10
    finally:
        for s in servers:
            s.shutdown()
            s._httpd.server_close()
