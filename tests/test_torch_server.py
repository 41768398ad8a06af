"""``server_query --device`` on the port against the JAX server.

The JAX CLI builds a basic and a primary k = 11 graph and annotates them
(the basic one with k-mer counts and coordinates, so that every mode is
allowed; the primary one without, so that the count and coordinate modes
are refused) in tmp_path.  The JAX ``MetaGraphServer(use_device=True)``
and the port's (``device="cpu"``: the plain versions of the kernels) serve
the same graph and annotation, each on a port the system chooses (port 0),
a primary graph wrapped in ``CanonicalDBG`` as ``server_query`` wraps it.
Both get the same requests: ``/search`` in every mode the annotation
allows, with ``discovery_fraction`` and ``top_labels``, the error cases,
``/stats`` (without its RSS values), ``/column_labels``, unknown
endpoints, requests in flight together, ``/align`` (one request, and
two in flight together), and the port's ``server_query`` started as a
subprocess.  Bodies and status codes must be equal.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_parity import REPO, jax_cli, references_and_reads, write_fasta


def _request(port, path, body=None):
    """-> (status, parsed JSON body); ``body`` a str is POSTed as is."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}",
        data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, json.loads(f.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server")
    rng = np.random.default_rng(29)
    refs, reads = references_and_reads(rng)
    write_fasta(tmp / "refs.fa", [(f"ref{i}", s) for i, s in enumerate(refs)])
    jax_cli("build", "-k", 11, "-o", tmp / "g", tmp / "refs.fa")
    jax_cli("annotate", "-i", tmp / "g.dbg", "--anno-header",
            "--count-kmers", "--coordinates", "-o", tmp / "a",
            tmp / "refs.fa")
    jax_cli("build", "--mode", "primary", "-k", 11, "-o", tmp / "gp",
            tmp / "refs.fa")
    jax_cli("annotate", "-i", tmp / "gp.dbg", "--anno-header", "-o",
            tmp / "ap", tmp / "refs.fa")
    fasta = "".join(f">q{i} read {i}\n{s}\n" for i, s in enumerate(reads))
    return tmp, fasta


@pytest.fixture(scope="module", params=("basic", "primary"))
def servers(request, data):
    """(JAX server port, port server port, kind), both serving."""
    from metagraph_tpu.annotation.annotated_dbg import AnnotatedDBG
    from metagraph_tpu.annotation.matrix import load_annotation as jax_anno
    from metagraph_tpu.graph.canonical import CanonicalDBG as JaxCanonical
    from metagraph_tpu.graph.dbg_succinct import DBGSuccinct as JaxDBG
    from metagraph_tpu.server.server import MetaGraphServer as JaxServer
    from metagraph_tpu_torch.annotation.matrix import load_annotation
    from metagraph_tpu_torch.graph.canonical import CanonicalDBG
    from metagraph_tpu_torch.graph.dbg_succinct import DBGSuccinct
    from metagraph_tpu_torch.server.server import MetaGraphServer
    tmp, _ = data
    g, a = ("g", "a") if request.param == "basic" else ("gp", "ap")
    jg, pg = JaxDBG.load(str(tmp / f"{g}.dbg")), \
        DBGSuccinct.load(str(tmp / f"{g}.dbg"))
    if request.param == "primary":
        jg, pg = JaxCanonical(jg), CanonicalDBG(pg)
    path = str(tmp / f"{a}.column.annodbg")
    jax_server = JaxServer(AnnotatedDBG(jg, jax_anno(path)), use_device=True)
    port_server = MetaGraphServer(pg, load_annotation(path), device="cpu")
    jax_server.serve("127.0.0.1", 0, background=True)
    port_server.serve("127.0.0.1", 0, background=True)
    yield (jax_server._httpd.server_address[1], port_server.port,
           request.param)
    jax_server.shutdown()
    jax_server._httpd.server_close()
    port_server.shutdown()


def _search(fasta, **kw):
    return json.dumps(dict(FASTA=fasta, **kw))


# (name, path, body as a function of the FASTA text, or None for a GET)
REQUESTS = [
    ("matches", "search", lambda f: _search(f)),
    ("matches-df", "search", lambda f: _search(f, discovery_fraction=0.3,
                                               top_labels=2)),
    ("matches-top1", "search", lambda f: _search(f, top_labels=1,
                                                 discovery_fraction=0.0)),
    ("signature", "search", lambda f: _search(f, with_signature=True,
                                              discovery_fraction=0.5)),
    ("counts-sum", "search", lambda f: _search(f, abundance_sum=True,
                                               top_labels="3")),
    ("counts", "search", lambda f: _search(f, query_counts=True)),
    ("coords", "search", lambda f: _search(f, query_coords=True,
                                           discovery_fraction=1.0)),
    ("count-labels-flag", "search", lambda f: _search(f, count_labels=True)),
    ("empty-fasta", "search", lambda f: _search("")),
    ("no-fasta", "search", lambda f: json.dumps({"top_labels": 3})),
    ("df-above-1", "search", lambda f: _search(f, discovery_fraction=1.5)),
    ("df-below-0", "search", lambda f: _search(f, discovery_fraction=-0.1)),
    ("df-not-a-number", "search", lambda f: _search(f,
                                                    discovery_fraction="x")),
    ("top-not-int", "search", lambda f: _search(f, top_labels="ten")),
    ("top-null", "search", lambda f: _search(f, top_labels=None)),
    ("bad-json", "search", lambda f: "{FASTA: 1"),
    ("not-an-object", "search", lambda f: "[1, 2]"),
    ("unknown-post", "nowhere", lambda f: _search(f)),
    ("align-no-fasta", "align", lambda f: "{}"),
    ("column-labels", "column_labels", None),
    ("column-labels-slash", "column_labels/", None),
    ("unknown-get", "nothing", None),
]


@pytest.mark.parametrize("name,path,body", REQUESTS,
                         ids=[r[0] for r in REQUESTS])
def test_replies_match_jax(servers, data, name, path, body):
    _, fasta = data
    jp, pp, kind = servers
    text = None if body is None else body(fasta)
    want = _request(jp, path, text)
    got = _request(pp, path, text)
    assert got == want
    if name in ("matches", "signature") or name == "counts" \
            and kind == "basic":
        assert want[0] == 200
        assert sum(bool(r["results"]) for r in want[1]) >= 10
        assert [r["seq_description"] for r in want[1]] == sorted(
            f"q{i}" for i in range(len(want[1])))
    if kind == "primary" and name in ("counts", "coords", "counts-sum"):
        assert want[0] == 400


def test_stats_match_jax(servers):
    """/stats: the same keys and values but the process's RSS."""
    jp, pp, kind = servers
    want, got = _request(jp, "stats"), _request(pp, "stats")
    assert got[0] == want[0] == 200
    assert set(got[1]["process"]) == set(want[1]["process"]) \
        == {"curr_rss_mb", "peak_rss_mb"}
    del got[1]["process"], want[1]["process"]
    assert got == want
    assert want[1]["graph"]["is_canonical_mode"] == (kind == "primary")


def test_align_refused_naming_roadmap(servers, data):
    """/align: the JAX server's reply to one request, and to two requests
    in flight together (each with its own aligner config)."""
    _, fasta = data
    jp, pp, _ = servers
    bodies = [_search(fasta),
              _search(fasta, min_exact_match=0.3,
                      max_alternative_alignments=2,
                      max_num_nodes_per_seq_char=3.0)]
    want = [_request(jp, "align", b) for b in bodies]
    assert want[0][0] == 200 and want[0] != want[1]
    assert sum(bool(r["alignments"]) for r in want[0][1]) >= 10
    assert _request(pp, "align", bodies[0]) == want[0]
    got = [None] * len(bodies)

    def worker(i):
        got[i] = _request(pp, "align", bodies[i])
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert got == want


def test_concurrent_requests(servers, data):
    """Requests in flight together get the answers they get one by one."""
    _, fasta = data
    jp, pp, _ = servers
    bodies = [_search(fasta, discovery_fraction=df, with_signature=sig)
              for df in (0.2, 0.5, 0.8) for sig in (False, True)]
    want = [_request(jp, "search", b) for b in bodies]
    got = [None] * len(bodies)

    def worker(i):
        got[i] = _request(pp, "search", bodies[i])
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert got == want


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_query_subprocess(servers, data):
    """``python -m metagraph_tpu_torch server_query`` prints the JAX
    line, serves the JAX server's replies, and imports no JAX."""
    tmp, fasta = data
    jp, _, kind = servers
    g, a = ("g", "a") if kind == "basic" else ("gp", "ap")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    # the module run as ``python -m``; on SIGTERM it reports the modules
    # it imported
    code = ("import runpy, signal, sys\n"
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
            "sys.argv = ['metagraph_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('metagraph_tpu_torch', run_name='__main__')\n"
            "finally:\n"
            "    bad = [m for m in sys.modules\n"
            "           if m.split('.')[0] in ('jax', 'metagraph_tpu')]\n"
            "    print('IMPORTED', bad, file=sys.stderr, flush=True)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "server_query", "--device", "-i",
         str(tmp / f"{g}.dbg"), "-a", str(tmp / f"{a}.column.annodbg"),
         "--port", str(port), "--threads-each", "2", "--torch-device",
         "cpu"], stderr=subprocess.PIPE, env=env, text=True)
    try:
        line = proc.stderr.readline()
        assert line.strip() == f"[Server] listening on 127.0.0.1:{port}"
        for body in (_search(fasta), _search(fasta, with_signature=True),
                     "{bad"):
            for _ in range(100):
                try:
                    got = _request(port, "search", body)
                    break
                except urllib.error.URLError:
                    threading.Event().wait(0.2)
            assert got == _request(jp, "search", body)
        assert _request(port, "column_labels") \
            == _request(jp, "column_labels")
    finally:
        proc.terminate()
        proc.wait(60)
        err = proc.stderr.read()
        proc.stderr.close()
    assert "IMPORTED []" in err
