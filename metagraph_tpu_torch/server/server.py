"""The HTTP query server (``server_query --device``) on the port.

Own copy of metagraph_tpu/server/server.py (ref src/cli/server.cpp: POST
``/search`` :379, POST ``/align`` :503, GET ``/column_labels`` :517, GET
``/stats`` :543) over the port's ``QueryEngine``: the same request checks
and error strings, the same JSON bodies and status codes (400 for a
``ValueError``, 500 for any other error, 404 for an unknown endpoint), so
that the JAX package's client (``metagraph_tpu/api/client.py``) talks to
it unchanged.  The index and the kernels are built in ``__init__``, before
the first request; the request threads share the engine, whose per-batch
state travels with each batch.  ``/align`` aligns a request's reads with
``DBGAligner.align_batch`` (seeding on the host, every wave one launch of
kernel B11 ``align_wave``) on a succinct graph (a primary one through
``CanonicalDBG``), one request at a time, as the aligners' column stores
live on the card and the graph's lazy tables are built at first use; a
hash, bitmap or sshash graph looks its k-mers up in the engine's kernel A
table.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils.timer import get_curr_rss, get_peak_rss


def _parse_fasta_string(fasta: str):
    records = []
    name, seq = None, []
    for line in fasta.splitlines():
        if line.startswith(">"):
            if name is not None:
                records.append((name, "".join(seq)))
            name = line[1:].split()[0] if len(line) > 1 else ""
            seq = []
        else:
            seq.append(line.strip())
    if name is not None:
        records.append((name, "".join(seq)))
    return records


class MetaGraphServer:
    def __init__(self, graph, annotation, device=None, name: str = "graph",
                 index=None):
        """``graph``: what ``DBGSuccinct.load`` gives (a primary graph
        wrapped in ``CanonicalDBG``, as ``server_query`` wraps it);
        ``annotation``: what ``load_annotation`` gives; ``device``: where
        the kernels run ("cuda" unless "cpu" is asked for); ``index``: a
        ``QueryIndex`` of the same k-mers and annotation built already
        (``convert.from_graph`` of the two by default)."""
        from .. import _build
        from ..convert import from_graph
        from ..query.pipeline import QueryEngine
        self.graph = graph
        self.annotation = annotation
        self.name = name
        self.engine = QueryEngine(
            from_graph(graph, annotation) if index is None else index,
            device=device, graph=graph)
        if self.engine.device.type == "cuda":
            _build.build_all()          # the kernels build before serving
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._align_lock = threading.Lock()     # /align, one at a time

    # -------------------------------------------------------------- search
    def search(self, payload: dict) -> list:
        from ..seq_io.fasta import FastaRecord
        fasta = payload.get("FASTA")
        if fasta is None:
            raise ValueError("No input sequences received from client")
        discovery = float(payload.get("discovery_fraction", 0.7))
        if not 0.0 <= discovery <= 1.0:
            raise ValueError("Discovery fraction should be within [0, 1.0]")
        try:
            top = int(payload.get("top_labels", 10000))
        except (TypeError, ValueError):
            raise ValueError("Value is not convertible to Int.")
        anno = self.annotation
        if payload.get("query_coords", False):
            if not getattr(anno, "has_coords", False):
                raise ValueError(
                    "Annotation does not support k-mer coordinate queries")
            mode = "coords"
        elif payload.get("query_counts", False):
            if not getattr(anno, "has_values", False) \
                    and not getattr(anno, "has_coords", False):
                raise ValueError(
                    "Annotation does not support k-mer count queries")
            mode = "counts"
        elif payload.get("with_signature", False):
            mode = "signature"
        elif payload.get("abundance_sum", False):
            if not getattr(anno, "has_values", False) \
                    and not getattr(anno, "has_coords", False):
                raise ValueError(
                    "Annotation does not support k-mer count queries")
            mode = "counts-sum"
        else:
            mode = "matches"
        records = [FastaRecord(n, s.encode())
                   for n, s in _parse_fasta_string(fasta)]
        out = [json.loads(res.to_json(False, self.graph.k))
               for res in self.engine.query_records(records, mode, top,
                                                    discovery, 0.0)]
        out.sort(key=lambda r: r.get("seq_description", ""))
        return out

    # --------------------------------------------------------------- align
    def align(self, payload: dict) -> list:
        from ..align.aligner import DBGAligner
        from ..align.config import AlignerConfig
        fasta = payload.get("FASTA")
        if fasta is None:
            raise ValueError("No input sequences received from client")
        g = self.graph
        base = g.graph if hasattr(g, "get_base_node") else g
        cfg = AlignerConfig(
            min_exact_match=float(payload.get("min_exact_match", 0.7)),
            num_alternative_paths=max(
                1, int(payload.get("max_alternative_alignments", 1))),
            max_nodes_per_seq_char=float(
                payload.get("max_num_nodes_per_seq_char", 5.0)),
            protein=base.alphabet == "Protein")
        records = _parse_fasta_string(fasta)
        aligner = DBGAligner(g, cfg, device=self.engine.device)
        with self._align_lock:
            results = aligner.align_batch([s.encode() for _, s in records])
        out = []
        for (name, seq), paths in zip(records, results):
            max_score = cfg.match_score(seq) + cfg.left_end_bonus \
                + cfg.right_end_bonus
            out.append({"seq_description": name, "alignments": [{
                "score": int(path.score),
                "max_score": max_score,
                "sequence": path.sequence.decode(),
                "cigar": path.cigar.to_string(),
                "orientation": path.orientation,
            } for path in paths]})
        return out

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        g, anno = self.graph, self.annotation
        base = g.graph if hasattr(g, "get_base_node") else g
        return {
            "graph": {
                "k": g.k,
                "nodes": int(base.num_nodes()),
                "is_canonical_mode": g.mode == "canonical",
            },
            "annotation": {
                "labels": int(anno.num_labels),
                "objects": int(anno.num_rows),
                "representation": getattr(anno, "representation", "column"),
            },
            "process": {
                "curr_rss_mb": round(get_curr_rss() / 1e6, 1),
                "peak_rss_mb": round(get_peak_rss() / 1e6, 1),
            },
        }

    def column_labels(self) -> list:
        return list(self.annotation.labels)

    # ------------------------------------------------------------- serving
    def serve(self, host: str = "127.0.0.1", port: int = 5555,
              background: bool = False):
        """Serve on ``host:port`` (port 0: a free port, then
        ``self.port``); with ``background``, on a daemon thread, which is
        returned."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path.rstrip("/").endswith("stats"):
                        self._reply(200, server.stats())
                    elif self.path.rstrip("/").endswith("column_labels"):
                        self._reply(200, server.column_labels())
                    else:
                        self._reply(404, {"error": "unknown endpoint"})
                except Exception as e:
                    self._reply(400, {"error": str(e)})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n) or b"{}"
                    try:
                        payload = json.loads(body)
                    except json.JSONDecodeError as e:
                        raise ValueError(f"Bad json received: {e}")
                    if self.path.rstrip("/").endswith("search"):
                        self._reply(200, server.search(payload))
                    elif self.path.rstrip("/").endswith("align"):
                        self._reply(200, server.align(payload))
                    else:
                        self._reply(404, {"error": "unknown endpoint"})
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:
                    self._reply(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if background:
            t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            t.start()
            return t
        self._httpd.serve_forever()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def shutdown(self):
        """Stop serving and close the socket."""
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
