"""Observability HTTP endpoints over a :class:`StreamSession`.

Stdlib-only (``http.server``), daemon-threaded, and strictly read-only:
the handlers touch the session's host-side observability surfaces
(registry render, ``health()``, retained explain reports) and never
execute, admit, or mutate anything — a scrape can't add a host sync or
perturb the one-sync contract by construction.

Endpoints
---------
``/metrics``
    Prometheus text exposition 0.0.4 of the session's registry (the
    process-global one under ``ExecConfig(telemetry=True)``).
``/healthz``
    JSON liveness readout from :meth:`StreamSession.health` — drainer
    thread alive, seconds since the last drain, pending depth, the
    degradation-ladder state (retries / degraded / quarantined / failed)
    and the bulk-lane starvation gauge (``bulk_starved_s``).  Durable
    sessions add a ``wal`` block (last/committed sequence, uncommitted
    suffix, snapshot counters) and a ``recovery`` block — ``recovered:
    true`` with snapshot seq / replayed records / recovery wall time
    when this process was restored from a durability directory,
    ``recovered: false`` for a fresh attach.  Status 200 when ``ok``,
    503 otherwise, so a probe needs no body parsing.
``/explain?id=<future id>``
    The retained :class:`~repro_torch.columnar.trace.ExplainReport` for one
    drained query: JSON by default, the human renderer with
    ``&format=text``.  404 for unknown/evicted ids; bare ``/explain``
    lists retained ids.

Usage::

    server = ObservabilityServer(session, port=0)   # 0 = ephemeral
    server.start()
    ... # scrape http://127.0.0.1:{server.port}/metrics
    server.stop()

``python -m repro_torch.serve.httpd --smoke`` runs a self-check: a synthetic
table + streaming session on the card (``--device cpu`` runs it on the
host), all three endpoints scraped over a real socket, round-tripped
through the exposition parser.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["ObservabilityServer"]


class _Handler(BaseHTTPRequestHandler):
    """One request; the server instance carries the session reference."""

    server_version = "repro-obs/1"

    # -- plumbing --------------------------------------------------------------
    def log_message(self, fmt, *args):          # pragma: no cover - quiet
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, obj: Any) -> None:
        self._send(code, json.dumps(obj, indent=2, sort_keys=True,
                                    default=str) + "\n",
                   "application/json")

    # -- routes ----------------------------------------------------------------
    def do_GET(self) -> None:                   # noqa: N802 (stdlib name)
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                self._metrics()
            elif url.path == "/healthz":
                self._healthz()
            elif url.path == "/explain":
                self._explain(parse_qs(url.query))
            else:
                self._send_json(404, {"error": f"no route {url.path!r}",
                                      "routes": ["/metrics", "/healthz",
                                                 "/explain?id="]})
        except Exception as exc:                # pragma: no cover - defensive
            self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})

    def _metrics(self) -> None:
        reg = self.server.session.telemetry     # type: ignore[attr-defined]
        if reg is None:
            self._send(503, "# telemetry disabled on this session\n",
                       "text/plain; version=0.0.4")
            return
        self._send(200, reg.render_prometheus(),
                   "text/plain; version=0.0.4")

    def _healthz(self) -> None:
        h = self.server.session.health()        # type: ignore[attr-defined]
        self._send_json(200 if h["ok"] else 503, h)

    def _explain(self, qs: dict) -> None:
        session = self.server.session           # type: ignore[attr-defined]
        raw = qs.get("id", [None])[0]
        if raw is None:
            self._send_json(200, {"retained": session.explain_ids()})
            return
        try:
            fid = int(raw)
        except ValueError:
            self._send_json(400, {"error": f"id must be an int, got {raw!r}"})
            return
        rep = session.explain(fid)
        if rep is None:
            self._send_json(404, {"error": f"no retained report for id "
                                           f"{fid} (evicted or never "
                                           "drained)",
                                  "retained": session.explain_ids()})
        elif qs.get("format", [""])[0] == "text":
            self._send(200, rep.render() + "\n", "text/plain; charset=utf-8")
        else:
            self._send_json(200, rep.as_dict())


class ObservabilityServer:
    """Daemon-threaded HTTP server bound to one stream session.

    ``port=0`` binds an ephemeral port (read :attr:`port` after
    construction — the bind happens eagerly so the port is known before
    :meth:`start`).
    """

    def __init__(self, session: Any, host: str = "127.0.0.1",
                 port: int = 0):
        self.session = session
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.session = session           # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ObservabilityServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-httpd", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent; returns after the serve thread has exited."""
        self._httpd.shutdown()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._httpd.server_close()
        self._thread = None

    def __enter__(self) -> "ObservabilityServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


def _smoke(device: str = "cuda") -> int:        # pragma: no cover - CLI
    """Self-check used by CI: real session, real socket, all routes."""
    from urllib.request import urlopen

    from ..columnar import ExecConfig, StreamSession, make_forest_table
    from ..columnar.queries import random_query_suite
    from ..runtime.telemetry import parse_prometheus

    table = make_forest_table(4_000, n_dup=2, seed=7)
    cfg = ExecConfig(planner="deepfish", engine="tape", batched=True,
                     device=device)
    with StreamSession(table, config=cfg) as session:
        queries = random_query_suite(table, 3, 4, 2, seed=1)
        futs = [session.submit(q) for q in queries]
        for f in futs:
            f.result(timeout=60.0)
        with ObservabilityServer(session) as srv:
            metrics = urlopen(f"{srv.url}/metrics", timeout=10).read()
            parsed = parse_prometheus(metrics.decode())
            assert parsed, "metrics page parsed empty"
            health = json.loads(
                urlopen(f"{srv.url}/healthz", timeout=10).read())
            assert health["ok"], health
            rep = json.loads(urlopen(
                f"{srv.url}/explain?id={futs[0].id}", timeout=10).read())
            assert rep["counters"]["host_syncs"] >= 1, rep
            text = urlopen(f"{srv.url}/explain?id={futs[0].id}&format=text",
                           timeout=10).read().decode()
            assert "EXPLAIN ANALYZE" in text
            print(f"obs httpd smoke OK: {len(parsed)} metric samples, "
                  f"health ok, explain id={futs[0].id} "
                  f"({rep['selected']}/{rep['n_records']} rows)")
    return 0


if __name__ == "__main__":                      # pragma: no cover - CLI
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="run the endpoint self-check and exit")
    ap.add_argument("--device", default="cuda",
                    help="where the self-check's session runs (cuda | cpu)")
    args = ap.parse_args()
    if args.smoke:
        raise SystemExit(_smoke(args.device))
    ap.error("only --smoke mode is wired as a CLI; embed "
             "ObservabilityServer(session) for real serving")
