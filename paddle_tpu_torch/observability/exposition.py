"""Exposition paths for the metrics runtime (counterpart of
``paddle_tpu/observability/exposition.py``, stdlib only).

* Prometheus scrapers — ``start_metrics_server()`` serves
  ``MetricRegistry.expose_text()`` over a stdlib ``http.server`` daemon
  thread (GET /metrics) on the address the caller binds.
* Offline/crash forensics — ``JsonlSnapshotWriter`` appends full
  registry snapshots as JSONL, one flushed line a snapshot (a killed
  process loses at most the line being written).
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricRegistry, get_registry

__all__ = ["start_metrics_server", "MetricsServer", "JsonlSnapshotWriter"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Handle for a running scrape endpoint: `.port`, `.url`,
    `.shutdown()`."""

    def __init__(self, registry: MetricRegistry, addr: str, port: int):
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = reg.expose_text().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):          # keep scrapes silent
                pass

        self._httpd = ThreadingHTTPServer((addr, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = addr
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="paddle-tpu-metrics",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}/metrics"

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_metrics_server(port: int = 0, addr: str = "127.0.0.1",
                         registry: Optional[MetricRegistry] = None
                         ) -> MetricsServer:
    """Serve the registry at http://addr:port/metrics from a daemon
    thread.  ``port=0`` picks an ephemeral port (read it back from the
    returned handle) — the serving loop never blocks on the scraper."""
    return MetricsServer(registry or get_registry(), addr, port)


class JsonlSnapshotWriter:
    """Append-only JSONL registry snapshots (visualdl.LogWriter style).

    Each `.write()` appends ONE self-contained line
    ``{"time": ..., "metrics": {...}}`` and flushes, so a crashed
    serving process still leaves every completed snapshot readable."""

    def __init__(self, logdir: str = "./metrics_log",
                 registry: Optional[MetricRegistry] = None,
                 filename: str = "metrics.jsonl"):
        self.logdir = logdir
        self.registry = registry or get_registry()
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f = open(self.path, "a")

    def write(self, walltime: Optional[float] = None) -> dict:
        snap = self.registry.snapshot()
        rec = {"time": walltime if walltime is not None else time.time(),
               "metrics": snap}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
