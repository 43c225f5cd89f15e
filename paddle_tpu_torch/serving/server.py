"""Streaming HTTP frontend over a ``Scheduler`` or ``ReplicaRouter``
— and the per-host BACKEND the remote-replica transport drives
(counterpart of ``paddle_tpu/serving/server.py``).

Stdlib-only (``http.server``), mirroring
``observability.exposition.MetricsServer``'s dependency discipline.

Data-plane endpoints (end users):

* ``POST /v1/completions`` — JSON body
  ``{"prompt": [token ids], "max_tokens": N, "stream": true,
  "eos_token_id": ..., "priority": ..., "deadline": ...,
  "max_queue_time": ..., "id": ...}``.  With ``stream`` (the
  default) the response is chunked ``application/x-ndjson``: one
  ``{"id", "tokens": [...]}`` line per engine step window as tokens
  are produced, then a terminal ``{"id", "done": true, "state",
  "n_tokens", "deadline_missed"}`` line.  ``"stream": false``
  returns one JSON object with the full token list.  A streaming
  client that sends ``Accept: text/event-stream`` gets the SAME
  events as SSE instead: ``data: {json}`` frames (one per NDJSON
  line, produced by one shared encoder) closed by a ``data: [DONE]``
  terminator.  Overload maps to
  HTTP: a shed request is ``429``, an invalid one ``400``, an
  oversized body ``413``.  Unless the body names its own
  ``deadline``, the frontend's ``request_timeout`` is submitted as
  the scheduler deadline — a client that gave up cannot leave its
  request decoding (a still-waiting request sheds at the moment the
  client stops listening).

Control-plane endpoints (``RemoteReplica`` in
serving/transport.py — non-blocking, JSON in/out, no long-lived
connections):

* ``POST /v1/submit`` — enqueue without streaming; IDEMPOTENT by
  rid: a rid the target already knows acks ``{"accepted": true,
  "duplicate": true}`` instead of double-admitting (the retry-after-
  lost-reply case).
* ``POST /v1/poll`` — ``{"ids": [...]}`` → per-rid state + full
  token list so far (the client diffs); unknown rids answer
  ``state="unknown"``.
* ``POST /v1/cancel`` / ``/v1/result`` / ``/v1/pop_result`` /
  ``/v1/forget`` — the scheduler surface, 429 for shed results,
  400 for contract violations.
* ``POST /v1/drain`` — stop admission (healthz turns 503).
* ``POST /v1/migrate_out`` / ``/v1/migrate_in`` — the KV-migration
  hop: packages travel as JSON with the swap blob base64-encoded;
  both run ON THE LOOP THREAD (engine state moves) via the command
  queue, and ``migrate_in`` is idempotent by rid like submit.
* ``GET /v1/load`` — the least-loaded routing key, cheap.
* ``GET /v1/stats`` — the target's full ``metrics_snapshot()``.
* ``GET /healthz`` — 200 while serving; **503** with a reason body
  when the scheduler is DRAINING or the loop thread died (WEDGED) —
  the prober and any LB act on the status code alone.
* ``GET /metrics`` — Prometheus text via the observability registry.
* ``GET /capsulez`` / ``GET /v1/capsule?rid=`` /
  ``POST /v1/replay`` — the request-capsule plane: store summary,
  one full capsule, and bit-exact replay of a capsule (local by rid
  or shipped in the body) through this backend's engine, returning
  the per-step divergence report.

The frontend owns the scheduling loop: a daemon thread drives
``target.step()`` whenever work is pending, so handler threads only
submit and wait on their per-request event queues — all engine work,
and with it every CUDA launch, stays on ONE thread, as the scheduler's
contract requires.  Handlers that touch engine state marshal closures
onto that thread through ``_on_loop``: migration and replay as in the
reference, and here also every read that reaches the engine
(``metrics_snapshot``, ``load``, ``fleet_snapshot``, the ``/memz``
rows — an MoE engine's snapshot copies its expert counts off the
card), so no handler thread touches a device tensor or engine state
while a step runs.  A step that raises ends the loop thread with the
error kept (``loop_error``); ``/healthz`` then answers 503 ``wedged``
with it, and the error still propagates on that thread.
"""
from __future__ import annotations

import base64
import json
import logging
import platform
import queue
import sys
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ..common.errors import EnforceError, UnavailableError
from ..observability import get_registry
from ..observability import capsule as _capsule
from ..observability import health as _health
from ..observability import introspection as _insp
from ..observability import tracing as _tracing
from ..observability.exposition import CONTENT_TYPE as _PROM_CONTENT_TYPE
from .scheduler import RejectedError

__all__ = ["HTTPFrontend", "start_http_frontend"]

_TERMINAL = ("finished", "cancelled", "shed")
_LOG = logging.getLogger("paddle_tpu_torch.serving")


class HTTPFrontend:
    """Serving endpoint handle: ``.port`` / ``.url``, ``.shutdown()``.
    ``target`` is anything with the scheduler request surface
    (``submit/cancel/pop_result/step/busy/metrics_snapshot`` and, for
    the control plane, ``knows/snapshot_requests/load/migrate_*``) —
    a ``Scheduler`` or a ``ReplicaRouter``.  ``max_body_bytes`` caps
    request bodies (oversized → 413) so a hostile Content-Length
    cannot balloon memory; one token of a Llama-3-8B request's pages
    is 131,072 bf16 bytes, so a backend that takes remote migrations
    at that width needs a larger cap.  ``/memz`` and ``/statusz`` read
    the device of the target's engine."""

    def __init__(self, target, addr: str = "127.0.0.1", port: int = 0,
                 registry=None, default_max_tokens: int = 64,
                 request_timeout: float = 120.0,
                 poll_interval: float = 0.002,
                 max_body_bytes: int = 4 << 20,
                 slow_ttft: Optional[float] = 1.0):
        self.target = target
        self.registry = registry or get_registry()
        self.default_max_tokens = default_max_tokens
        self.request_timeout = request_timeout
        self.poll_interval = poll_interval
        self.max_body_bytes = int(max_body_bytes)
        # TTFT threshold (seconds) past which one slow-request line —
        # rid, trace_id, queue wait, preemptions — is logged; None
        # disables
        self.slow_ttft = slow_ttft
        self._t_start = time.monotonic()
        self._stop = threading.Event()
        self._cmds: "queue.Queue[tuple]" = queue.Queue()
        self.loop_error: Optional[BaseException] = None
        self.device = _target_device(target)
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):        # keep request logs quiet
                pass

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_json(self) -> Optional[dict]:
                """Parse the JSON body under the size cap; on any
                violation the error response is already written and
                ``None`` returns (the caller just stops)."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._json(400, {"error": "invalid Content-Length"})
                    return None
                if n < 0:
                    self._json(400, {"error": "invalid Content-Length"})
                    return None
                if n > frontend.max_body_bytes:
                    self._json(413, {
                        "error": f"request body of {n} bytes exceeds "
                                 f"the {frontend.max_body_bytes}-byte "
                                 f"limit"})
                    return None
                try:
                    return json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad JSON body: {e}"})
                    return None

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    code, body = frontend._health()
                    self._json(code, body)
                elif path == "/metrics":
                    body = frontend.registry.expose_text().encode(
                        "utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     _PROM_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/statusz":
                    frontend._guarded(self, frontend._statusz)
                elif path == "/tracez":
                    frontend._guarded(
                        self, lambda: frontend._tracez(query))
                elif path == "/v1/load":
                    frontend._guarded(self, lambda: {
                        "load": frontend._on_loop(frontend.target.load)})
                elif path == "/v1/requests":
                    frontend._guarded(self, lambda: {
                        "requests":
                            frontend.target.requests_overview()})
                elif path == "/v1/stats":
                    frontend._guarded(self, frontend._snapshot)
                elif path == "/v1/metrics_snapshot":
                    # the federation scrape verb: same payload as
                    # /v1/stats today, but a dedicated route so the
                    # fleet plane can version it independently
                    frontend._guarded(self, frontend._snapshot)
                elif path == "/fleetz":
                    frontend._guarded(self, frontend._fleetz)
                elif path == "/compilez":
                    frontend._guarded(self, frontend._compilez)
                elif path == "/memz":
                    frontend._guarded(self, frontend._memz)
                elif path == "/capsulez":
                    frontend._guarded(self, frontend._capsulez)
                elif path == "/v1/capsule":
                    frontend._guarded(
                        self, lambda: frontend._capsule_get(query))
                else:
                    self._json(404, {"error": f"no route {path}"})

            def do_POST(self):
                path = self.path.split("?")[0]
                routes = {
                    "/v1/completions": frontend._completions,
                    "/v1/submit": frontend._cp_submit,
                    "/v1/cancel": frontend._cp_cancel,
                    "/v1/poll": frontend._cp_poll,
                    "/v1/result": frontend._cp_result,
                    "/v1/pop_result": frontend._cp_pop_result,
                    "/v1/forget": frontend._cp_forget,
                    "/v1/drain": frontend._cp_drain,
                    "/v1/timeline": frontend._cp_timeline,
                    "/v1/migrate_out": frontend._cp_migrate_out,
                    "/v1/migrate_in": frontend._cp_migrate_in,
                    "/v1/replay": frontend._cp_replay,
                }
                fn = routes.get(path)
                if fn is None:
                    self._json(404, {"error": f"no route {path}"})
                    return
                body = self._read_json()
                if body is None:
                    return
                fn(self, body)

        self._httpd = ThreadingHTTPServer((addr, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = addr
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="paddle-tpu-serving-http", daemon=True)
        self._loop_thread = threading.Thread(
            target=self._loop, name="paddle-tpu-serving-sched",
            daemon=True)
        self._http_thread.start()
        self._loop_thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}"

    # -- the scheduling loop ---------------------------------------------------
    def _loop(self):
        try:
            while not self._stop.is_set():
                self._run_cmds()
                if self.target.busy():
                    self.target.step()
                else:
                    self._stop.wait(self.poll_interval)
        except BaseException as e:
            # the thread dies with the error (it propagates to the
            # thread's excepthook); /healthz reports it as wedged
            self.loop_error = e
            _tracing.record_event(
                "error", where="serving-loop",
                error=f"{type(e).__name__}: {e}")
            raise
        self._run_cmds()                      # unblock late callers

    def _run_cmds(self):
        """Execute marshaled closures (engine-state work from handler
        threads) on the loop thread."""
        while True:
            try:
                fn, box, done = self._cmds.get_nowait()
            except queue.Empty:
                return
            try:
                box[0] = fn()
            except BaseException as e:
                box[1] = e
            done.set()

    def _on_loop(self, fn, timeout: float = 60.0):
        """Run ``fn`` on the scheduling loop thread and return its
        result — the engine-state marshaling primitive (the scheduler
        contract: ONE thread owns all engine work)."""
        if not self._loop_thread.is_alive():
            raise UnavailableError(
                "scheduler loop thread is not running")
        box = [None, None]
        done = threading.Event()
        self._cmds.put((fn, box, done))
        if not done.wait(timeout):
            raise UnavailableError("loop-thread command timed out")
        if box[1] is not None:
            raise box[1]
        return box[0]

    def shutdown(self, drain: bool = True):
        """Stop serving.  ``drain=True`` finishes in-flight requests
        first (new submissions are already refused once the HTTP
        socket closes)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=10)
        self._stop.set()
        self._loop_thread.join(timeout=10)
        if drain:
            self.target.drain()

    def kill(self):
        """Chaos hook: die NOW — close the socket and stop the loop
        with no drain and no handshakes, the closest an in-process
        server gets to a host crash.  Subsequent connections are
        refused; in-flight state is simply gone."""
        self._stop.set()
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._http_thread.join(timeout=10)
        self._loop_thread.join(timeout=10)

    def _snapshot(self) -> dict:
        """The target's ``metrics_snapshot()``, read on the loop thread
        (it reaches engine state)."""
        return self._on_loop(self.target.metrics_snapshot)

    # -- handlers: health ------------------------------------------------------
    def _health(self) -> tuple:
        """(status code, body): 200 only while this backend can take
        and make progress on work — 503 ``draining`` once admission
        stopped, 503 ``wedged`` when the scheduling loop thread died
        (alive socket, dead engine: the worst failure to hide)."""
        if not self._loop_thread.is_alive() and not self._stop.is_set():
            self._wedge_dump("loop thread died")
            err = self.loop_error
            return 503, {"status": "wedged",
                         "reason": "scheduler loop thread died — "
                                   "accepting connections but not "
                                   "decoding",
                         "error": None if err is None
                         else f"{type(err).__name__}: {err}"}
        try:
            snap = self._snapshot()
        except Exception as e:
            self._wedge_dump(f"target snapshot failed: {e}")
            return 503, {"status": "wedged",
                         "reason": f"target snapshot failed: {e}"}
        out = {"status": "ok"}
        draining = bool(snap.get("draining", False))
        if "replicas" in snap:                # router target
            out["replicas"] = [
                {"replica": r["replica"], "healthy": r["healthy"],
                 "load": r["load"]} for r in snap["replicas"]]
            scheds = [r.get("sched", {}) for r in snap["replicas"]]
            draining = bool(scheds) and all(
                s.get("draining", False) for s in scheds)
        else:
            out["waiting"] = snap.get("waiting", 0)
            out["draining"] = draining
        if draining:
            return 503, {**out, "status": "draining",
                         "reason": "scheduler is draining; new work "
                                   "is refused"}
        return 200, out

    def _wedge_dump(self, reason: str):
        """Wedge detected: record it and dump the flight record ONCE
        (health probes repeat; the record must not be rewritten on
        every probe)."""
        rec = _tracing.get_flight_recorder()
        if rec is not None:
            rec.record("wedge", reason=reason, port=self.port)
            try:
                rec.dump_once("wedged")
            except Exception:
                pass                      # a failing dump can't take
                                          # the health endpoint down

    # -- handlers: statusz / tracez --------------------------------------------
    def _statusz(self) -> dict:
        """Operator summary: build/config, the live request table with
        ages, cache occupancy, latency percentiles, recent errors —
        the one page to read FIRST when a host misbehaves."""
        # the port's build line: torch, its CUDA and the card (the
        # reference names its jax here)
        dev = torch.device(self.device) if self.device is not None \
            else (torch.device("cuda") if torch.cuda.is_available()
                  else None)
        cuda = dev is not None and dev.type == "cuda"
        out = {
            "status": self._health()[1].get("status", "ok"),
            "uptime_seconds": time.monotonic() - self._t_start,
            "build": {"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "device": str(dev) if dev is not None else None,
                      "device_name": torch.cuda.get_device_name(dev)
                      if cuda else "cpu",
                      "platform": platform.platform()},
            "config": {"addr": self.addr, "port": self.port,
                       "default_max_tokens": self.default_max_tokens,
                       "request_timeout": self.request_timeout,
                       "slow_ttft": self.slow_ttft},
        }
        try:
            out["requests"] = self.target.requests_overview()
        except Exception as e:
            out["requests"] = [{"error": str(e)}]
        try:
            snap = self._snapshot()
        except Exception as e:
            snap = {"error": str(e)}
        # surface the capacity/latency headline (router targets nest
        # per-replica; scheduler targets answer directly)
        eng = snap.get("engine") or {}
        out["target"] = {
            "waiting": snap.get("waiting"),
            "suspended": snap.get("suspended"),
            "draining": snap.get("draining"),
            "shed": snap.get("shed"),
            "replicas": len(snap["replicas"])
            if "replicas" in snap else None,
            "kv_page_utilization": eng.get("kv_page_utilization"),
            "active_requests": eng.get("active_requests"),
            "prefilling_requests": eng.get("prefilling_requests"),
            # ragged unified step: the last mixed batch's decode/
            # prefill split (interleave ratio = prefill / (prefill +
            # decode)) and the compile counter (0 in eager PyTorch)
            "mixed_batch_decode_slots":
                eng.get("mixed_batch_decode_slots"),
            "mixed_batch_prefill_tokens":
                eng.get("mixed_batch_prefill_tokens"),
            "mixed_compiles": eng.get("mixed_compiles"),
            # MoE serving: per-expert load + imbalance SLO (None for
            # dense-FFN backbones; scheduler targets nest the engine
            # snapshot, router targets federate via /fleetz)
            "moe": eng.get("moe") if isinstance(eng, dict)
            else snap.get("moe"),
            # speculative decoding: acceptance headline (None without
            # a draft_model; router targets federate via /fleetz)
            "spec": eng.get("spec") if isinstance(eng, dict)
            else snap.get("spec"),
            "ttft_seconds": self._ttft_view(eng),
        }
        tr = _tracing.get_tracer()
        out["tracing"] = {"enabled": tr is not None and tr.enabled,
                          "finished_spans": len(tr.finished_spans())
                          if tr is not None else 0,
                          "dropped_spans": tr.dropped
                          if tr is not None else 0}
        rec = _tracing.get_flight_recorder()
        out["recent_errors"] = rec.recent_errors() \
            if rec is not None else []
        cs = _capsule.get_capsule_store()
        if cs.enabled:
            out["capsules"] = cs.snapshot()
            # an error line with a captured capsule carries its id —
            # the operator goes straight from /statusz to
            # /v1/capsule?rid= to /v1/replay without grepping logs
            annotated = []
            for err in out["recent_errors"]:
                rid = err.get("rid")
                cap = cs.capsule_id(rid) if rid is not None else None
                annotated.append({**err, "capsule": cap}
                                 if cap is not None else err)
            out["recent_errors"] = annotated
        return out

    @staticmethod
    def _ttft_view(eng: dict) -> Optional[dict]:
        """The /statusz TTFT block.  With the health plane on, the
        percentiles come from the sliding window (what latency looks
        like NOW) instead of the lifetime histogram a week of uptime
        has diluted; either way an empty view renders ``"n/a"``, not
        a 0.0 that reads as "instant"."""
        h = _health.get_health()
        if h.enabled:
            win = h.snapshot()["windows"]["ttft"]
            view = {k: win.get(k) for k in
                    ("count", "mean", "p50", "p95", "p99")}
            view["window_seconds"] = win["window_seconds"]
        elif isinstance(eng.get("ttft_seconds"), dict):
            view = {k: eng["ttft_seconds"][k]
                    for k in ("count", "mean", "p50", "p95", "p99")
                    if k in eng["ttft_seconds"]}
        else:
            return None
        return {k: ("n/a" if v is None else v)
                for k, v in view.items()}

    def _fleetz(self) -> dict:
        """The federated fleet page: per-replica circuit/load/KV/SLO
        state plus merged fleet-wide counters and histograms.  Router
        targets answer from ``fleet_snapshot()``; a single-replica
        target is presented as a fleet of one so operators can point
        dashboards at any tier."""
        target = self.target
        if hasattr(target, "fleet_snapshot"):
            return self._on_loop(target.fleet_snapshot)
        try:
            snap = self._snapshot()
            stale, err = False, None
        except Exception as e:
            snap, stale, err = None, True, str(e)
        eng = (snap or {}).get("engine") or {}
        row = {"replica": 0, "ejected": False, "healthy": not stale,
               "load": None, "stale": stale, "metrics": snap,
               "kv_page_utilization": eng.get("kv_page_utilization"),
               "slo": ((snap or {}).get("health") or {}).get("slo")}
        if err is not None:
            row["error"] = err
        try:
            row["load"] = self._on_loop(target.load)
        except Exception:
            pass
        out = {"router": None, "replicas": [row],
               "fleet": {"replicas": 1,
                         "scraped": 0 if stale else 1,
                         "stale": 1 if stale else 0}}
        h = _health.get_health()
        if h.enabled:
            out["health"] = h.snapshot()
        cw = _insp.get_compile_watch()
        if cw.enabled:
            out["introspection"] = cw.snapshot(include_log=False)
        return out

    def _compilez(self) -> dict:
        """Compile log + per-program table from the CompileWatch
        (``{"enabled": false}`` with a note when the plane is off —
        the endpoint always answers, like /tracez; eager PyTorch
        records no compiles)."""
        return _insp.compilez_snapshot()

    def _memz(self) -> dict:
        """Memory plane of the engine's device: the caching allocator's
        watermarks (``torch.cuda.memory_stats``), accounted pool rows
        (paged KV, host swap, checkpoint staging) and top consumers."""
        return self._on_loop(lambda: _insp.memz_snapshot(self.device))

    def _tracez(self, query: str) -> dict:
        """Recent slow traces: every trace whose wall extent exceeds
        ``threshold_ms`` (query param, default 100), slowest first,
        ``limit`` traces (default 20) with their full span trees."""
        qs = urllib.parse.parse_qs(query or "")
        thr_ms = float(qs.get("threshold_ms", ["100"])[0])
        limit = int(qs.get("limit", ["20"])[0])
        tr = _tracing.get_tracer()
        if tr is None or not tr.enabled:
            return {"enabled": False, "threshold_ms": thr_ms,
                    "traces": []}
        traces = tr.slow_traces(thr_ms / 1e3, limit=limit)
        for t in traces:
            t["duration_ms"] = t.pop("duration") * 1e3
        return {"enabled": True, "threshold_ms": thr_ms,
                "traces": traces}

    # -- handlers: capsules ----------------------------------------------------
    def _capsulez(self) -> dict:
        """Capture/replay plane summary: store counters, recent
        audits, and one brief row per live capsule
        (``{"enabled": false}`` when the plane is off — the endpoint
        always answers, like /compilez)."""
        return _capsule.get_capsule_store().capsulez()

    def _capsule_get(self, query: str) -> dict:
        """The full capsule for one request id — what an operator
        downloads to replay elsewhere (``POST /v1/replay`` accepts it
        verbatim as ``{"capsule": ...}``)."""
        qs = urllib.parse.parse_qs(query or "")
        rid = (qs.get("rid") or [None])[0]
        if not rid:
            raise EnforceError("need ?rid=<request id>")
        cap = _capsule.get_capsule_store().get(rid)
        if cap is None:
            raise EnforceError(f"no capsule for rid {rid!r} (capture "
                               f"off, never captured, or evicted)")
        return {"id": rid, "capsule": cap}

    # -- handlers: data plane --------------------------------------------------
    def _completions(self, handler, body: dict):
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or \
                not all(isinstance(t, int) for t in prompt):
            handler._json(400, {"error": "'prompt' must be a list of "
                                         "token ids"})
            return
        rid = body.get("id") or uuid.uuid4().hex
        stream = bool(body.get("stream", True))
        events: "queue.Queue[dict]" = queue.Queue()
        # the request's ROOT span: children (queue wait, admission,
        # engine work — possibly on another host) parent here, so one
        # /v1/completions = one connected trace.  An inbound trace
        # context (an upstream proxy's headers) is adopted as parent.
        root = _tracing.start_span(
            "http.request", activate=False,
            ctx=_tracing.extract_headers(handler.headers),
            attrs={"rid": str(rid), "path": "/v1/completions"})
        kw = dict(max_new_tokens=int(body.get("max_tokens",
                                              self.default_max_tokens)),
                  priority=int(body.get("priority", 0)),
                  on_event=events.put)
        if root is not _tracing.NULL_SPAN:
            kw["trace_ctx"] = root.context()
        if body.get("eos_token_id") is not None:
            kw["eos_token_id"] = int(body["eos_token_id"])
        if body.get("deadline") is not None:
            kw["deadline"] = float(body["deadline"])
        elif self.request_timeout is not None:
            # a client that times out stops listening at
            # request_timeout — submit that as the scheduler deadline
            # so its request cannot keep decoding for nobody
            kw["deadline"] = float(self.request_timeout)
        if body.get("max_queue_time") is not None:
            kw["max_queue_time"] = float(body["max_queue_time"])
        try:
            self.target.submit(rid, prompt, **kw)
        except RejectedError as e:
            root.set_attr("status", 429).end()
            handler._json(429, {"error": str(e), "id": rid})
            return
        except EnforceError as e:
            root.set_attr("status", 400).end()
            handler._json(400, {"error": str(e), "id": rid})
            return
        try:
            if stream:
                # an Accept: text/event-stream client gets SSE
                # framing; everything else keeps the chunked-NDJSON
                # default.  Same events, same teardown.
                sse = "text/event-stream" in \
                    (handler.headers.get("Accept") or "")
                self._stream_response(handler, rid, events, sse=sse)
            else:
                self._unary_response(handler, rid, events)
        finally:
            self._log_if_slow(rid, root)
            root.end()
            self._forget(rid)

    def _log_if_slow(self, rid, root):
        """One structured log line for a request whose TTFT crossed
        the threshold — rid + trace_id is the handle an operator
        pastes into /tracez (or the exported trace) to see WHY."""
        if self.slow_ttft is None:
            return
        try:
            tl = self.target.request_timeline(rid)
        except Exception:
            return
        ttft = tl.get("ttft")
        if ttft is None or ttft <= self.slow_ttft:
            return
        trace_id = tl.get("trace_id") or root.trace_id
        cap_id = tl.get("capsule")
        cs = _capsule.get_capsule_store()
        if cs.enabled and cap_id is None:
            # router-fronted targets may not have the scheduler-side
            # threshold armed — persist here so the slow line always
            # lands a replayable capsule handle
            cap_id = cs.persist(rid, "slow_ttft")
        _LOG.warning(
            "slow request rid=%s trace_id=%s capsule=%s ttft=%.3fs "
            "queue_wait=%s preemptions=%s state=%s n_tokens=%s",
            rid, trace_id, cap_id, ttft,
            f"{tl['queue_wait']:.3f}s"
            if tl.get("queue_wait") is not None else "?",
            tl.get("preemptions"), tl.get("state"),
            tl.get("n_tokens"))

    def _forget(self, rid):
        """Best-effort teardown after the response (or a client
        disconnect): cancel if still running, then drop the record so
        a long-lived server's memory stays bounded."""
        try:
            if self.target.status(rid) in ("waiting", "active",
                                           "suspended"):
                self.target.cancel(rid)
                # an active-request cancel lands at the loop thread's
                # next step(); wait it out before popping
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline and \
                        self.target.status(rid) in ("waiting", "active",
                                                    "suspended"):
                    time.sleep(self.poll_interval)
            self.target.forget(rid)
        except Exception:
            pass                              # already popped

    def _next_event(self, events) -> Optional[dict]:
        try:
            return events.get(timeout=self.request_timeout)
        except queue.Empty:
            return None

    @staticmethod
    def _encode_stream_event(rid, ev, n_tokens):
        """One queued engine event → its wire object — the SINGLE
        encoding both stream framings (NDJSON lines and SSE ``data:``
        events) share, so the two streams cannot drift.  Returns
        ``(obj_or_None, n_tokens, done)``; ``ev is None`` means the
        event wait timed out."""
        if ev is None:
            return ({"id": rid, "done": True, "state": "timeout",
                     "n_tokens": n_tokens}, n_tokens, True)
        if ev["type"] == "tokens":
            n_tokens += len(ev["tokens"])
            return ({"id": rid, "tokens": ev["tokens"]},
                    n_tokens, False)
        if ev["type"] in _TERMINAL:
            return ({"id": rid, "done": True, "state": ev["type"],
                     "n_tokens": len(ev.get("tokens", [])) or
                     n_tokens,
                     "deadline_missed": ev.get("deadline_missed",
                                               False),
                     "reason": ev.get("reason")}, n_tokens, True)
        return None, n_tokens, False

    def _stream_response(self, handler, rid, events,
                         sse: bool = False):
        handler.send_response(200)
        handler.send_header("Content-Type",
                            "text/event-stream" if sse
                            else "application/x-ndjson")
        handler.send_header("Transfer-Encoding", "chunked")
        if sse:
            handler.send_header("Cache-Control", "no-cache")
        handler.end_headers()

        def chunk(data: bytes):
            handler.wfile.write(hex(len(data))[2:].encode("ascii") +
                                b"\r\n" + data + b"\r\n")
            handler.wfile.flush()

        def emit(obj: dict):
            if sse:
                chunk(b"data: " +
                      json.dumps(obj).encode("utf-8") + b"\n\n")
            else:
                chunk((json.dumps(obj) + "\n").encode("utf-8"))

        n_tokens = 0
        while True:
            ev = self._next_event(events)
            obj, n_tokens, done = self._encode_stream_event(
                rid, ev, n_tokens)
            if obj is not None:
                emit(obj)
            if done:
                break
        if sse:
            chunk(b"data: [DONE]\n\n")   # the SSE terminator clients
                                         # key end-of-stream on
        handler.wfile.write(b"0\r\n\r\n")
        handler.wfile.flush()

    def _unary_response(self, handler, rid, events):
        tokens = []
        while True:
            ev = self._next_event(events)
            if ev is None:
                handler._json(504, {"error": "generation timed out",
                                    "id": rid,
                                    "tokens": tokens})
                return
            if ev["type"] == "tokens":
                tokens.extend(ev["tokens"])
            elif ev["type"] == "shed":
                handler._json(429, {"error": f"request shed "
                                             f"({ev.get('reason')})",
                                    "id": rid})
                return
            elif ev["type"] in _TERMINAL:
                handler._json(200, {
                    "id": rid, "state": ev["type"],
                    "tokens": ev.get("tokens") or tokens,
                    "deadline_missed": ev.get("deadline_missed",
                                              False)})
                return

    # -- handlers: control plane (the remote-replica surface) ------------------
    def _guarded(self, handler, fn):
        """Run ``fn`` and map the scheduler error vocabulary onto
        HTTP: shed → 429, contract violation → 400, anything else →
        500 (retryable transport-side)."""
        try:
            out = fn()
        except RejectedError as e:
            handler._json(429, {"error": str(e)})
        except EnforceError as e:
            handler._json(400, {"error": str(e)})
        except Exception as e:
            _tracing.record_event(
                "error", where=f"http:{handler.path.split('?')[0]}",
                error=f"{type(e).__name__}: {e}")
            _health.get_health().event("error_rate", bad=True)
            handler._json(500, {"error": f"{type(e).__name__}: {e}"})
        else:
            handler._json(200, out if isinstance(out, dict) else {})

    def _cp_submit(self, handler, body: dict):
        rid = body.get("id")
        prompt = body.get("prompt")
        if not rid or not isinstance(prompt, list) or \
                not all(isinstance(t, int) for t in prompt):
            handler._json(400, {"error": "need 'id' and 'prompt' "
                                         "(list of token ids)"})
            return
        kw = dict(max_new_tokens=int(body.get("max_tokens",
                                              self.default_max_tokens)),
                  priority=int(body.get("priority", 0)))
        if body.get("eos_token_id") is not None:
            kw["eos_token_id"] = int(body["eos_token_id"])
        if body.get("deadline") is not None:
            kw["deadline"] = float(body["deadline"])
        if body.get("max_queue_time") is not None:
            kw["max_queue_time"] = float(body["max_queue_time"])
        # cross-host trace context rides in the HEADERS (the remote
        # transport put it there): adopt it so this host's spans join
        # the submitter's trace
        ctx = _tracing.extract_headers(handler.headers)
        if ctx is not None:
            kw["trace_ctx"] = ctx

        def submit():
            if self.target.knows(rid):
                # idempotent resubmission: the first attempt WAS
                # admitted, its reply was lost — ack, don't double-run
                return {"id": rid, "accepted": True, "duplicate": True}
            try:
                self.target.submit(rid, prompt, **kw)
            except EnforceError:
                if self.target.knows(rid):    # lost the knows() race
                    return {"id": rid, "accepted": True,
                            "duplicate": True}
                raise
            return {"id": rid, "accepted": True}

        self._guarded(handler, submit)

    def _cp_cancel(self, handler, body: dict):
        rid = body.get("id")
        self._guarded(handler, lambda: {
            "id": rid, "cancelled": bool(self.target.cancel(rid))})

    def _cp_poll(self, handler, body: dict):
        ids = body.get("ids", [])
        self._guarded(handler, lambda: {
            "requests": self.target.snapshot_requests(ids)})

    def _cp_result(self, handler, body: dict):
        rid = body.get("id")
        self._guarded(handler, lambda: {
            "id": rid, "tokens": self.target.result(rid)})

    def _cp_pop_result(self, handler, body: dict):
        rid = body.get("id")
        self._guarded(handler, lambda: {
            "id": rid, "tokens": self.target.pop_result(rid)})

    def _cp_forget(self, handler, body: dict):
        rid = body.get("id")

        def forget():
            self.target.forget(rid)
            return {"id": rid}

        self._guarded(handler, forget)

    def _cp_timeline(self, handler, body: dict):
        rid = body.get("id")
        self._guarded(handler, lambda: {
            "id": rid,
            "timeline": self.target.request_timeline(rid)})

    def _cp_drain(self, handler, body: dict):
        resume = body.get("mode") == "resume"

        def drain():
            if resume:
                self.target.resume_admission()
            else:
                self.target.stop_admission()
            return {"draining": not resume}

        self._guarded(handler, drain)

    def _cp_migrate_out(self, handler, body: dict):
        rid = body.get("id")

        def migrate():
            pkg = self._on_loop(lambda: self.target.migrate_out(rid))
            if pkg is None:
                return {"package": None}
            pkg.pop("on_event", None)         # never crosses the wire
            if pkg.get("swap") is not None:
                pkg["swap"] = base64.b64encode(
                    pkg["swap"]).decode("ascii")
            return {"package": pkg}

        self._guarded(handler, migrate)

    def _cp_migrate_in(self, handler, body: dict):
        pkg = body.get("package")
        if not isinstance(pkg, dict) or "rid" not in pkg:
            handler._json(400, {"error": "need a 'package' with a "
                                         "'rid'"})
            return
        pkg = dict(pkg)
        pkg.pop("on_event", None)
        if pkg.get("swap") is not None:
            pkg["swap"] = base64.b64decode(pkg["swap"])

        def migrate():
            if self.target.knows(pkg["rid"]):
                return {"id": pkg["rid"], "accepted": True,
                        "duplicate": True}
            self._on_loop(lambda: self.target.migrate_in(pkg))
            return {"id": pkg["rid"], "accepted": True}

        self._guarded(handler, migrate)

    def _cp_replay(self, handler, body: dict):
        """Replay a capsule through THIS backend's engine and return
        the per-step divergence report.  Body: ``{"id": rid}``
        (resolved from the local store) or ``{"capsule": {...}}`` (a
        capsule fetched from another replica — the cross-replica audit
        hop).  Replay is engine work, so it runs on the loop thread
        like migration."""
        def replay():
            cap = body.get("capsule")
            if cap is None and body.get("id") is not None:
                cap = _capsule.get_capsule_store().get(body["id"])
                if cap is None:
                    raise EnforceError(
                        f"no capsule for rid {body['id']!r}")
            if not isinstance(cap, dict):
                raise EnforceError(
                    "need 'capsule' (a capsule object) or 'id' (a rid "
                    "with a live capsule)")
            engine = getattr(self.target, "engine", None)
            if engine is None:
                raise EnforceError(
                    "replay needs a scheduler-fronted backend (the "
                    "router tier has no engine of its own — POST to a "
                    "replica)")
            return self._on_loop(
                lambda: _capsule.replay_capsule(cap, engine),
                timeout=300.0)

        self._guarded(handler, replay)


def _target_device(target):
    """The device of the engine under ``target``: a scheduler's own, or
    the first in-process replica's of a router; None (the GPU) when no
    engine is reachable."""
    eng = getattr(target, "engine", None)
    if eng is not None:
        return getattr(eng, "device", None)
    for rep in getattr(target, "replicas", ()):
        eng = getattr(rep, "engine", None)
        if eng is not None:
            return getattr(eng, "device", None)
    return None


def start_http_frontend(target, addr: str = "127.0.0.1",
                        port: int = 0, **kw) -> HTTPFrontend:
    """Serve ``target`` (a Scheduler or ReplicaRouter) over HTTP on a
    daemon thread; ``port=0`` picks an ephemeral port (read it back
    from the handle)."""
    return HTTPFrontend(target, addr=addr, port=port, **kw)
