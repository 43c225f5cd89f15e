"""Request/step tracing + crash flight recorder (stdlib only).

Counterpart of ``paddle_tpu/observability/tracing.py``, kept as its own
copy.

- :class:`Tracer` — a low-overhead span tracer.  A span is
  ``(trace_id, span_id, parent_id, name, start, end, attrs)`` timed on
  an injectable monotonic clock.  Spans nest implicitly per thread (a
  span started while another is active parents to it), or explicitly
  via a ``ctx={"trace_id", "parent_id"}`` carried with the request
  (``inject_headers`` / ``extract_headers`` move it through HTTP
  headers, so a retried or migrated request yields one connected
  trace).  Finished spans live in a bounded ring; export as dicts or
  Chrome-trace JSON (the ``chrome://tracing`` / Perfetto format that
  ``profiler.export_chrome_tracing`` writes too).

- :class:`FlightRecorder` — a bounded in-memory ring of structured
  events plus the tracer's recent/open spans, dumped to JSONL on
  SIGTERM, fatal exceptions (``guard()``), or any explicit call.

Disabled-is-free contract: every instrumentation site goes through the
module-level :func:`span` / :func:`record_event` helpers, which read
ONE module global and return the shared :data:`NULL_SPAN` singleton
when no tracer is enabled — no allocation, no clock read, no lock.
Spans are host-side bookkeeping only: they never touch the sampling
key stream or a device tensor, so tracing cannot change tokens.
"""
from __future__ import annotations

import itertools
import json
import os
import signal
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "FlightRecorder", "NULL_SPAN",
           "get_tracer", "set_tracer", "enable_tracing",
           "disable_tracing", "span", "start_span", "record_span",
           "current_context", "get_flight_recorder",
           "enable_flight_recorder", "disable_flight_recorder",
           "record_event", "inject_headers", "extract_headers",
           "TRACE_ID_HEADER", "PARENT_SPAN_HEADER"]

# the cross-host trace-context carriers (HTTP headers)
TRACE_ID_HEADER = "X-Paddle-Trace-Id"
PARENT_SPAN_HEADER = "X-Paddle-Parent-Span"


class Span:
    """One timed operation.  ``end()`` (or ``with``) finalizes it into
    the tracer's ring; idempotent.  ``context()`` is the propagation
    handle: children created with it parent HERE."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end_time", "attrs", "_tracer", "_activated")

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 start, attrs=None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end_time = None
        self.attrs = dict(attrs) if attrs else {}
        self._activated = False

    def set_attr(self, key, value) -> "Span":
        self.attrs[key] = value
        return self

    def context(self) -> dict:
        return {"trace_id": self.trace_id, "parent_id": self.span_id}

    @property
    def duration(self) -> Optional[float]:
        if self.end_time is None:
            return None
        return self.end_time - self.start

    def end(self) -> None:
        self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start": self.start, "end": self.end_time,
                "duration": self.duration, "attrs": dict(self.attrs)}


class _NullSpan:
    """The disabled-tracing singleton: every method is a no-op, every
    ``span()`` call returns THIS object — the zero-allocation hot-path
    contract (``tracing.span(...) is tracing.NULL_SPAN`` when off)."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = None

    def set_attr(self, key, value):
        return self

    def context(self):
        return None

    def end(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + bounded ring of finished spans (see module
    docstring).  ``clock`` is injectable (monotonic by default);
    ``max_spans`` bounds memory — always-on tracing cannot grow
    without limit (``dropped`` counts ring evictions)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_spans: int = 4096):
        self.enabled = True
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        self._open: Dict[str, Span] = {}
        self._ids = itertools.count(1)
        # process-scoped id prefix: span ids stay unique when traces
        # cross hosts and merge (each host mints under its own pid)
        self._prefix = f"{os.getpid():x}"
        self._tls = threading.local()
        self.dropped = 0

    # -- ids / thread-local nesting --------------------------------------------
    def _next_id(self, kind: str) -> str:
        return f"{kind}{self._prefix}-{next(self._ids):x}"

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def current_context(self) -> Optional[dict]:
        cur = self.current()
        return cur.context() if cur is not None else None

    @staticmethod
    def context_of(span) -> Optional[dict]:
        return span.context() if isinstance(span, Span) else None

    # -- span lifecycle --------------------------------------------------------
    def start_span(self, name: str, ctx: Optional[dict] = None,
                   attrs: Optional[dict] = None,
                   activate: bool = True) -> Span:
        """Open a span.  Parenting: explicit ``ctx`` wins (the
        propagated request context); otherwise the thread's current
        active span; otherwise a fresh trace root.  ``activate=True``
        makes it the thread's current span until it ends — pass False
        for spans held open across threads/time (queue waits,
        suspensions)."""
        trace_id = parent_id = None
        if ctx:
            trace_id = ctx.get("trace_id")
            parent_id = ctx.get("parent_id")
        else:
            cur = self.current()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
        if trace_id is None:
            trace_id = self._next_id("t")
        sp = Span(self, name, trace_id, self._next_id("s"), parent_id,
                  self._clock(), attrs)
        if activate:
            self._stack().append(sp)
            sp._activated = True
        with self._lock:
            self._open[sp.span_id] = sp
        return sp

    def span(self, name: str, ctx: Optional[dict] = None,
             attrs: Optional[dict] = None) -> Span:
        """``start_span`` with thread-local activation — the ``with``
        form every instrumentation site uses."""
        return self.start_span(name, ctx=ctx, attrs=attrs)

    def record_span(self, name: str, duration: float,
                    ctx: Optional[dict] = None,
                    attrs: Optional[dict] = None) -> Span:
        """Retroactively record a span that just ended (duration
        measured by the caller, e.g. StepTimer's fenced step time)."""
        now = self._clock()
        trace_id = (ctx or {}).get("trace_id") or self._next_id("t")
        sp = Span(self, name, trace_id, self._next_id("s"),
                  (ctx or {}).get("parent_id"), now - duration, attrs)
        sp.end_time = now
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(sp)
        return sp

    def _finish(self, sp: Span) -> None:
        if sp.end_time is not None:        # idempotent
            return
        sp.end_time = self._clock()
        if sp._activated:
            st = self._stack()
            # tolerate out-of-order ends (a held child outliving its
            # parent must not corrupt the stack)
            if sp in st:
                st.remove(sp)
            sp._activated = False
        with self._lock:
            self._open.pop(sp.span_id, None)
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(sp)

    # -- export ----------------------------------------------------------------
    def finished_spans(self, trace_id: Optional[str] = None
                       ) -> List[dict]:
        with self._lock:
            spans = list(self._spans)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return [s.to_dict() for s in spans]

    def open_spans(self) -> List[dict]:
        """Spans started but not ended — the crash-dump view of what
        the process was doing."""
        with self._lock:
            return [s.to_dict() for s in self._open.values()]

    def traces(self) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for s in self.finished_spans():
            out.setdefault(s["trace_id"], []).append(s)
        return out

    def slow_traces(self, threshold: float,
                    limit: int = 20) -> List[dict]:
        """Recent traces whose wall extent (first start to last end)
        exceeds ``threshold`` seconds, slowest first — the /tracez
        payload."""
        out = []
        for tid, spans in self.traces().items():
            t0 = min(s["start"] for s in spans)
            t1 = max(s["end"] for s in spans)
            if t1 - t0 <= threshold:
                continue
            roots = [s for s in spans if s["parent_id"] is None]
            root = roots[0] if roots else \
                min(spans, key=lambda s: s["start"])
            out.append({"trace_id": tid, "name": root["name"],
                        "duration": t1 - t0, "n_spans": len(spans),
                        "attrs": root["attrs"], "spans": spans})
        out.sort(key=lambda t: -t["duration"])
        return out[:limit]

    def chrome_events(self, trace_id: Optional[str] = None,
                      tid: int = 0) -> List[dict]:
        """Complete ("ph": "X") Chrome-trace events for the finished
        spans — microsecond timestamps per the trace-event format."""
        return [{"name": s["name"], "ph": "X", "pid": os.getpid(),
                 "tid": tid, "ts": int(s["start"] * 1e6),
                 "dur": int((s["end"] - s["start"]) * 1e6),
                 "args": dict(s["attrs"], trace_id=s["trace_id"],
                              span_id=s["span_id"])}
                for s in self.finished_spans(trace_id)]

    def to_chrome_trace(self, trace_id: Optional[str] = None) -> dict:
        return {"traceEvents": self.chrome_events(trace_id)}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open.clear()
        self.dropped = 0


# -- the module-global tracer (the ONE hot-path indirection) -------------------
_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    global _TRACER
    _TRACER = tracer
    return tracer


def enable_tracing(clock: Optional[Callable[[], float]] = None,
                   max_spans: int = 4096) -> Tracer:
    """Install a fresh process-global tracer and return it."""
    return set_tracer(Tracer(clock=clock, max_spans=max_spans))


def disable_tracing() -> None:
    set_tracer(None)


def span(name: str, ctx: Optional[dict] = None,
         attrs: Optional[dict] = None):
    """THE instrumentation entry point: an activated span when tracing
    is on, the shared :data:`NULL_SPAN` when off (no allocation)."""
    t = _TRACER
    if t is None or not t.enabled:
        return NULL_SPAN
    return t.start_span(name, ctx=ctx, attrs=attrs)


def start_span(name: str, ctx: Optional[dict] = None,
               attrs: Optional[dict] = None, activate: bool = True):
    """Explicit-lifetime variant of :func:`span` (held spans: queue
    waits, suspensions)."""
    t = _TRACER
    if t is None or not t.enabled:
        return NULL_SPAN
    return t.start_span(name, ctx=ctx, attrs=attrs, activate=activate)


def record_span(name: str, duration: float,
                ctx: Optional[dict] = None,
                attrs: Optional[dict] = None) -> None:
    t = _TRACER
    if t is not None and t.enabled:
        t.record_span(name, duration, ctx=ctx, attrs=attrs)


def current_context() -> Optional[dict]:
    t = _TRACER
    if t is None or not t.enabled:
        return None
    return t.current_context()


# -- HTTP propagation ----------------------------------------------------------
def inject_headers(ctx: Optional[dict],
                   headers: Optional[dict] = None) -> dict:
    """Fold a trace context into an HTTP header dict (no-op for a
    None context) — the remote transport calls this on every submit/
    migrate so the far host's spans join the same trace."""
    headers = dict(headers) if headers else {}
    if ctx and ctx.get("trace_id"):
        headers[TRACE_ID_HEADER] = str(ctx["trace_id"])
        if ctx.get("parent_id"):
            headers[PARENT_SPAN_HEADER] = str(ctx["parent_id"])
    return headers


def extract_headers(headers) -> Optional[dict]:
    """Read a trace context back out of request headers (anything with
    ``.get``); None when the request carries no trace."""
    tid = headers.get(TRACE_ID_HEADER)
    if not tid:
        return None
    return {"trace_id": tid,
            "parent_id": headers.get(PARENT_SPAN_HEADER) or None}


# -- flight recorder -----------------------------------------------------------
class FlightRecorder:
    """Bounded ring of structured events + the tracer's recent/open
    spans, dumped to JSONL when the process is about to die (module
    docstring).  ``dump()`` is safe to call from a signal handler:
    pure-python file writes, no locks shared with the hot path held
    across the write."""

    def __init__(self, path: Optional[str] = None,
                 max_events: int = 2048,
                 tracer: Optional[Tracer] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.path = path or "flight_recorder.jsonl"
        self._events: deque = deque(maxlen=max_events)
        self._tracer = tracer
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._prev_sigterm = None
        self._dumped_reasons: set = set()
        self.dumps = 0

    # -- events ----------------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        ev = {"t": self._clock(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)

    def record_error(self, where: str, err: BaseException) -> None:
        self.record("error", where=where,
                    error=f"{type(err).__name__}: {err}")

    def recent(self, n: Optional[int] = None,
               kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs[-n:] if n else evs

    def recent_errors(self, n: int = 20) -> List[dict]:
        return self.recent(n, kind="error")

    # -- dumping ---------------------------------------------------------------
    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> str:
        """Write the flight record as JSONL: one header line, then one
        line per event, open span, and finished span.  Returns the
        path written."""
        path = path or self.path
        tracer = self._tracer if self._tracer is not None else _TRACER
        lines = [{"type": "flight_recorder", "reason": reason,
                  "wall_time": time.time(), "pid": os.getpid(),
                  "n_events": len(self._events)}]
        lines.extend({"type": "event", **e} for e in self.recent())
        if tracer is not None:
            lines.extend({"type": "span", "open": True, **s}
                         for s in tracer.open_spans())
            lines.extend({"type": "span", **s}
                         for s in tracer.finished_spans())
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self.dumps += 1
        return path

    def dump_once(self, reason: str,
                  path: Optional[str] = None) -> Optional[str]:
        """``dump`` at most once per reason — wedge detection runs on
        every health probe and must not rewrite the record forever."""
        with self._lock:
            if reason in self._dumped_reasons:
                return None
            self._dumped_reasons.add(reason)
        return self.dump(path=path, reason=reason)

    # -- triggers --------------------------------------------------------------
    def guard(self, reason: str = "fatal"):
        """Context manager: a raising body records the exception and
        dumps before re-raising — wrap a serving loop / train loop so
        an unhandled fatal leaves the record behind."""
        recorder = self

        class _Guard:
            def __enter__(self):
                return recorder

            def __exit__(self, etype, exc, tb):
                if exc is not None:
                    recorder.record_error(reason, exc)
                    recorder.dump(reason=reason)
                return False

        return _Guard()

    def install_signal_hook(self, signum: int = signal.SIGTERM) -> None:
        """Dump on ``signum`` (SIGTERM: the preemption/eviction
        signal), then chain any previously-installed python handler
        (same discipline as CheckpointManager's preemption hook).
        Main-thread only."""
        prev = signal.getsignal(signum)

        def handler(sig, frame):
            self.record("signal", signum=int(sig))
            try:
                self.dump(reason=f"signal_{int(sig)}")
            except Exception:
                pass                      # dying anyway: best effort
            if callable(prev) and prev not in (
                    signal.SIG_DFL, signal.SIG_IGN,
                    signal.default_int_handler):
                prev(sig, frame)

        self._prev_sigterm = (signum, prev)
        signal.signal(signum, handler)

    def uninstall_signal_hook(self) -> None:
        if self._prev_sigterm is not None:
            signum, prev = self._prev_sigterm
            signal.signal(signum, prev)
            self._prev_sigterm = None


_RECORDER: Optional[FlightRecorder] = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def enable_flight_recorder(path: Optional[str] = None,
                           **kw) -> FlightRecorder:
    global _RECORDER
    _RECORDER = FlightRecorder(path=path, **kw)
    return _RECORDER


def disable_flight_recorder() -> None:
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.uninstall_signal_hook()
    _RECORDER = None


def record_event(kind: str, **fields) -> None:
    """Hot-path event helper: one global read, no-op when no recorder
    is enabled."""
    r = _RECORDER
    if r is not None:
        r.record(kind, **fields)
