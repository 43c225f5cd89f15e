"""Remote-replica transport (counterpart of
``paddle_tpu/serving/transport.py``): drive per-host HTTP backends
through the same duck-typed interface ``ReplicaRouter`` uses for
in-process ``Scheduler`` replicas.

``RemoteReplica`` wraps one backend (``serving/server.py`` serving a
``Scheduler`` over HTTP) behind the scheduler request surface —
``submit`` / ``cancel`` / ``status`` / ``result`` / ``pop_result`` /
``forget`` / ``step`` / ``busy`` / ``load`` / ``health`` /
``stop_admission`` / ``migrate_out`` / ``migrate_in`` — so a router
built for local replicas scales to hosts without changing a line.
Transport discipline, because at multi-host scale partial failure is
the common case:

* every call has a per-call TIMEOUT (no handler thread ever blocks on
  a dead host);
* transient failures retry with BOUNDED exponential backoff plus
  deterministic jitter (seeded rng — chaos runs reproduce);
* submission is IDEMPOTENT, keyed by rid: the server acks a rid it
  already knows instead of double-admitting, so a retry after a
  lost-reply disconnect cannot run the same request twice;
* streaming state lives client-side: the backend never holds a
  long-lived connection per request — ``step()`` polls
  ``POST /v1/poll`` and synthesizes the scheduler's ``on_event``
  stream (tokens / finished / cancelled / shed) from token-list
  deltas, so a dropped poll loses nothing (the next poll re-diffs);
* a structured ``FaultPlan`` (serving/faults.py) can be installed at
  this seam — every injected refuse/timeout/slow/disconnect/crash
  exercises exactly the retry/idempotency machinery above;
* migration packages are JSON end to end: only the ``swap`` blob
  needs base64 framing (bf16 pages travel inside it as their uint16
  bit patterns, ``PagedKVCache.export_swap``) — the request CAPSULE
  (observability/capsule.py) the package may carry is already plain
  JSON and ships untouched, so a drained request stays bit-exactly
  replayable on the destination host.

``HealthProber`` actively polls each replica's ``health()`` and feeds
the router's circuit breaker, distinguishing SLOW from DEAD:

* slow / draining (a reply, but late or shedding) — the circuit opens
  for the cooldown and the router's existing half-open probe decides
  recovery;
* dead (connection refused / wedged backend, ``dead_after``
  consecutive strikes) — the replica is EJECTED and its in-flight
  work requeued onto the survivors (``router.eject``), which is what
  turns a host loss into re-decoded tokens instead of hung clients.
"""
from __future__ import annotations

import base64
import http.client
import json
import random
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional

from ..common.errors import (InvalidArgumentError, UnavailableError,
                             enforce)
from ..observability import get_registry
from ..observability import tracing as _tracing
from .scheduler import RejectedError

__all__ = ["RemoteReplica", "HealthProber", "TransportError",
           "TransportTimeout"]

_TERMINAL = ("finished", "cancelled", "shed")
# errors worth a retry: the network or the far host, not the request
_RETRYABLE = (ConnectionError, TimeoutError, http.client.HTTPException,
              OSError)


class TransportError(UnavailableError):
    """The remote backend could not be reached (all retries failed)."""


class TransportTimeout(TransportError, TimeoutError):
    """A per-call timeout elapsed — the call MAY have been processed
    (resubmit idempotently, never assume it wasn't)."""


class _Tracked:
    """Client-side record of one request submitted through this
    adapter: the streaming callback, how many tokens were already
    delivered to it, and the last state seen from a poll."""

    __slots__ = ("on_event", "seen", "state", "tokens")

    def __init__(self, on_event):
        self.on_event = on_event
        self.seen = 0
        self.state = "waiting"
        self.tokens: List[int] = []


class RemoteReplica:
    """HTTP client adapter over one ``serving/server.py`` backend (see
    module docstring).  ``sleep`` and the jitter rng are injectable so
    failover tests run deterministic and without real waiting."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 max_retries: int = 3, backoff_base: float = 0.05,
                 backoff_max: float = 2.0, load_ttl: float = 0.05,
                 seed: int = 0,
                 sleep: Optional[Callable[[float], None]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 enable_metrics: bool = True, name: Optional[str] = None):
        u = urllib.parse.urlsplit(base_url)
        enforce(u.scheme == "http" and u.hostname,
                f"base_url must be http://host:port, got {base_url!r}")
        self.host = u.hostname
        self.port = u.port or 80
        self.base_url = base_url.rstrip("/")
        self.name = name or f"{self.host}:{self.port}"
        self.timeout = float(timeout)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.load_ttl = float(load_ttl)
        self._rng = random.Random(seed)
        self._sleep = sleep or time.sleep
        self._clock = clock or time.monotonic
        self._lock = threading.RLock()
        self._track: Dict[object, _Tracked] = {}
        self._fault_plan = None
        self._load_cache: Optional[tuple] = None   # (expiry, value)
        self._init_metrics(enable_metrics)

    # -- metrics ---------------------------------------------------------------
    def _init_metrics(self, enabled: bool):
        self._metrics = None
        if not enabled:
            return
        reg = get_registry()
        self._m_calls = reg.counter(
            "serving_transport_calls_total",
            "HTTP calls issued to the remote backend, by op.",
            ("transport", "op"))
        self._m_retries = reg.counter(
            "serving_transport_retries_total",
            "Calls re-attempted after a transient transport failure.",
            ("transport",)).labels(self.name)
        self._m_errors = reg.counter(
            "serving_transport_errors_total",
            "Transport-level failures by kind (timeout / refused / "
            "disconnect / http).", ("transport", "kind"))
        self._metrics = True

    def _count_error(self, err: BaseException):
        # the flight recorder keeps the last transport failures for
        # /statusz and crash dumps (no-op unless one is enabled)
        _tracing.record_event("error", where=f"transport:{self.name}",
                              error=f"{type(err).__name__}: {err}")
        if self._metrics is None:
            return
        if isinstance(err, TimeoutError):
            kind = "timeout"
        elif isinstance(err, ConnectionRefusedError):
            kind = "refused"
        elif isinstance(err, ConnectionError):
            kind = "disconnect"
        else:
            kind = "http"
        self._m_errors.labels(self.name, kind).inc()

    # -- fault injection seam --------------------------------------------------
    def set_fault_plan(self, plan) -> None:
        """Install a ``FaultPlan`` consulted around every HTTP call —
        the structured chaos seam (serving/faults.py)."""
        self._fault_plan = plan

    def clear_fault_plan(self) -> None:
        self._fault_plan = None

    # -- the one HTTP primitive ------------------------------------------------
    def _call(self, op: str, method: str, path: str,
              payload: Optional[dict] = None,
              timeout: Optional[float] = None,
              retries: Optional[int] = None,
              headers: Optional[dict] = None) -> dict:
        """One logical backend call: per-attempt timeout, bounded
        exponential backoff with jitter between attempts, fault-plan
        hooks around the wire work.  Overload (429) and bad requests
        (4xx) raise immediately — retrying them cannot help; transient
        transport errors and 5xx retry up to ``retries`` attempts.
        ``headers`` ride on every attempt (trace-context
        propagation)."""
        timeout = self.timeout if timeout is None else timeout
        attempts = (self.max_retries if retries is None else retries) + 1
        extra_headers = dict(headers) if headers else {}
        body = None if payload is None else \
            json.dumps(payload).encode("utf-8")
        last_err: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt and self._metrics is not None:
                self._m_retries.inc()
            if attempt:
                step = min(self.backoff_max,
                           self.backoff_base * (2 ** (attempt - 1)))
                self._sleep(step * (0.5 + 0.5 * self._rng.random()))
            try:
                if self._fault_plan is not None:
                    self._fault_plan.before(op)
                if self._metrics is not None:
                    self._m_calls.labels(self.name, op).inc()
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=timeout)
                try:
                    headers = {"Content-Type": "application/json"} \
                        if body is not None else {}
                    headers.update(extra_headers)
                    conn.request(method, path, body, headers)
                    resp = conn.getresponse()
                    raw = resp.read()
                    status = resp.status
                finally:
                    conn.close()
                if self._fault_plan is not None:
                    self._fault_plan.after(op)
            except _RETRYABLE as e:
                self._count_error(e)
                last_err = e
                continue
            try:
                out = json.loads(raw) if raw else {}
            except json.JSONDecodeError as e:
                last_err = e
                continue
            if status == 429:
                raise RejectedError(out.get("error", "rejected"))
            if 400 <= status < 500:
                raise InvalidArgumentError(
                    f"{self.name} {method} {path} -> {status}: "
                    f"{out.get('error', raw[:200])}")
            if status >= 500:
                last_err = TransportError(
                    f"{self.name} {method} {path} -> {status}: "
                    f"{out.get('error', '')}")
                continue
            return out
        if isinstance(last_err, TimeoutError):
            raise TransportTimeout(
                f"{self.name} {method} {path} timed out after "
                f"{attempts} attempts: {last_err}")
        raise TransportError(
            f"{self.name} {method} {path} failed after {attempts} "
            f"attempts: {last_err}")

    # -- request API (the scheduler surface) -----------------------------------
    def submit(self, rid, prompt_ids, max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None,
               max_queue_time: Optional[float] = None,
               on_event: Optional[Callable[[dict], None]] = None,
               trace_ctx: Optional[dict] = None):
        """Submit one request to the backend.  The streaming callback
        stays CLIENT-side (``step()`` synthesizes its events from
        polls); the wire carries only JSON.  Idempotent by rid: a
        retried submit whose first attempt was admitted but lost its
        reply acks as a duplicate instead of double-admitting.
        ``trace_ctx`` propagates in HTTP HEADERS (not the body), so
        the far scheduler's spans join the submitter's trace — a
        retried or failed-over request still yields one connected
        cross-host trace."""
        rid = str(rid)
        payload = {"id": rid, "prompt": list(prompt_ids),
                   "max_tokens": max_new_tokens, "priority": priority}
        if eos_token_id is not None:
            payload["eos_token_id"] = eos_token_id
        if deadline is not None:
            payload["deadline"] = deadline
        if max_queue_time is not None:
            payload["max_queue_time"] = max_queue_time
        self._call("submit", "POST", "/v1/submit", payload,
                   headers=_tracing.inject_headers(trace_ctx))
        with self._lock:
            self._track[rid] = _Tracked(on_event)
        return rid

    def knows(self, rid) -> bool:
        with self._lock:
            return str(rid) in self._track

    def cancel(self, rid) -> bool:
        out = self._call("cancel", "POST", "/v1/cancel",
                         {"id": str(rid)})
        return bool(out.get("cancelled"))

    def status(self, rid) -> str:
        rid = str(rid)
        out = self._call("poll", "POST", "/v1/poll", {"ids": [rid]})
        st = out["requests"][rid]["state"]
        if st == "unknown":
            with self._lock:
                rec = self._track.get(rid)
            if rec is not None:
                return rec.state           # last state seen before pop
        return st

    def result(self, rid) -> List[int]:
        out = self._call("result", "POST", "/v1/result",
                         {"id": str(rid)})
        return list(out["tokens"])

    def pop_result(self, rid) -> List[int]:
        rid = str(rid)
        out = self._call("result", "POST", "/v1/pop_result",
                         {"id": rid})
        with self._lock:
            self._track.pop(rid, None)
        return list(out["tokens"])

    def forget(self, rid) -> None:
        rid = str(rid)
        self._call("result", "POST", "/v1/forget", {"id": rid})
        with self._lock:
            self._track.pop(rid, None)

    def abandon(self, rid) -> None:
        """Drop client-side tracking WITHOUT touching the backend —
        the ejection path: the router has requeued this rid elsewhere
        and the (dead) backend can keep whatever it had."""
        with self._lock:
            self._track.pop(str(rid), None)

    def last_known_state(self, rid) -> Optional[str]:
        """The rid's state as of the last poll, from CLIENT memory —
        readable even when the backend is dead (the ejection path
        must not requeue work it already saw terminate)."""
        with self._lock:
            rec = self._track.get(str(rid))
            return None if rec is None else rec.state

    # -- the loop surface ------------------------------------------------------
    def _open_rids(self) -> List[str]:
        with self._lock:
            return [rid for rid, rec in self._track.items()
                    if rec.state not in _TERMINAL]

    def step(self) -> Dict[object, List[int]]:
        """One poll: diff the backend's per-request token lists
        against what was already delivered, fire the synthesized
        events, return ``{rid: [new tokens]}``.  Transport failures
        return ``{}`` — the prober decides whether the host is slow
        or dead; losing a poll loses no tokens (the next diff
        catches up)."""
        rids = self._open_rids()
        if not rids:
            return {}
        try:
            out = self._call("poll", "POST", "/v1/poll", {"ids": rids})
        except (TransportError, RejectedError, InvalidArgumentError):
            return {}
        events: List = []
        deltas: Dict[object, List[int]] = {}
        with self._lock:
            for rid, snap in out.get("requests", {}).items():
                rec = self._track.get(rid)
                if rec is None or rec.state in _TERMINAL:
                    continue
                state = snap["state"]
                toks = snap.get("tokens", [])
                if state == "unknown":
                    # the backend lost this rid (crash/restart) and
                    # nobody requeued it: terminate it as shed so no
                    # waiter hangs — the no-lost-request invariant
                    rec.state = "shed"
                    if rec.on_event is not None:
                        events.append((rec.on_event,
                                       {"type": "shed", "rid": rid,
                                        "reason": "lost"}))
                    continue
                new = toks[rec.seen:]
                if new and rec.on_event is not None:
                    events.append((rec.on_event,
                                   {"type": "tokens", "rid": rid,
                                    "tokens": list(new)}))
                if new:
                    deltas[rid] = list(new)
                rec.seen = len(toks)
                rec.tokens = list(toks)
                if state in _TERMINAL and rec.state not in _TERMINAL:
                    rec.state = state
                    if rec.on_event is not None:
                        ev = {"type": state, "rid": rid,
                              "tokens": list(toks)}
                        if state == "shed":
                            ev = {"type": "shed", "rid": rid,
                                  "reason": snap.get("shed_reason")}
                        elif state == "finished":
                            ev["deadline_missed"] = snap.get(
                                "deadline_missed", False)
                        events.append((rec.on_event, ev))
                else:
                    rec.state = state
        for cb, ev in events:
            cb(ev)
        return deltas

    def busy(self) -> bool:
        return bool(self._open_rids())

    def run_until_idle(self, max_steps: Optional[int] = None
                       ) -> Dict[object, List[int]]:
        out: Dict[object, List[int]] = {}
        steps = 0
        while self.busy():
            for rid, t in self.step().items():
                out.setdefault(rid, []).extend(t)
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    # -- routing / control surface ---------------------------------------------
    def load(self) -> int:
        """The backend's waiting+suspended+active count, cached for
        ``load_ttl`` seconds (the router reads load on every pick —
        one scrape per pick would melt a busy router).  An unreachable
        backend answers a huge sentinel: prefer anyone else."""
        now = self._clock()
        with self._lock:
            if self._load_cache is not None and \
                    now < self._load_cache[0]:
                return self._load_cache[1]
        try:
            out = self._call("poll", "GET", "/v1/load", retries=0,
                             timeout=min(self.timeout, 2.0))
            val = int(out["load"])
        except (TransportError, RejectedError, InvalidArgumentError):
            val = 1 << 30
        with self._lock:
            self._load_cache = (now + self.load_ttl, val)
        return val

    def health(self, timeout: Optional[float] = None) -> dict:
        """One ``GET /healthz`` with NO retries — the prober wants the
        raw signal (refused / timeout / slow / draining), not a
        smoothed one.  Raises the underlying transport error."""
        timeout = self.timeout if timeout is None else timeout
        if self._fault_plan is not None:
            self._fault_plan.before("health")
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        if self._fault_plan is not None:
            self._fault_plan.after("health")
        return json.loads(raw)

    def stop_admission(self) -> None:
        self._call("migrate", "POST", "/v1/drain", {})

    def resume_admission(self) -> None:
        self._call("migrate", "POST", "/v1/drain", {"mode": "resume"})

    def metrics_snapshot(self) -> dict:
        return self._call("poll", "GET", "/v1/stats")

    def fleet_scrape(self) -> dict:
        """The federation scrape (``GET /v1/metrics_snapshot``): one
        round trip, NO retries, a short bound like ``load()``'s — a
        wedged replica makes the fleet view mark it ``stale``, it must
        not stall the scrape loop for the full retry ladder."""
        return self._call("poll", "GET", "/v1/metrics_snapshot",
                          retries=0, timeout=min(self.timeout, 2.0))

    def compilez(self) -> dict:
        """The backend's compile-plane page (``GET /compilez``):
        per-program table + bounded compile log from its
        CompileWatch."""
        return self._call("poll", "GET", "/compilez")

    def memz(self) -> dict:
        """The backend's memory-plane page (``GET /memz``): device
        watermarks, accounted pool rows, top consumers."""
        return self._call("poll", "GET", "/memz")

    def request_timeline(self, rid) -> dict:
        """The backend's per-request timing breakdown
        (``POST /v1/timeline``) — timestamps are the BACKEND's
        monotonic clock; only the derived fields (queue_wait, ttft)
        compare across hosts."""
        out = self._call("poll", "POST", "/v1/timeline",
                         {"id": str(rid)})
        return out.get("timeline", out)

    def requests_overview(self) -> List[dict]:
        """Live requests on the backend (``GET /v1/requests``) — the
        /statusz table row source for remote replicas."""
        out = self._call("poll", "GET", "/v1/requests")
        return list(out.get("requests", []))

    # -- migration -------------------------------------------------------------
    def migrate_out(self, rid) -> Optional[dict]:
        """Pull one live request off the backend as a migration
        package (the backend suspends it and serializes its swap
        entry).  The local streaming callback rides along in the
        returned dict (``on_event``) so the router can re-attach it at
        the destination."""
        rid = str(rid)
        out = self._call("migrate", "POST", "/v1/migrate_out",
                         {"id": rid})
        pkg = out.get("package")
        with self._lock:
            rec = self._track.pop(rid, None)
        if pkg is None:
            return None
        if pkg.get("swap") is not None:
            pkg["swap"] = base64.b64decode(pkg["swap"])
        pkg["on_event"] = rec.on_event if rec is not None else None
        # tokens the CLIENT has delivered so far — the backend may be
        # ahead of our polls, and the destination must re-stream that
        # backlog, not skip it
        pkg["delivered"] = rec.seen if rec is not None \
            else len(pkg.get("tokens", []))
        return pkg

    def migrate_in(self, pkg: dict,
                   on_event: Optional[Callable[[dict], None]] = None):
        """Hand a migration package to the backend and track it here:
        subsequent polls continue the token stream exactly where the
        source left off (``seen`` primes to the tokens already
        delivered)."""
        cb = on_event if on_event is not None else pkg.get("on_event")
        wire = {k: v for k, v in pkg.items() if k != "on_event"}
        wire["rid"] = str(wire["rid"])
        if wire.get("swap") is not None:
            wire["swap"] = base64.b64encode(wire["swap"]).decode("ascii")
        self._call("migrate", "POST", "/v1/migrate_in",
                   {"package": wire})
        with self._lock:
            rec = _Tracked(cb)
            rec.seen = pkg.get("delivered",
                               len(pkg.get("tokens", [])))
            rec.tokens = list(pkg.get("tokens", []))
            rec.state = "suspended" if pkg.get("admitted") else "waiting"
            self._track[wire["rid"]] = rec
        return wire["rid"]


class HealthProber:
    """Active health probing over a router's replicas (module
    docstring): ``probe_once()`` classifies every replica as
    ok / slow / draining / dead-strike and feeds the router — slow
    opens the circuit (half-open probe decides recovery), DEAD
    (``dead_after`` consecutive strikes, or a wedged backend) ejects
    the replica and requeues its in-flight work on the survivors.
    ``start()`` runs it on a daemon thread; tests drive
    ``probe_once()`` directly with injected clocks."""

    def __init__(self, router, interval: float = 0.5,
                 timeout: float = 2.0,
                 slow_threshold: Optional[float] = None,
                 dead_after: int = 2, reinstate: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 enable_metrics: bool = True):
        enforce(dead_after >= 1, "dead_after must be >= 1")
        self.router = router
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.slow_threshold = slow_threshold
        self.dead_after = int(dead_after)
        self.reinstate = bool(reinstate)
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self._strikes = [0] * len(router.replicas)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._metrics = None
        if enable_metrics:
            self._m_probes = get_registry().counter(
                "serving_probe_checks_total",
                "Health probes by outcome (ok / slow / draining / "
                "dead / ejected).", ("router", "outcome"))
            self._metrics = True

    def _count(self, outcome: str):
        if self._metrics is not None:
            self._m_probes.labels(self.router.router_id, outcome).inc()

    def _classify(self, replica) -> str:
        t0 = self._clock()
        try:
            h = replica.health(timeout=self.timeout)
        except TimeoutError:
            return "slow"
        except (ConnectionError, OSError, UnavailableError):
            return "dead"
        dt = self._clock() - t0
        status = h.get("status")
        if status == "ok":
            if self.slow_threshold is not None and \
                    dt > self.slow_threshold:
                return "slow"
            return "ok"
        if status == "draining":
            return "draining"
        return "dead"                      # wedged: alive but can't decode

    def probe_once(self) -> Dict[int, str]:
        """Probe every replica once and apply the verdicts to the
        router.  Returns ``{replica index: outcome}``."""
        outcomes: Dict[int, str] = {}
        for idx, replica in enumerate(self.router.replicas):
            outcome = self._classify(replica)
            if outcome == "ok":
                self._strikes[idx] = 0
                if self.reinstate and self.router.is_ejected(idx):
                    self.router.reinstate(idx)
            elif outcome in ("slow", "draining"):
                self._strikes[idx] = 0
                self.router.mark_slow(idx)
            else:
                self._strikes[idx] += 1
                if self._strikes[idx] >= self.dead_after and \
                        not self.router.is_ejected(idx):
                    self.router.eject(idx)
                    outcome = "ejected"
            outcomes[idx] = outcome
            self._count(outcome)
        return outcomes

    # -- background thread -----------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:
                pass                       # probing must never die
            self._stop.wait(self.interval)

    def start(self) -> "HealthProber":
        enforce(self._thread is None, "prober already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-tpu-serving-prober",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
