"""Multi-replica router (counterpart of ``paddle_tpu/serving/router.py``):
spread requests across N scheduler-wrapped engine replicas —
in-process ``Scheduler``s or ``RemoteReplica`` adapters over per-host
HTTP backends (serving/transport.py); the router only speaks the
duck-typed replica surface.

One engine saturates one card; traffic beyond that is served by
REPLICAS (same weights, independent KV pools).  The router is the
host-side policy layer in front of them:

* least-loaded routing — a request goes to the healthy replica with
  the fewest waiting + suspended + active requests (``load()``; ties
  break on replica index);
* per-replica health with circuit breaking — ``failure_threshold``
  consecutive submission failures open the replica's circuit for
  ``cooldown`` seconds (no traffic), after which ONE half-open
  attempt probes it (success closes the circuit, failure re-opens);
  a ``HealthProber`` can also drive the breaker out-of-band
  (``mark_slow``);
* retry with exponential backoff — a failed submission moves to the
  next-best replica; when every candidate has failed this call, the
  router backs off (``backoff_base`` doubling per round) before
  re-trying the set, up to ``max_attempts`` attempts total;
* EJECTION with requeue (``eject``) — a replica declared DEAD (the
  prober's verdict) stops receiving traffic entirely (no half-open
  probes) and every request it owned is resubmitted to the
  survivors.  The router remembers each request's prompt and options
  for exactly this; re-streamed tokens are offset-suppressed (greedy
  decode re-derives the same tokens, the client's stream continues
  where it left off) and a request no survivor accepts terminates as
  ``shed`` — submitted work always terminates somewhere;
* KV-MIGRATING drain (``drain_replica``) — planned removal: the
  replica stops admitting, every live request it owns is
  ``migrate_out``-ed (suspended, its KV swap entry serialized) and
  ``migrate_in``-ed at a survivor, where it resumes bit-identical
  (swap-in, or recompute when the blob doesn't fit) — zero in-flight
  decodes lost, no tokens re-streamed;
* fault injection (``set_fault``) — tests and chaos drills raise
  synthetic failures on a chosen replica without touching the engine
  (``FaultPlan.router_hook()`` adapts the structured chaos schedules
  from serving/faults.py to this seam).

A replica-level ``RejectedError`` (its bounded queue is full) is load
signal, not failure: the router tries the other replicas but does not
open the circuit; if ALL replicas reject, the rejection propagates.

Threading mirrors the scheduler: ``submit``/``cancel`` from any
thread, ``step()``/``run_until_idle`` from the owner's loop thread;
the prober's ``mark_slow``/``eject`` may land from its own thread.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from ..common.errors import UnavailableError, enforce
from ..observability import get_registry
from ..observability import capsule as _capsule
from ..observability import health as _health
from ..observability import introspection as _insp
from ..observability import tracing as _tracing
from ..observability.tracing import record_event
from .scheduler import RejectedError

__all__ = ["ReplicaRouter"]

_ROUTER_IDS = itertools.count()


class _ReplicaState:
    def __init__(self):
        self.consecutive_failures = 0
        self.open_until: Optional[float] = None  # circuit-open deadline
        self.failures_total = 0
        self.requests_total = 0


class _EventTap:
    """Pass-through wrapper around a request's ``on_event`` callback
    that counts delivered tokens and, after a requeue, suppresses the
    first ``skip`` re-streamed ones — a replayed (bit-identical
    greedy) request continues the client's stream seamlessly instead
    of duplicating its prefix.  Terminal events pass through intact
    (their ``tokens`` field is the authoritative full list)."""

    __slots__ = ("cb", "delivered", "skip")

    def __init__(self, cb):
        self.cb = cb
        self.delivered = 0
        self.skip = 0

    def __call__(self, ev):
        if ev.get("type") == "tokens":
            toks = ev["tokens"]
            if self.skip:
                drop = min(self.skip, len(toks))
                self.skip -= drop
                toks = toks[drop:]
                if not toks:
                    return
                ev = dict(ev, tokens=list(toks))
            self.delivered += len(toks)
        self.cb(ev)


class ReplicaRouter:
    """Least-loaded router over ``Scheduler`` replicas (see module
    docstring).  ``sleep`` and ``clock`` are injectable so failover
    tests run without real waiting."""

    def __init__(self, replicas: List, max_attempts: int = 4,
                 backoff_base: float = 0.05,
                 failure_threshold: int = 3, cooldown: float = 5.0,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 enable_metrics: bool = True):
        enforce(len(replicas) >= 1, "need at least one replica")
        enforce(max_attempts >= 1, "max_attempts must be >= 1")
        self.replicas = list(replicas)
        self.max_attempts = max_attempts
        self.backoff_base = float(backoff_base)
        self.failure_threshold = failure_threshold
        self.cooldown = float(cooldown)
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self._lock = threading.RLock()
        self._state = [_ReplicaState() for _ in self.replicas]
        self._fault: Dict[int, Callable] = {}
        self._owner: Dict[object, int] = {}
        self._ejected: set = set()
        # per-request (prompt, kw, tap) so an ejected replica's work
        # can requeue on the survivors; dropped at pop_result/forget
        self._requests: Dict[object, tuple] = {}
        self.retry_count = 0
        self.router_id = str(next(_ROUTER_IDS))
        self._init_metrics(enable_metrics)

    # -- metrics ---------------------------------------------------------------
    def _init_metrics(self, enabled: bool):
        self._metrics = None
        if not enabled:
            return
        reg = get_registry()
        rid = self.router_id
        self._m_retries = reg.counter(
            "serving_router_retries_total",
            "Submission attempts retried on another replica (or after "
            "backoff) following a failure or rejection.",
            ("router",)).labels(rid)
        self._m_requests = reg.counter(
            "serving_router_requests_total",
            "Requests routed, by replica.", ("router", "replica"))
        self._m_unhealthy = reg.gauge(
            "serving_router_replica_unhealthy",
            "1 while the replica's circuit is open (shedding "
            "traffic), else 0.", ("router", "replica"))
        self._m_load = reg.gauge(
            "serving_router_replica_load",
            "Waiting + suspended (preempted) + active requests on the "
            "replica (the least-loaded routing key).",
            ("router", "replica"))
        self._m_ejected = reg.counter(
            "serving_router_ejected_total",
            "Replicas declared dead and removed from routing "
            "(in-flight work requeued).", ("router",)).labels(rid)
        self._m_requeued = reg.counter(
            "serving_router_requeued_total",
            "Requests resubmitted to a survivor after their replica "
            "was ejected.", ("router",)).labels(rid)
        self._m_migrated = reg.counter(
            "serving_router_migrated_total",
            "Requests moved between replicas with their KV state by "
            "drain_replica.", ("router",)).labels(rid)
        self._metrics = True

    def _track_replica(self, idx: int):
        if self._metrics is None:
            return
        self._m_unhealthy.labels(self.router_id, str(idx)).set(
            0.0 if self._healthy(idx) else 1.0)
        self._m_load.labels(self.router_id, str(idx)).set(
            self._load(idx))

    # -- health / picking ------------------------------------------------------
    def _healthy(self, idx: int) -> bool:
        if idx in self._ejected:
            return False
        st = self._state[idx]
        return st.open_until is None or self._clock() >= st.open_until

    def healthy_replicas(self) -> List[int]:
        with self._lock:
            return [i for i in range(len(self.replicas))
                    if self._healthy(i)]

    def _load(self, idx: int) -> int:
        """The replica's waiting + suspended + active count via its
        duck-typed ``load()`` (suspended requests count: they WILL
        resume and reclaim capacity — a replica thrashing on
        preemption must look loaded, or least-loaded routing feeds
        the thrash).  An unreachable replica answers a huge sentinel:
        prefer anyone else.  Ties still break on replica index
        (deterministic)."""
        try:
            return self.replicas[idx].load()
        except Exception:
            return 1 << 30

    def _pick(self, exclude) -> Optional[int]:
        cands = [i for i in range(len(self.replicas))
                 if i not in exclude and self._healthy(i)]
        if not cands:
            # half-open probe: any non-ejected circuit may try once
            cands = [i for i in range(len(self.replicas))
                     if i not in exclude and i not in self._ejected]
        if not cands:
            return None
        return min(cands, key=lambda i: (self._load(i), i))

    def _record_failure(self, idx: int):
        st = self._state[idx]
        st.consecutive_failures += 1
        st.failures_total += 1
        if st.consecutive_failures >= self.failure_threshold:
            st.open_until = self._clock() + self.cooldown
        self._track_replica(idx)

    def _record_success(self, idx: int):
        st = self._state[idx]
        st.consecutive_failures = 0
        st.open_until = None
        st.requests_total += 1
        self._track_replica(idx)

    # -- fault injection -------------------------------------------------------
    def set_fault(self, idx: int, fn: Callable) -> None:
        """Install a fault hook on replica ``idx``: called as
        ``fn(rid)`` before every submission routed there; raising
        simulates the replica failing.  Failover paths become testable
        without breaking a real engine."""
        self._fault[idx] = fn

    def clear_fault(self, idx: int) -> None:
        self._fault.pop(idx, None)

    # -- request API -----------------------------------------------------------
    def submit(self, rid, prompt_ids, **kw) -> int:
        """Route one request; returns the replica index that accepted
        it.  Raises ``RejectedError`` when every replica sheds, or
        ``UnavailableError`` when ``max_attempts`` submissions all
        fail.  The prompt and options are remembered until the result
        is popped, so an ejected replica's work can requeue; the
        streaming callback is wrapped in a delivery-counting tap for
        the same reason (re-streamed tokens are suppressed)."""
        with self._lock:
            enforce(rid not in self._owner,
                    f"duplicate request id {rid!r}")
            kw = dict(kw)
            tap = None
            if kw.get("on_event") is not None:
                tap = _EventTap(kw["on_event"])
                kw["on_event"] = tap
            # pin the trace context at THIS level when the caller did
            # not: the remembered kw is what ejection-requeue and
            # failover retries resubmit, so the request keeps ONE
            # trace across replicas instead of each replica minting a
            # fresh root
            if kw.get("trace_ctx") is None:
                tr = _tracing.get_tracer()
                if tr is not None and tr.enabled:
                    root = tr.start_span(
                        "router.request", activate=False,
                        attrs={"rid": str(rid),
                               "router": self.router_id})
                    root.end()
                    kw["trace_ctx"] = root.context()
            prompt = list(prompt_ids)
            idx = self._route(rid, prompt, kw)
            self._requests[rid] = (prompt, kw, tap)
            return idx

    def _route(self, rid, prompt_ids, kw) -> int:
        """The retry/failover loop shared by ``submit`` and the
        ejection requeue (lock held)."""
        tried: set = set()
        last_err: Optional[BaseException] = None
        delay = self.backoff_base
        for attempt in range(self.max_attempts):
            idx = self._pick(tried)
            if idx is None:
                # whole set failed this round: back off, retry all
                tried.clear()
                self._sleep(delay)
                delay *= 2
                idx = self._pick(tried)
            if idx is None:                   # every replica ejected
                break
            if attempt > 0:
                self.retry_count += 1
                if self._metrics is not None:
                    self._m_retries.inc()
            try:
                fault = self._fault.get(idx)
                if fault is not None:
                    fault(rid)
                self.replicas[idx].submit(rid, prompt_ids, **kw)
            except RejectedError as e:
                # load signal, not replica failure — no circuit hit
                tried.add(idx)
                last_err = e
                self._track_replica(idx)
            except Exception as e:
                self._record_failure(idx)
                tried.add(idx)
                last_err = e
            else:
                self._record_success(idx)
                self._owner[rid] = idx
                if self._metrics is not None:
                    self._m_requests.labels(self.router_id,
                                            str(idx)).inc()
                return idx
        if isinstance(last_err, RejectedError):
            raise last_err
        raise UnavailableError(
            f"request {rid!r} failed on every replica after "
            f"{self.max_attempts} attempts: {last_err}")

    def _replica_of(self, rid) -> int:
        enforce(rid in self._owner, f"unknown request id {rid!r}")
        return self._owner[rid]

    def cancel(self, rid) -> bool:
        with self._lock:
            return self.replicas[self._replica_of(rid)].cancel(rid)

    def status(self, rid) -> str:
        with self._lock:
            return self.replicas[self._replica_of(rid)].status(rid)

    def result(self, rid) -> List[int]:
        with self._lock:
            return self.replicas[self._replica_of(rid)].result(rid)

    def pop_result(self, rid) -> List[int]:
        with self._lock:
            idx = self._replica_of(rid)
            out = self.replicas[idx].pop_result(rid)
            del self._owner[rid]
            self._requests.pop(rid, None)
            return out

    def forget(self, rid) -> None:
        with self._lock:
            idx = self._replica_of(rid)
            self.replicas[idx].forget(rid)
            del self._owner[rid]
            self._requests.pop(rid, None)

    def knows(self, rid) -> bool:
        with self._lock:
            return rid in self._owner

    def request_timeline(self, rid) -> dict:
        """The owning replica's per-request timing breakdown
        (``Scheduler.request_timeline``).  A request that failed over
        answers from its CURRENT owner — the trace id ties the hops
        together."""
        with self._lock:
            return self.replicas[self._replica_of(rid)] \
                .request_timeline(rid)

    def requests_overview(self) -> List[dict]:
        """Live requests across every non-ejected replica (the
        ``/statusz`` request table); an unreachable replica
        contributes an error marker instead of failing the scrape."""
        out: List[dict] = []
        with self._lock:
            for i, replica in enumerate(self.replicas):
                if i in self._ejected:
                    continue
                try:
                    rows = replica.requests_overview()
                except Exception as e:
                    rows = [{"replica": i, "error": str(e)}]
                else:
                    rows = [dict(r, replica=i) for r in rows]
                out.extend(rows)
        return out

    def snapshot_requests(self, rids) -> Dict[object, dict]:
        """Poll view over all replicas (the remote-transport surface,
        delegated to each rid's owner)."""
        out: Dict[object, dict] = {}
        with self._lock:
            by_replica: Dict[int, List] = {}
            for rid in rids:
                idx = self._owner.get(rid)
                if idx is None:
                    out[rid] = {"state": "unknown", "tokens": []}
                else:
                    by_replica.setdefault(idx, []).append(rid)
            for idx, group in by_replica.items():
                out.update(self.replicas[idx].snapshot_requests(group))
        return out

    # -- prober verdicts / replica lifecycle -----------------------------------
    @staticmethod
    def _last_state(replica, rid) -> Optional[str]:
        """Best-effort LOCAL view of a rid's state on a possibly-dead
        replica: remote adapters remember their last poll
        (``last_known_state``), in-process schedulers answer from
        memory; anything that must touch the network answers None."""
        lk = getattr(replica, "last_known_state", None)
        try:
            if lk is not None:
                return lk(rid)
            return replica.status(rid)
        except Exception:
            return None

    def is_ejected(self, idx: int) -> bool:
        with self._lock:
            return idx in self._ejected

    def mark_slow(self, idx: int) -> None:
        """Prober verdict SLOW (or draining): open the replica's
        circuit for the cooldown — the existing half-open probe
        decides recovery.  Traffic shifts away now without declaring
        the replica dead."""
        with self._lock:
            self._state[idx].open_until = self._clock() + self.cooldown
            self._track_replica(idx)

    def reinstate(self, idx: int) -> None:
        """Return an ejected (or circuit-opened) replica to routing
        with a clean slate — the prober calls this when a host comes
        back healthy.  Its previous requests were requeued at
        ejection; nothing is restored here."""
        with self._lock:
            self._ejected.discard(idx)
            st = self._state[idx]
            st.consecutive_failures = 0
            st.open_until = None
            self._track_replica(idx)

    def eject(self, idx: int) -> List:
        """Prober verdict DEAD: remove the replica from routing
        entirely (no half-open probes — only ``reinstate`` brings it
        back) and REQUEUE every request it owned onto the survivors
        from the remembered (prompt, options): greedy decode
        re-derives the same tokens and each request's event tap
        suppresses the re-streamed prefix, so client streams continue
        seamlessly.  A request no survivor accepts terminates as
        ``shed`` (reason ``replica_ejected``) — never silently lost.
        Returns the requeued rids.  Idempotent."""
        events: List = []
        requeued: List = []
        with self._lock:
            if idx in self._ejected:
                return []
            self._ejected.add(idx)
            record_event("replica_ejected", router=self.router_id,
                         replica=idx)
            if self._metrics is not None:
                self._m_ejected.inc()
            self._track_replica(idx)
            replica = self.replicas[idx]
            abandon = getattr(replica, "abandon", None)
            rids = [r for r, o in self._owner.items() if o == idx]
            for rid in rids:
                del self._owner[rid]
                # a rid already seen terminating must NOT replay — its
                # terminal event was delivered; its unread result died
                # with the host (pop_result will answer unknown)
                state = self._last_state(replica, rid)
                if abandon is not None:
                    abandon(rid)
                if state in ("finished", "cancelled", "shed"):
                    self._requests.pop(rid, None)
                    continue
                prompt, kw, tap = self._requests.get(
                    rid, (None, None, None))
                if prompt is None:
                    continue               # no record — nothing to replay
                if tap is not None:
                    tap.skip = tap.delivered
                try:
                    self._route(rid, prompt, kw)
                    requeued.append(rid)
                    if self._metrics is not None:
                        self._m_requeued.inc()
                except Exception:
                    self._requests.pop(rid, None)
                    cb = kw.get("on_event")
                    if cb is not None:
                        events.append((cb, {
                            "type": "shed", "rid": rid,
                            "reason": "replica_ejected"}))
        for cb, ev in events:
            cb(ev)
        return requeued

    def drain_replica(self, idx: int) -> List:
        """KV-MIGRATING drain: stop the replica's admission, then move
        every request it owns to a survivor with its computed state —
        ``migrate_out`` suspends it and serializes its KV swap entry,
        ``migrate_in`` adopts it where it resumes bit-identical
        (swap-in when the blob fits the destination's host pool,
        recompute otherwise).  No in-flight decode is lost and no
        token is re-streamed (the stream picks up at the next new
        token).  A request no survivor accepts terminates as ``shed``
        (reason ``drain_failed``).  Returns the migrated rids.  Call
        from the stepping thread (engine state moves on the source).
        The drained replica stays routable-off until ``reinstate``
        (its scheduler refuses admission while draining anyway)."""
        events: List = []
        moved: List = []
        with self._lock:
            src = self.replicas[idx]
            src.stop_admission()
            rids = [r for r, o in self._owner.items() if o == idx]
            for rid in rids:
                try:
                    pkg = src.migrate_out(rid)
                except Exception:
                    continue               # terminal record: pop at src
                if pkg is None:            # a pending cancel resolved
                    continue
                cb = pkg.pop("on_event", None)
                _, kw, tap = self._requests.get(rid, (None, {}, None))
                if tap is not None:        # prefer the router's tap
                    cb = tap
                placed = False
                tried = {idx}
                while True:
                    didx = self._pick(tried)
                    if didx is None:
                        break
                    try:
                        self.replicas[didx].migrate_in(pkg, on_event=cb)
                    except Exception:
                        tried.add(didx)
                        continue
                    self._owner[rid] = didx
                    moved.append(rid)
                    placed = True
                    if self._metrics is not None:
                        self._m_migrated.inc()
                        self._m_requests.labels(self.router_id,
                                                str(didx)).inc()
                    break
                if not placed:
                    del self._owner[rid]
                    self._requests.pop(rid, None)
                    if cb is not None:
                        events.append((cb, {
                            "type": "shed", "rid": rid,
                            "reason": "drain_failed"}))
        for cb, ev in events:
            cb(ev)
        return moved

    # -- the loop --------------------------------------------------------------
    def step(self) -> Dict[object, List[int]]:
        """Step every live replica once; returns the merged
        ``{rid: [new tokens]}`` map (rids are globally unique, so the
        merge cannot collide).  Ejected replicas are dead to the
        router: stepping one would double-decode requests already
        requeued on the survivors."""
        out: Dict[object, List[int]] = {}
        for i, sched in enumerate(self.replicas):
            if i in self._ejected:
                continue
            if sched.busy():
                out.update(sched.step())
            self._track_replica(i)
        return out

    def busy(self) -> bool:
        return any(s.busy() for i, s in enumerate(self.replicas)
                   if i not in self._ejected)

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

    def drain(self) -> None:
        for i, sched in enumerate(self.replicas):
            if i in self._ejected:
                continue                  # dead host: nothing to stop
            try:
                sched.stop_admission()
            except Exception:
                pass                      # unreachable ≈ not admitting
        self.run_until_idle()

    def metrics_snapshot(self) -> dict:
        """Router view + every replica's scheduler snapshot."""
        with self._lock:
            return {
                "router": self.router_id,
                "retries": self.retry_count,
                "ejected": sorted(self._ejected),
                "replicas": [{
                    "replica": i,
                    "healthy": self._healthy(i),
                    "ejected": i in self._ejected,
                    "load": self._load(i),
                    "consecutive_failures":
                        self._state[i].consecutive_failures,
                    "failures_total": self._state[i].failures_total,
                    "requests_total": self._state[i].requests_total,
                    "sched": self._replica_snapshot(sched),
                } for i, sched in enumerate(self.replicas)],
            }

    @staticmethod
    def _replica_snapshot(replica) -> dict:
        """A replica's own snapshot — unreachable remote replicas
        answer an error marker instead of failing the whole scrape."""
        try:
            return replica.metrics_snapshot()
        except Exception as e:
            return {"error": str(e)}

    # -- federation ------------------------------------------------------------
    _FLEET_COUNTERS = ("admitted", "completed", "aborted",
                       "deadline_miss", "preempted", "migrated_out",
                       "migrated_in")
    _FLEET_ENGINE_COUNTERS = ("prompt_tokens", "generated_tokens",
                              "requests")
    _FLEET_HISTOGRAMS = (("ttft_seconds", "engine"),
                         ("tpot_seconds", "engine"),
                         ("queue_wait_seconds", "sched"))

    def fleet_snapshot(self) -> dict:
        """The federated fleet view behind ``GET /fleetz``: one scrape
        per live replica (``fleet_scrape()`` for remote backends — a
        single short-timeout ``/v1/metrics_snapshot`` round trip — or
        ``metrics_snapshot()`` in-process), merged into fleet-wide
        counters and bucket-wise-merged latency histograms, plus each
        replica's circuit/load/KV/SLO state.  A replica that fails its
        scrape is marked ``stale`` (last resort: an unreachable
        replica must not take the whole fleet view down), and ejected
        replicas are never scraped — they are dead to the router."""
        # router state under the lock; the scrapes (network round
        # trips for remote replicas) outside it — a slow replica must
        # not stall submit()/step() for its timeout
        with self._lock:
            n = len(self.replicas)
            rows = [{
                "replica": i,
                "ejected": i in self._ejected,
                "healthy": self._healthy(i),
                "consecutive_failures":
                    self._state[i].consecutive_failures,
                "failures_total": self._state[i].failures_total,
                "requests_total": self._state[i].requests_total,
                "circuit_open_until": self._state[i].open_until,
                "load": None, "stale": False, "metrics": None,
            } for i in range(len(self.replicas))]
        for row, replica in zip(rows, self.replicas):
            if row["ejected"]:
                row["stale"] = True           # nothing fresh, by design
                continue
            row["load"] = self._load(row["replica"])
            try:
                scrape = replica.fleet_scrape() \
                    if hasattr(replica, "fleet_scrape") \
                    else replica.metrics_snapshot()
                enforce(isinstance(scrape, dict),
                        "scrape must be a dict")
                row["metrics"] = scrape
            except Exception as e:
                row["stale"] = True
                row["error"] = str(e)
        for row in rows:
            snap = row["metrics"] or {}
            eng = snap.get("engine") or {}
            row["kv_page_utilization"] = eng.get("kv_page_utilization")
            row["slo"] = (snap.get("health") or {}).get("slo")
        fresh = [r["metrics"] for r in rows if r["metrics"]]
        fleet = {"replicas": n, "scraped": len(fresh),
                 "stale": sum(1 for r in rows if r["stale"])}
        for key in self._FLEET_COUNTERS:
            fleet[key] = sum(s.get(key, 0) or 0 for s in fresh)
        fleet["shed"] = sum((s.get("shed") or {}).get("total", 0)
                            for s in fresh)
        for key in self._FLEET_ENGINE_COUNTERS:
            fleet[key] = sum((s.get("engine") or {}).get(key, 0) or 0
                             for s in fresh)
        for name, where in self._FLEET_HISTOGRAMS:
            parts = [(s.get("engine") or {}).get(name) if where ==
                     "engine" else s.get(name) for s in fresh]
            merged = _health.merge_histogram_snapshots(parts)
            if merged is not None:
                fleet[name] = merged
        # compile-plane federation: sum each replica's per-program
        # compile/recompile counts and compile seconds (a recompile
        # storm anywhere in the fleet shows up in ONE table)
        compile_fleet: Dict[str, dict] = {}
        for s in fresh:
            progs = (s.get("introspection") or {}).get("programs") or {}
            for name, st in progs.items():
                agg = compile_fleet.setdefault(
                    name, {"compiles": 0, "recompiles": 0,
                           "compile_seconds": 0.0})
                agg["compiles"] += int(st.get("compiles", 0) or 0)
                agg["recompiles"] += int(st.get("recompiles", 0) or 0)
                agg["compile_seconds"] += float(
                    st.get("compile_seconds", 0.0) or 0.0)
        if compile_fleet:
            fleet["compile"] = {
                name: dict(st, compile_seconds=round(
                    st["compile_seconds"], 6))
                for name, st in sorted(compile_fleet.items())}
        # memory-plane federation: pool bytes sum across replicas.
        # device_pool_bytes sums the GLOBAL logical pools (a tp=4
        # replica's sharded KV pool counts once at full size — it must
        # not look 4× cheaper); device_pool_bytes_per_shard sums the
        # per-card footprints (capacity planning: what each replica
        # asks of one card's memory), falling back to the global figure
        # for replicas predating the field
        mems = [s.get("memory") for s in fresh if s.get("memory")]
        if mems:
            fleet["memory"] = {
                "device_pool_bytes": sum(
                    int(m.get("device_pool_bytes") or 0) for m in mems),
                "device_pool_bytes_per_shard": sum(
                    int(m.get("device_pool_bytes_per_shard",
                              m.get("device_pool_bytes")) or 0)
                    for m in mems),
                "host_pool_bytes": sum(
                    int(m.get("host_pool_bytes") or 0) for m in mems),
                "checkpoint_staging_dirs": sum(
                    int((m.get("checkpoint_staging") or {})
                        .get("dirs") or 0) for m in mems),
            }
        # capsule-plane federation: capture/replay counters summed
        # across replicas — a divergent replay ANYWHERE in the fleet
        # shows up in one row of /fleetz
        caps = [s.get("capsules") for s in fresh if s.get("capsules")]
        if caps:
            fleet["capsules"] = {
                key: sum(int(c.get(key, 0) or 0) for c in caps)
                for key in ("captured_total", "persisted_total",
                            "live", "replays_total",
                            "divergent_replays_total")}
        # MoE-plane federation: element-wise per-expert load sum and
        # the fleet-wide imbalance recomputed from the merged loads (a
        # mean of per-replica ratios would hide one replica's hot
        # expert behind another's cold one)
        moes = [(s.get("engine") or {}).get("moe") for s in fresh]
        moes = [m for m in moes if m]
        if moes:
            width = max(len(m.get("expert_tokens") or []) for m in moes)
            tok = [0] * width
            for m in moes:
                for i, v in enumerate(m.get("expert_tokens") or []):
                    tok[i] += int(v)
            total = sum(tok)
            fleet["moe"] = {
                "num_experts": width,
                "expert_tokens": tok,
                "dropped_tokens": sum(
                    int(m.get("dropped_tokens", 0) or 0)
                    for m in moes),
                "imbalance": (max(tok) / (total / width)
                              if total else 0.0),
            }
        # speculative-plane federation: proposed / accepted /
        # delivered summed across replicas, acceptance rate recomputed
        # from the merged counters (a mean of per-replica rates would
        # weight an idle replica the same as a saturated one)
        specs = [(s.get("engine") or {}).get("spec") for s in fresh]
        specs = [m for m in specs if m]
        if specs:
            prop = sum(int(m.get("proposed", 0) or 0) for m in specs)
            acc = sum(int(m.get("accepted", 0) or 0) for m in specs)
            fleet["spec"] = {
                "windows": sum(int(m.get("windows", 0) or 0)
                               for m in specs),
                "proposed": prop,
                "accepted": acc,
                "delivered": sum(int(m.get("delivered", 0) or 0)
                                 for m in specs),
                "acceptance_rate": (acc / prop if prop else 0.0),
            }
        out = {"router": self.router_id, "retries": self.retry_count,
               "ejected": sorted(self._ejected),
               "replicas": rows, "fleet": fleet}
        h = _health.get_health()
        if h.enabled:
            out["health"] = h.snapshot()
        cw = _insp.get_compile_watch()
        if cw.enabled:
            out["introspection"] = cw.snapshot(include_log=False)
        cs = _capsule.get_capsule_store()
        if cs.enabled:
            out["capsules"] = cs.snapshot()
        return out
