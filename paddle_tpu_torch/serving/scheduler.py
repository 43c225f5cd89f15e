"""Continuous-batching scheduler — the runtime between user traffic
and one ``LLMEngine`` (counterpart of ``paddle_tpu/serving/scheduler.py``,
the same policy over the port's engine).

The ``Scheduler`` wraps ONE engine with:

* a priority-aware waiting queue (lower ``priority`` value runs first,
  FIFO within a priority class) with a hard bound — when
  ``max_queue`` requests are already waiting, ``submit`` sheds with
  ``RejectedError`` instead of growing without limit;
* capacity-checked admission: a request is admitted only when the
  engine has a free slot AND the paged cache has the request's full
  page budget (``ceil((prompt + max_new) / page_size)``) free or
  evictable — a full cache QUEUES work instead of letting the
  ``PagedKVCache`` OOM raise escape to the caller.  The check is
  exact, not heuristic: the engine reserves the whole budget at
  admission, so an admitted request can always decode to completion;
* per-request deadlines and max-queue-time: a waiting request whose
  deadline or queue-time budget expires is shed (it could only waste
  pages), and a request that finishes late is delivered but counted
  as a deadline miss — the accounting a goodput bench needs;
* cancellation (``cancel``) for waiting AND active requests — active
  ones release their KV pages via ``LLMEngine.abort``;
* graceful ``drain()``: stop admitting, finish everything in flight;
* priority PREEMPTION (``preemption=True``, the default): when the
  head of the waiting queue has STRICTLY higher priority than the
  lowest-priority active request and capacity blocks it, the victim
  is suspended — its KV pages swap into the engine's host pool (or
  are recomputed at resume) and its slot frees NOW.  The victim
  re-enters the priority queue in the SUSPENDED state and resumes
  through the same admission path when capacity allows, continuing
  with bit-identical tokens.  ``max_preemptions_per_request`` bounds
  how many times one request can be evicted (no livelock: after the
  bound it holds its slot to completion);
* bin-packing admission (``packing=True``, opt-in): when the head
  does not fit, smaller waiters that DO fit admit around it —
  bounded by an aging rule (``packing_max_overtakes`` admissions may
  overtake one blocked head, then strict order resumes) so a big
  request is delayed, never starved.

Determinism contract: the scheduler adds policy, never math — tokens
are equal to driving the engine directly with the same admission
order, and given the same clock it takes the reference's decisions
(admission, preemption, shedding) step for step.

Threading: ``submit``/``cancel`` may be called from any thread (the
HTTP frontend's handler threads do); all ENGINE work happens inside
``step()``, which the owner drives from one thread.  Streaming
callbacks (``on_event``) fire outside the scheduler lock, from the
thread that called ``step``/``submit``.

Memory: retirement pops the engine entry (``pop_result``) — a
long-running server does not grow the engine's request map.  The
scheduler's own finished records live until ``pop_result(rid)``;
frontends pop when the response is delivered.
"""
from __future__ import annotations

import heapq
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

__all__ = ["Scheduler", "RejectedError", "ScheduledRequest"]

_SCHED_IDS = itertools.count()

# queue-wait ladder (seconds): admission is host-side, so the
# interesting range spans "admitted immediately" to "parked behind a
# long decode burst"
_QWAIT_BUCKETS = (.001, .005, .01, .025, .05, .1, .25, .5, 1.0, 2.5,
                  5.0, 15.0, 60.0)

WAITING = "waiting"
ACTIVE = "active"
SUSPENDED = "suspended"      # preempted: in the queue, tokens so far kept
FINISHED = "finished"
CANCELLED = "cancelled"
SHED = "shed"
MIGRATED = "migrated"        # exported to another replica (terminal HERE)


class RejectedError(UnavailableError):
    """The scheduler refused the request (bounded queue full, draining,
    or expired while waiting) — explicit load shedding, the
    alternative to unbounded queue growth or an OOM raise."""


class ScheduledRequest:
    """Scheduler-side record of one request's life: queue → engine →
    result.  ``tokens`` accumulates everything produced (the prefill
    token included); ``state`` is one of waiting/active/finished/
    cancelled/shed."""

    def __init__(self, rid, prompt, max_new, eos, priority, deadline,
                 max_queue_time, submit_t, on_event, seq):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new = max_new
        self.eos = eos
        self.priority = priority
        self.deadline = deadline            # absolute clock value or None
        self.max_queue_time = max_queue_time
        self.submit_t = submit_t
        self.admit_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.on_event = on_event
        self.seq = seq
        self.state = WAITING
        self.tokens: List[int] = []
        self.deadline_missed = False
        self.shed_reason: Optional[str] = None
        # preemption bookkeeping: times this request has been evicted,
        # when the current suspension started, packing-aging overtakes
        # while this request blocked the head of the queue, and
        # whether the record currently sits in the admission heap
        # (suspended records re-enter it; packed admissions leave a
        # stale entry that must not be double-pushed)
        self.preempts = 0
        self.preempt_t: Optional[float] = None
        self.overtaken = 0
        self.in_heap = False
        # observability: the request's trace context ({"trace_id",
        # "parent_id"} — propagated from the frontend or minted here),
        # held-open spans by role (root/queue/suspend), the structured
        # timeline (event name, clock) request_timeline() serves, and
        # when the first token landed (scheduler-side TTFT)
        self.trace_ctx: Optional[dict] = None
        self.spans: Dict[str, object] = {}
        self.timeline: List[tuple] = []
        self.first_token_t: Optional[float] = None
        # id of this request's capsule once a TRIGGERED capture fired
        # (slow TTFT / deadline miss / error / sentinel trip) — the
        # statusz → capsule → replay cross-link
        self.capsule_id: Optional[str] = None

    def __lt__(self, other):                # heapq tie-breaks via seq
        return (self.priority, self.seq) < (other.priority, other.seq)


class Scheduler:
    """Priority/deadline-aware continuous-batching loop over one
    ``LLMEngine`` (see module docstring for the policy contract).

    Parameters: ``max_queue`` bounds the WAITING set (active requests
    are bounded by the engine's ``max_seqs`` already);
    ``max_queue_time`` is the default queue-time budget (seconds,
    None = unlimited), overridable per request; ``clock`` is
    injectable (tests pass a fake) and defaults to
    ``time.monotonic``; ``preemption``/``max_preemptions_per_request``
    and ``packing``/``packing_max_overtakes`` select the preemption
    and bin-packing admission policies (module docstring).  Suspended
    requests do NOT count against ``max_queue`` (they were already
    admitted once; shedding them would discard computed tokens) and
    are never expired by queue timers — only ``cancel`` or their
    deadline at delivery touches them.

    ``chunked_prefill`` (opt-in, requires an engine built with
    ``unified_step=True``) admits waiting requests through
    ``LLMEngine.begin_request`` instead of the synchronous
    ``add_request``: the prompt's prefill then rides the ragged
    unified step alongside ongoing decodes, a page-sized chunk per
    step under the engine's ``prefill_token_budget``, so a long
    prompt never stalls in-flight decode.  The first token arrives
    from a later ``step()`` rather than at admission — TTFT
    bookkeeping moves to token delivery.  ``decode_tpot_slo``
    (seconds per decode token, None = off) enables an AIMD
    controller on the engine's runtime ``prefill_token_budget``:
    when a mixed step's per-token wall time breaches the SLO the
    budget halves (decode latency wins), otherwise it recovers one
    page per step up to the configured ceiling."""

    def __init__(self, engine, max_queue: int = 64,
                 max_queue_time: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 enable_metrics: bool = True,
                 preemption: bool = True,
                 max_preemptions_per_request: int = 2,
                 packing: bool = False,
                 packing_max_overtakes: int = 8,
                 chunked_prefill: bool = False,
                 decode_tpot_slo: Optional[float] = None,
                 slow_ttft: Optional[float] = None):
        if getattr(engine, "tp", 1) > 1:
            # every rank of a mesh must make the same engine calls in
            # the same order; this loop's clock-driven decisions would
            # differ between ranks (a leader rank that broadcasts each
            # step's calls is the missing piece)
            raise NotImplementedError(
                "the serving runtime over a tensor-parallel engine (tp > "
                "1) is not ported yet (ROADMAP 'Multi-device')")
        enforce(max_queue >= 1, "max_queue must be >= 1")
        enforce(max_preemptions_per_request >= 0,
                "max_preemptions_per_request must be >= 0")
        enforce(packing_max_overtakes >= 1,
                "packing_max_overtakes must be >= 1")
        enforce(not chunked_prefill or getattr(engine, "unified_step",
                                              False),
                "chunked_prefill requires an engine with "
                "unified_step=True")
        enforce(decode_tpot_slo is None or decode_tpot_slo > 0,
                "decode_tpot_slo must be positive (or None)")
        self.engine = engine
        self.max_queue = max_queue
        self.default_max_queue_time = max_queue_time
        self.preemption = bool(preemption)
        self.max_preemptions_per_request = max_preemptions_per_request
        self.packing = bool(packing)
        self.packing_max_overtakes = packing_max_overtakes
        self.chunked_prefill = bool(chunked_prefill)
        self.decode_tpot_slo = decode_tpot_slo
        # triggered-capture TTFT threshold (seconds).  None defers to
        # the CapsuleStore's own ``slow_ttft``; either way a first
        # token past it persists the request's capsule
        self.slow_ttft = slow_ttft
        # sentinel trips already accounted: a NEW trip while requests
        # are in flight persists their capsules exactly once
        self._capsule_trips_seen = 0
        self._clock = clock or time.monotonic
        self._lock = threading.RLock()
        self._reqs: Dict[object, ScheduledRequest] = {}
        self._heap: List[ScheduledRequest] = []
        self._n_waiting = 0
        self._n_suspended = 0
        self._seq = itertools.count()
        self._pending_abort: List[object] = []
        self._draining = False
        self.sched_id = str(next(_SCHED_IDS))
        # host-side shed accounting (kept even with metrics off; the
        # registry's shed family is shared across schedulers, this is
        # THIS scheduler's view)
        self.shed_stats: Dict[str, int] = {}
        self._init_metrics(enable_metrics)

    # -- metrics ---------------------------------------------------------------
    def _init_metrics(self, enabled: bool):
        self._metrics = None
        if not enabled:
            return
        reg = get_registry()
        sid = self.sched_id
        lbl = ("sched",)
        self._metrics = {
            "queue_wait": reg.histogram(
                "serving_sched_queue_wait_seconds",
                "Submit-to-admission wait of admitted requests.",
                lbl, buckets=_QWAIT_BUCKETS).labels(sid),
            "admitted": reg.counter(
                "serving_sched_admitted_total",
                "Requests admitted into the engine.", lbl).labels(sid),
            "completed": reg.counter(
                "serving_sched_completed_total",
                "Requests that ran to EOS / token budget.",
                lbl).labels(sid),
            "shed": reg.counter(
                "serving_sched_shed_total",
                "Requests refused or dropped unserved (load "
                "shedding), by reason.",
                ("sched", "reason")),
            "aborts": reg.counter(
                "serving_sched_abort_total",
                "Requests cancelled by the client.", lbl).labels(sid),
            "deadline_miss": reg.counter(
                "serving_sched_deadline_miss_total",
                "Requests past their deadline (shed while waiting, or "
                "delivered late).", lbl).labels(sid),
            "waiting": reg.gauge(
                "serving_sched_waiting",
                "Requests in the bounded waiting queue.",
                lbl).labels(sid),
            "preempted": reg.counter(
                "serving_sched_preempted_total",
                "Active requests evicted (suspended) so a strictly "
                "higher-priority waiter could admit.", lbl).labels(sid),
            "packed": reg.counter(
                "serving_sched_packed_admissions_total",
                "Requests admitted around a blocked head of queue "
                "(bin-packing admission).", lbl).labels(sid),
            "suspended": reg.gauge(
                "serving_sched_suspended",
                "Preempted requests waiting to resume.", lbl).labels(
                    sid),
            "time_preempted": reg.histogram(
                "serving_sched_time_preempted_seconds",
                "Wall time a preempted request spent suspended before "
                "resuming.", lbl, buckets=_QWAIT_BUCKETS).labels(sid),
            "migrated_out": reg.counter(
                "serving_sched_migrated_out_total",
                "Requests exported to another replica "
                "(migrate_out).", lbl).labels(sid),
            "migrated_in": reg.counter(
                "serving_sched_migrated_in_total",
                "Requests adopted from another replica "
                "(migrate_in).", lbl).labels(sid),
        }

    def _shed_inc(self, reason: str):
        self.shed_stats[reason] = self.shed_stats.get(reason, 0) + 1
        _health.get_health().event("shed_rate", bad=True)
        if self._metrics is not None:
            self._metrics["shed"].labels(self.sched_id, reason).inc()

    def _set_waiting_gauge(self):
        if self._metrics is not None:
            self._metrics["waiting"].set(self._n_waiting)
            self._metrics["suspended"].set(self._n_suspended)

    # -- submission / cancellation (any thread) --------------------------------
    def submit(self, rid, prompt_ids, max_new_tokens: int = 64,
               eos_token_id: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None,
               max_queue_time: Optional[float] = None,
               on_event: Optional[Callable[[dict], None]] = None,
               trace_ctx: Optional[dict] = None):
        """Queue a request.  Raises ``RejectedError`` when the bounded
        queue is full or the scheduler is draining, and
        ``InvalidArgumentError`` for requests that could NEVER be
        admitted (over the engine/model length limit) — an error now
        beats a request that would wait forever.

        ``deadline`` / ``max_queue_time`` are seconds from submission;
        ``on_event`` receives ``{"type": "tokens"|"finished"|
        "cancelled"|"shed", "rid": ..., ...}`` dicts as the request
        progresses (tokens stream per engine step window).
        ``trace_ctx`` is the propagated trace context (``{"trace_id",
        "parent_id"}`` — from the HTTP frontend's root span, or a
        remote submit's headers); with tracing enabled and no context,
        the scheduler roots a trace itself, so a directly-driven
        scheduler still yields connected traces."""
        eng = self.engine
        plen = len(list(prompt_ids))
        enforce(plen >= 1, "empty prompt")
        enforce(max_new_tokens >= 1, "max_new_tokens must be >= 1")
        limit = min(eng.max_len, eng.config.max_position_embeddings)
        enforce(plen + max_new_tokens <= limit,
                f"prompt ({plen}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine/model limit {limit} — this "
                f"request can never be admitted")
        P = eng.cache.page_size
        need = -(-(plen + max_new_tokens) // P)
        enforce(need <= eng.cache.n_pages - 1,
                f"request needs {need} KV pages but the cache holds "
                f"{eng.cache.n_pages - 1} usable — it can never be "
                f"admitted")
        now = self._clock()
        with self._lock:
            enforce(rid not in self._reqs,
                    f"duplicate request id {rid!r} (pop_result "
                    f"retired ids before reuse)")
            if self._draining:
                self._shed_inc("draining")
                raise RejectedError(
                    f"scheduler is draining; request {rid!r} rejected")
            if self._n_waiting >= self.max_queue:
                self._shed_inc("queue_full")
                raise RejectedError(
                    f"waiting queue full ({self.max_queue}); request "
                    f"{rid!r} shed")
            mqt = max_queue_time if max_queue_time is not None \
                else self.default_max_queue_time
            rec = ScheduledRequest(
                rid, prompt_ids, max_new_tokens, eos_token_id,
                priority, now + deadline if deadline is not None
                else None, mqt, now, on_event, next(self._seq))
            self._reqs[rid] = rec
            heapq.heappush(self._heap, rec)
            rec.in_heap = True
            self._n_waiting += 1
            rec.timeline.append(("submitted", now))
            self._trace_enqueue(rec, trace_ctx)
            self._set_waiting_gauge()
        # shed-rate SLO sees every submission outcome: good here, bad
        # at each _shed_inc site
        _health.get_health().event("shed_rate", bad=False)
        return rid

    def cancel(self, rid) -> bool:
        """Cancel a waiting or active request.  Waiting requests leave
        the queue immediately; active ones are aborted (pages
        released) at the next ``step()`` — engine state is only
        touched from the stepping thread.  Returns False if the
        request already finished (idempotent)."""
        events = []
        with self._lock:
            enforce(rid in self._reqs, f"unknown request id {rid!r}")
            rec = self._reqs[rid]
            if rec.state == WAITING:
                rec.state = CANCELLED
                rec.finish_t = self._clock()
                self._n_waiting -= 1
                self._trace_terminal(rec, CANCELLED)
                if self._metrics is not None:
                    self._metrics["aborts"].inc()
                self._set_waiting_gauge()
                self._event(events, rec, {"type": "cancelled",
                                          "rid": rid, "tokens": []})
            elif rec.state in (ACTIVE, SUSPENDED):
                # engine state (pages, swap pool) is only touched from
                # the stepping thread — defer to the next step()
                self._pending_abort.append(rid)
            else:
                self._dispatch(events)
                return False
        self._dispatch(events)
        return True

    # -- the scheduling loop (one thread) --------------------------------------
    def step(self) -> Dict[object, List[int]]:
        """One scheduler iteration: process cancellations, expire
        stale waiters, admit while capacity allows, run one engine
        step window, retire finished requests.  Returns
        ``{rid: [new tokens]}`` for this call (admission's prefill
        token included) — the same streaming contract as
        ``LLMEngine.step``.

        Window-boundary contract: ``engine.step()`` is where control
        returns to the host, so EVERYTHING scheduler-shaped — admission
        of waiters, preemption/suspend, migrate-out, abort, the AIMD
        budget decision below — lands BETWEEN decode windows, never
        inside one.  With the split path's windows (steps_per_sync > 1)
        a window is up to steps_per_sync tokens per request; the engine
        returns the full per-request token lists for the window, so the
        streaming contract, retirement, and the equal-token guarantees
        of suspend→resume, migration and preemption are unchanged — a
        request suspended here was never mid-window by construction.
        Every device launch of the step happens here, on the calling
        thread.  This is also why ``self._lock`` wrapping one
        ``engine.step()`` is sufficient synchronization: there is no
        finer-grained engine state to race with."""
        events: List = []
        out: Dict[object, List[int]] = {}
        with self._lock:
            self._process_aborts(events)
            self._expire_waiting(events)
            self._admit(events, out)
            if self.engine.has_work():
                t0 = time.perf_counter()
                try:
                    step_out = self.engine.step()
                except BaseException as e:
                    # triggered capture: an engine step blowing up is
                    # THE reproduction case — persist every in-flight
                    # capsule before the error propagates
                    for rec in self._reqs.values():
                        if rec.state == ACTIVE:
                            self._capsule_persist(
                                rec, f"error:{type(e).__name__}")
                    raise
                self._adapt_prefill_budget(time.perf_counter() - t0,
                                           step_out)
                for rid, toks in step_out.items():
                    rec = self._reqs.get(rid)
                    if rec is None or rec.state != ACTIVE:
                        continue
                    if (rec.first_token_t is None and toks
                            and not rec.tokens):
                        # chunked admission: the first token arrives
                        # from a mixed step, not at admit time
                        rec.first_token_t = self._clock()
                        rec.timeline.append(("first_token",
                                             rec.first_token_t))
                        self._capsule_first_token(rec)
                    rec.tokens.extend(toks)
                    out.setdefault(rid, []).extend(toks)
                    self._event(events, rec,
                                {"type": "tokens", "rid": rid,
                                 "tokens": list(toks)})
                self._capsule_sentinel_check()
            self._retire_done(events)
        self._dispatch(events)
        return out

    def _adapt_prefill_budget(self, dt: float, step_out: dict):
        """AIMD on the engine's runtime ``prefill_token_budget``
        (chunked_prefill + decode_tpot_slo only).  ``dt`` is the wall
        time of one engine step window; divided by the window's token
        count it approximates decode TPOT.  Windows with prefill
        packed are single dispatches (nsteps == 1) so the
        approximation is exact where the knob matters; scanned
        multi-token windows (``scan_decode``) divide by the tokens the
        window actually delivered — the max over
        ``len(step_out[rid])`` — so an early-exited window is costed
        by its real length.  Speculative windows fall out of the same
        rule: ``step_out`` carries only ACCEPTED (delivered) tokens,
        so a low-acceptance draft reads as HIGH per-token cost and
        sheds prefill interleave instead of hiding behind proposed-
        but-rejected tokens.  Breach: halve (floor 1 — the engine's own
        livelock guard still guarantees prefill progress on
        prefill-only steps).  Under SLO: recover one page per step up
        to the configured ceiling (``engine._pf_budget_static``)."""
        if not self.chunked_prefill or self.decode_tpot_slo is None:
            return
        eng = self.engine
        nsteps = max((len(t) for t in step_out.values()), default=1)
        per_tok = dt / max(1, nsteps)
        budget = int(eng.prefill_token_budget)
        if per_tok > self.decode_tpot_slo:
            eng.prefill_token_budget = max(1, budget // 2)
        else:
            eng.prefill_token_budget = min(
                eng._pf_budget_static, budget + eng.cache.page_size)

    def busy(self) -> bool:
        """True while anything is waiting, suspended, active, or
        pending abort."""
        with self._lock:
            return bool(self._n_waiting or self._n_suspended or
                        self._pending_abort) or self.engine.has_work()

    def run_until_idle(self, max_steps: Optional[int] = None
                       ) -> Dict[object, List[int]]:
        """Drive ``step()`` until nothing is waiting or active (or
        ``max_steps`` elapses); returns the union of the per-step
        token streams."""
        out: Dict[object, List[int]] = {}
        steps = 0
        while self.busy():
            for rid, t in self.step().items():
                out.setdefault(rid, []).extend(t)
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    def stop_admission(self) -> None:
        """Refuse further submissions (``submit`` raises
        ``RejectedError``) — the first half of ``drain``."""
        with self._lock:
            self._draining = True

    def resume_admission(self) -> None:
        """Accept submissions again — closes a TEMPORARY drain (a
        rebalancing migration, a suspected-bad host that probed
        healthy) without rebuilding the scheduler."""
        with self._lock:
            self._draining = False

    def drain(self) -> None:
        """Graceful shutdown: refuse new submissions, then finish
        every queued and active request."""
        self.stop_admission()
        self.run_until_idle()

    # -- control surface (router / remote transport) ---------------------------
    def load(self) -> int:
        """Waiting + suspended + active requests — the least-loaded
        routing key.  Suspended requests count: they hold no device
        pages right now but WILL resume and reclaim capacity, so a
        replica thrashing on preemption must look loaded."""
        with self._lock:
            return (self._n_waiting + self._n_suspended +
                    len(self.engine._active) +
                    len(getattr(self.engine, "_prefilling", ())))

    def health(self, timeout: Optional[float] = None) -> dict:
        """Liveness answer the prober consumes — in-process replicas
        are reachable by construction, so only the draining state
        matters (``timeout`` exists for signature parity with the
        remote adapter)."""
        with self._lock:
            return {"status": "draining" if self._draining else "ok",
                    "waiting": self._n_waiting}

    def knows(self, rid) -> bool:
        """True while ``rid`` has a record here (any state) — the
        idempotent-resubmission check: a retried submit for a known
        rid must ack, not double-admit."""
        with self._lock:
            return rid in self._reqs

    def snapshot_requests(self, rids) -> Dict[object, dict]:
        """Poll view for the remote transport: per rid, its state and
        FULL token list so far (the client diffs against what it has
        already delivered).  Unknown rids answer ``state="unknown"``
        instead of raising — a poller racing retirement is normal."""
        out: Dict[object, dict] = {}
        with self._lock:
            for rid in rids:
                rec = self._reqs.get(rid)
                if rec is None:
                    out[rid] = {"state": "unknown", "tokens": []}
                else:
                    out[rid] = {"state": rec.state,
                                "tokens": list(rec.tokens),
                                "deadline_missed": rec.deadline_missed,
                                "shed_reason": rec.shed_reason}
        return out

    # -- per-request timing breakdown ------------------------------------------
    def request_timeline(self, rid) -> dict:
        """Structured life-of-a-request record: submitted / admitted /
        first-token / preemption-resume / migration / terminal
        timestamps (this scheduler's clock), derived queue-wait and
        TTFT, and the trace id tying it to the span tracer.  Readable
        in ANY state — a live request answers with what has happened
        so far.  Unknown rids raise (like ``status``)."""
        with self._lock:
            enforce(rid in self._reqs, f"unknown request id {rid!r}")
            rec = self._reqs[rid]
            return {
                "rid": str(rec.rid), "sched": self.sched_id,
                "state": rec.state, "priority": rec.priority,
                "trace_id": (rec.trace_ctx or {}).get("trace_id"),
                "submitted": rec.submit_t, "admitted": rec.admit_t,
                "first_token": rec.first_token_t,
                "finished": rec.finish_t,
                "queue_wait": None if rec.admit_t is None
                else rec.admit_t - rec.submit_t,
                "ttft": None if rec.first_token_t is None
                else rec.first_token_t - rec.submit_t,
                "preemptions": rec.preempts,
                "n_tokens": len(rec.tokens),
                "deadline_missed": rec.deadline_missed,
                "shed_reason": rec.shed_reason,
                "capsule": rec.capsule_id,
                "timeline": [{"event": e, "t": t}
                             for e, t in rec.timeline],
            }

    def requests_overview(self) -> List[dict]:
        """Live (waiting/active/suspended) requests with ages — the
        ``/statusz`` request table."""
        now = self._clock()
        with self._lock:
            return [{"rid": str(rec.rid), "sched": self.sched_id,
                     "state": rec.state, "priority": rec.priority,
                     "age": now - rec.submit_t,
                     "n_tokens": len(rec.tokens),
                     "preemptions": rec.preempts,
                     "trace_id": (rec.trace_ctx or {}).get("trace_id"),
                     "capsule": rec.capsule_id}
                    for rec in self._reqs.values()
                    if rec.state in (WAITING, ACTIVE, SUSPENDED)]

    # -- migration (KV-migrating drain / rebalance) ----------------------------
    def migrate_out(self, rid) -> Optional[dict]:
        """Export one live request as a migration package for another
        replica's ``migrate_in``: WAITING requests travel as policy
        only (prompt + limits — nothing computed yet), ACTIVE ones are
        suspended first (KV swaps to the host pool or arms the
        recompute path), and SUSPENDED ones ship their swap entry
        serialized portably.  Deadlines re-base: the package carries
        REMAINING seconds, so differing host clocks cannot corrupt
        them.  The record leaves this scheduler (state ``migrated``).

        A rid with a cancel pending resolves the cancel instead and
        returns ``None`` — the client asked for termination, not a new
        home.  Call from the stepping thread (engine state moves)."""
        events: List = []
        pkg = None
        with self._lock:
            enforce(rid in self._reqs, f"unknown request id {rid!r}")
            rec = self._reqs[rid]
            enforce(rec.state in (WAITING, ACTIVE, SUSPENDED),
                    f"request {rid!r} is {rec.state} — only live "
                    f"requests migrate")
            if rid in self._pending_abort:
                self._process_aborts(events)
            else:
                now = self._clock()
                pkg = {"rid": rid, "priority": rec.priority,
                       "deadline_remaining":
                           None if rec.deadline is None
                           else rec.deadline - now,
                       "trace": rec.trace_ctx,
                       "on_event": rec.on_event}
                # sync lifecycle context into the capsule BEFORE the
                # engine exports it into the package — the capsule
                # travels whole (timeline, windows, key anchor) and
                # replays on the destination
                cs = _capsule.get_capsule_store()
                if cs.enabled:
                    cs.annotate(rid, timeline=list(rec.timeline),
                                trace_id=(rec.trace_ctx or {}).get(
                                    "trace_id"))
                ereq = self.engine.requests.get(rid)
                if rec.state == WAITING:
                    pkg.update({
                        "admitted": False, "prompt": list(rec.prompt),
                        "tokens": [], "max_new": rec.max_new,
                        "eos": rec.eos, "swap": None,
                        "max_queue_time_remaining":
                            None if rec.max_queue_time is None
                            else rec.max_queue_time
                            - (now - rec.submit_t)})
                    self._n_waiting -= 1
                elif ereq is not None and not ereq.out:
                    # chunked admission, prefill not finished: no
                    # token exists, so there is nothing computed worth
                    # shipping (``import_request`` rightly refuses an
                    # empty ``out``).  Drop the engine side and travel
                    # policy-only — the destination admits it fresh.
                    if rec.state == SUSPENDED:
                        self._n_suspended -= 1
                    self.engine.abort(rid)
                    self.engine.requests.pop(rid, None)
                    pkg.update({
                        "admitted": False, "prompt": list(rec.prompt),
                        "tokens": [], "max_new": rec.max_new,
                        "eos": rec.eos, "swap": None,
                        "max_queue_time_remaining": None})
                else:
                    with _tracing.span("sched.migrate_out",
                                       ctx=rec.trace_ctx) as sp:
                        if rec.state == ACTIVE:
                            self.engine.suspend(rid)
                        else:
                            self._n_suspended -= 1
                        epkg = self.engine.export_request(rid)
                        sp.set_attr("rid", str(rid))
                        sp.set_attr("sched", self.sched_id)
                        sp.set_attr("swap",
                                    epkg["swap"] is not None)
                    pkg.update({
                        "admitted": True, "prompt": epkg["prompt"],
                        "tokens": epkg["out"],
                        "max_new": epkg["max_new"], "eos": epkg["eos"],
                        "swap": epkg["swap"],
                        "max_queue_time_remaining": None})
                # the capsule rides the package: admitted exports get
                # it from the engine package, policy-only paths lift
                # it straight out of the store (plain JSON — remote
                # transports ship it untouched)
                if pkg.get("capsule") is None:
                    pkg["capsule"] = epkg.get("capsule") \
                        if pkg["admitted"] else \
                        (cs.export(rid) if cs.enabled else None)
                rec.state = MIGRATED
                self._trace_terminal(rec, MIGRATED)
                del self._reqs[rid]
                if self._metrics is not None:
                    self._metrics["migrated_out"].inc()
                self._set_waiting_gauge()
        self._dispatch(events)
        return pkg

    def migrate_in(self, pkg: dict,
                   on_event: Optional[Callable[[dict], None]] = None):
        """Adopt a migration package.  Admitted requests re-enter as
        SUSPENDED at their original priority (they resume through the
        normal capacity-checked admission path — swap-in when the blob
        fits this cache's pool, recompute otherwise, bit-identical
        either way); never-admitted ones re-enter WAITING and are
        subject to the queue bound like any submit.  Raises
        ``RejectedError`` when draining or (waiting only) the queue is
        full, and engine limit/geometry errors propagate — the caller
        tries another replica.  Returns the rid."""
        rid = pkg["rid"]
        now = self._clock()
        events: List = []
        with self._lock:
            enforce(rid not in self._reqs,
                    f"duplicate request id {rid!r}")
            if self._draining:
                self._shed_inc("draining")
                raise RejectedError(
                    f"scheduler is draining; migrated request {rid!r} "
                    f"rejected")
            dl = pkg.get("deadline_remaining")
            mqt = pkg.get("max_queue_time_remaining")
            rec = ScheduledRequest(
                rid, pkg["prompt"], pkg["max_new"], pkg["eos"],
                pkg.get("priority", 0),
                None if dl is None else now + dl, mqt, now,
                on_event if on_event is not None
                else pkg.get("on_event"), next(self._seq))
            if pkg["admitted"]:
                self.engine.import_request(
                    {"rid": rid, "prompt": pkg["prompt"],
                     "out": pkg["tokens"], "max_new": pkg["max_new"],
                     "eos": pkg["eos"], "swap": pkg.get("swap"),
                     "capsule": pkg.get("capsule")})
                rec.tokens = list(pkg["tokens"])
                rec.state = SUSPENDED
                rec.preempt_t = now
                self._n_suspended += 1
            else:
                # policy-only package: the engine never sees it here —
                # adopt its capsule directly (a fresh admission will
                # open a new capture; until then the source's history
                # stays queryable)
                cs = _capsule.get_capsule_store()
                if cs.enabled and pkg.get("capsule"):
                    cs.adopt(pkg["capsule"])
                if self._n_waiting >= self.max_queue:
                    self._shed_inc("queue_full")
                    raise RejectedError(
                        f"waiting queue full ({self.max_queue}); "
                        f"migrated request {rid!r} shed")
                self._n_waiting += 1
            rec.timeline.append(("migrated_in", now))
            # continue the SOURCE's trace (the package carries its
            # context), so a migrated request stays ONE trace across
            # hosts; admitted packages re-enter as suspended
            self._trace_enqueue(rec, pkg.get("trace"),
                                suspended=bool(pkg["admitted"]))
            self._reqs[rid] = rec
            heapq.heappush(self._heap, rec)
            rec.in_heap = True
            if self._metrics is not None:
                self._metrics["migrated_in"].inc()
            self._set_waiting_gauge()
            # tokens the source computed but never delivered to the
            # stream (a remote source can run ahead of its polls):
            # catch the stream up before new tokens arrive
            delivered = pkg.get("delivered", len(rec.tokens))
            if rec.tokens[delivered:]:
                self._event(events, rec,
                            {"type": "tokens", "rid": rid,
                             "tokens": list(rec.tokens[delivered:])})
        self._dispatch(events)
        return rid

    # -- results ---------------------------------------------------------------
    def status(self, rid) -> str:
        with self._lock:
            enforce(rid in self._reqs, f"unknown request id {rid!r}")
            return self._reqs[rid].state

    def result(self, rid) -> List[int]:
        """Token list of a finished or cancelled request (partial for
        cancelled — check ``status``).  Shed requests raise
        ``RejectedError`` (they produced nothing); waiting/active ones
        raise like ``LLMEngine.result``."""
        with self._lock:
            enforce(rid in self._reqs, f"unknown request id {rid!r}")
            rec = self._reqs[rid]
            if rec.state == SHED:
                raise RejectedError(
                    f"request {rid!r} was shed ({rec.shed_reason})")
            enforce(rec.state in (FINISHED, CANCELLED),
                    f"request {rid!r} is {rec.state} — results exist "
                    f"only after it finishes or is cancelled")
            return list(rec.tokens)

    def pop_result(self, rid) -> List[int]:
        """``result(rid)`` + forget the record (the bounded-memory
        read — frontends pop once the response is delivered)."""
        out = self.result(rid)
        with self._lock:
            del self._reqs[rid]
        return out

    def forget(self, rid) -> None:
        """Drop a TERMINAL record (finished/cancelled/shed) without
        reading it — the teardown path for shed requests, whose
        ``result`` raises by design.  Waiting/active records refuse
        (cancel first)."""
        with self._lock:
            enforce(rid in self._reqs, f"unknown request id {rid!r}")
            rec = self._reqs[rid]
            enforce(rec.state in (FINISHED, CANCELLED, SHED),
                    f"request {rid!r} is {rec.state} — cancel before "
                    f"forgetting")
            del self._reqs[rid]

    def metrics_snapshot(self) -> dict:
        """Scheduler counters + the wrapped engine's snapshot, one
        JSON-able dict (the same series land in the global registry
        under label sched=<id> for /metrics scrapes)."""
        with self._lock:
            states: Dict[str, int] = {}
            for rec in self._reqs.values():
                states[rec.state] = states.get(rec.state, 0) + 1
            snap = {
                "sched": self.sched_id,
                "waiting": self._n_waiting,
                "suspended": self._n_suspended,
                "draining": self._draining,
                "states": states,
                "shed": dict(self.shed_stats,
                             total=sum(self.shed_stats.values())),
                "engine": self.engine.metrics_snapshot(),
            }
            if self._metrics is not None:
                m = self._metrics
                snap.update({
                    "admitted": int(m["admitted"].value),
                    "completed": int(m["completed"].value),
                    "aborted": int(m["aborts"].value),
                    "deadline_miss": int(m["deadline_miss"].value),
                    "preempted": int(m["preempted"].value),
                    "packed_admissions": int(m["packed"].value),
                    "migrated_out": int(m["migrated_out"].value),
                    "migrated_in": int(m["migrated_in"].value),
                    "time_preempted_seconds":
                        m["time_preempted"]._snapshot_value(),
                    "queue_wait_seconds":
                        m["queue_wait"]._snapshot_value(),
                })
        # windowed health view rides along so every /v1/stats or
        # /v1/metrics_snapshot scrape carries burn rates (the hub is
        # process-global: in-process replicas share one hub, remote
        # replicas each publish their own)
        h = _health.get_health()
        if h.enabled:
            snap["health"] = h.snapshot()
        # compile & memory plane rides the same scrape when the watch
        # is on: the brief per-program table (no log) + pool byte
        # totals, which fleet_snapshot() sums across replicas
        cw = _insp.get_compile_watch()
        if cw.enabled:
            snap["introspection"] = cw.snapshot(include_log=False)
            snap["memory"] = _insp.memory_brief(
                getattr(self.engine, "device", None))
        # request-capsule plane rides along too — capture counters +
        # audit verdicts, summed across replicas by fleet_snapshot()
        cs = _capsule.get_capsule_store()
        if cs.enabled:
            snap["capsules"] = cs.snapshot()
        return snap

    # -- internals (lock held) -------------------------------------------------
    def _event(self, events, rec, ev):
        if rec.on_event is not None:
            events.append((rec.on_event, ev))

    @staticmethod
    def _dispatch(events):
        for cb, ev in events:
            cb(ev)

    # -- capsule internals (lock held; strict no-ops with capture off) ---------
    def _capsule_persist(self, rec, reason: str):
        """Triggered capture: sync the lifecycle timeline + trace_id
        into the request's capsule, persist it with ``reason``, and
        cross-link the capsule id onto the record and the flight
        recorder (so /statusz and the slow-request WARNING can point
        straight at it)."""
        cs = _capsule.get_capsule_store()
        if not cs.enabled:
            return None
        trace_id = (rec.trace_ctx or {}).get("trace_id")
        cs.annotate(rec.rid, timeline=list(rec.timeline),
                    trace_id=trace_id)
        cap_id = cs.persist(rec.rid, reason)
        if cap_id is not None:
            rec.capsule_id = cap_id
            _tracing.record_event(
                "capsule_captured", rid=str(rec.rid), capsule=cap_id,
                reason=reason, trace_id=trace_id, sched=self.sched_id)
        return cap_id

    def _capsule_first_token(self, rec):
        """Slow-TTFT trigger, called where ``first_token_t`` is
        stamped (sync admission and the chunked-delivery merge
        loop)."""
        cs = _capsule.get_capsule_store()
        if not cs.enabled or rec.first_token_t is None:
            return
        thr = self.slow_ttft if self.slow_ttft is not None \
            else cs.slow_ttft
        if thr is not None and \
                rec.first_token_t - rec.submit_t > thr:
            self._capsule_persist(rec, "slow_ttft")

    def _capsule_sentinel_check(self):
        """Persist in-flight capsules when the AnomalySentinel tripped
        since the last check — the trip and the requests decoding
        through it are the reproduction case."""
        cs = _capsule.get_capsule_store()
        if not cs.enabled:
            return
        sent = getattr(_health.get_health(), "sentinel", None)
        if sent is None:
            return
        trips = len(sent.trips)
        if trips > self._capsule_trips_seen:
            self._capsule_trips_seen = trips
            for rec in self._reqs.values():
                if rec.state == ACTIVE:
                    self._capsule_persist(rec, "sentinel_trip")

    # -- tracing internals (lock held; strict no-ops with tracing off) ---------
    def _trace_enqueue(self, rec, trace_ctx, suspended: bool = False):
        """Adopt (or mint) the request's trace context and open the
        held span covering its time in the queue — ``sched.queue_wait``
        for fresh submissions, ``sched.suspended`` for migrated-in
        admitted requests."""
        tr = _tracing.get_tracer()
        if tr is None or not tr.enabled:
            rec.trace_ctx = trace_ctx
            return
        if trace_ctx is None:
            root = tr.start_span(
                "sched.request", activate=False,
                attrs={"rid": str(rec.rid), "sched": self.sched_id})
            rec.spans["root"] = root
            trace_ctx = root.context()
        rec.trace_ctx = trace_ctx
        key, name = ("suspend", "sched.suspended") if suspended \
            else ("queue", "sched.queue_wait")
        rec.spans[key] = tr.start_span(
            name, ctx=trace_ctx, activate=False,
            attrs={"rid": str(rec.rid), "sched": self.sched_id})

    @staticmethod
    def _end_span(rec, key) -> None:
        sp = rec.spans.pop(key, None)
        if sp is not None:
            sp.end()

    def _trace_terminal(self, rec, state, reason=None) -> None:
        """Close every held span at a terminal transition (finished /
        cancelled / shed / migrated) and stamp the timeline."""
        rec.timeline.append((state, rec.finish_t
                             if rec.finish_t is not None
                             else self._clock()))
        self._end_span(rec, "queue")
        self._end_span(rec, "suspend")
        root = rec.spans.pop("root", None)
        if root is not None:
            root.set_attr("state", state)
            if reason is not None:
                root.set_attr("reason", reason)
            root.end()

    def _process_aborts(self, events):
        for rid in self._pending_abort:
            rec = self._reqs.get(rid)
            if rec is None or rec.state not in (ACTIVE, SUSPENDED):
                continue                     # finished in the meantime
            if self.engine.abort(rid):
                if rec.state == SUSPENDED:
                    self._n_suspended -= 1
                rec.tokens = self.engine.pop_result(rid)
                rec.state = CANCELLED
                rec.finish_t = self._clock()
                self._trace_terminal(rec, CANCELLED)
                if self._metrics is not None:
                    self._metrics["aborts"].inc()
                self._set_waiting_gauge()
                self._event(events, rec,
                            {"type": "cancelled", "rid": rid,
                             "tokens": list(rec.tokens)})
        self._pending_abort.clear()

    def _expire_waiting(self, events):
        """Shed waiting requests whose queue-time budget or deadline
        has already passed — they can only waste pages."""
        now = self._clock()
        for rec in self._heap:
            if rec.state != WAITING:
                continue
            reason = None
            if rec.max_queue_time is not None and \
                    now - rec.submit_t > rec.max_queue_time:
                reason = "queue_timeout"
            elif rec.deadline is not None and now > rec.deadline:
                reason = "deadline"
                rec.deadline_missed = True
                if self._metrics is not None:
                    self._metrics["deadline_miss"].inc()
            if reason is None:
                continue
            rec.state = SHED
            rec.shed_reason = reason
            rec.finish_t = now
            self._n_waiting -= 1
            if reason == "deadline":
                # waiting requests were never admitted, so this is
                # usually a no-op — it fires for requests admitted
                # then re-queued (preemptees) whose deadline lapsed
                self._capsule_persist(rec, "deadline_miss")
            self._trace_terminal(rec, SHED, reason=reason)
            self._shed_inc(reason)
            self._event(events, rec, {"type": "shed", "rid": rec.rid,
                                      "reason": reason})
        self._set_waiting_gauge()

    def _need(self, rec) -> int:
        P = self.engine.cache.page_size
        return -(-(len(rec.prompt) + rec.max_new) // P)

    def _admit(self, events, out):
        """Admit from the priority queue while the engine has a free
        slot and the paged cache holds the head request's FULL page
        budget (the ``capacity()`` snapshot — one atomic read per
        decision, see its invariant).  Head-of-line order is
        (priority, FIFO); a blocked head may trigger PREEMPTION of a
        strictly-lower-priority active request, and the opt-in
        packing mode may admit smaller waiters around it (bounded by
        the aging rule) — both documented in the module docstring.
        Suspended requests re-admit through this same path: their
        heap position is their original (priority, seq), so a
        preempted request resumes ahead of later arrivals of its own
        class."""
        eng = self.engine
        while self._heap:
            rec = self._heap[0]
            if rec.state not in (WAITING, SUSPENDED):
                heapq.heappop(self._heap)    # cancelled/shed/packed
                rec.in_heap = False
                continue
            slots, pages = eng.capacity()
            if slots < 1 or pages < self._need(rec):
                if self.preemption and self._try_preempt(rec, events):
                    continue                 # capacity freed: re-check
                if self.packing:
                    self._admit_packed(events, out)
                break
            heapq.heappop(self._heap)
            rec.in_heap = False
            self._admit_one(rec, events, out)
        self._set_waiting_gauge()

    def _admit_one(self, rec, events, out):
        """Move one WAITING or SUSPENDED record into the engine (the
        caller has verified capacity and owns the heap entry)."""
        eng = self.engine
        now = self._clock()
        if rec.state == SUSPENDED:
            self._end_span(rec, "suspend")
            with _tracing.span("sched.resume", ctx=rec.trace_ctx) as sp:
                path = eng.resume(rec.rid)
                sp.set_attr("rid", str(rec.rid))
                sp.set_attr("sched", self.sched_id)
                sp.set_attr("path", path)
            rec.timeline.append((f"resumed:{path}", now))
            rec.state = ACTIVE
            self._n_suspended -= 1
            if self._metrics is not None and rec.preempt_t is not None:
                self._metrics["time_preempted"].observe(
                    now - rec.preempt_t)
            rec.preempt_t = None
            return
        self._end_span(rec, "queue")
        # the admit span is ACTIVATED: the engine's prefill spans
        # (whole-prompt + per-chunk) nest under it, landing the whole
        # admission inside the request's trace
        with _tracing.span("sched.admit", ctx=rec.trace_ctx) as sp:
            if self.chunked_prefill:
                eng.begin_request(rec.rid, rec.prompt,
                                  max_new_tokens=rec.max_new,
                                  eos_token_id=rec.eos)
            else:
                eng.add_request(rec.rid, rec.prompt,
                                max_new_tokens=rec.max_new,
                                eos_token_id=rec.eos)
            sp.set_attr("rid", str(rec.rid))
            sp.set_attr("sched", self.sched_id)
            sp.set_attr("prompt_tokens", len(rec.prompt))
        rec.state = ACTIVE
        rec.admit_t = now
        rec.timeline.append(("admitted", now))
        self._n_waiting -= 1
        if self._metrics is not None:
            self._metrics["queue_wait"].observe(now - rec.submit_t)
            self._metrics["admitted"].inc()
        if self.chunked_prefill:
            # prefill rides subsequent mixed steps — no token exists
            # yet; step()'s merge loop stamps first_token on delivery
            return
        rec.first_token_t = self._clock()   # admission's prefill token
        rec.timeline.append(("first_token", rec.first_token_t))
        self._capsule_first_token(rec)
        first = list(eng.requests[rec.rid].out)
        rec.tokens.extend(first)
        out.setdefault(rec.rid, []).extend(first)
        self._event(events, rec, {"type": "tokens", "rid": rec.rid,
                                  "tokens": first})

    def _try_preempt(self, head, events) -> bool:
        """Evict ONE active request so ``head`` can admit: the victim
        is the lowest-priority active request STRICTLY below the
        head's priority (youngest within that class — it has computed
        the least), provided it has not already been preempted
        ``max_preemptions_per_request`` times (the livelock bound: a
        request past the bound keeps its slot to completion).
        Returns True when a victim was suspended — the caller
        re-checks capacity and may preempt again if one eviction was
        not enough."""
        cands = [r for r in self._reqs.values()
                 if r.state == ACTIVE and r.priority > head.priority
                 and r.preempts < self.max_preemptions_per_request]
        if not cands:
            return False
        victim = max(cands, key=lambda r: (r.priority, r.seq))
        with _tracing.span("sched.preempt", ctx=victim.trace_ctx) as sp:
            self.engine.suspend(victim.rid)
            sp.set_attr("rid", str(victim.rid))
            sp.set_attr("sched", self.sched_id)
        victim.state = SUSPENDED
        victim.preempts += 1
        victim.preempt_t = self._clock()
        victim.timeline.append(("preempted", victim.preempt_t))
        tr = _tracing.get_tracer()
        if tr is not None and tr.enabled:
            victim.spans["suspend"] = tr.start_span(
                "sched.suspended", ctx=victim.trace_ctx, activate=False,
                attrs={"rid": str(victim.rid), "sched": self.sched_id})
        self._n_suspended += 1
        if not victim.in_heap:
            heapq.heappush(self._heap, victim)
            victim.in_heap = True
        if self._metrics is not None:
            self._metrics["preempted"].inc()
        self._event(events, victim,
                    {"type": "preempted", "rid": victim.rid,
                     "n_tokens": len(victim.tokens)})
        return True

    def _admit_packed(self, events, out):
        """Bin-packing admission around a blocked head: walk the rest
        of the queue in (priority, FIFO) order and admit requests
        whose full page budget fits.  Aging-based starvation bound:
        each packed admission charges the head one overtake; at
        ``packing_max_overtakes`` the head stops being overtaken and
        strict order resumes until it admits."""
        head = self._heap[0]
        for rec in sorted(self._heap)[1:]:
            if head.overtaken >= self.packing_max_overtakes:
                break
            if rec.state not in (WAITING, SUSPENDED):
                continue
            slots, pages = self.engine.capacity()
            if slots < 1:
                break
            if pages < self._need(rec):
                continue
            # the heap entry stays (state != WAITING/SUSPENDED pops it
            # lazily at the head later)
            self._admit_one(rec, events, out)
            head.overtaken += 1
            if self._metrics is not None:
                self._metrics["packed"].inc()

    def _retire_done(self, events):
        for rid, ereq in list(self.engine.requests.items()):
            if not ereq.done:
                continue
            rec = self._reqs.get(rid)
            if rec is None or rec.state != ACTIVE:
                continue
            rec.tokens = self.engine.pop_result(rid)
            rec.state = FINISHED
            rec.finish_t = self._clock()
            self._trace_terminal(rec, FINISHED)
            if rec.deadline is not None and rec.finish_t > rec.deadline:
                rec.deadline_missed = True
                if self._metrics is not None:
                    self._metrics["deadline_miss"].inc()
                self._capsule_persist(rec, "deadline_miss")
            # retirement closes the capsule: final timeline + trace
            # cross-link, marked COMPLETE (audit-eligible)
            cs = _capsule.get_capsule_store()
            if cs.enabled:
                cs.annotate(rid, timeline=list(rec.timeline),
                            trace_id=(rec.trace_ctx or {}).get(
                                "trace_id"), complete=True)
            if self._metrics is not None:
                self._metrics["completed"].inc()
            _health.get_health().event("error_rate", bad=False)
            self._event(events, rec,
                        {"type": "finished", "rid": rid,
                         "tokens": list(rec.tokens),
                         "deadline_missed": rec.deadline_missed})
