"""Structured fault injection for the serving tier (counterpart of
``paddle_tpu/serving/faults.py``).

Chaos testing needs faults that are *scheduled*, not sprinkled: "the
2nd submit to replica 0 times out, the 5th poll drops the connection,
the backend crashes at its 3rd step" — then assert the system-level
invariant (every submitted rid terminates in exactly one of
completed / cancelled / timeout / shed).  This module is that
schedule:

* ``Fault`` — one rule: which operation (``submit``/``poll``/
  ``cancel``/``health``/``result``/``migrate`` or ``"*"``), at which
  per-op call index (``nth``, 1-based), for how many calls
  (``times``), does what (``kind``):

  - ``refuse``     — connection refused BEFORE the server sees the
    call (raises ``FaultInjected``, a ``ConnectionError``);
  - ``timeout``    — the call times out client-side (raises
    ``InjectedTimeout``, a ``TimeoutError`` — the server never sees
    it either);
  - ``slow``       — delivery is delayed by ``delay`` seconds, then
    proceeds (distinguishes slow-but-alive from dead for the prober);
  - ``disconnect`` — the connection drops AFTER the server processed
    the call but before the client read the reply (raises
    ``InjectedDisconnect``) — the case idempotent resubmission
    exists for: the work happened, the ack was lost;
  - ``crash``      — invoke ``on_crash`` (e.g. kill the backend
    process/frontend), then refuse.  ``crash`` + ``op="poll"`` +
    ``nth=N`` is crash-on-Nth-step.

* ``FaultPlan`` — an ordered set of rules sharing per-op call
  counters.  The remote transport consults ``plan.before(op)`` /
  ``plan.after(op)`` around every HTTP call (``RemoteReplica
  .set_fault_plan``); ``plan.router_hook()`` adapts the same schedule
  to ``ReplicaRouter.set_fault`` for in-process replicas — one fault
  vocabulary for both seams.

The plan is thread-safe (handler/prober/router threads all hit the
seam) and deterministic: counters only ever advance, so a given
schedule injects the same faults at the same calls every run.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..common.errors import enforce

__all__ = ["Fault", "FaultPlan", "FaultInjected", "InjectedTimeout",
           "InjectedDisconnect"]

_KINDS = ("refuse", "timeout", "slow", "disconnect", "crash")
_OPS = ("submit", "poll", "cancel", "health", "result", "migrate", "*")


class FaultInjected(ConnectionError):
    """Injected connection-refused (the transport treats it like any
    refused TCP connect: retry/backoff, then the replica looks dead)."""


class InjectedTimeout(TimeoutError):
    """Injected client-side timeout (the transport treats it like a
    socket timeout: the call MAY have reached the server)."""


class InjectedDisconnect(ConnectionError):
    """Injected mid-stream disconnect AFTER the server processed the
    call — the reply is lost, the work is not."""


class Fault:
    """One injection rule — see the module docstring for the kinds.
    ``nth`` is the 1-based per-op call index the rule starts firing
    at; ``times`` how many consecutive calls it affects (``None`` =
    every call from ``nth`` on)."""

    def __init__(self, op: str = "*", kind: str = "refuse",
                 nth: int = 1, times: Optional[int] = 1,
                 delay: float = 0.0,
                 on_crash: Optional[Callable[[], None]] = None):
        enforce(op in _OPS, f"unknown fault op {op!r} (one of {_OPS})")
        enforce(kind in _KINDS,
                f"unknown fault kind {kind!r} (one of {_KINDS})")
        enforce(nth >= 1, "nth is 1-based")
        enforce(times is None or times >= 1,
                "times must be >= 1 (or None for unbounded)")
        enforce(kind != "crash" or on_crash is not None,
                "crash faults need an on_crash hook")
        self.op = op
        self.kind = kind
        self.nth = nth
        self.times = times
        self.delay = float(delay)
        self.on_crash = on_crash
        self.fired = 0                     # calls this rule affected

    def _matches(self, op: str, call_index: int) -> bool:
        if self.op != "*" and self.op != op:
            return False
        if call_index < self.nth:
            return False
        return self.times is None or \
            call_index < self.nth + self.times


class FaultPlan:
    """An injection schedule over the transport seam (module
    docstring).  ``sleep`` is injectable so ``slow`` faults cost no
    real wall time in tests."""

    def __init__(self, faults: List[Fault],
                 sleep: Optional[Callable[[float], None]] = None):
        import time
        self.faults = list(faults)
        self._sleep = sleep or time.sleep
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}   # per-op call counters
        self.injected: Dict[str, int] = {}  # kind -> times fired

    def _record(self, fault: Fault):
        fault.fired += 1
        self.injected[fault.kind] = self.injected.get(fault.kind, 0) + 1

    def _pick(self, op: str, idx: int, kinds) -> Optional[Fault]:
        for f in self.faults:
            if f.kind in kinds and f._matches(op, idx):
                return f
        return None

    def before(self, op: str) -> None:
        """Consult the plan before op's HTTP call goes out.  Advances
        op's call counter; raises / delays per the first matching
        pre-delivery rule (refuse, timeout, slow, crash)."""
        with self._lock:
            idx = self._calls.get(op, 0) + 1
            self._calls[op] = idx
            fault = self._pick(op, idx, ("refuse", "timeout", "slow",
                                         "crash"))
            if fault is not None:
                self._record(fault)
        if fault is None:
            return
        if fault.kind == "slow":
            self._sleep(fault.delay)
        elif fault.kind == "timeout":
            raise InjectedTimeout(f"injected timeout on {op!r}")
        elif fault.kind == "crash":
            fault.on_crash()
            raise FaultInjected(f"injected crash during {op!r}")
        else:
            raise FaultInjected(f"injected connection refused on "
                                f"{op!r}")

    def after(self, op: str) -> None:
        """Consult the plan after the server processed op but before
        the client reads the reply — only ``disconnect`` rules fire
        here (the lost-ack case).  Uses the call index ``before``
        already assigned to this call."""
        with self._lock:
            idx = self._calls.get(op, 0)
            fault = self._pick(op, idx, ("disconnect",))
            if fault is not None:
                self._record(fault)
        if fault is not None:
            raise InjectedDisconnect(
                f"injected disconnect after {op!r}")

    def router_hook(self) -> Callable:
        """Adapt this plan to ``ReplicaRouter.set_fault`` (the
        in-process seam): the returned ``fn(rid)`` runs the plan's
        ``before``/``after`` for a ``submit`` — same schedule
        vocabulary, no HTTP."""
        def fn(rid):
            self.before("submit")
            self.after("submit")
        return fn
