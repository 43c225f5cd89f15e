"""FleetWatcher — the policy loop that closes the rebalancing gap
(counterpart of ``paddle_tpu/serving/autopilot.py``).

The router ships the MECHANISMS (``mark_slow`` opens a circuit,
``drain_replica`` KV-migrates a replica empty, ``reinstate`` brings
one back); the health plane ships the SIGNALS (burn rates, per-replica
load, staleness).  This module is the missing half: a deliberately
small policy loop that reads ``ReplicaRouter.fleet_snapshot()`` and
acts through those existing mechanisms ONLY — it never touches engine
or scheduler internals, so everything it does is something an operator
could have typed.

Design rules, each load-bearing:

* **Hysteresis everywhere.**  A condition must hold for
  ``*_trip_ticks`` consecutive ticks before the watcher acts, and a
  recovered replica must look healthy for ``clear_ticks`` consecutive
  ticks before it is reinstated — one noisy scrape moves nothing.
* **Bounded action rate.**  A global token bucket
  (``max_actions_per_min``) plus a per-replica ``replica_cooldown``
  cap how fast the watcher can churn the fleet; a broken policy
  degrades into a slow one, never a flapping one.
* **Deterministic core.**  ``tick()`` is one synchronous pass with an
  injectable clock — chaos tests drive it directly from the stepping
  thread (``drain_replica`` moves engine state and MUST run there).
  The optional ``start()`` thread is a convenience wrapper that calls
  ``tick()`` on an interval; when the serving tier steps on its own
  loop thread, pass ``act_via`` (e.g. the frontend's ``_on_loop``) so
  actions marshal to it.
* **Every action is explained.**  Trips land in the flight recorder
  as ``record_event("autopilot", ...)`` and in the
  ``serving_autopilot_actions_total{action}`` counter, so a
  post-mortem dump says WHY a replica was drained.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..common.errors import enforce
from ..observability import get_registry
from ..observability.tracing import record_event

__all__ = ["FleetWatcher"]


class _ReplicaPolicy:
    """Per-replica hysteresis state (watcher-private)."""

    __slots__ = ("burn_streak", "skew_streak", "clear_streak",
                 "slowed", "drained", "cooldown_until")

    def __init__(self):
        self.burn_streak = 0
        self.skew_streak = 0
        self.clear_streak = 0
        self.slowed = False       # we opened its circuit (mark_slow)
        self.drained = False      # we drained it (admission stopped)
        self.cooldown_until = 0.0


class FleetWatcher:
    """Watch ``router.fleet_snapshot()``; rebalance through the
    router's own actuators.

    Policy (evaluated per replica, per tick):

    * sustained SLO burn (any SLO ``burning`` in the replica's scraped
      health view for ``burn_trip_ticks`` ticks) → ``mark_slow`` —
      traffic shifts away for the router cooldown, the circuit's
      half-open probe decides recovery;
    * sustained load skew (load ≥ ``skew_min_load`` AND >
      ``skew_ratio`` × the mean load of the other live replicas, for
      ``skew_trip_ticks`` ticks) → ``drain_replica`` — its requests
      KV-migrate to the survivors, none lost;
    * recovery (``clear_ticks`` consecutive healthy, non-burning,
      non-stale ticks after a watcher action) → ``resume_admission``
      + ``reinstate``.

    Ejected replicas are the HealthProber's jurisdiction — the watcher
    never reinstates a replica it didn't act on."""

    def __init__(self, router, interval: float = 1.0,
                 clock: Optional[Callable[[], float]] = None,
                 burn_trip_ticks: int = 3,
                 skew_ratio: float = 3.0, skew_min_load: int = 8,
                 skew_trip_ticks: int = 3, clear_ticks: int = 5,
                 max_actions_per_min: int = 4,
                 replica_cooldown: float = 10.0,
                 act_via: Optional[Callable] = None,
                 enable_metrics: bool = True):
        enforce(interval > 0, "watcher interval must be > 0")
        enforce(burn_trip_ticks >= 1 and skew_trip_ticks >= 1 and
                clear_ticks >= 1, "trip/clear tick counts must be >= 1")
        enforce(max_actions_per_min >= 1,
                "max_actions_per_min must be >= 1")
        self.router = router
        self.interval = float(interval)
        self._clock = clock or time.monotonic
        self.burn_trip_ticks = int(burn_trip_ticks)
        self.skew_ratio = float(skew_ratio)
        self.skew_min_load = int(skew_min_load)
        self.skew_trip_ticks = int(skew_trip_ticks)
        self.clear_ticks = int(clear_ticks)
        self.max_actions_per_min = int(max_actions_per_min)
        self.replica_cooldown = float(replica_cooldown)
        self._act_via = act_via
        self._policy: Dict[int, _ReplicaPolicy] = {}
        self._action_times: deque = deque()
        self.actions: List[dict] = []
        self.ticks = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._metrics = None
        if enable_metrics:
            self._metrics = get_registry().counter(
                "serving_autopilot_actions_total",
                "Rebalancing actions the FleetWatcher took, by kind "
                "(mark_slow / drain / reinstate).", ("action",))

    # -- action plumbing -------------------------------------------------------
    def _budget_ok(self, now: float, pol: _ReplicaPolicy) -> bool:
        """Global token bucket AND per-replica cooldown — checked
        BEFORE acting, charged only when an action fires."""
        while self._action_times and \
                now - self._action_times[0] > 60.0:
            self._action_times.popleft()
        return (len(self._action_times) < self.max_actions_per_min
                and now >= pol.cooldown_until)

    def _act(self, now: float, pol: _ReplicaPolicy, action: str,
             replica: int, reason: str, fn: Callable) -> bool:
        """Run one actuator (optionally marshaled via ``act_via``),
        charge the budget, record the WHY."""
        try:
            if self._act_via is not None:
                self._act_via(fn)
            else:
                fn()
        except Exception as e:
            record_event("autopilot", action=action, replica=replica,
                         reason=reason, error=f"{type(e).__name__}: {e}")
            return False
        self._action_times.append(now)
        pol.cooldown_until = now + self.replica_cooldown
        rec = {"t": now, "action": action, "replica": replica,
               "reason": reason}
        self.actions.append(rec)
        record_event("autopilot", action=action, replica=replica,
                     reason=reason)
        if self._metrics is not None:
            self._metrics.labels(action).inc()
        return True

    # -- the policy pass -------------------------------------------------------
    @staticmethod
    def _burning(row: dict) -> Optional[str]:
        """Name of a burning SLO in the replica's scraped health view,
        or None."""
        slo = row.get("slo") or {}
        for name, st in slo.items():
            if isinstance(st, dict) and st.get("burning"):
                return name
        return None

    def tick(self) -> List[dict]:
        """One deterministic policy pass; returns the actions taken
        this tick.  Call from the stepping thread (or pass ``act_via``
        at construction) — ``drain_replica`` moves engine state."""
        now = self._clock()
        self.ticks += 1
        # with ``act_via`` the scrape marshals too: it reads the
        # in-process replicas' engines, which only the loop thread may
        snap = self._act_via(self.router.fleet_snapshot) \
            if self._act_via is not None else self.router.fleet_snapshot()
        rows = snap.get("replicas", [])
        live = [r for r in rows
                if not r["ejected"] and not r["stale"]
                and isinstance(r.get("load"), (int, float))
                and r["load"] < (1 << 29)]   # sentinel loads aren't data
        taken: List[dict] = []
        for row in rows:
            idx = row["replica"]
            pol = self._policy.setdefault(idx, _ReplicaPolicy())
            if row["ejected"]:
                # the prober's case, not ours — but our streaks must
                # not survive into its reinstate
                pol.burn_streak = pol.skew_streak = 0
                pol.clear_streak = 0
                continue
            burn = self._burning(row) if not row["stale"] else None
            skewed = False
            if not row["stale"] and \
                    isinstance(row.get("load"), (int, float)) and \
                    row["load"] >= self.skew_min_load:
                others = [r["load"] for r in live
                          if r["replica"] != idx]
                if others:
                    mean = sum(others) / len(others)
                    skewed = row["load"] > self.skew_ratio * \
                        max(mean, 1e-9)
            pol.burn_streak = pol.burn_streak + 1 if burn else 0
            pol.skew_streak = pol.skew_streak + 1 if skewed else 0

            acted_on = pol.slowed or pol.drained
            if skewed and pol.skew_streak >= self.skew_trip_ticks \
                    and not pol.drained and self._budget_ok(now, pol):
                if self._act(now, pol, "drain", idx,
                             f"load_skew(load={row['load']})",
                             lambda i=idx:
                             self.router.drain_replica(i)):
                    pol.drained = True
                    pol.clear_streak = 0
                    taken.append(self.actions[-1])
                continue
            if burn and pol.burn_streak >= self.burn_trip_ticks \
                    and not acted_on and self._budget_ok(now, pol):
                if self._act(now, pol, "mark_slow", idx,
                             f"slo_burning({burn})",
                             lambda i=idx: self.router.mark_slow(i)):
                    pol.slowed = True
                    pol.clear_streak = 0
                    taken.append(self.actions[-1])
                continue
            if acted_on:
                # recovery watch: healthy scrape, nothing burning, and
                # (for a drain) the load actually gone
                calm = (not row["stale"] and burn is None and
                        (not pol.drained or
                         (isinstance(row.get("load"), (int, float))
                          and row["load"] < self.skew_min_load)))
                pol.clear_streak = pol.clear_streak + 1 if calm else 0
                if pol.clear_streak >= self.clear_ticks and \
                        self._budget_ok(now, pol):
                    def _reinstate(i=idx, drained=pol.drained):
                        if drained:
                            self.router.replicas[i].resume_admission()
                        self.router.reinstate(i)
                    if self._act(now, pol, "reinstate", idx,
                                 f"recovered({pol.clear_streak} ticks)",
                                 _reinstate):
                        pol.slowed = pol.drained = False
                        pol.clear_streak = 0
                        taken.append(self.actions[-1])
        return taken

    # -- optional background loop ----------------------------------------------
    def start(self) -> "FleetWatcher":
        """Run ``tick()`` every ``interval`` seconds on a daemon
        thread named ``paddle-tpu-watcher`` (the conftest leak guard
        knows the name).  Pass ``act_via`` at construction when the
        engines step on another thread."""
        enforce(self._thread is None, "watcher already started")
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval):
                try:
                    self.tick()
                except Exception as e:
                    record_event("autopilot", action="tick_error",
                                 error=f"{type(e).__name__}: {e}")

        self._thread = threading.Thread(
            target=_loop, name="paddle-tpu-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=10.0)
        self._thread = None

    def snapshot(self) -> dict:
        return {"ticks": self.ticks,
                "actions": list(self.actions),
                "policy": {i: {"burn_streak": p.burn_streak,
                               "skew_streak": p.skew_streak,
                               "clear_streak": p.clear_streak,
                               "slowed": p.slowed,
                               "drained": p.drained}
                           for i, p in self._policy.items()}}
