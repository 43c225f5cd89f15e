"""The port's fault plans, fleet federation and ``FleetWatcher`` against
the reference's, on the CPU (the ``FaultPlan``, federation and
``FleetWatcher`` cases of ``tests/test_fleet_health.py``).

Each script runs on the reference's ``paddle_tpu.serving`` and on the
port's under a ``FakeClock`` (``torch_serving_parity.both``):

* a ``FaultPlan`` fed the same calls raises the same faults at the same
  call indices and counts them alike, at the transport seam and through
  ``router_hook`` at the router's;
* ``fleet_snapshot`` sums counters and merges the queue-wait histogram
  across in-process replicas, marks an ejected replica stale without
  scraping it, and marks a remote replica whose scrape times out stale
  instead of raising; ``/fleetz`` serves it;
* the watcher's policy over a canned fleet (burn → ``mark_slow`` after
  its hysteresis, skew → drain, recovery → reinstate, a bounded action
  rate and a per-replica cooldown, stale and ejected rows never trip)
  makes the same calls in the same order, and over real replicas drains
  a skewed one with every request finished on equal tokens.

The health plane's windows are fed by the engines' own host clocks, so
of them only event counts are compared.
"""
import http.client
import json
import time

import pytest

from torch_serving_parity import (NOSLEEP, PORT, Tracker, both, models,
                                  reset_planes, series)


@pytest.fixture(scope="module", autouse=True)
def _models():
    models()


@pytest.fixture(autouse=True)
def _planes():
    yield
    reset_planes()


def _replica(X, clock, max_queue=4):
    return X.S.Scheduler(X.engine(max_seqs=2), max_queue=max_queue,
                         clock=clock)


# -- fault plans ---------------------------------------------------------------
def test_fault_plan_schedule_and_router_hook():
    def script(X, clock):
        S = X.S
        crashed = []
        plan = S.FaultPlan([
            S.Fault(op="submit", kind="refuse", nth=2, times=2),
            S.Fault(op="poll", kind="timeout", nth=1, times=1),
            S.Fault(op="poll", kind="disconnect", nth=3, times=1),
            S.Fault(op="*", kind="slow", nth=4, times=None, delay=0.5),
            S.Fault(op="health", kind="crash", nth=2, times=1,
                    on_crash=lambda: crashed.append(1)),
        ], sleep=lambda s: crashed.append(s))
        log = []
        for op in ["submit"] * 5 + ["poll"] * 5 + ["health"] * 3:
            try:
                plan.before(op)
                plan.after(op)
                log.append((op, "ok"))
            except Exception as e:
                log.append((op, type(e).__name__, str(e)))
        with pytest.raises(X.errors.EnforceError):
            S.Fault(op="nope")
        with pytest.raises(X.errors.EnforceError):
            S.Fault(kind="crash")
        # the same vocabulary at the router seam
        reps = [_replica(X, clock) for _ in range(2)]
        router = S.ReplicaRouter(reps, failure_threshold=1,
                                 sleep=NOSLEEP, clock=clock)
        hook_plan = S.FaultPlan([S.Fault(op="submit", kind="refuse",
                                         nth=1, times=1)])
        router.set_fault(0, hook_plan.router_hook())
        picks = [router.submit(f"h{i}", [5, 9, 2], max_new_tokens=2)
                 for i in range(2)]
        router.run_until_idle()
        return {"log": log, "injected": plan.injected, "crashed": crashed,
                "fired": [f.fired for f in plan.faults],
                "picks": picks, "hook": hook_plan.injected,
                "healthy": router.healthy_replicas(),
                "series": series(X, reps, [router])}

    out = both(script)
    assert out["injected"]["refuse"] == 2 and 1 in out["crashed"]
    assert out["picks"] == [1, 1] and out["hook"] == {"refuse": 1}


# -- fleet federation ----------------------------------------------------------
def test_in_process_fleet_snapshot_merges():
    def script(X, clock):
        reps = [_replica(X, clock) for _ in range(2)]
        router = X.S.ReplicaRouter(reps, sleep=NOSLEEP, clock=clock)
        for i in range(3):
            router.submit(f"f{i}", [5, 9, 2 + i], max_new_tokens=4)
            clock.advance(0.01)
        while router.busy():
            clock.advance(0.1)
            router.step()
        snap = router.fleet_snapshot()
        per = sum(r["metrics"]["engine"]["ttft_seconds"]["count"]
                  for r in snap["replicas"])
        assert snap["fleet"]["ttft_seconds"]["count"] == per == 3
        with router._lock:
            router._ejected.add(1)
        stale = router.fleet_snapshot()
        return {"snap": snap, "stale": stale}

    out = both(script)
    fleet = out["snap"]["fleet"]
    assert fleet["replicas"] == 2 and fleet["scraped"] == 2
    assert fleet["admitted"] == 3 and fleet["generated_tokens"] == 12
    assert fleet["queue_wait_seconds"]["count"] == 3
    rows = out["stale"]["replicas"]
    assert rows[1]["ejected"] and rows[1]["stale"]
    assert rows[1]["metrics"] is None
    assert out["stale"]["fleet"]["stale"] == 1


def test_remote_scrape_fleetz_and_stale_on_timeout():
    def script(X, clock):
        fes = []
        try:
            scheds = [X.S.Scheduler(X.engine(), max_queue=8)
                      for _ in range(2)]
            fes = [X.S.start_http_frontend(s) for s in scheds]
            reps = [X.S.RemoteReplica(fe.url, timeout=30, sleep=NOSLEEP)
                    for fe in fes]
            router = X.S.ReplicaRouter(reps, sleep=NOSLEEP)
            router.submit("r1", [5, 9, 2], max_new_tokens=4)
            router.run_until_idle(max_steps=5000)
            fresh = router.fleet_snapshot()["fleet"]
            fr = X.S.start_http_frontend(router)
            fes.append(fr)
            conn = http.client.HTTPConnection("127.0.0.1", fr.port,
                                              timeout=120)
            conn.request("GET", "/fleetz")
            fz = json.loads(conn.getresponse().read())
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", fes[0].port,
                                              timeout=120)
            conn.request("GET", "/fleetz")
            one = json.loads(conn.getresponse().read())
            conn.close()
            reps[1].set_fault_plan(X.S.FaultPlan(
                [X.S.Fault(op="poll", kind="timeout", nth=1,
                           times=None)], sleep=NOSLEEP))
            partial = router.fleet_snapshot()
            reps[1].set_fault_plan(None)
            healed = router.fleet_snapshot()["fleet"]
        finally:
            for fe in fes:
                fe.shutdown(drain=False)
        return {
            "fresh": {k: fresh[k] for k in ("admitted", "completed",
                                            "stale", "scraped")},
            "fleetz": {k: fz["fleet"][k] for k in ("replicas",
                                                   "admitted")},
            "one": (one["router"], one["fleet"]["replicas"],
                    one["replicas"][0]["metrics"]["admitted"]),
            "partial": ([r["stale"] for r in partial["replicas"]],
                        "error" in partial["replicas"][1],
                        partial["fleet"]["scraped"],
                        partial["fleet"]["admitted"]),
            "healed": (healed["stale"], healed["scraped"])}

    out = both(script)
    assert out["fleetz"] == {"replicas": 2, "admitted": 1}
    assert out["partial"] == [[False, True], True, 1, 1]
    assert out["healed"] == [0, 2]


# -- the autopilot -------------------------------------------------------------
class StubRouter:
    """Canned fleet_snapshot + recorded actuator calls."""

    class _Rep:
        def __init__(self, log, idx):
            self.log, self.idx = log, idx

        def resume_admission(self):
            self.log.append(("resume_admission", self.idx))

    def __init__(self, rows):
        self.rows = rows
        self.calls = []
        self.replicas = [self._Rep(self.calls, i) for i in range(len(rows))]

    def fleet_snapshot(self):
        return {"replicas": [dict(r) for r in self.rows]}

    def mark_slow(self, i):
        self.calls.append(("mark_slow", i))

    def drain_replica(self, i):
        self.calls.append(("drain", i))

    def reinstate(self, i):
        self.calls.append(("reinstate", i))


def _row(i, load=0, burning=False, stale=False, ejected=False):
    return {"replica": i, "ejected": ejected, "stale": stale,
            "load": load,
            "slo": {"ttft": {"burning": burning}} if burning else {}}


def _drive_watcher(X, clock, rows, plan, **kw):
    """Tick a watcher over canned rows; ``plan`` is a list of (rows
    update or None, ticks, advance per tick)."""
    router = StubRouter(rows)
    w = X.S.FleetWatcher(router, clock=clock, **kw)
    trace = []
    for update, ticks, dt in plan:
        if update is not None:
            update(rows)
        for _ in range(ticks):
            clock.advance(dt)
            w.tick()
            trace.append(list(router.calls))
    return {"trace": trace, "snap": w.snapshot()}


def test_burn_trip_marks_slow_once_then_reinstates(tmp_path):
    def script(X, clock):
        clock.advance(100.0)
        rec = X.tracing.enable_flight_recorder(
            path=str(tmp_path / f"fr_{X.name}.jsonl"))
        rows = [_row(0, load=1, burning=True), _row(1, load=1)]
        out = _drive_watcher(
            X, clock, rows,
            [(None, 4, 1.0),
             (lambda r: r.__setitem__(0, _row(0, load=1)), 2, 1.0)],
            burn_trip_ticks=3, clear_ticks=2, replica_cooldown=0.0,
            max_actions_per_min=10)
        out["explained"] = [e["action"] for e in
                            rec.recent(kind="autopilot")]
        return out

    out = both(script)
    assert out["trace"][-1] == [["mark_slow", 0], ["reinstate", 0]]
    assert out["explained"] == ["mark_slow", "reinstate"]


def test_skew_trip_drains_then_resumes_admission():
    def script(X, clock):
        clock.advance(100.0)
        rows = [_row(0, load=20), _row(1, load=2)]
        return _drive_watcher(
            X, clock, rows,
            [(None, 2, 1.0),
             (lambda r: r.__setitem__(0, _row(0, load=0)), 2, 1.0)],
            skew_ratio=3.0, skew_min_load=8, skew_trip_ticks=2,
            clear_ticks=2, replica_cooldown=0.0, max_actions_per_min=10)

    out = both(script)
    assert out["trace"][-1] == [["drain", 0], ["resume_admission", 0],
                                ["reinstate", 0]]


def test_action_rate_bounded_and_cooldown():
    def script(X, clock):
        clock.advance(100.0)
        rows = [_row(0, load=1, burning=True),
                _row(1, load=1, burning=True)]

        def calm(r):
            r[0] = _row(0, load=1)
            r[1] = _row(1, load=1)

        return _drive_watcher(
            X, clock, rows,
            [(None, 11, 1.0), (None, 1, 61.0), (calm, 1, 61.0),
             (None, 1, 200.0)],
            burn_trip_ticks=1, clear_ticks=1, replica_cooldown=200.0,
            max_actions_per_min=1)

    out = both(script)
    assert len(out["trace"][10]) == 1
    assert ["reinstate", 0] in out["trace"][-1]


def test_stale_and_ejected_rows_never_trip():
    def script(X, clock):
        clock.advance(100.0)
        rows = [_row(0, load=50, burning=True, stale=True),
                _row(1, load=1, burning=True, ejected=True)]
        return _drive_watcher(X, clock, rows, [(None, 5, 1.0)],
                              burn_trip_ticks=1, skew_trip_ticks=1,
                              replica_cooldown=0.0)

    out = both(script)
    assert out["trace"][-1] == []


def test_watcher_thread_start_stop():
    router = StubRouter([_row(0, load=1)])
    w = PORT.S.FleetWatcher(router, interval=0.02, replica_cooldown=0.0)
    w.start()
    with pytest.raises(PORT.errors.EnforceError):
        w.start()
    deadline = time.monotonic() + 5.0
    while w.ticks < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    w.stop()
    assert w.ticks >= 2 and w._thread is None
    w.stop()


def test_watcher_drains_skewed_replica_no_lost_requests():
    def script(X, clock):
        clock.advance(100.0)
        scheds = [_replica(X, clock), _replica(X, clock)]
        router = X.S.ReplicaRouter(scheds, sleep=NOSLEEP, clock=clock)
        w = X.S.FleetWatcher(router, clock=clock, skew_ratio=2.0,
                             skew_min_load=3, skew_trip_ticks=2,
                             clear_ticks=2, burn_trip_ticks=2,
                             replica_cooldown=0.0, max_actions_per_min=10)
        router.mark_slow(1)
        tr = Tracker()
        rids = [f"c{i}" for i in range(4)]
        picks = [router.submit(r, [5, 9, 2], max_new_tokens=6,
                               on_event=tr.cb(r)) for r in rids]
        router.reinstate(1)
        for _ in range(2):
            w.tick()
            clock.advance(1.0)
        with pytest.raises(X.S.RejectedError):
            scheds[0].submit("refused", [5], max_new_tokens=1)
        router.run_until_idle(max_steps=8000)
        for r in rids:
            assert [e["type"] for e in tr.terminals[r]] == ["finished"]
            assert router.pop_result(r) == X.direct([5, 9, 2], 6)
        for _ in range(2):
            w.tick()
            clock.advance(1.0)
        after = router.submit("after", [5, 9, 2], max_new_tokens=2)
        router.run_until_idle(max_steps=8000)
        for _ in range(4):
            w.tick()
            clock.advance(1.0)
        assert "serving_autopilot_actions_total" in \
            X.registry.expose_text()
        return {"picks": picks, "after": after, "order": tr.order,
                "actions": [(a["action"], a["replica"], a["reason"])
                            for a in w.actions],
                "healthy": router.healthy_replicas(),
                "series": series(X, scheds, [router])}

    out = both(script)
    assert out["picks"] == [0, 0, 0, 0]
    assert [a[0] for a in out["actions"]] == ["drain", "reinstate"]


def test_enabled_health_plane_counts_the_same_events():
    def script(X, clock):
        X.health.enable_health()
        sched = _replica(X, clock, max_queue=1)
        sched.submit("s1", [5, 9, 2, 14], max_new_tokens=8)
        with pytest.raises(X.S.RejectedError):
            sched.submit("s2", [5, 9, 2], max_new_tokens=2)
        sched.run_until_idle()
        snap = sched.metrics_snapshot()
        st = X.health.get_health().slo.status()
        win = snap["health"]["windows"]
        return {"tokens": sched.result("s1"),
                "ttft_count": win["ttft"]["count"],
                "tpot_count": win["tpot"]["count"],
                "shed": st["shed_rate"]["windows"]["fast"]["events"],
                "shed_bad": st["shed_rate"]["windows"]["fast"]["bad"],
                "errors": st["error_rate"]["windows"]["fast"]["events"]}

    out = both(script)
    assert out["ttft_count"] == 1 and out["shed"] == 2
    assert out["shed_bad"] == 1 and out["errors"] == 1
