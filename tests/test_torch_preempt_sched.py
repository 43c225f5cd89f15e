"""The port's preemptive scheduling and bin-packing admission against the
reference's, on the CPU (the cases of ``tests/test_preempt_sched.py``).

Each script runs on the reference's ``Scheduler`` over its JAX engine
and on the port's over its engine, under a ``FakeClock``
(``torch_serving_parity.both``): a strictly-higher-priority waiter
evicts the lowest-priority active request (swap-in and recompute resume
paths, on unified and split engines), ``max_preemptions_per_request``
bounds eviction, packing admits smaller waiters around a blocked head
until ``packing_max_overtakes``, and the router counts suspended
requests in a replica's load and never opens a circuit on
``RejectedError``.  Equal on both sides: tokens, states, admission and
preemption order (the event stream), timelines, snapshots and the
``serving_sched_*`` / ``serving_router_*`` series.
"""
import pytest

from torch_serving_parity import (NOSLEEP, Tracker, both, models,
                                  reset_planes, sched_record, series)


@pytest.fixture(scope="module", autouse=True)
def _models():
    models()


@pytest.fixture(autouse=True)
def _planes():
    yield
    reset_planes()


def _one_slot(X, **kw):
    kw.setdefault("enable_prefix_caching", False)
    return X.engine(max_seqs=1, max_len=32, n_pages=5, **kw)


# -- preemption policy ---------------------------------------------------------
@pytest.mark.parametrize("path", ["unified", "split_sync4"])
def test_preemption_admits_high_priority_both_exact(path):
    ekw = {} if path == "unified" else dict(unified_step=False,
                                            steps_per_sync=4)

    def script(X, clock):
        eng = _one_slot(X, **ekw)
        sched = X.S.Scheduler(eng, max_queue=8, clock=clock)
        tr = Tracker()
        sched.submit("lo", [1, 2, 3], max_new_tokens=16, priority=1,
                     on_event=tr.cb("lo"))
        sched.step()
        clock.advance(1.0)
        sched.step()
        sched.submit("hi", [7, 8, 9], max_new_tokens=4, priority=0,
                     on_event=tr.cb("hi"))
        while sched.busy():
            clock.advance(0.5)
            sched.step()
        assert sched.result("lo") == X.direct([1, 2, 3], 16, **ekw)
        assert sched.result("hi") == X.direct([7, 8, 9], 4, **ekw)
        snap = sched.metrics_snapshot()
        assert snap["preempted"] == 1
        assert snap["engine"]["kv_cache"]["swap_out_pages"] >= 1
        return {"order": tr.order,
                "rec": sched_record(sched, ["lo", "hi"]),
                "series": series(X, [sched])}

    out = both(script)
    assert ("lo", "preempted") in [tuple(e) for e in out["order"]]
    tl = [e["event"] for e in
          out["rec"]["requests"]["lo"]["timeline"]["timeline"]]
    assert tl == ["submitted", "admitted", "first_token", "preempted",
                  "resumed:swap_in", "finished"]


def test_victim_is_the_youngest_of_the_lowest_priority():
    """Three active requests fill the slots: a high-priority arrival
    evicts the youngest request of the lowest class, then the next
    arrival the one before it."""
    def script(X, clock):
        eng = X.engine(max_seqs=3, max_len=32, n_pages=13,
                       enable_prefix_caching=False)
        sched = X.S.Scheduler(eng, max_queue=8, clock=clock)
        tr = Tracker()
        for rid, prio in (("a", 1), ("b", 2), ("c", 2)):
            sched.submit(rid, [1, 2, 3], max_new_tokens=12, priority=prio,
                         on_event=tr.cb(rid))
        sched.step()
        for rid in ("h1", "h2"):
            sched.submit(rid, [7, 8, 9], max_new_tokens=3, priority=0,
                         on_event=tr.cb(rid))
            sched.step()
        sched.run_until_idle()
        return {"order": tr.order,
                "rec": sched_record(sched, ["a", "b", "c", "h1", "h2"]),
                "series": series(X, [sched])}

    out = both(script)
    victims = [r for r, kind in out["order"] if kind == "preempted"]
    assert victims == ["c", "b"]


def test_equal_priority_never_preempts():
    def script(X, clock):
        sched = X.S.Scheduler(_one_slot(X), max_queue=8, clock=clock)
        sched.submit("first", [1, 2, 3], max_new_tokens=8, priority=1)
        sched.step()
        sched.submit("second", [4, 5, 6], max_new_tokens=4, priority=1)
        sched.step()
        states = (sched.status("first"), sched.status("second"))
        sched.run_until_idle()
        return {"states": states,
                "rec": sched_record(sched, ["first", "second"]),
                "series": series(X, [sched])}

    out = both(script)
    assert out["states"] == ["active", "waiting"]
    assert out["rec"]["snapshot"]["preempted"] == 0


def test_max_preemptions_bound_prevents_livelock():
    def script(X, clock):
        sched = X.S.Scheduler(_one_slot(X), max_queue=8, clock=clock,
                              max_preemptions_per_request=1)
        tr = Tracker()
        sched.submit("lo", [1, 2, 3], max_new_tokens=16, priority=2,
                     on_event=tr.cb("lo"))
        sched.step()
        sched.submit("hi1", [7, 8, 9], max_new_tokens=2, priority=0,
                     on_event=tr.cb("hi1"))
        while sched.status("hi1") != "finished":
            clock.advance(0.5)
            sched.step()
        assert sched.status("lo") == "suspended"
        while sched.status("lo") != "active":
            clock.advance(0.5)
            sched.step()
        sched.submit("hi2", [7, 8, 9], max_new_tokens=2, priority=0,
                     on_event=tr.cb("hi2"))
        sched.step()
        states = (sched.status("lo"), sched.status("hi2"))
        sched.run_until_idle()
        assert sched.result("lo") == X.direct([1, 2, 3], 16)
        return {"states": states, "order": tr.order,
                "rec": sched_record(sched, ["lo", "hi1", "hi2"]),
                "series": series(X, [sched])}

    out = both(script)
    assert out["states"] == ["active", "waiting"]
    assert out["rec"]["snapshot"]["preempted"] == 1


def test_preemption_recompute_path_exact():
    def script(X, clock):
        sched = X.S.Scheduler(_one_slot(X, swap_pool_pages=0),
                              max_queue=8, clock=clock)
        sched.submit("lo", [1, 2, 3], max_new_tokens=12, priority=1)
        sched.step()
        sched.step()
        sched.submit("hi", [7, 8, 9], max_new_tokens=2, priority=0)
        sched.run_until_idle()
        assert sched.result("lo") == X.direct([1, 2, 3], 12)
        return {"rec": sched_record(sched, ["lo", "hi"]),
                "series": series(X, [sched])}

    out = both(script)
    assert out["rec"]["snapshot"]["engine"]["kv_cache"][
        "swap_fallbacks"] >= 1
    tl = [e["event"] for e in
          out["rec"]["requests"]["lo"]["timeline"]["timeline"]]
    assert "resumed:recompute" in tl


def test_cancel_suspended_request_drops_swap():
    def script(X, clock):
        eng = _one_slot(X)
        sched = X.S.Scheduler(eng, max_queue=8, clock=clock)
        sched.submit("lo", [1, 2, 3], max_new_tokens=16, priority=1)
        sched.step()
        sched.submit("hi", [7, 8, 9], max_new_tokens=8, priority=0)
        sched.step()
        assert sched.status("lo") == "suspended"
        assert sched.cancel("lo") is True
        sched.step()
        assert sched.status("lo") == "cancelled"
        assert eng.cache.swap_pool_used() == 0
        sched.run_until_idle()
        assert not sched.busy()
        return {"rec": sched_record(sched, ["lo", "hi"]),
                "series": series(X, [sched])}

    both(script)


# -- bin-packing admission -----------------------------------------------------
@pytest.mark.parametrize("kw,want", [
    (dict(packing=True), ["blocker", "s1", "s2", "big"]),
    ({}, ["blocker", "big", "s1", "s2"]),
    (dict(packing=True, packing_max_overtakes=1),
     ["blocker", "s1", "big", "s2"]),
], ids=["packing", "strict", "starvation_bound"])
def test_packing_admission(kw, want):
    def script(X, clock):
        eng = X.engine(max_seqs=2, max_len=32, n_pages=5,
                       enable_prefix_caching=False)
        sched = X.S.Scheduler(eng, max_queue=8, clock=clock, **kw)
        tr = Tracker()
        sched.submit("blocker", [1, 2, 3], max_new_tokens=5,
                     on_event=tr.cb("blocker"))
        sched.step()
        sched.submit("big", list(range(1, 9)), max_new_tokens=24,
                     on_event=tr.cb("big"))
        sched.submit("s1", [4, 5], max_new_tokens=5, on_event=tr.cb("s1"))
        sched.submit("s2", [6, 7], max_new_tokens=5, on_event=tr.cb("s2"))
        while sched.busy():
            clock.advance(0.25)
            sched.step()
        assert tr.admitted() == want
        for rid in want:
            r = sched._reqs[rid]
            assert sched.result(rid) == X.direct(r.prompt, r.max_new)
        return {"order": tr.order, "overtaken": sched._reqs["big"].overtaken,
                "rec": sched_record(sched, want),
                "series": series(X, [sched])}

    both(script)


# -- router: preemption-inflated load ------------------------------------------
def test_router_counts_suspended_in_load_and_breaks_ties():
    def script(X, clock):
        r0 = X.S.Scheduler(_one_slot(X), max_queue=4, clock=clock)
        r1 = X.S.Scheduler(_one_slot(X), max_queue=4, clock=clock)
        router = X.S.ReplicaRouter([r0, r1], sleep=NOSLEEP, clock=clock)
        r0.submit("lo", [1, 2, 3], max_new_tokens=16, priority=1)
        r0.step()
        r0.submit("hi", [7, 8, 9], max_new_tokens=8, priority=0)
        r0.step()
        loads = [router._load(0), router._load(1)]
        picks = [router.submit("n1", [4, 5], max_new_tokens=8),
                 router.submit("n2", [4, 6], max_new_tokens=8)]
        r1.step()
        loads.append(router._load(1))
        picks.append(router.submit("n3", [4, 7], max_new_tokens=2))
        router.run_until_idle()
        return {"loads": loads, "picks": picks,
                "r0": sched_record(r0, ["lo", "hi"]),
                "routed": [router.result(r) for r in ("n1", "n2", "n3")],
                "series": series(X, [r0, r1], [router])}

    out = both(script)
    assert out["loads"] == [2, 0, 2] and out["picks"] == [1, 1, 0]


def test_rejected_is_load_signal_not_failure_regression():
    def script(X, clock):
        reps = [X.S.Scheduler(_one_slot(X), max_queue=1, clock=clock)
                for _ in range(2)]
        router = X.S.ReplicaRouter(reps, failure_threshold=1,
                                   sleep=NOSLEEP, clock=clock)
        for i in range(2):
            router.submit(f"a{i}", [1 + i, 2, 3], max_new_tokens=4)
        router.step()
        for i in range(2):
            router.submit(f"w{i}", [3 + i, 2], max_new_tokens=2)
        with pytest.raises(X.S.RejectedError):
            router.submit("overflow", [9, 9], max_new_tokens=2)
        healthy = router.healthy_replicas()
        router.run_until_idle()
        return {"healthy": healthy,
                "tokens": [router.result(r) for r in
                           ("a0", "a1", "w0", "w1")],
                "snap": router.metrics_snapshot(),
                "series": series(X, reps, [router])}

    out = both(script)
    assert out["healthy"] == [0, 1]


def test_preemption_metrics_exposed():
    def script(X, clock):
        sched = X.S.Scheduler(_one_slot(X), max_queue=4, clock=clock)
        sched.submit("lo", [1, 2, 3], max_new_tokens=8, priority=1)
        sched.step()
        clock.advance(2.0)
        sched.submit("hi", [7, 8, 9], max_new_tokens=2, priority=0)
        while sched.busy():
            clock.advance(0.5)
            sched.step()
        text = X.registry.expose_text()
        for name in ("serving_sched_preempted_total",
                     "serving_sched_suspended",
                     "serving_sched_time_preempted_seconds_bucket",
                     "serving_sched_packed_admissions_total",
                     "kv_cache_swap_pool_pages"):
            assert name in text
        return {"rec": sched_record(sched, ["lo", "hi"]),
                "series": series(X, [sched])}

    out = both(script)
    snap = out["rec"]["snapshot"]
    assert snap["suspended"] == 0 and snap["preempted"] == 1
    assert snap["time_preempted_seconds"]["count"] == 1
