"""The port's serving runtime (``paddle_tpu_torch.serving``: Scheduler,
ReplicaRouter, HTTP frontend) against the reference's, on the CPU.

Each case of ``tests/test_serving.py`` runs as one script on the
reference's ``paddle_tpu.serving`` over its JAX engine and on the port's
over its engine (the reference's tiny Llama carried in, f32, pages of
8), each under a ``FakeClock`` from 0 (``torch_serving_parity.both``).
Equal on both sides: every request's tokens, final state, shed reason
and timeline, the order of admissions, the scheduler's and router's
snapshots and the values of their ``serving_sched_*`` /
``serving_router_*`` series.  One case runs split-path engines
(``unified_step=False``, ``steps_per_sync`` 4, kernel #7's plain
version), one chunked admission under the AIMD prefill budget.  The
HTTP cases stream the same tokens from both frontends; ``/statusz``
names torch, its CUDA and the device, not JAX; a loop thread that dies
in a step turns ``/healthz`` into 503 with the error.
"""
import http.client
import json
import urllib.error
import urllib.request

import pytest

from torch_serving_parity import (NOSLEEP, PORT, FakeClock, Tracker, both,
                                  models, reset_planes, sched_record, series)


@pytest.fixture(scope="module", autouse=True)
def _models():
    models()


@pytest.fixture(autouse=True)
def _planes():
    yield
    reset_planes()


# -- scheduler: equivalence ----------------------------------------------------
STREAMS = {"a": ([5, 9, 2, 14], 8), "b": ([3, 3, 7], 5),
           "c": (list(range(1, 12)), 4)}


@pytest.mark.parametrize("path", ["unified", "split_sync4"])
def test_scheduler_matches_direct_engine(path):
    ekw = {} if path == "unified" else dict(unified_step=False,
                                            steps_per_sync=4)

    def script(X, clock):
        sched = X.S.Scheduler(X.engine(**ekw), max_queue=8, clock=clock)
        tr = Tracker()
        for rid, (p, n) in STREAMS.items():
            sched.submit(rid, p, max_new_tokens=n, on_event=tr.cb(rid))
        out = sched.run_until_idle()
        for rid, (p, n) in STREAMS.items():
            assert out[rid] == sched.result(rid) == X.direct(p, n, **ekw)
        snap = sched.metrics_snapshot()
        assert snap["admitted"] == 3 and snap["completed"] == 3
        assert snap["engine"]["kv_cache"]["oom_events"] == 0
        return {"out": out, "order": tr.order,
                "rec": sched_record(sched, list(STREAMS)),
                "series": series(X, [sched])}

    both(script)


def test_scheduler_priority_order():
    def script(X, clock):
        eng = X.engine(max_seqs=1, max_len=32, n_pages=3,
                       enable_prefix_caching=False)
        sched = X.S.Scheduler(eng, max_queue=8, clock=clock)
        tr = Tracker()
        sched.submit("hold", [1, 2, 3], max_new_tokens=4,
                     on_event=tr.cb("hold"))
        sched.step()
        for rid, prio in [("p2", 2), ("p0", 0), ("p1", 1)]:
            clock.advance(0.5)
            sched.submit(rid, [4, 5, 6], max_new_tokens=2, priority=prio,
                         on_event=tr.cb(rid))
        while sched.busy():
            clock.advance(0.25)
            sched.step()
        assert tr.admitted() == ["hold", "p0", "p1", "p2"]
        return {"order": tr.order,
                "rec": sched_record(sched, ["hold", "p0", "p1", "p2"]),
                "series": series(X, [sched])}

    both(script)


# -- scheduler: overload / deadlines -------------------------------------------
def test_overload_queues_then_sheds_without_oom():
    def script(X, clock):
        eng = X.engine(max_seqs=2, max_len=32, n_pages=5,
                       enable_prefix_caching=False)
        sched = X.S.Scheduler(eng, max_queue=2, clock=clock)
        shed = []
        for i in range(6):
            try:
                sched.submit(f"r{i}", [1 + i, 2, 3], max_new_tokens=8)
            except X.S.RejectedError:
                shed.append(i)
        assert shed == [2, 3, 4, 5]
        sched.run_until_idle()
        snap = sched.metrics_snapshot()
        assert snap["shed"]["queue_full"] == 4
        assert snap["engine"]["kv_cache"]["oom_events"] == 0
        text = X.registry.expose_text()
        for name in ("serving_sched_shed_total", 'reason="queue_full"',
                     "serving_sched_deadline_miss_total",
                     "serving_sched_queue_wait_seconds_bucket"):
            assert name in text
        return {"shed": shed, "rec": sched_record(sched, ["r0", "r1"]),
                "series": series(X, [sched])}

    both(script)


def test_overload_queue_absorbs_within_bound():
    def script(X, clock):
        eng = X.engine(max_seqs=2, max_len=32, n_pages=5,
                       enable_prefix_caching=False)
        sched = X.S.Scheduler(eng, max_queue=8, clock=clock)
        rids = [f"q{i}" for i in range(6)]
        for i, rid in enumerate(rids):
            sched.submit(rid, [1 + i, 2, 3], max_new_tokens=6)
        while sched.busy():
            clock.advance(0.1)
            sched.step()
        assert sched.shed_stats == {}
        assert eng.cache.free_pages() == eng.cache.n_pages - 1
        return {"rec": sched_record(sched, rids),
                "series": series(X, [sched])}

    both(script)


def test_queue_timeout_sheds_waiting_request():
    def script(X, clock):
        eng = X.engine(max_seqs=1, max_len=32, n_pages=3,
                       enable_prefix_caching=False)
        sched = X.S.Scheduler(eng, max_queue=4, max_queue_time=2.0,
                              clock=clock)
        tr = Tracker()
        sched.submit("hold", [1, 2, 3], max_new_tokens=8,
                     on_event=tr.cb("hold"))
        sched.step()
        sched.submit("late", [4, 5, 6], max_new_tokens=4,
                     on_event=tr.cb("late"))
        clock.advance(3.0)
        sched.step()
        assert sched.status("late") == "shed"
        with pytest.raises(X.S.RejectedError):
            sched.result("late")
        sched.run_until_idle()
        return {"order": tr.order, "shed": dict(sched.shed_stats),
                "rec": sched_record(sched, ["hold", "late"]),
                "series": series(X, [sched])}

    out = both(script)
    assert out["shed"] == {"queue_timeout": 1}


def test_deadline_miss_accounting():
    def script(X, clock):
        eng = X.engine(max_seqs=2, max_len=32, n_pages=5,
                       enable_prefix_caching=False)
        s1 = X.S.Scheduler(eng, max_queue=4, clock=clock)
        s1.submit("late", [1, 2, 3], max_new_tokens=4, deadline=5.0)
        s1.step()
        clock.advance(10.0)
        s1.run_until_idle()
        assert s1._reqs["late"].deadline_missed
        eng2 = X.engine(max_seqs=1, max_len=32, n_pages=3,
                        enable_prefix_caching=False)
        s2 = X.S.Scheduler(eng2, max_queue=4, clock=clock)
        s2.submit("hold", [1, 2, 3], max_new_tokens=8)
        s2.step()
        s2.submit("doomed", [4, 5, 6], max_new_tokens=4, deadline=1.0)
        clock.advance(2.0)
        s2.step()
        assert s2.status("doomed") == "shed"
        return {"s1": sched_record(s1, ["late"]),
                "s2": sched_record(s2, ["hold", "doomed"]),
                "series": series(X, [s1, s2])}

    out = both(script)
    assert out["s2"]["requests"]["doomed"]["shed_reason"] == "deadline"


# -- scheduler: cancellation / drain / memory ----------------------------------
def test_cancel_mid_decode_releases_pages_keeps_others_exact():
    def script(X, clock):
        eng = X.engine()
        sched = X.S.Scheduler(eng, max_queue=4, clock=clock)
        sched.submit("dead", [5, 9, 2, 14], max_new_tokens=32)
        sched.submit("b", [3, 3, 7], max_new_tokens=8)
        sched.step()
        clock.advance(1.0)
        sched.step()
        assert sched.cancel("dead") is True
        sched.run_until_idle()
        assert sched.status("dead") == "cancelled"
        assert 1 <= len(sched.result("dead")) < 33
        assert sched.result("b") == X.direct([3, 3, 7], 8)
        assert eng.cache.free_pages() == eng.cache.n_pages - 1
        assert sched.cancel("b") is False
        return {"rec": sched_record(sched, ["dead", "b"]),
                "series": series(X, [sched])}

    both(script)


def test_cancel_waiting_request():
    def script(X, clock):
        eng = X.engine(max_seqs=1, max_len=32, n_pages=3,
                       enable_prefix_caching=False)
        sched = X.S.Scheduler(eng, max_queue=4, clock=clock)
        sched.submit("hold", [1, 2, 3], max_new_tokens=6)
        sched.step()
        sched.submit("queued", [4, 5, 6], max_new_tokens=4)
        assert sched.cancel("queued") is True
        assert sched.result("queued") == []
        sched.run_until_idle()
        return {"rec": sched_record(sched, ["hold", "queued"]),
                "series": series(X, [sched])}

    both(script)


def test_drain_refuses_new_finishes_inflight():
    def script(X, clock):
        sched = X.S.Scheduler(X.engine(max_seqs=2), max_queue=4,
                              clock=clock)
        sched.submit("a", [5, 9, 2], max_new_tokens=6)
        sched.step()
        sched.stop_admission()
        assert sched.health()["status"] == "draining"
        with pytest.raises(X.S.RejectedError):
            sched.submit("nope", [1, 2], max_new_tokens=2)
        sched.drain()
        assert not sched.busy()
        return {"rec": sched_record(sched, ["a"]),
                "series": series(X, [sched])}

    both(script)


def test_scheduler_bounds_engine_memory():
    def script(X, clock):
        eng = X.engine(max_seqs=2, max_len=32)
        sched = X.S.Scheduler(eng, max_queue=8, clock=clock)
        got = []
        for i in range(4):
            sched.submit(f"m{i}", [1 + i, 2], max_new_tokens=3)
            sched.run_until_idle()
            got.append(sched.pop_result(f"m{i}"))
        assert eng.requests == {} and sched._reqs == {}
        sched.submit("m0", [9, 9], max_new_tokens=2)    # rid reuse
        sched.run_until_idle()
        got.append(sched.pop_result("m0"))
        return {"got": got, "series": series(X, [sched])}

    both(script)


def test_submit_refuses_requests_that_never_fit():
    def script(X, clock):
        sched = X.S.Scheduler(X.engine(max_len=32), clock=clock)
        msgs = []
        for prompt, n in ((list(range(30)), 8), ([], 2), ([1], 0)):
            with pytest.raises(X.errors.EnforceError) as ei:
                sched.submit("x", prompt, max_new_tokens=n)
            msgs.append(str(ei.value))
        sched.submit("ok", [1, 2], max_new_tokens=2)
        with pytest.raises(X.errors.EnforceError):
            sched.submit("ok", [1, 2], max_new_tokens=2)   # duplicate
        sched.run_until_idle()
        return {"msgs": msgs, "rec": sched_record(sched, ["ok"])}

    both(script)


def test_chunked_prefill_aimd_budget():
    """Chunked admission rides the unified step; an SLO no step can
    meet halves the runtime prefill budget every step (floor 1), the
    same trajectory on both sides."""
    prompt = list(range(1, 30))

    def script(X, clock):
        eng = X.engine()
        sched = X.S.Scheduler(eng, max_queue=4, clock=clock,
                              chunked_prefill=True, decode_tpot_slo=1e-12)
        tr = Tracker()
        sched.submit("long", prompt, max_new_tokens=6,
                     on_event=tr.cb("long"))
        sched.submit("short", [3, 3, 7], max_new_tokens=6,
                     on_event=tr.cb("short"))
        budgets = []
        while sched.busy():
            clock.advance(0.1)
            sched.step()
            budgets.append(int(eng.prefill_token_budget))
        assert sched.result("long") == X.direct(prompt, 6)
        return {"budgets": budgets, "order": tr.order,
                "rec": sched_record(sched, ["long", "short"]),
                "series": series(X, [sched])}

    out = both(script)
    assert out["budgets"][-1] == 1


# -- router --------------------------------------------------------------------
def test_router_failover_under_injected_fault():
    def script(X, clock):
        reps = [X.S.Scheduler(X.engine(max_seqs=2), max_queue=4,
                              clock=clock) for _ in range(2)]
        router = X.S.ReplicaRouter(reps, failure_threshold=2,
                                   sleep=NOSLEEP, clock=clock)
        fails = []

        def boom(rid):
            fails.append(rid)
            raise RuntimeError("injected replica fault")

        router.set_fault(0, boom)
        idxs = [router.submit(f"f{i}", [5, 9, 2], max_new_tokens=4)
                for i in range(3)]
        assert idxs == [1, 1, 1]
        assert router.healthy_replicas() == [1]
        router.run_until_idle()
        for i in range(3):
            assert router.result(f"f{i}") == X.direct([5, 9, 2], 4)
        text = X.registry.expose_text()
        assert "serving_router_retries_total" in text
        assert "serving_router_replica_unhealthy" in text
        return {"fails": fails, "snap": router.metrics_snapshot(),
                "series": series(X, reps, [router])}

    out = both(script)
    assert out["snap"]["replicas"][1]["requests_total"] == 3


def test_router_circuit_recloses_after_cooldown():
    def script(X, clock):
        reps = [X.S.Scheduler(X.engine(max_seqs=2), max_queue=4,
                              clock=clock) for _ in range(2)]
        router = X.S.ReplicaRouter(reps, failure_threshold=1,
                                   cooldown=5.0, clock=clock,
                                   sleep=NOSLEEP)
        router.set_fault(0, lambda rid: (_ for _ in ()).throw(
            RuntimeError("down")))
        router.submit("a", [5, 9, 2], max_new_tokens=2)
        assert router.healthy_replicas() == [1]
        router.clear_fault(0)
        clock.advance(6.0)
        assert 0 in router.healthy_replicas()
        assert router.submit("b", [5, 9, 2], max_new_tokens=2) == 0
        router.run_until_idle()
        return {"a": router.pop_result("a"), "b": router.pop_result("b"),
                "snap": router.metrics_snapshot(),
                "series": series(X, reps, [router])}

    both(script)


def test_router_least_loaded_and_all_reject():
    def script(X, clock):
        reps = [X.S.Scheduler(X.engine(max_seqs=1, max_len=32, n_pages=3,
                                       enable_prefix_caching=False),
                              max_queue=1, clock=clock)
                for _ in range(2)]
        router = X.S.ReplicaRouter(reps, sleep=NOSLEEP, clock=clock)
        spread = [router.submit(f"l{i}", [1 + i, 2, 3], max_new_tokens=4)
                  for i in range(2)]
        router.step()
        spread += [router.submit(f"l{i}", [1 + i, 2, 3],
                                 max_new_tokens=4) for i in range(2, 4)]
        with pytest.raises(X.S.RejectedError):
            router.submit("overflow", [9, 9], max_new_tokens=2)
        router.run_until_idle()
        return {"spread": spread,
                "tokens": [router.result(f"l{i}") for i in range(4)],
                "snap": router.metrics_snapshot(),
                "series": series(X, reps, [router])}

    out = both(script)
    assert sorted(out["spread"][:2]) == [0, 1]


# -- HTTP frontend -------------------------------------------------------------
def _stream(fe, body):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    status, ctype = resp.status, resp.getheader("Content-Type")
    raw = resp.read()
    conn.close()
    return status, ctype, raw


def _get(fe, path):
    try:
        r = urllib.request.urlopen(fe.url + path, timeout=60)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_streams_completion_and_scrapes_metrics():
    def script(X, clock):
        fe = X.S.start_http_frontend(
            X.S.Scheduler(X.engine(max_seqs=2), max_queue=4, clock=clock))
        try:
            status, ctype, raw = _stream(
                fe, {"prompt": [5, 9, 2, 14], "max_tokens": 8, "id": "h1"})
            lines = [json.loads(l) for l in raw.decode().splitlines()]
            code, hz = _get(fe, "/healthz")
            _, text = _get(fe, "/metrics")
            ucode, ctype2, uraw = _stream(
                fe, {"prompt": [3, 3, 7], "max_tokens": 5, "id": "u1",
                     "stream": False})
            bad = [_stream(fe, b)[0] for b in (
                {"prompt": "not ids"},
                {"prompt": list(range(60)), "max_tokens": 50})]
            nope = _get(fe, "/nope")[0]
        finally:
            fe.shutdown()
        streamed = [t for l in lines for t in l.get("tokens", [])]
        assert streamed == X.direct([5, 9, 2, 14], 8)
        assert len(lines) >= 2 and lines[-1]["done"]
        for name in (b"serving_sched_admitted_total",
                     b"serving_sched_shed_total",
                     b"llm_engine_generated_tokens_total"):
            assert name in text
        return {"status": status, "ctype": ctype, "lines": lines,
                "healthz": (code, json.loads(hz)),
                "unary": (ucode, ctype2, json.loads(uraw)),
                "bad": bad, "nope": nope}

    out = both(script)
    assert out["unary"][2]["tokens"] == PORT.direct([3, 3, 7], 5)
    assert out["bad"] == [400, 400] and out["nope"] == 404


def test_http_statusz_names_torch_and_the_device():
    clock = FakeClock()
    fe = PORT.S.start_http_frontend(
        PORT.S.Scheduler(PORT.engine(max_seqs=2), max_queue=4,
                         clock=clock))
    try:
        _stream(fe, {"prompt": [5, 9, 2], "max_tokens": 3})
        code, raw = _get(fe, "/statusz")
        mcode, mraw = _get(fe, "/memz")
        ccode, craw = _get(fe, "/compilez")
    finally:
        fe.shutdown()
    import torch
    assert code == 200
    st = json.loads(raw)
    build = st["build"]
    assert "jax" not in build and "jax" not in raw.decode().lower()
    assert build["torch"] == torch.__version__
    assert build["cuda"] == torch.version.cuda
    assert build["device"] == "cpu" and build["device_name"] == "cpu"
    assert st["target"]["waiting"] == 0
    assert mcode == 200 and ccode == 200
    memz = json.loads(mraw)
    assert memz["devices"][0]["device"] == "cpu"
    assert any(r["device_bytes"] > 0 for r in memz["consumers"].values())


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_http_healthz_503_keeps_the_step_error():
    """A step that raises ends the loop thread: /healthz answers 503
    ``wedged`` with the error, and handlers that need the loop refuse
    instead of hanging."""
    class Broken:
        engine = None
        draining = False

        def busy(self):
            return True

        def step(self):
            raise RuntimeError("launch failed")

        def metrics_snapshot(self):
            return {"waiting": 0}

        def drain(self):
            pass

    fe = PORT.S.start_http_frontend(Broken())
    try:
        fe._loop_thread.join(timeout=10)
        assert not fe._loop_thread.is_alive()
        code, raw = _get(fe, "/healthz")
        scode, sraw = _get(fe, "/v1/stats")
    finally:
        fe.shutdown(drain=False)
    assert code == 503
    body = json.loads(raw)
    assert body["status"] == "wedged"
    assert body["error"] == "RuntimeError: launch failed"
    assert isinstance(fe.loop_error, RuntimeError)
    # the reference's error vocabulary: UnavailableError is a
    # contract error (400), never a hang
    assert scode == 400 and b"loop thread" in sraw

