"""The port's migration, ejection and remote transport against the
reference's, on the CPU (the serving-level cases of
``tests/test_transport.py``).

In-process cases run one script on the reference's ``paddle_tpu.serving``
and on the port's under a ``FakeClock`` (``torch_serving_parity.both``):
a waiting request migrates policy-only with its deadline re-based, a
pending cancel wins over a move, ``drain_replica`` moves an active
request with its KV pages (or by recompute where either swap pool is
off) and the stream continues without a duplicate or missing token,
``eject`` requeues onto the survivor or sheds with no survivor, and
concurrent submits through a half-open circuit admit each request once.
Equal on both sides: tokens, event streams, states, timelines, snapshots
and the ``serving_*`` series.

The HTTP cases put each side's ``Scheduler`` behind its own
``start_http_frontend`` and drive it through its ``RemoteReplica``:
tokens equal the direct engine's, a reply dropped by a ``FaultPlan`` is
resubmitted idempotently (admitted once), a drain migrates mid-decode
over HTTP, the prober ejects a killed backend, and under every chaos
schedule every rid ends in exactly one terminal.  A bf16 swap blob (its
pages as uint16 bit patterns) survives the base64 JSON hop byte for
byte, and a remote migration of bf16 pools resumes on the far side.
"""
import base64
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from torch_serving_parity import (NOSLEEP, PORT, Tracker, both, models,
                                  reset_planes, sched_record, series)


@pytest.fixture(scope="module", autouse=True)
def _models():
    models()


@pytest.fixture(autouse=True)
def _planes():
    yield
    reset_planes()


# -- scheduler-level migration -------------------------------------------------
def test_sched_migrate_waiting_request_rebases_deadline():
    def script(X, clock):
        e0 = X.engine(max_seqs=1, n_pages=3, max_len=32,
                      enable_prefix_caching=False)
        s0 = X.S.Scheduler(e0, max_queue=4, clock=clock)
        s1 = X.S.Scheduler(X.engine(), max_queue=4, clock=clock)
        s0.submit("hog", [1, 2, 3], max_new_tokens=4)
        s0.step()
        clock.advance(2.0)
        s0.submit("w", [4, 5, 6], max_new_tokens=4, deadline=10.0)
        pkg = s0.migrate_out("w")
        assert s0.knows("w") is False
        clock.advance(1.0)
        s1.migrate_in(pkg)
        deadline = s1._reqs["w"].deadline
        s0.run_until_idle()
        s1.run_until_idle()
        pkg.pop("on_event")
        return {"pkg": pkg, "deadline": deadline,
                "s0": sched_record(s0, ["hog"]),
                "s1": sched_record(s1, ["w"]),
                "series": series(X, [s0, s1])}

    out = both(script)
    assert out["deadline"] == 13.0
    assert out["pkg"]["admitted"] is False
    assert out["s1"]["snapshot"]["migrated_in"] == 1


def test_sched_migrate_cancel_pending_resolves_cancel():
    def script(X, clock):
        s0 = X.S.Scheduler(X.engine(), max_queue=4, clock=clock)
        s0.submit("c", [5, 9, 2], max_new_tokens=8)
        s0.step()
        s0.cancel("c")
        pkg = s0.migrate_out("c")
        s0.run_until_idle()
        return {"pkg": pkg, "rec": sched_record(s0, ["c"])}

    out = both(script)
    assert out["pkg"] is None
    assert out["rec"]["requests"]["c"]["state"] == "cancelled"


# -- router: drain + eject -----------------------------------------------------
def test_drain_replica_migrates_inflight_bit_identical():
    def script(X, clock):
        s0 = X.S.Scheduler(X.engine(), max_queue=8, clock=clock)
        s1 = X.S.Scheduler(X.engine(), max_queue=8, clock=clock)
        router = X.S.ReplicaRouter([s0, s1], sleep=NOSLEEP, clock=clock)
        tr = Tracker()
        router.submit("a", [5, 9, 2, 14], max_new_tokens=12,
                      on_event=tr.cb("a"))
        src = router._owner["a"]
        router.replicas[src].step()
        clock.advance(1.0)
        router.replicas[src].step()
        moved = router.drain_replica(src)
        router.run_until_idle()
        owner = router._owner["a"]
        rec = sched_record(router.replicas[owner], ["a"])
        a = router.pop_result("a")
        assert a == tr.streamed("a") == X.direct([5, 9, 2, 14], 12)
        with pytest.raises(X.S.RejectedError):
            router.replicas[src].submit("n", [1, 2], max_new_tokens=2)
        router.replicas[src].resume_admission()
        router.submit("b", [3, 3, 7], max_new_tokens=8,
                      on_event=tr.cb("b"))
        router.run_until_idle()
        assert router.pop_result("b") == X.direct([3, 3, 7], 8)
        return {"moved": moved, "src": src, "owner": owner,
                "order": tr.order, "rec": rec,
                "snap": router.metrics_snapshot(),
                "series": series(X, [s0, s1], [router])}

    out = both(script)
    assert out["moved"] == ["a"] and out["owner"] == 1 - out["src"]
    tl = [e["event"] for e in out["rec"]["requests"]["a"]["timeline"][
        "timeline"]]
    assert tl[0] == "migrated_in" and "resumed:swap_in" in tl


@pytest.mark.parametrize("pool_off", ["source", "destination"])
def test_drain_replica_recompute_fallback(pool_off):
    def script(X, clock):
        kws = [{"swap_pool_pages": 0}, {}]
        if pool_off == "destination":
            kws.reverse()
        reps = [X.S.Scheduler(X.engine(**kw), max_queue=4, clock=clock)
                for kw in kws]
        router = X.S.ReplicaRouter(reps, sleep=NOSLEEP, clock=clock)
        router.submit("r", [5, 9, 2], max_new_tokens=10)
        src = router._owner["r"]
        router.replicas[src].step()
        moved = router.drain_replica(src)
        router.run_until_idle()
        dst = router.replicas[1 - src]
        rec = sched_record(dst, ["r"])
        assert router.pop_result("r") == X.direct([5, 9, 2], 10)
        return {"src": src, "moved": moved, "rec": rec,
                "series": series(X, reps, [router])}

    out = both(script)
    assert out["rec"]["snapshot"]["engine"]["kv_cache"][
        "swap_in_pages"] == 0


def test_eject_requeues_inflight_and_stream_continues():
    def script(X, clock):
        reps = [X.S.Scheduler(X.engine(), max_queue=8, clock=clock)
                for _ in range(2)]
        router = X.S.ReplicaRouter(reps, sleep=NOSLEEP, clock=clock)
        tr = Tracker()
        router.submit("e", [5, 9, 2, 14], max_new_tokens=10,
                      on_event=tr.cb("e"))
        src = router._owner["e"]
        router.replicas[src].step()
        router.replicas[src].step()
        delivered = len(tr.streamed("e"))
        requeued = [router.eject(src), router.eject(src)]
        router.run_until_idle()
        assert router.pop_result("e") == tr.streamed("e") == \
            X.direct([5, 9, 2, 14], 10)
        text = X.registry.expose_text()
        assert "serving_router_ejected_total" in text
        assert "serving_router_requeued_total" in text
        return {"delivered": delivered, "requeued": requeued,
                "order": tr.order, "snap": router.metrics_snapshot(),
                "series": series(X, reps, [router])}

    out = both(script)
    assert out["requeued"] == [["e"], []]


def test_eject_with_no_survivor_sheds_not_hangs():
    def script(X, clock):
        s0 = X.S.Scheduler(X.engine(), max_queue=4, clock=clock)
        router = X.S.ReplicaRouter([s0], sleep=NOSLEEP, clock=clock)
        tr = Tracker()
        router.submit("x", [1, 2, 3], max_new_tokens=6,
                      on_event=tr.cb("x"))
        router.step()
        router.eject(0)
        assert not router.busy()
        return {"terminals": tr.terminals["x"], "order": tr.order,
                "series": series(X, [s0], [router])}

    out = both(script)
    assert out["terminals"][0]["reason"] == "replica_ejected"


def test_half_open_probe_races_concurrent_submits():
    def script(X, clock):
        scheds = [X.S.Scheduler(X.engine(), max_queue=16, clock=clock)
                  for _ in range(2)]
        router = X.S.ReplicaRouter(scheds, failure_threshold=1,
                                   cooldown=5.0, clock=clock,
                                   sleep=NOSLEEP)
        down = {"on": True}

        def flaky(rid):
            if down["on"]:
                raise RuntimeError("injected: replica down")

        router.set_fault(0, flaky)
        router.submit("warm", [1, 2], max_new_tokens=2)
        opened = router.healthy_replicas()
        down["on"] = False
        clock.advance(6.0)
        errs = []
        barrier = threading.Barrier(4)

        def worker(i):
            barrier.wait()
            try:
                router.submit(f"c{i}", [1 + i, 2, 3], max_new_tokens=2)
            except Exception as e:             # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        router.run_until_idle()
        placed = sum(1 for s in scheds for r in s._reqs
                     if str(r).startswith("c"))
        return {"opened": opened, "errs": errs,
                "healthy": router.healthy_replicas(), "placed": placed,
                "tokens": [router.result(f"c{i}") for i in range(4)]}

    out = both(script)
    assert out["opened"] == [1] and out["healthy"] == [0, 1]
    assert out["placed"] == 4 and out["errs"] == []


# -- remote transport over HTTP ------------------------------------------------
class Rig:
    """Frontends over each side's schedulers, torn down on exit."""

    def __init__(self, X):
        self.X = X
        self.fes = []

    def make(self, n=2, engine_kw=None, fe_kw=None, **rep_kw):
        X = self.X
        scheds = [X.S.Scheduler(X.engine(**(engine_kw or {})),
                                max_queue=8) for _ in range(n)]
        fes = [X.S.start_http_frontend(s, **(fe_kw or {}))
               for s in scheds]
        self.fes.extend(fes)
        reps = [X.S.RemoteReplica(fe.url, timeout=30, sleep=NOSLEEP,
                                  **rep_kw) for fe in fes]
        return fes, scheds, reps, X.S.ReplicaRouter(reps, sleep=NOSLEEP)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for fe in self.fes:
            try:
                fe.shutdown(drain=False)
            except Exception:
                pass


def test_remote_replica_matches_direct_engine():
    def script(X, clock):
        with Rig(X) as rig:
            fes, scheds, reps, router = rig.make()
            tr = Tracker()
            router.submit("h1", [5, 9, 2, 14], max_new_tokens=8,
                          on_event=tr.cb("h1"))
            router.run_until_idle(max_steps=5000)
            toks = router.pop_result("h1")
            assert toks == tr.streamed("h1") == X.direct([5, 9, 2, 14], 8)
            return {"tokens": toks,
                    "terminals": [e["type"] for e in tr.terminals["h1"]],
                    "health": reps[0].health()["status"],
                    "admitted": [s.metrics_snapshot()["admitted"]
                                 for s in scheds]}

    both(script)


def test_remote_idempotent_resubmission_on_lost_reply():
    def script(X, clock):
        with Rig(X) as rig:
            fes, scheds, reps, router = rig.make(n=1)
            plan = X.S.FaultPlan(
                [X.S.Fault(op="submit", kind="disconnect", nth=1,
                           times=1)], sleep=NOSLEEP)
            reps[0].set_fault_plan(plan)
            reps[0].submit("i1", [5, 9, 2], max_new_tokens=6)
            reps[0].run_until_idle(max_steps=5000)
            toks = reps[0].pop_result("i1")
            assert toks == X.direct([5, 9, 2], 6)
            text = X.registry.expose_text()
            assert "serving_transport_retries_total" in text
            return {"tokens": toks, "injected": plan.injected,
                    "admitted": scheds[0].metrics_snapshot()["admitted"]}

    out = both(script)
    assert out["injected"] == {"disconnect": 1} and out["admitted"] == 1


def test_remote_drain_migrates_mid_decode():
    def script(X, clock):
        with Rig(X) as rig:
            fes, scheds, reps, router = rig.make()
            tr = Tracker()
            idx = router.submit("m1", [5, 9, 2, 14], max_new_tokens=48,
                                on_event=tr.cb("m1"))
            router.step()
            moved = router.drain_replica(idx)
            router.run_until_idle(max_steps=8000)
            toks = router.pop_result("m1")
            assert toks == tr.streamed("m1") == \
                X.direct([5, 9, 2, 14], 48)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(fes[idx].url + "/healthz",
                                       timeout=30)
            status = json.loads(ei.value.read())["status"]
            reps[idx].resume_admission()
            return {"moved": moved, "code": ei.value.code,
                    "status": status,
                    "after": reps[idx].health()["status"],
                    "migrated": [s.metrics_snapshot()["migrated_in"]
                                 for s in scheds]}

    out = both(script)
    assert out["moved"] == ["m1"] and out["code"] == 503
    assert out["status"] == "draining" and out["after"] == "ok"


def test_prober_kill_ejects_and_requeues():
    def script(X, clock):
        with Rig(X) as rig:
            fes, scheds, reps, router = rig.make()
            tr = Tracker()
            idx = router.submit("k1", [3, 3, 7], max_new_tokens=48,
                                on_event=tr.cb("k1"))
            router.step()
            prober = X.S.HealthProber(router, dead_after=1, timeout=1.0,
                                      sleep=NOSLEEP)
            fes[idx].kill()
            verdict = prober.probe_once()[idx]
            router.run_until_idle(max_steps=8000)
            toks = router.pop_result("k1")
            assert toks == tr.streamed("k1") == X.direct([3, 3, 7], 48)
            return {"verdict": verdict,
                    "moved": router._owner.get("k1", 1 - idx) != idx,
                    "terminals": [e["type"] for e in tr.terminals["k1"]]}

    out = both(script)
    assert out["verdict"] == "ejected" and out["terminals"] == ["finished"]


def test_prober_slow_opens_circuit_then_recovers():
    def script(X, clock):
        with Rig(X) as rig:
            fes, scheds, reps, router = rig.make()
            router._clock = clock
            plan = X.S.FaultPlan([X.S.Fault(op="health", kind="timeout",
                                            nth=1, times=1)],
                                 sleep=NOSLEEP)
            reps[0].set_fault_plan(plan)
            prober = X.S.HealthProber(router, dead_after=2, timeout=1.0,
                                      sleep=NOSLEEP, clock=clock)
            first = prober.probe_once()[0]
            opened = router.healthy_replicas()
            ejected = router.is_ejected(0)
            clock.advance(router.cooldown + 1)
            half = router.healthy_replicas()
            return {"first": first, "opened": opened, "ejected": ejected,
                    "half": half, "second": prober.probe_once()[0]}

    out = both(script)
    assert out == {"first": "slow", "opened": [1], "ejected": False,
                   "half": [0, 1], "second": "ok"}


def test_prober_background_thread_start_stop():
    import time as _t
    with Rig(PORT) as rig:
        fes, scheds, reps, router = rig.make(n=1)
        prober = PORT.S.HealthProber(router, interval=0.01, dead_after=3,
                                     timeout=2.0).start()
        names = [t.name for t in threading.enumerate()]
        _t.sleep(0.1)
        prober.stop()
        assert router.healthy_replicas() == [0]
    assert "paddle-tpu-serving-prober" in names
    assert "paddle-tpu-serving-sched" in names


# -- chaos suite ---------------------------------------------------------------
def _drive(router, prober=None, max_steps=3000, probe_every=10):
    steps = 0
    while router.busy() and steps < max_steps:
        router.step()
        steps += 1
        if prober is not None and steps % probe_every == 0:
            prober.probe_once()
    return steps


@pytest.mark.parametrize("schedule", ["refused", "timeout", "slow",
                                      "disconnect", "crash"])
def test_chaos_no_lost_requests(schedule):
    """Every submitted rid ends in exactly one of finished / cancelled /
    shed, and finished rids carry the faultless tokens (the backends
    step on their own threads, so where a terminal lands is timing;
    the invariant is not).  48 new tokens keep each replica busy for
    more polls than the latest fault's index (the port's CPU engine
    finishes 24 in as few as 7 polls)."""
    N = 48

    def script(X, clock):
        with Rig(X) as rig:
            fes, scheds, reps, router = rig.make()
            faults = {
                "refused": [X.S.Fault(op="submit", kind="refuse", nth=1,
                                      times=2),
                            X.S.Fault(op="poll", kind="refuse", nth=3,
                                      times=2)],
                "timeout": [X.S.Fault(op="submit", kind="timeout", nth=1,
                                      times=1),
                            X.S.Fault(op="poll", kind="timeout", nth=4,
                                      times=2)],
                "slow": [X.S.Fault(op="*", kind="slow", nth=1,
                                   times=None, delay=0.01)],
                "disconnect": [
                    X.S.Fault(op="submit", kind="disconnect", nth=1,
                              times=1),
                    X.S.Fault(op="poll", kind="disconnect", nth=5,
                              times=1)],
                "crash": [X.S.Fault(op="poll", kind="crash", nth=6,
                                    times=1, on_crash=fes[0].kill)],
            }[schedule]
            plan = X.S.FaultPlan(faults, sleep=NOSLEEP)
            reps[0].set_fault_plan(plan)
            prober = X.S.HealthProber(router, dead_after=2, timeout=1.0,
                                      sleep=NOSLEEP)
            tr = Tracker()
            submitted = []
            for i in range(4):
                try:
                    router.submit(f"q{i}", [1 + i, 2, 3],
                                  max_new_tokens=N, on_event=tr.cb(f"q{i}"))
                    submitted.append(f"q{i}")
                except Exception:
                    pass
            router.step()
            if submitted:
                try:
                    router.cancel(submitted[0])
                except Exception:
                    pass
            _drive(router, prober=prober)
            assert plan.injected
            for i, rid in enumerate(submitted):
                terms = tr.terminals.get(rid, [])
                assert len(terms) == 1, (schedule, rid, terms)
                if terms[0]["type"] == "finished":
                    assert tr.streamed(rid) == X.direct([1 + i, 2, 3], N)
            return {"injected_kinds": sorted(plan.injected),
                    "one_terminal_each": True}

    both(script)


def test_chaos_deadline_is_the_timeout_terminal():
    def script(X, clock):
        with Rig(X) as rig:
            fes, scheds, reps, router = rig.make(
                n=1, engine_kw=dict(max_seqs=1, n_pages=5, max_len=32,
                                    enable_prefix_caching=False))
            tr = Tracker()
            router.submit("hog", [1, 2, 3], max_new_tokens=24,
                          on_event=tr.cb("hog"))
            router.submit("late", [4, 5, 6], max_new_tokens=4,
                          deadline=0.0, on_event=tr.cb("late"))
            _drive(router)
            return {"late": tr.terminals["late"],
                    "hog": [e["type"] for e in tr.terminals["hog"]]}

    out = both(script)
    assert out["late"][0]["type"] == "shed"
    assert out["late"][0]["reason"] == "deadline"
    assert out["hog"] == ["finished"]


# -- bf16 pages over the wire --------------------------------------------------
def test_bf16_swap_blob_survives_base64_json_hop():
    """bf16 pages travel as their uint16 bit patterns: the blob goes
    through the frontend's base64 + JSON framing and imports into
    another cache whose swap-in restores the pages bit for bit."""
    from paddle_tpu_torch.inference.paged_cache import PagedKVCache
    cfg = dict(n_pages=9, page_size=4, n_kv_heads=2, head_dim=8,
               max_seqs=2, max_len=16, num_layers=2, swap_pool_pages=8,
               dtype=torch.bfloat16, device="cpu")
    src, dst = PagedKVCache(**cfg), PagedKVCache(**cfg)
    slot = src.allocate(10)
    g = torch.Generator().manual_seed(0)
    for _ in range(7):
        k, v = (torch.randn((2, 1, 2, 8), generator=g).to(torch.bfloat16)
                for _ in range(2))
        src.append([slot], k, v)
    pages = list(src._pages[slot])[:2]                # the written pages
    want = [src.k_pages[:, :, p].clone() for p in pages] + \
        [src.v_pages[:, :, p].clone() for p in pages]
    blob = src.export_swap(src.swap_out(slot))
    wire = json.dumps({"swap": base64.b64encode(blob).decode("ascii")})
    back = base64.b64decode(json.loads(wire)["swap"])
    assert back == blob
    slot2 = dst.swap_in(dst.import_swap(back), 10)
    got_pages = list(dst._pages[slot2])[:2]
    got = [dst.k_pages[:, :, p] for p in got_pages] + \
        [dst.v_pages[:, :, p] for p in got_pages]
    for w, g_ in zip(want, got):
        assert g_.dtype == torch.bfloat16
        assert torch.equal(w.view(torch.int16), g_.view(torch.int16))


def test_remote_migration_of_bf16_pools():
    want = PORT.direct([5, 9, 2, 14], 24, dtype=torch.bfloat16)
    with Rig(PORT) as rig:
        fes, scheds, reps, router = rig.make(
            engine_kw=dict(dtype=torch.bfloat16))
        tr = Tracker()
        idx = router.submit("b1", [5, 9, 2, 14], max_new_tokens=24,
                            on_event=tr.cb("b1"))
        router.step()
        assert router.drain_replica(idx) == ["b1"]
        router.run_until_idle(max_steps=8000)
        assert router.pop_result("b1") == tr.streamed("b1") == want
        kv = scheds[1 - idx].metrics_snapshot()["engine"]["kv_cache"]
    assert kv["swap_imported_pages"] >= 1 and kv["swap_in_pages"] >= 1
