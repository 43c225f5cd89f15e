"""The port's observability plane against the reference's.

``paddle_tpu_torch/observability`` keeps its own copy of the reference's
stdlib modules (metrics, exposition, tracing, health) and ports the
memory/compile plane and the profiler over PyTorch.  Fed the same
operations, the two registries must expose byte-identical Prometheus
text and equal snapshots; tracers and health hubs driven by the same
injected clock must give equal spans, Chrome events, window quantiles
and SLO burn rates.  The scrape endpoint is bound to ``127.0.0.1:0``.
Every test leaves the process-global planes off (the fixture below), so
a test of either package in the same worker sees the null singletons.
"""
import json
import math
import urllib.error
import urllib.request

import pytest
import torch

from paddle_tpu.observability import capsule as ref_capsule
from paddle_tpu.observability import health as ref_health
from paddle_tpu.observability import introspection as ref_insp
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.observability import tracing as ref_tracing
from paddle_tpu.profiler import make_scheduler as ref_make_scheduler

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler
from paddle_tpu_torch.common.errors import UnavailableError
from paddle_tpu_torch.observability import capsule, health, introspection
from paddle_tpu_torch.observability import metrics, tracing


@pytest.fixture(autouse=True)
def null_planes():
    """Restore every process-global plane of both packages to off."""
    yield
    for mod in (tracing, ref_tracing):
        mod.disable_tracing()
        mod.disable_flight_recorder()
    for mod in (health, ref_health):
        mod.disable_health()
    for mod in (capsule, ref_capsule):
        mod.disable_capsule_capture()
    for mod in (introspection, ref_insp):
        mod.disable_compile_watch()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _feed(reg):
    """The same operations on either package's registry."""
    c = reg.counter("req_total", "Requests \\ served\nby path.",
                    ("path", "code"))
    c.labels("/v1", "200").inc()
    c.labels("/v1", "200").inc(2.5)
    c.labels(path='/x"y', code="5\n00").inc(1e16)
    reg.counter("bare_total").inc(3)
    g = reg.gauge("depth", "Queue depth.", ("engine",))
    g.labels("0").set(7)
    g.labels("1").set(-0.125)
    g.labels("1").dec(2)
    reg.gauge("inf_gauge").set(math.inf)
    h = reg.histogram("lat_seconds", "Latency.", ("engine",),
                      buckets=(0.01, 0.1, 1.0, math.inf))
    for v, n in ((0.005, 1), (0.05, 3), (0.5, 2), (5.0, 1), (0.1, 4)):
        h.labels("0").observe(v, n=n)
    reg.histogram("empty_seconds", "Nothing observed.")
    d = reg.histogram("default_buckets_seconds")
    d.observe(0.3)
    # get-or-create returns the same family
    assert reg.counter("req_total", "", ("path", "code")) is c
    return h


def test_prometheus_text_is_byte_identical_to_the_reference():
    port_reg, ref_reg = metrics.MetricRegistry(), ref_metrics.MetricRegistry()
    ph, rh = _feed(port_reg), _feed(ref_reg)
    assert port_reg.expose_text() == ref_reg.expose_text()
    assert port_reg.snapshot() == ref_reg.snapshot()
    assert port_reg.expose_text().encode() == ref_reg.expose_text().encode()
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert ph.labels("0").quantile(q) == rh.labels("0").quantile(q)
    assert metrics.DEFAULT_BUCKETS == ref_metrics.DEFAULT_BUCKETS
    # the same refusals
    for reg in (port_reg, ref_reg):
        with pytest.raises(ValueError, match="label schema mismatch"):
            reg.counter("req_total", "", ("path",))
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("bare_total").inc(-1)


def test_collect_hooks_run_on_read_and_drop_with_their_owner():
    reg = metrics.MetricRegistry()
    seen = []

    class Owner:
        def fold(self):
            seen.append(1)
            reg.counter("folded_total").inc()

    owner = Owner()
    reg.add_collect_hook(owner.fold)
    assert "folded_total 1" in reg.expose_text()
    assert reg.snapshot()["folded_total"]["values"][""] == 2
    del owner
    reg.expose_text()
    assert len(seen) == 2 and not reg._hooks


def test_jsonl_writer_and_scrape_endpoint(tmp_path):
    reg = metrics.MetricRegistry()
    _feed(reg)
    with obs.JsonlSnapshotWriter(str(tmp_path / "m"), registry=reg) as w:
        w.write(walltime=1.5)
        reg.counter("bare_total").inc()
        w.write(walltime=2.5)
    lines = [json.loads(ln) for ln in
             (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert [r["time"] for r in lines] == [1.5, 2.5]
    assert lines[1]["metrics"] == json.loads(json.dumps(reg.snapshot()))
    assert lines[0]["metrics"]["bare_total"]["values"][""] == 3
    srv = obs.start_metrics_server(port=0, addr="127.0.0.1", registry=reg)
    try:
        assert srv.url == f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            body = r.read().decode()
            ctype = r.headers["Content-Type"]
        assert body == reg.expose_text()
        assert ctype == "text/plain; version=0.0.4; charset=utf-8"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nothing", timeout=10)
    finally:
        srv.shutdown()


def _trace(mod, clock):
    """The same span tree on either package's tracer."""
    tr = mod.enable_tracing(clock=clock, max_spans=8)
    with mod.span("request", attrs={"rid": "r0"}) as root:
        clock.t += 0.5
        with mod.span("engine.prefill_chunk") as ch:
            ch.set_attr("chunk", 0).set_attr("tokens", 8)
            clock.t += 0.25
        held = mod.start_span("queue_wait", activate=False)
        clock.t += 0.125
        held.end()
        headers = mod.inject_headers(root.context(), {"a": "b"})
    ctx = mod.extract_headers(headers)
    clock.t += 1.0
    with mod.span("remote.step", ctx=ctx):
        clock.t += 0.0625
    mod.record_span("fenced_step", 0.5, ctx=ctx, attrs={"n": 1})
    return tr, headers


def test_span_trees_and_chrome_trace_equal_the_reference():
    pt, ph = _trace(tracing, FakeClock())
    rt, rh = _trace(ref_tracing, FakeClock())
    assert ph == rh
    spans = pt.finished_spans()
    assert spans == rt.finished_spans()
    by = {s["name"]: s for s in spans}
    root = by["request"]
    assert root["parent_id"] is None
    for name in ("engine.prefill_chunk", "queue_wait", "remote.step",
                 "fenced_step"):
        assert by[name]["trace_id"] == root["trace_id"]
        assert by[name]["parent_id"] == root["span_id"]
    assert by["engine.prefill_chunk"]["duration"] == 0.25
    assert by["engine.prefill_chunk"]["attrs"] == {"chunk": 0, "tokens": 8}
    assert pt.open_spans() == [] and pt.traces().keys() == {root["trace_id"]}
    assert pt.slow_traces(1.0) == rt.slow_traces(1.0)
    chrome = pt.to_chrome_trace()
    assert chrome == rt.to_chrome_trace()
    json.dumps(chrome)
    for ev in chrome["traceEvents"]:
        assert ev["ph"] == "X" and isinstance(ev["ts"], int)
        assert isinstance(ev["dur"], int) and ev["dur"] >= 0
        assert {"trace_id", "span_id"} <= set(ev["args"])
    # the ring is bounded: evictions are counted
    for _ in range(10):
        tracing.span("x").end()
    assert len(pt.finished_spans()) == 8 and pt.dropped == 7


def test_flight_recorder_dumps_events_and_spans(tmp_path):
    clock = FakeClock()
    tr = tracing.enable_tracing(clock=clock)
    fr = tracing.enable_flight_recorder(path=str(tmp_path / "fr.jsonl"),
                                        clock=clock)
    tracing.record_event("anomaly", metric="loss")
    with tracing.span("engine.mixed_step"):
        pass
    opened = tracing.start_span("engine.swap_out", activate=False)
    with pytest.raises(RuntimeError):
        with fr.guard("fatal"):
            raise RuntimeError("boom")
    lines = [json.loads(ln) for ln in
             (tmp_path / "fr.jsonl").read_text().splitlines()]
    assert lines[0]["type"] == "flight_recorder"
    assert lines[0]["reason"] == "fatal"
    kinds = [ln.get("kind") for ln in lines if ln["type"] == "event"]
    assert kinds == ["anomaly", "error"]
    names = {(ln["name"], ln.get("open", False))
             for ln in lines if ln["type"] == "span"}
    assert names == {("engine.mixed_step", False),
                     ("engine.swap_out", True)}
    assert fr.dump_once("wedge") and fr.dump_once("wedge") is None
    opened.end()
    assert tr.open_spans() == []


def _drive_health(mod, clock):
    hub = mod.HealthHub(clock=clock, enable_metrics=False,
                        sentinel_warmup=3)
    for i, v in enumerate((0.2, 0.4, 1.5, 2.0, 0.05, 0.7)):
        hub.observe_ttft(v)
        hub.observe_tpot(v / 10, n=i + 1)
        clock.t += 7.0
    hub.event("shed_rate", bad=True)
    hub.event("shed_rate", n=9)
    clock.t += 30.0
    hub.observe_ttft(3.0)
    for v in (1.0, 1.0, 1.0, 1.01, 50.0):
        hub.sentinel_check(step=int(clock.t), loss=v)
    return hub


def test_health_windows_and_burn_rates_equal_the_reference():
    pc, rc = FakeClock(), FakeClock()
    ph, rh = _drive_health(health, pc), _drive_health(ref_health, rc)
    for which in ("ttft", "tpot"):
        for q in (0.5, 0.9, 0.95, 0.99):
            assert ph.windows[which].quantile(q) == \
                rh.windows[which].quantile(q)
    for name in ("ttft", "tpot", "shed_rate", "error_rate"):
        for which in ("fast", "slow"):
            assert ph.slo.burn_rate(name, which) == \
                rh.slo.burn_rate(name, which)
    assert ph.slo.status() == rh.slo.status()
    snap = ph.snapshot()
    want = rh.snapshot()
    assert snap["windows"] == want["windows"]
    assert snap["sentinel"]["trips"] == want["sentinel"]["trips"]
    assert [t["reason"] for t in snap["sentinel"]["trips"]][0] \
        .startswith("ewma_spike")
    # a window past its span forgets
    pc.t += 10_000.0
    assert ph.windows["ttft"].quantile(0.5) is None
    assert ph.slo.burn_rate("ttft") is None
    # the merge helper and the goodput meter
    snaps = [ref_metrics.Histogram("h", buckets=(0.1, 1.0))
             for _ in range(2)]
    snaps[0].observe(0.05, n=3)
    snaps[1].observe(0.5, n=2)
    parts = [s.snapshot() for s in snaps]
    assert health.merge_histogram_snapshots(parts) == \
        ref_health.merge_histogram_snapshots(parts)
    gc = FakeClock()
    gm = health.GoodputMeter(clock=gc)
    gm.start()
    with gm.region("productive_step"):
        gc.t += 3.0
    gc.t += 1.0
    frac = gm.report()["fractions"]
    assert frac["productive_step"] == 0.75 and frac["other"] == 0.25


def test_null_singletons_cost_one_global_read():
    assert tracing.span("engine.mixed_step") is tracing.NULL_SPAN
    assert tracing.start_span("x") is tracing.NULL_SPAN
    assert tracing.NULL_SPAN.set_attr("a", 1) is tracing.NULL_SPAN
    assert tracing.current_context() is None
    assert health.get_health() is health.NULL_HEALTH
    assert health.goodput_region("compile") is health.NULL_REGION
    assert capsule.get_capsule_store() is capsule.NULL_CAPSULE_STORE
    assert introspection.get_compile_watch() is \
        introspection.NULL_COMPILE_WATCH
    for null in (tracing.NULL_SPAN, health.NULL_HEALTH,
                 capsule.NULL_CAPSULE_STORE,
                 introspection.NULL_COMPILE_WATCH):
        assert type(null).__slots__ == ()
    with profiler.RecordEvent("llm_engine.decode") as ev:
        assert ev._span is None
    tr = tracing.enable_tracing()
    with profiler.RecordEvent("llm_engine.decode"):
        pass
    assert [s["name"] for s in tr.finished_spans()] == ["llm_engine.decode"]
    tracing.disable_tracing()
    assert tracing.span("x") is tracing.NULL_SPAN


def test_compile_plane_records_no_compiles():
    assert introspection.watched_call("engine.mixed_step", max, 3, 4) == 4
    assert introspection.compilez_snapshot() == {
        "enabled": False, "note": "eager: no compiled programs"}
    w = introspection.enable_compile_watch(on_recompile="raise",
                                           enable_metrics=False)
    w.register_program("engine.prefill_chunk")
    assert w.call("engine.prefill_chunk", min, (3, 4), {}) == 3
    snap = introspection.compilez_snapshot()
    assert snap["note"] == "eager: no compiled programs"
    assert snap["programs"]["engine.prefill_chunk"]["compiles"] == 0
    w.record_compile("engine.prefill_chunk", signature="f32[8]")
    with pytest.raises(introspection.RecompileError):
        w.record_compile("engine.prefill_chunk", signature="f32[9]")
    sig = introspection.abstract_signature(
        (torch.zeros(2, 3), [torch.zeros(4, dtype=torch.int32), 5]),
        {"eps": 1e-5})
    assert sig == "f32[2,3],i32[4],5,eps=1e-05"


class _Pool:
    def __init__(self, dev, host):
        self.rows = {"device_bytes": dev, "host_bytes": host}

    def memory_rows(self):
        return self.rows


def test_memory_plane_reads_the_named_device():
    a, b = _Pool(100, 7), _Pool(50, 0)
    introspection.register_memory_consumer("kv_cache:test_a", a)
    introspection.register_memory_consumer("kv_cache:test_b", b)
    rows = introspection.device_memory_rows("cpu")
    assert rows == [{"device": "cpu", "bytes_in_use": None,
                     "peak_bytes_in_use": None, "bytes_limit": None,
                     "bytes_free": None,
                     "note": "CPU: no device allocator to read"}]
    brief = introspection.memory_brief("cpu")
    assert brief["devices"] == rows
    memz = introspection.memz_snapshot("cpu")
    assert memz["consumers"]["kv_cache:test_a"] == a.rows
    tops = [t["name"] for t in memz["top_consumers"]]
    assert tops.index("kv_cache:test_a") < tops.index("kv_cache:test_b")
    del a
    assert "kv_cache:test_a" not in introspection.memory_consumers()
    with pytest.raises(ValueError, match="memory_rows"):
        introspection.register_memory_consumer("bad", object())
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError, match="device='cpu'"):
            introspection.device_memory_rows()


def test_profiler_schedule_session_and_chrome_export(tmp_path):
    sched = profiler.make_scheduler(closed=1, ready=1, record=2, repeat=2,
                                    skip_first=1)
    ref = ref_make_scheduler(closed=1, ready=1, record=2, repeat=2,
                             skip_first=1)
    assert [sched(i).name for i in range(12)] == \
        [ref(i).name for i in range(12)]
    tr = tracing.enable_tracing()
    p = profiler.Profiler(
        scheduler=profiler.make_scheduler(closed=1, ready=0, record=2),
        on_trace_ready=profiler.export_chrome_tracing(str(tmp_path),
                                                      "w0"))
    p.start()
    for _ in range(3):
        with profiler.RecordEvent("llm_engine.decode"):
            torch.ones(4).add_(1)
        p.step()
    p.stop()
    assert len(p._sessions) == 1
    names = {e.key for e in p._sessions[0].key_averages()}
    assert "llm_engine.decode" in names
    steps = profiler.load_profiler_result(
        str(tmp_path / "steps.chrome_trace.json"))["traceEvents"]
    # stop() closes the interval since the last step() as a step too
    assert [e["name"] for e in steps if e["tid"] == 0] == \
        ["step 0", "step 1", "step 2", "step 3"]
    assert sum(e["name"] == "llm_engine.decode" and e["tid"] == 1
               for e in steps) == 3
    assert sum(e["tid"] == 2 for e in steps) == len(tr.finished_spans())
    assert (tmp_path / "w0.torch.0.chrome_trace.json").exists()
    assert "step time (ms)" in p.summary()
