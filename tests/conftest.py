"""tests/ conftest: fleet/mesh state is torn down after every test so
topology-building tests can't leak meshes into each other; a
thread-leak guard keeps the serving tier's HTTP servers / probers /
loop threads — the checkpoint tier's ``paddle-tpu-ckpt-writer``
async-save threads and the autopilot's ``paddle-tpu-watcher`` policy
loop included (every serving-tier thread carries the ``paddle-tpu-``
name prefix precisely so this guard sees it) — from outliving their
test (a leaked loop thread is
how a tier-1 run hangs on a 1-core box); and a staging-dir guard fails
any test that leaves ``*.tmp-<nonce>`` checkpoint staging dirs behind
(an un-swept torn save — call ``CheckpointManager.gc_stale()`` or do a
recovery save before returning).  The CompileWatch global is likewise
reset after every test (mirroring the tracer/health guards inside
observability tests): a watch left enabled would count every later
test's compiles against ITS warmup allowances and trip the recompile
sentinel on innocent tests."""
import threading
import time

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running (trace capture, big compiles) — excluded "
        "from the tier-1 `-m 'not slow'` run")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's kernels) — skips "
        "on a machine without one")


def requires_mesh(n):
    """Skip marker for tests that need ``n`` devices for a tp mesh
    (``from conftest import requires_mesh``).

    The root conftest forces an 8-device CPU platform
    (``--xla_force_host_platform_device_count=8``), so any tp <= 8
    normally runs everywhere; the guard only fires when an environment
    overrides XLA_FLAGS down to fewer host devices.
    """
    import jax

    return pytest.mark.skipif(
        len(jax.devices()) < n,
        reason=f"needs >= {n} devices for a tp={n} mesh",
    )


@pytest.fixture(autouse=True)
def _reset_fleet_state():
    yield
    from paddle_tpu.distributed import fleet
    fleet.reset()


@pytest.fixture(autouse=True)
def _no_thread_leaks():
    """Assert no non-daemon thread — and no paddle-tpu-named serving
    thread (HTTP server, scheduler loop, prober), daemon or not —
    survives the test.  Leaked threads are given a short grace period
    to finish joining (ThreadingHTTPServer handler threads wind down
    asynchronously after shutdown())."""
    before = {t.ident for t in threading.enumerate()}
    yield

    def leaked():
        return [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive() and
                (not t.daemon or t.name.startswith("paddle-tpu-"))]

    deadline = time.monotonic() + 10.0
    while leaked() and time.monotonic() < deadline:
        time.sleep(0.05)
    left = leaked()
    assert not left, (
        f"threads leaked past the test: "
        f"{[(t.name, 'daemon' if t.daemon else 'non-daemon') for t in left]} "
        f"— shut down frontends/probers (fe.shutdown(), prober.stop()) "
        f"before returning")


@pytest.fixture(autouse=True)
def _reset_compile_watch():
    """Disable the process-global CompileWatch after every test — the
    same guard the tracing/health planes get inside their own test
    files, but process-global here because EVERY test that builds an
    engine or train step registers programs with whatever watch is
    live.  Without this, one test's enabled watch inherits the next
    test's compiles and its sentinel assertions become order-dependent."""
    yield
    from paddle_tpu.observability import introspection as _insp
    _insp.disable_compile_watch()


@pytest.fixture(autouse=True)
def _reset_capsule_store():
    """Disable the process-global CapsuleStore after every test — the
    same process-global hygiene as ``_reset_compile_watch``: every
    engine admission consults the live store, so one test's enabled
    capture would otherwise record the next test's requests and its
    counter/identity assertions become order-dependent."""
    yield
    from paddle_tpu.observability import capsule as _cap
    _cap.disable_capsule_capture()


@pytest.fixture(autouse=True)
def _decode_window_zero_recompiles(request):
    """Scanned-window tests (the ``decode_window`` and
    ``speculative`` suites) must leave ZERO
    ``jit_recompile_events_total`` on the warm engine: the on-device
    window's power-of-two buckets — and the speculative draft /
    verify programs — are DECLARED CompileWatch allowances, so any
    recompile such a test provokes is an anomaly
    — asserted here, after the test body but before
    ``_reset_compile_watch`` disables the watch (this fixture is
    declared later, so its teardown runs first).  Scoped by nodeid so
    tests that exercise recompiles ON PURPOSE (test_introspection)
    stay out of its jurisdiction."""
    yield
    if "decode_window" not in request.node.nodeid and \
            "speculative" not in request.node.nodeid:
        return
    from paddle_tpu.observability.introspection import get_compile_watch
    snap = get_compile_watch().snapshot()
    if not snap.get("enabled"):
        return
    assert not snap["recompiles"], (
        f"scanned-window test left recompile events on the warm "
        f"engine: {snap['recompiles']} — a window bucket escaped its "
        f"registered allowance")


@pytest.fixture(autouse=True)
def _no_ckpt_staging_leaks():
    """Fail any test that leaves a live ``*.tmp-<nonce>`` checkpoint
    staging dir on disk: an uncommitted save the test neither swept
    (``CheckpointManager.gc_stale()``) nor recovered with a follow-up
    save.  The registry is cleared either way so one leak can't cascade
    into every later test."""
    yield
    from paddle_tpu.distributed import checkpoint as _ckpt
    left = _ckpt.staging_dirs_alive()
    for p in left:
        _ckpt._untrack_staging(p)
    assert not left, (
        f"checkpoint staging dirs leaked past the test: {left} — a "
        f"crashed/failed save was never swept (gc_stale) or recovered "
        f"(follow-up save)")
