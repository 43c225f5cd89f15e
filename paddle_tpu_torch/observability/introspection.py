"""Compile & memory introspection plane (counterpart of
``paddle_tpu/observability/introspection.py``).

The reference builds this plane on XLA's one-program-per-shape
invariant: every jit entry point registers with a ``CompileWatch`` and a
compile past its warmup allowance is flagged as a recompile.  The port
runs eager PyTorch: nothing is traced or compiled, and its CUDA kernels
are built once per process from ``csrc/`` by ``ops/_build.py``.  So:

* ``CompileWatch`` keeps the reference's API (``register_program``,
  ``call``, ``record_compile``, ``snapshot``) and observes no compiles:
  ``call`` runs the function, and only an explicit ``record_compile``
  adds a record.
* ``watched_call(program, fn, *args)`` calls ``fn``.
* ``compilez_snapshot()`` says so: ``"eager: no compiled programs"``.

The memory plane is real.  ``register_memory_consumer`` keeps weak
references to pools with a ``memory_rows()`` method (the paged KV cache,
its host swap pool); ``device_memory_rows(device)`` reads the card's
allocator through ``torch.cuda.memory_stats`` and
``torch.cuda.mem_get_info``, or returns one explicit CPU row when the
caller passes ``device="cpu"``.  Without a device and without that
request it raises (``runtime/device.py``'s rule): nothing reports an
empty device table in silence.  ``memory_brief`` and ``memz_snapshot``
combine the two.

Disabled is free, as in ``tracing.py`` and ``health.py``:
``get_compile_watch()`` returns the shared ``NULL_COMPILE_WATCH`` when
the watch is off.
"""
from __future__ import annotations

import os
import threading
import time
import traceback
import warnings
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

from ..common.errors import enforce
from . import tracing as _tracing
from .metrics import get_registry

__all__ = [
    "CompileWatch", "RecompileError", "NULL_COMPILE_WATCH",
    "enable_compile_watch", "disable_compile_watch",
    "get_compile_watch", "watched_call", "abstract_signature",
    "register_memory_consumer", "memory_consumers",
    "device_memory_rows", "memory_brief", "compilez_snapshot",
    "memz_snapshot", "EAGER_NOTE",
]

EAGER_NOTE = "eager: no compiled programs"


class RecompileError(RuntimeError):
    """A program recorded past its allowance under the ``raise``
    policy."""


# -- abstract signatures ------------------------------------------------------

_DTYPE_SHORT = {
    "float64": "f64", "float32": "f32", "float16": "f16",
    "bfloat16": "bf16", "int64": "i64", "int32": "i32",
    "int16": "i16", "int8": "i8", "uint32": "u32", "uint8": "u8",
    "bool": "b1",
}


def _leaf_sig(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype).replace("torch.", "")
        short = _DTYPE_SHORT.get(name, name)
        return f"{short}[{','.join(str(int(d)) for d in shape)}]"
    if isinstance(x, (bool, int, float, str)):
        return repr(x)
    return type(x).__name__


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    else:
        yield x


def abstract_signature(args: tuple, kwargs: dict,
                       limit: int = 2048) -> str:
    """One ``dtype[shape]`` token per tensor leaf of ``args``, scalars
    and strings verbatim, then ``k=...`` for each keyword."""
    parts = [_leaf_sig(leaf) for leaf in _leaves(args)]
    for k in sorted(kwargs):
        parts.append(f"{k}={_leaf_sig(kwargs[k])}")
    sig = ",".join(parts)
    return sig if len(sig) <= limit else sig[:limit - 3] + "..."


def _call_site() -> Optional[str]:
    """The innermost stack frame outside this module."""
    try:
        here = os.path.basename(__file__)
        for fr in reversed(traceback.extract_stack()):
            base = os.path.basename(fr.filename or "")
            if base != here:
                return f"{base}:{fr.lineno} ({fr.name})"
    except Exception:
        pass
    return None


# -- the watch ----------------------------------------------------------------

class CompileWatch:
    """The enabled plane, with the reference's surface.  Eager PyTorch
    compiles nothing, so ``call`` records nothing; ``record_compile``
    takes explicit records (and applies the recompile policy to them:
    ``"warn"``, or ``"raise"`` / ``"halt"``)."""

    POLICIES = ("warn", "raise", "halt")
    enabled = True

    def __init__(self, on_recompile: str = "warn",
                 log_limit: int = 256, enable_metrics: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        enforce(on_recompile in self.POLICIES,
                f"on_recompile {on_recompile!r} not in {self.POLICIES}")
        self.on_recompile = on_recompile
        self._clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._programs: Dict[str, dict] = {}
        self._log: deque = deque(maxlen=int(log_limit))
        self._recompiles: List[dict] = []
        self._subprograms: Dict[str, dict] = {}
        self._peaks: Dict[str, int] = {}      # device -> peak bytes seen
        self._metrics = None
        if enable_metrics:
            reg = get_registry()
            self._metrics = {
                "compiles": reg.counter(
                    "jit_compile_events_total",
                    "Compilation events the CompileWatch observed, "
                    "by program name (none in eager PyTorch).",
                    ("program",)),
                "recompiles": reg.counter(
                    "jit_recompile_events_total",
                    "Recorded compiles past the program's allowance.",
                    ("program",)),
                "seconds": reg.counter(
                    "jit_compile_seconds_total",
                    "Wall time of recorded compiles.", ("program",)),
                "peak": reg.gauge(
                    "device_memory_peak_bytes",
                    "Peak device bytes-in-use the memory plane has "
                    "seen (watermark).", ("device",)),
                "pool": reg.gauge(
                    "memory_pool_bytes",
                    "Bytes held by a first-class memory pool (paged "
                    "KV, host swap).", ("pool",)),
            }

    def register_program(self, program: str, expected: int = 1):
        """Declare an entry point and its allowance of recorded
        compiles."""
        with self._lock:
            st = self._program_locked(program)
            st["allowed"] += max(0, int(expected))

    def _program_locked(self, program: str) -> dict:
        st = self._programs.get(program)
        if st is None:
            st = {"compiles": 0, "recompiles": 0, "allowed": 0,
                  "seconds": 0.0, "last": None}
            self._programs[program] = st
        return st

    def note_subprogram(self, name: str, **meta):
        with self._lock:
            if name in self._subprograms:
                self._subprograms[name]["traces"] += 1
                return
            self._subprograms[name] = dict(meta, traces=1)
            self._log.append({"kind": "subprogram", "program": name,
                              **meta})

    def call(self, program: str, fn, args: tuple, kwargs: dict):
        """Run one dispatch.  Nothing compiles in eager PyTorch, so
        nothing is recorded."""
        return fn(*args, **kwargs)

    def record_compile(self, program: str,
                       signature: Optional[str] = None,
                       seconds: float = 0.0, cost: Optional[dict] = None,
                       memory: Optional[dict] = None,
                       call_site: Optional[str] = None, **_):
        """One explicit compilation record; past the program's
        allowance it counts as a recompile (event, flight-recorder dump,
        then the policy)."""
        site = call_site if call_site is not None else _call_site()
        rec = {"kind": "compile", "program": program,
               "signature": signature, "seconds": round(seconds, 6),
               "cost": cost, "memory": memory, "call_site": site}
        with self._lock:
            st = self._program_locked(program)
            st["compiles"] += 1
            st["seconds"] += seconds
            st["last"] = {k: rec[k] for k in
                          ("signature", "seconds", "cost", "memory",
                           "call_site")}
            is_recompile = st["compiles"] > max(1, st["allowed"])
            if is_recompile:
                st["recompiles"] += 1
                n_recompiles = st["recompiles"]
            self._log.append(rec)
        if self._metrics is not None:
            self._metrics["compiles"].labels(program).inc()
            self._metrics["seconds"].labels(program).inc(
                max(0.0, seconds))
        from . import health as _health
        _health.get_health().goodput.attribute(
            "compile", program, seconds)
        if not is_recompile:
            return
        event = {"program": program, "signature": signature,
                 "seconds": round(seconds, 6), "call_site": site,
                 "n": n_recompiles}
        with self._lock:
            self._recompiles.append(event)
        if self._metrics is not None:
            self._metrics["recompiles"].labels(program).inc()
        _tracing.record_event("recompile", **event)
        fr = _tracing.get_flight_recorder()
        if fr is not None:
            try:
                fr.dump_once(f"recompile:{program}:{n_recompiles}")
            except Exception:
                pass
        msg = (f"recompile of program {program!r} (signature "
               f"{signature!r}, call site {site})")
        if self.on_recompile in ("raise", "halt"):
            raise RecompileError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def track_devices(self, rows: List[dict]) -> List[dict]:
        """Fold device rows into the peak watermarks and publish the
        gauges; returns the rows with ``tracked_peak_bytes``."""
        with self._lock:
            for row in rows:
                dev = str(row.get("device"))
                cur = int(row.get("bytes_in_use") or 0)
                reported_peak = int(row.get("peak_bytes_in_use") or 0)
                peak = max(self._peaks.get(dev, 0), cur, reported_peak)
                self._peaks[dev] = peak
                row["tracked_peak_bytes"] = peak
        if self._metrics is not None:
            for row in rows:
                self._metrics["peak"].labels(str(row["device"])).set(
                    float(row["tracked_peak_bytes"]))
        return rows

    def set_pool_gauge(self, pool: str, nbytes: float):
        if self._metrics is not None:
            self._metrics["pool"].labels(pool).set(float(nbytes))

    def program_memory(self) -> Dict[str, dict]:
        with self._lock:
            return {name: dict(st["last"]["memory"])
                    for name, st in self._programs.items()
                    if st["last"] and st["last"].get("memory")}

    def snapshot(self, include_log: bool = True) -> dict:
        """The ``/compilez`` payload: the per-program table (registered
        programs with 0 compiles in eager PyTorch), recorded recompiles,
        and the note saying why."""
        with self._lock:
            programs = {
                name: {"compiles": st["compiles"],
                       "recompiles": st["recompiles"],
                       "allowed": max(1, st["allowed"]),
                       "compile_seconds": round(st["seconds"], 6),
                       "last": st["last"]}
                for name, st in sorted(self._programs.items())}
            out = {"enabled": True, "policy": self.on_recompile,
                   "note": EAGER_NOTE, "programs": programs,
                   "recompiles": list(self._recompiles),
                   "subprograms": {k: dict(v) for k, v in
                                   self._subprograms.items()}}
            if include_log:
                out["log"] = list(self._log)
        return out


class _NullCompileWatch:
    """The disabled plane: one shared instance, every method a no-op."""

    __slots__ = ()

    enabled = False

    def register_program(self, program, expected=1):
        pass

    def note_subprogram(self, name, **meta):
        pass

    def record_compile(self, program, **kw):
        pass

    def call(self, program, fn, args, kwargs):
        return fn(*args, **kwargs)

    def snapshot(self, include_log=True):
        return {"enabled": False, "note": EAGER_NOTE}


NULL_COMPILE_WATCH = _NullCompileWatch()

_WATCH: Optional[CompileWatch] = None


def enable_compile_watch(**kw) -> CompileWatch:
    """Install the process-global CompileWatch."""
    global _WATCH
    _WATCH = CompileWatch(**kw)
    return _WATCH


def disable_compile_watch() -> None:
    global _WATCH
    _WATCH = None


def get_compile_watch():
    """The active watch, or the shared ``NULL_COMPILE_WATCH``."""
    w = _WATCH
    return w if w is not None else NULL_COMPILE_WATCH


def watched_call(program: str, fn, *args, **kwargs):
    """The reference's dispatch wrapper: eager PyTorch compiles nothing,
    so it calls ``fn``."""
    return fn(*args, **kwargs)


# -- the memory plane ---------------------------------------------------------

# name -> weakref to an object with memory_rows() -> dict (with
# "device_bytes" and "host_bytes")
_CONSUMERS: Dict[str, "weakref.ref"] = {}
_CONSUMERS_LOCK = threading.Lock()


def register_memory_consumer(name: str, obj) -> None:
    """Register a live memory pool for ``/memz``, weakly held: when the
    owner is collected its row goes.  Re-registering a name replaces
    the old reference."""
    enforce(hasattr(obj, "memory_rows"),
            f"memory consumer {name!r} must expose memory_rows()")
    with _CONSUMERS_LOCK:
        _CONSUMERS[name] = weakref.ref(obj)


def memory_consumers() -> Dict[str, dict]:
    """Live consumer rows; dead references are pruned on read."""
    out: Dict[str, dict] = {}
    with _CONSUMERS_LOCK:
        items = list(_CONSUMERS.items())
    dead = []
    for name, ref in items:
        obj = ref()
        if obj is None:
            dead.append(name)
            continue
        try:
            out[name] = dict(obj.memory_rows())
        except Exception as e:
            out[name] = {"error": str(e), "device_bytes": 0,
                         "host_bytes": 0}
    if dead:
        with _CONSUMERS_LOCK:
            for name in dead:
                if name in _CONSUMERS and _CONSUMERS[name]() is None:
                    del _CONSUMERS[name]
    return out


def device_memory_rows(device=None) -> List[dict]:
    """One row per CUDA device from the caching allocator
    (``torch.cuda.memory_stats``: bytes allocated now and at peak) and
    the driver (``torch.cuda.mem_get_info``: free and total bytes).
    ``device="cpu"`` returns one explicit CPU row: the CPU has no device
    allocator to read, so the consumer rows are the whole account.  The
    default (``None``) means the GPU and raises without one."""
    import torch

    from ..runtime.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [{"device": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None,
                 "bytes_free": None,
                 "note": "CPU: no device allocator to read"}]
    rows = []
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        rows.append({
            "device": f"cuda:{i}",
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak",
                                            0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current",
                                         0)),
            "bytes_limit": int(total), "bytes_free": int(free)})
    return rows


def _staging_row() -> dict:
    """Checkpoint staging (the reference's atomic-commit directories):
    the port has no checkpoint writer yet, so the row is empty."""
    return {"dirs": 0, "bytes": 0}


def memory_brief(device=None) -> dict:
    """Per-pool byte totals and the device rows (``device`` as in
    ``device_memory_rows``)."""
    consumers = memory_consumers()
    device_pool = sum(int(r.get("device_bytes") or 0)
                      for r in consumers.values())
    host_pool = sum(int(r.get("host_bytes") or 0)
                    for r in consumers.values())
    per_shard = sum(int(r.get("device_bytes_per_shard",
                              r.get("device_bytes")) or 0)
                    for r in consumers.values())
    out = {"device_pool_bytes": device_pool,
           "device_pool_bytes_per_shard": per_shard,
           "host_pool_bytes": host_pool,
           "checkpoint_staging": _staging_row()}
    devices = device_memory_rows(device)
    w = _WATCH
    if w is not None:
        devices = w.track_devices(devices)
        w.set_pool_gauge("kv_pool", device_pool)
        w.set_pool_gauge("host_swap", host_pool)
    out["devices"] = devices
    return out


def memz_snapshot(device=None) -> dict:
    """The ``/memz`` payload: device rows, every consumer's rows, and
    the consumers by total footprint."""
    consumers = memory_consumers()
    devices = device_memory_rows(device)
    w = _WATCH
    if w is not None:
        devices = w.track_devices(devices)
    totals = {name: int(r.get("device_bytes") or 0) +
              int(r.get("host_bytes") or 0)
              for name, r in consumers.items()}
    top = sorted(totals.items(), key=lambda t: -t[1])
    out = {"watch_enabled": w is not None,
           "devices": devices,
           "consumers": consumers,
           "checkpoint_staging": _staging_row(),
           "top_consumers": [{"name": n, "bytes": b} for n, b in top]}
    if w is not None:
        w.set_pool_gauge("kv_pool", sum(
            int(r.get("device_bytes") or 0) for r in consumers.values()))
        w.set_pool_gauge("host_swap", sum(
            int(r.get("host_bytes") or 0) for r in consumers.values()))
        out["per_program"] = w.program_memory()
    return out


def compilez_snapshot() -> dict:
    """The ``/compilez`` payload: ``{"enabled": False, "note": ...}``
    with the watch off, its snapshot with it on."""
    w = _WATCH
    if w is None:
        return {"enabled": False, "note": EAGER_NOTE}
    return w.snapshot(include_log=True)
