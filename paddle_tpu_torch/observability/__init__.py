"""paddle_tpu_torch.observability — serving telemetry (counterpart of
``paddle_tpu/observability``).

- :mod:`~.metrics` — Counter/Gauge/Histogram and the process-global
  ``MetricRegistry`` the engine and the paged KV cache report into.
- :mod:`~.exposition` — the Prometheus text scrape endpoint
  (``start_metrics_server``) and JSONL snapshots
  (``JsonlSnapshotWriter``).
- :mod:`~.tracing` — request/step span tracing (``Tracer``, trace
  context through HTTP headers, Chrome-trace export) and the crash
  ``FlightRecorder``.  Disabled tracing costs one global read: every
  site gets the shared ``NULL_SPAN``.
- :mod:`~.health` — ``SlidingWindow`` views, ``SLOTracker`` burn rates,
  ``GoodputMeter``, ``AnomalySentinel`` and the histogram merge helper;
  ``get_health()`` returns ``NULL_HEALTH`` when the plane is off.
- :mod:`~.introspection` — the memory plane (the KV pools as weakly
  held consumers, the card's allocator rows) and the compile plane,
  which in eager PyTorch records no compiles.
- :mod:`~.capsule` — request capsules (``CapsuleStore``), bit-exact
  ``replay_capsule`` through the port engine, ``divergence_audit``;
  ``get_capsule_store()`` returns ``NULL_CAPSULE_STORE`` when off.

The metrics, exposition, tracing and health modules are stdlib only and
the reference's code; the engine's instrumentation
(``inference/engine.py``) surfaces through ``LLMEngine.metrics_snapshot()``
and the registry.  The training ``StepTimer`` is not ported.
"""
from .metrics import (Counter, Gauge, Histogram, MetricRegistry,
                      DEFAULT_BUCKETS, get_registry)
from .exposition import (JsonlSnapshotWriter, MetricsServer,
                         start_metrics_server)
from .tracing import (FlightRecorder, Span, Tracer, disable_tracing,
                      enable_flight_recorder, enable_tracing,
                      get_flight_recorder, get_tracer)
from .health import (SLO, AnomalySentinel, GoodputMeter, HealthHub,
                     SlidingWindow, SLOTracker, disable_health,
                     enable_health, get_health, goodput_region,
                     merge_histogram_snapshots)
from .introspection import (CompileWatch, RecompileError,
                            compilez_snapshot, device_memory_rows,
                            disable_compile_watch, enable_compile_watch,
                            get_compile_watch, memory_brief,
                            memory_consumers, memz_snapshot,
                            register_memory_consumer, watched_call)
from .capsule import (CapsuleStore, NULL_CAPSULE_STORE,
                      disable_capsule_capture, divergence_audit,
                      enable_capsule_capture, get_capsule_store,
                      model_fingerprint, replay_capsule)
from . import capsule
from . import health
from . import introspection
from . import tracing

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "DEFAULT_BUCKETS", "get_registry", "JsonlSnapshotWriter",
           "MetricsServer", "start_metrics_server", "Span", "Tracer",
           "FlightRecorder", "enable_tracing", "disable_tracing",
           "get_tracer", "enable_flight_recorder", "get_flight_recorder",
           "tracing", "SlidingWindow", "SLO", "SLOTracker",
           "GoodputMeter", "AnomalySentinel", "HealthHub",
           "enable_health", "disable_health", "get_health",
           "goodput_region", "merge_histogram_snapshots", "health",
           "CompileWatch", "RecompileError", "enable_compile_watch",
           "disable_compile_watch", "get_compile_watch", "watched_call",
           "register_memory_consumer", "memory_consumers",
           "device_memory_rows", "memory_brief", "memz_snapshot",
           "compilez_snapshot", "introspection", "CapsuleStore",
           "NULL_CAPSULE_STORE", "enable_capsule_capture",
           "disable_capsule_capture", "get_capsule_store",
           "model_fingerprint", "replay_capsule", "divergence_audit",
           "capsule"]
