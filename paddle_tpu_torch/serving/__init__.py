"""``paddle_tpu_torch.serving`` — the runtime between user traffic and
the port's ``LLMEngine`` (counterpart of ``paddle_tpu/serving/``).

All of it is host code (threads, heaps, ``http.server``, JSON) kept
as the reference's, line for line where it can be: the engine is the
only device code under it, and every device launch happens inside
``LLMEngine.step`` on the thread that drives the scheduler.  Layers,
composable bottom-up:

* ``Scheduler`` — continuous-batching loop over ONE engine: bounded
  priority queue, capacity-checked admission (a full KV cache queues
  instead of raising), priority preemption (a strictly-higher-priority
  waiter evicts the lowest-priority active request; its KV swaps to
  the host pool or recomputes at resume, tokens stay equal), opt-in
  bin-packing admission around a blocked head with an aging
  starvation bound, deadlines / max-queue-time with deadline-miss
  accounting, load shedding (``RejectedError``), cancellation,
  graceful drain, and per-request MIGRATION (``migrate_out`` /
  ``migrate_in`` move a live request — KV swap state included —
  between schedulers).  Adds policy, never math: tokens equal those
  of driving the engine directly in the same admission order.
* ``ReplicaRouter`` — least-loaded routing across N replicas
  (in-process schedulers or remote backends) with per-replica circuit
  breaking, retry-with-backoff failover, dead-replica EJECTION with
  requeue, KV-migrating ``drain_replica``, and a fault-injection
  hook.
* ``RemoteReplica`` / ``HealthProber`` (serving/transport.py) — the
  multi-host tier: an HTTP client adapter that drives a per-host
  backend through the same duck-typed replica surface (per-call
  timeouts, bounded backoff + jitter, idempotent rid-keyed
  resubmission), and an active prober that feeds the router's
  circuit breaker — slow opens the circuit, dead ejects + requeues.
* ``Fault`` / ``FaultPlan`` (serving/faults.py) — structured chaos:
  scheduled refuse / timeout / slow / disconnect / crash injections
  at the transport seam (and, via ``router_hook``, the router seam).
* ``HTTPFrontend`` / ``start_http_frontend`` — stdlib streaming HTTP:
  ``POST /v1/completions`` (chunked per-step token streaming), the
  ``/v1/*`` control plane the remote transport drives,
  ``GET /healthz`` (503 when draining/wedged), ``GET /metrics``
  (Prometheus text via the observability registry), and
  ``GET /fleetz`` (the federated fleet health page built from
  ``ReplicaRouter.fleet_snapshot()``).
* ``FleetWatcher`` (serving/autopilot.py) — the rebalancing policy
  loop: reads burn rates and load skew from ``fleet_snapshot()`` and
  acts through the router's own actuators (``mark_slow`` /
  ``drain_replica`` / ``reinstate``) with hysteresis and a bounded
  action rate.

All layers report through the port's process-global
``MetricRegistry`` under the reference's series names — one
``/metrics`` scrape covers the stack.  Threads keep the reference's
names (``paddle-tpu-serving-http`` / ``-sched`` / ``-prober``,
``paddle-tpu-watcher``).
"""
from .scheduler import RejectedError, ScheduledRequest, Scheduler
from .router import ReplicaRouter
from .server import HTTPFrontend, start_http_frontend
from .transport import (HealthProber, RemoteReplica, TransportError,
                        TransportTimeout)
from .faults import Fault, FaultInjected, FaultPlan
from .autopilot import FleetWatcher

__all__ = ["Scheduler", "ScheduledRequest", "RejectedError",
           "ReplicaRouter", "HTTPFrontend", "start_http_frontend",
           "RemoteReplica", "HealthProber", "TransportError",
           "TransportTimeout", "Fault", "FaultPlan", "FaultInjected",
           "FleetWatcher"]
