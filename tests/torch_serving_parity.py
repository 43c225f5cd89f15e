"""Shared harness of the serving runtime's parity tests
(``test_torch_serving.py``, ``test_torch_preempt_sched.py``,
``test_torch_transport.py``, ``test_torch_autopilot.py``).

A test writes one script against a ``Side``: the serving package, the
engine factory, the error types and the metric registry of either the
reference (``paddle_tpu.serving`` over its JAX engine) or the port
(``paddle_tpu_torch.serving`` over its engine on the CPU).  ``both``
runs the script on the reference and then on the port, each with a
fresh ``FakeClock``, and asserts that what the two return is equal once
``norm`` has dropped what cannot be equal: object ids (scheduler,
router, engine, trace), compile counters (the port compiles nothing)
and the engine's TTFT/TPOT histograms (timed on the host's own clock).
The tiny Llama's weights are the reference's, carried into the port by
``load_raw_state_dict``; both models are built once per process.
"""
import numpy as np

import paddle_tpu as paddle
from paddle_tpu import serving as ref_serving
from paddle_tpu.common import errors as ref_errors
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.observability import capsule as ref_capsule
from paddle_tpu.observability import health as ref_health
from paddle_tpu.observability import introspection as ref_insp
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.observability import tracing as ref_tracing

from paddle_tpu_torch import serving as port_serving
from paddle_tpu_torch.common import errors as port_errors
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.observability import capsule as port_capsule
from paddle_tpu_torch.observability import health as port_health
from paddle_tpu_torch.observability import introspection as port_insp
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.observability import tracing as port_tracing

GEOM = dict(max_seqs=4, max_len=64, page_size=8)
NOSLEEP = lambda s: None                       # noqa: E731

_MODELS = {}


def models():
    """(reference model, port model), the same weights, built once."""
    if not _MODELS:
        paddle.seed(0)
        ref = RefLlama(ref_tiny_config())
        ref.eval()
        port = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        load_raw_state_dict(port, {k: np.asarray(v) for k, v in
                                   ref.raw_state_dict().items()})
        _MODELS["m"] = (ref, port)
    return _MODELS["m"]


def reset_planes():
    """Every process-global plane of both packages back to off."""
    for mod in (port_tracing, ref_tracing):
        mod.disable_tracing()
        mod.disable_flight_recorder()
    for mod in (port_health, ref_health):
        mod.disable_health()
    for mod in (port_capsule, ref_capsule):
        mod.disable_capsule_capture()
    for mod in (port_insp, ref_insp):
        mod.disable_compile_watch()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Tracker:
    """Per-rid event log + terminal accounting (every rid exactly one
    terminal)."""

    def __init__(self):
        self.events = {}
        self.terminals = {}
        self.order = []

    def cb(self, rid):
        def on_ev(ev):
            self.events.setdefault(rid, []).append(ev)
            self.order.append((str(rid), ev["type"]))
            if ev["type"] in ("finished", "cancelled", "shed"):
                self.terminals.setdefault(rid, []).append(ev)
        return on_ev

    def streamed(self, rid):
        return [t for ev in self.events.get(rid, [])
                if ev["type"] == "tokens" for t in ev["tokens"]]

    def admitted(self):
        """Rids in the order their first tokens arrived."""
        seen = []
        for rid, kind in self.order:
            if kind == "tokens" and rid not in seen:
                seen.append(rid)
        return seen


class Side:
    """One package's serving stack over its tiny Llama."""

    def __init__(self, name, serving, errors, metrics, tracing, health,
                 make_engine):
        self.name = name
        self.S = serving
        self.errors = errors
        self.registry = metrics.get_registry()
        self.tracing = tracing
        self.health = health
        self._make = make_engine
        self._direct = {}

    def engine(self, **kw):
        return self._make(**dict(GEOM, **kw))

    def direct(self, prompt, n, **kw):
        """Tokens of the request alone on a fresh engine (cached)."""
        key = (tuple(prompt), n, tuple(sorted(kw.items())))
        if key not in self._direct:
            eng = self.engine(**kw)
            eng.add_request("ref", prompt, max_new_tokens=n)
            while eng.has_work():
                eng.step()
            self._direct[key] = eng.result("ref")
        return self._direct[key]


def _ref_engine(**kw):
    return RefEngine(models()[0], **kw)


def _port_engine(**kw):
    return LLMEngine(models()[1], device="cpu", **kw)


REF = Side("reference", ref_serving, ref_errors, ref_metrics, ref_tracing,
           ref_health, _ref_engine)
PORT = Side("port", port_serving, port_errors, port_metrics,
            port_tracing, port_health, _port_engine)

# keys whose values are ids, compile counts or host-clock timings
_DROP = {"router", "trace_id", "engine_id", "ttft_seconds",
         "tpot_seconds", "prefill_compiles", "decode_compiles",
         "mixed_compiles", "window_compiles", "scan_decode", "url",
         "uptime_seconds", "introspection", "memory"}


def norm(obj):
    """``obj`` with ids, compile counters and host-clock histograms
    dropped (recursively); ``sched`` and ``engine`` keys go where they
    hold an id and stay where they hold a snapshot."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in _DROP:
                continue
            if k in ("sched", "engine") and not isinstance(v, dict):
                continue
            out[k] = norm(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [norm(v) for v in obj]
    return obj


def sched_record(sched, rids):
    """What a scheduler decided: each rid's state, tokens (None where
    shed), shed reason, deadline flag, preemptions and timeline, and the
    scheduler's snapshot."""
    out = {}
    for rid in rids:
        rec = sched._reqs.get(rid)
        if rec is None:
            out[rid] = None
            continue
        out[rid] = {"state": rec.state, "tokens": list(rec.tokens),
                    "shed_reason": rec.shed_reason,
                    "deadline_missed": rec.deadline_missed,
                    "preempts": rec.preempts,
                    "timeline": norm(sched.request_timeline(rid))}
    return {"requests": out, "snapshot": norm(sched.metrics_snapshot())}


def series(side, scheds=(), routers=()):
    """Values of the ``serving_*`` series labelled with these
    schedulers' and routers' ids, the ids replaced by their position
    (``s0``, ``r0`` ...), from the side's registry."""
    ids = {"sched": {s.sched_id: f"s{i}" for i, s in enumerate(scheds)},
           "router": {r.router_id: f"r{i}"
                      for i, r in enumerate(routers)}}
    out = {}
    for fam in side.registry.collect():
        if not fam.name.startswith("serving_"):
            continue
        for key, val in fam.snapshot_dict().items():
            labels = dict(kv.split("=", 1) for kv in key.split(",")
                          if kv)
            mine = [n for n in ids if n in labels]
            if not mine or any(labels[n] not in ids[n] for n in mine):
                continue
            for n in mine:
                labels[n] = ids[n][labels[n]]
            out[(fam.name,) + tuple(sorted(labels.items()))] = val
    return out


def first_difference(a, b, path="$"):
    """Path and values of the first place ``a`` and ``b`` differ, or
    None."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=repr):
            if k not in a or k not in b:
                return f"{path}[{k!r}]", a.get(k, "<missing>"), \
                    b.get(k, "<missing>")
            d = first_difference(a[k], b[k], f"{path}[{k!r}]")
            if d is not None:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{path}[{i}]")
            if d is not None:
                return d
        return None
    return None if a == b else (path, a, b)


def both(script):
    """Run ``script(side, clock)`` on the reference and the port; the
    normalized results must be equal.  Returns the port's result."""
    got = []
    for side in (REF, PORT):
        got.append(norm(script(side, FakeClock())))
    assert got[1] == got[0], first_difference(got[0], got[1])
    return got[1]
