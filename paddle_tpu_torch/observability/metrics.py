"""Dependency-free metrics runtime (Counter / Gauge / Histogram +
MetricRegistry).

Counterpart of ``paddle_tpu/observability/metrics.py``, kept as its own
copy (the module is stdlib only): the same label, bucket and Prometheus
text rules, so the same operations render byte-identical text in both
packages.  The serving engine (``inference/engine.py``) and the paged KV
cache report into the process-global registry; every record is a dict
lookup and a few float adds under a lock, host work only.

Exposition is split from collection: ``MetricRegistry.expose_text()``
renders the Prometheus text format (0.0.4) deterministically (metrics
and label sets sorted); ``MetricRegistry.snapshot()`` returns a JSON-able
dict for the JSONL snapshot writer (``exposition.JsonlSnapshotWriter``).
Both first run the registry's collect hooks: a producer whose counts
live on the GPU (the engine's per-expert load) folds them into its
series there, at read time, instead of copying them to the host on
every step.
"""
from __future__ import annotations

import bisect
import math
import threading
import weakref
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..common.errors import enforce

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "get_registry", "DEFAULT_BUCKETS"]

# Prometheus client_python default buckets — latency-shaped (seconds).
DEFAULT_BUCKETS = (.005, .01, .025, .05, .1, .25, .5, 1.0, 2.5, 5.0,
                   10.0)


def _fmt_value(v) -> str:
    """Prometheus sample value: integral values render bare, +Inf per
    the text-format spec."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n",
                                                               "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    """Base metric family: owns the label schema and the children map
    (one child per label-value tuple).  An unlabeled family is its own
    () child, so `reg.counter("x").inc()` records AND exposes without
    a `.labels()` hop.  All children of a family share one lock —
    record paths touch a handful of floats, contention is nil."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        enforce(bool(name) and not name[0].isdigit() and
                name.replace("_", "a").replace(":", "a").isalnum(),
                f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        if not self.labelnames:
            self._children[()] = self

    # -- label fan-out ---------------------------------------------------------
    def labels(self, *values, **kv):
        if kv:
            enforce(not values, "pass label values positionally OR by "
                                "keyword, not both")
            enforce(set(kv) == set(self.labelnames),
                    f"{self.name}: labels() keywords {sorted(kv)} != "
                    f"declared {list(self.labelnames)}")
            values = tuple(kv[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        enforce(len(values) == len(self.labelnames),
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._new_child()
                child._lock = self._lock
                self._children[values] = child
        return child

    def _sorted_children(self):
        with self._lock:
            return sorted(self._children.items())

    # -- exposition ------------------------------------------------------------
    def _label_str(self, labelvalues, extra: str = "") -> str:
        parts = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.labelnames, labelvalues)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def expose(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for lv, child in self._sorted_children():
            lines.extend(child._sample_lines(self, lv))
        return "\n".join(lines)

    def snapshot_dict(self):
        """{"k=v,k2=v2" (or "" unlabeled): child snapshot value}."""
        out = {}
        for lv, child in self._sorted_children():
            key = ",".join(f"{n}={v}"
                           for n, v in zip(self.labelnames, lv))
            out[key] = child._snapshot_value()
        return out


class Counter(_Metric):
    """Monotonic counter.  `.inc(n)`; negative increments are refused."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _new_child(self):
        return Counter(self.name, self.help)

    def inc(self, n: float = 1.0):
        enforce(n >= 0, f"{self.name}: counters only go up (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """This child's count; on a labeled family, the total across
        all label sets."""
        if self.labelnames:
            return sum(c._value for c in self._children.values())
        return self._value

    def _snapshot_value(self):
        return self._value

    def _sample_lines(self, parent, lv):
        return [f"{parent.name}{parent._label_str(lv)} "
                f"{_fmt_value(self._value)}"]


class Gauge(_Metric):
    """Point-in-time value.  `.set(v)` / `.inc()` / `.dec()`."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _new_child(self):
        return Gauge(self.name, self.help)

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0):
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def _snapshot_value(self):
        return self._value

    def _sample_lines(self, parent, lv):
        return [f"{parent.name}{parent._label_str(lv)} "
                f"{_fmt_value(self._value)}"]


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative buckets, Prometheus
    semantics).  `.observe(v, n=1)` — the `n` weight lets hot paths
    record a whole decode window (n tokens at the same per-token
    latency) with ONE bucket update instead of n."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = tuple(float(b) for b in buckets)
        if bs and bs[-1] == math.inf:
            bs = bs[:-1]
        enforce(len(bs) >= 1, f"{name}: need at least one finite bucket")
        enforce(bs == tuple(sorted(bs)) and len(set(bs)) == len(bs),
                f"{name}: histogram buckets must be sorted/unique")
        self.buckets = bs                       # upper bounds, no +Inf
        self._counts = [0] * (len(bs) + 1)      # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, v: float, n: int = 1):
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += n
            self._sum += v * n
            self._count += n

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0..1) by linear interpolation inside
        the bucket holding the q-th observation (Prometheus
        ``histogram_quantile`` semantics).  Observations past the last
        finite bucket clamp to that bound — a fixed-bucket histogram
        cannot resolve its own overflow tail.  ``None`` when empty
        (rendered ``n/a`` by /statusz): an empty histogram has no
        percentile, and 0.0 reads as "instant" on a latency family."""
        enforce(0.0 <= q <= 1.0, f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c:
                if i >= len(self.buckets):      # +Inf overflow bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * (rank - (cum - c)) / c
        return self.buckets[-1]

    def _snapshot_value(self):
        cum = 0
        buckets = {}
        for ub, c in zip(list(self.buckets) + [math.inf], self._counts):
            cum += c
            buckets[_fmt_value(ub)] = cum
        return {"count": self._count, "sum": self._sum,
                "mean": self.mean, "buckets": buckets,
                # bucket-interpolated latency percentiles, so /statusz
                # and bench rows report tails instead of mean-only
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self) -> dict:
        """{count, sum, mean, p50/p95/p99, buckets{le: cumulative}}
        for this child (quantiles are bucket-interpolated
        estimates)."""
        return self._snapshot_value()

    def _sample_lines(self, parent, lv):
        lines = []
        cum = 0
        for ub, c in zip(list(self.buckets) + [math.inf], self._counts):
            cum += c
            le = f'le="{_fmt_value(ub)}"'
            lines.append(f"{parent.name}_bucket"
                         f"{parent._label_str(lv, le)} {cum}")
        lines.append(f"{parent.name}_sum{parent._label_str(lv)} "
                     f"{_fmt_value(self._sum)}")
        lines.append(f"{parent.name}_count{parent._label_str(lv)} "
                     f"{self._count}")
        return lines


class MetricRegistry:
    """Named metric store.  Factory methods are get-or-create (the
    engine, the cache, and tests may all ask for the same family) and
    enforce kind/label-schema agreement on reuse."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._hooks: list = []

    def add_collect_hook(self, fn) -> None:
        """Run ``fn()`` before every ``expose_text`` / ``snapshot``.
        Held weakly (a bound method by ``WeakMethod``): a hook whose
        owner was collected drops out instead of pinning it."""
        ref = weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
            else weakref.ref(fn)
        with self._lock:
            self._hooks.append(ref)

    def _run_hooks(self):
        with self._lock:
            refs = list(self._hooks)
        dead = []
        for ref in refs:
            fn = ref()
            if fn is None:
                dead.append(ref)
            else:
                fn()
        if dead:
            with self._lock:
                self._hooks = [r for r in self._hooks if r not in dead]

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        enforce(isinstance(m, cls),
                f"metric {name!r} already registered as {m.kind}")
        enforce(m.labelnames == tuple(labelnames),
                f"metric {name!r} label schema mismatch: "
                f"{m.labelnames} vs {tuple(labelnames)}")
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        m = self._get_or_create(Histogram, name, help, labelnames,
                                buckets=buckets)
        enforce(m.buckets == tuple(float(b) for b in buckets
                                   if b != math.inf),
                f"metric {name!r} bucket mismatch")
        return m

    def get(self, name) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self):
        with self._lock:
            self._metrics.clear()
            self._hooks.clear()

    def collect(self) -> Iterable[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # -- exposition ------------------------------------------------------------
    def expose_text(self) -> str:
        """Prometheus text exposition format 0.0.4 — deterministic
        ordering (metric name, then label values) so the output is
        golden-file testable."""
        self._run_hooks()
        out = [m.expose() for m in self.collect()]
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict:
        """JSON-able {name: {kind, help, values}} view of everything."""
        self._run_hooks()
        return {m.name: {"kind": m.kind, "help": m.help,
                         "labelnames": list(m.labelnames),
                         "values": m.snapshot_dict()}
                for m in self.collect()}


# the process-global default registry — serving/training
# instrumentation reports here unless handed an explicit registry
REGISTRY = MetricRegistry()


def get_registry() -> MetricRegistry:
    return REGISTRY
