"""Health plane: windowed SLO views, goodput accounting, anomaly
sentinels (counterpart of ``paddle_tpu/observability/health.py``,
stdlib only, kept as its own copy).

* ``SlidingWindow`` — a ring of time-bucketed sub-snapshots over
  counter/gauge/histogram-style observations (injectable clock).
  Expired slots are recycled lazily on access, so recording stays O(1)
  with no background thread.
* ``SLOTracker`` — declared objectives (``SLO``) evaluated with
  multi-window burn rates: a fast (~1 min) and a slow (~10 min) window
  each track the bad-event fraction; burn rate = bad_fraction /
  objective, and an SLO is "burning" only when both windows exceed
  their thresholds.
* ``GoodputMeter`` — classifies training wall time into
  productive-step / data-stall / checkpoint-save / restart-replay /
  compile buckets (plus the ``other`` remainder); fractions sum to 1.0.
* ``AnomalySentinel`` — per-step loss / global-grad-norm watcher:
  NaN/Inf trips immediately, an EWMA spike trips after warmup; the
  policy (``warn`` / ``skip_step`` / ``halt``) is the caller's word,
  and every trip dumps the flight recorder (``tracing.py``).

The serving engine observes TTFT and TPOT here.  The module-level
plumbing follows ``tracing.py``'s disabled-is-free contract:
``get_health()`` / ``goodput_region()`` read one module global and
return the shared ``NULL_HEALTH`` / ``NULL_REGION`` singletons when the
plane is off.

``merge_histogram_snapshots`` merges per-replica histogram snapshots
bucket-wise (cumulative ``le`` counts add exactly when the replicas
share bucket edges, as every engine's families do).
"""
from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..common.errors import enforce
from . import tracing as _tracing
from .metrics import DEFAULT_BUCKETS, _fmt_value, get_registry

__all__ = [
    "SlidingWindow", "SLO", "SLOTracker", "GoodputMeter",
    "AnomalySentinel", "HealthHub", "NULL_HEALTH", "NULL_REGION",
    "enable_health", "disable_health", "get_health", "goodput_region",
    "quantile_from_buckets", "merge_histogram_snapshots",
    "GOODPUT_BUCKETS", "DEFAULT_SLOS",
]


# -- windowed views -----------------------------------------------------------

class SlidingWindow:
    """Ring of time-bucketed sub-snapshots: observations land in the
    slot covering ``now``; reads merge only the slots still inside the
    window.  ``bounds`` (histogram upper bounds, no +Inf) enables
    ``quantile``; without them the window is a counter/ratio view.

    Slots are recycled LAZILY: each slot remembers the absolute slot
    number it was last used for, and any access that lands on a slot
    from a previous revolution zeroes it first — O(1) per record, no
    sweeper thread, fake clocks welcome."""

    def __init__(self, window: float = 60.0, slots: int = 12,
                 bounds: Optional[Sequence[float]] = None,
                 clock: Optional[Callable[[], float]] = None):
        enforce(window > 0 and slots >= 1,
                "SlidingWindow needs window > 0 and slots >= 1")
        self.window = float(window)
        self.slots = int(slots)
        self.bounds = tuple(float(b) for b in bounds) if bounds else None
        if self.bounds:
            enforce(self.bounds == tuple(sorted(self.bounds)),
                    "window bounds must be sorted")
        self._span = self.window / self.slots
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        nb = len(self.bounds) + 1 if self.bounds else 0
        self._counts = [0] * self.slots          # events per slot
        self._bad = [0] * self.slots             # bad events per slot
        self._sums = [0.0] * self.slots
        self._hist = [[0] * nb for _ in range(self.slots)] \
            if self.bounds else None
        self._slot_id = [None] * self.slots      # absolute slot numbers

    def _slot(self, now: float) -> int:
        """Ring index for ``now``, recycling the slot if it belonged
        to a previous revolution (lock held)."""
        k = int(now / self._span)
        i = k % self.slots
        if self._slot_id[i] != k:
            self._slot_id[i] = k
            self._counts[i] = 0
            self._bad[i] = 0
            self._sums[i] = 0.0
            if self._hist is not None:
                self._hist[i] = [0] * (len(self.bounds) + 1)
        return i

    def _live(self, now: float) -> List[int]:
        """Ring indices still inside the window (lock held)."""
        k = int(now / self._span)
        lo = k - self.slots + 1
        return [i for i in range(self.slots)
                if self._slot_id[i] is not None
                and lo <= self._slot_id[i] <= k]

    def observe(self, value: float, n: int = 1, bad: int = 0):
        """Record ``n`` observations of ``value`` (the weighted-observe
        convention Histogram uses for decode windows), ``bad`` of them
        counting against the objective."""
        now = self._clock()
        with self._lock:
            i = self._slot(now)
            self._counts[i] += n
            self._bad[i] += bad
            self._sums[i] += float(value) * n
            if self._hist is not None:
                self._hist[i][bisect_left(self.bounds, float(value))] += n

    def inc(self, n: int = 1, bad: int = 0):
        """Counter-style record: ``n`` events, ``bad`` of them bad."""
        now = self._clock()
        with self._lock:
            i = self._slot(now)
            self._counts[i] += n
            self._bad[i] += bad

    # -- reads ----------------------------------------------------------------
    def _merged(self) -> Tuple[int, int, float, Optional[List[int]]]:
        now = self._clock()
        with self._lock:
            live = self._live(now)
            count = sum(self._counts[i] for i in live)
            bad = sum(self._bad[i] for i in live)
            total = sum(self._sums[i] for i in live)
            hist = None
            if self._hist is not None:
                hist = [0] * (len(self.bounds) + 1)
                for i in live:
                    for j, c in enumerate(self._hist[i]):
                        hist[j] += c
        return count, bad, total, hist

    def count(self) -> int:
        return self._merged()[0]

    def bad(self) -> int:
        return self._merged()[1]

    def sum(self) -> float:
        return self._merged()[2]

    def mean(self) -> Optional[float]:
        count, _, total, _ = self._merged()
        return total / count if count else None

    def rate(self) -> float:
        """Events per second over the window span."""
        return self._merged()[0] / self.window

    def bad_fraction(self) -> Optional[float]:
        """Bad events / events over the window; None with no events
        (an empty window is UNKNOWN, not healthy)."""
        count, bad, _, _ = self._merged()
        return bad / count if count else None

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated q-quantile over the window, ``None``
        when the window holds no observations (matching the
        ``Histogram.quantile`` empty contract)."""
        enforce(self.bounds is not None,
                "quantile needs a window built with bounds")
        enforce(0.0 <= q <= 1.0, f"quantile {q} outside [0, 1]")
        count, _, _, hist = self._merged()
        if not count:
            return None
        rank = q * count
        cum = 0
        for i, c in enumerate(hist):
            cum += c
            if cum >= rank and c:
                if i >= len(self.bounds):     # overflow bucket clamps
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * (rank - (cum - c)) / c
        return self.bounds[-1]

    def snapshot(self) -> dict:
        count, bad, total, hist = self._merged()
        out = {"window_seconds": self.window, "count": count,
               "bad": bad, "sum": total,
               "mean": total / count if count else None,
               "rate_per_sec": count / self.window}
        if self.bounds is not None:
            cum = 0
            buckets = {}
            for ub, c in zip(list(self.bounds) + [math.inf], hist or []):
                cum += c
                buckets[_fmt_value(ub)] = cum
            out["buckets"] = buckets
            out["p50"] = self.quantile(0.50)
            out["p95"] = self.quantile(0.95)
            out["p99"] = self.quantile(0.99)
        return out


# -- federation merge helpers -------------------------------------------------

def quantile_from_buckets(buckets: Dict[str, float], q: float
                          ) -> Optional[float]:
    """Bucket-interpolated quantile over a CUMULATIVE ``{le: count}``
    dict (the ``Histogram._snapshot_value()["buckets"]`` shape) —
    the same interpolation ``Histogram.quantile`` uses, so a merged
    fleet histogram answers the same percentile a single process
    covering all the traffic would.  ``None`` when empty."""
    items = sorted(((float(le), c) for le, c in buckets.items()),
                   key=lambda t: t[0])
    if not items:
        return None
    total = items[-1][1]
    if not total:
        return None
    rank = q * total
    prev_le, prev_cum = 0.0, 0
    last_finite = None
    for le, cum in items:
        c = cum - prev_cum
        if cum >= rank and c:
            if math.isinf(le):                # overflow bucket clamps
                return last_finite
            return prev_le + (le - prev_le) * (rank - prev_cum) / c
        if not math.isinf(le):
            last_finite = le
        prev_le = le if not math.isinf(le) else prev_le
        prev_cum = cum
    return last_finite


def merge_histogram_snapshots(snaps: Sequence[Optional[dict]]
                              ) -> Optional[dict]:
    """Bucket-wise merge of ``Histogram.snapshot()`` dicts from N
    replicas: cumulative counts per ``le`` add exactly when the
    replicas share bucket edges (they do — every engine registers the
    same families).  A replica missing an edge contributes its count
    at the nearest lower edge (cumulative counts are monotone, so the
    merge stays a valid histogram).  Returns ``None`` when nothing
    merged."""
    snaps = [s for s in snaps
             if isinstance(s, dict) and "buckets" in s]
    if not snaps:
        return None
    les: set = set()
    for s in snaps:
        les.update(float(le) for le in s["buckets"])
    merged: Dict[str, float] = {}
    for le in sorted(les):
        tot = 0
        for s in snaps:
            best = 0
            for sle, c in s["buckets"].items():
                fle = float(sle)
                if fle <= le and c > best:
                    best = c
            tot += best
        merged[_fmt_value(le)] = tot
    count = sum(s.get("count", 0) for s in snaps)
    total = sum(s.get("sum", 0.0) for s in snaps)
    return {"count": count, "sum": total,
            "mean": total / count if count else None,
            "buckets": merged,
            "p50": quantile_from_buckets(merged, 0.50),
            "p95": quantile_from_buckets(merged, 0.95),
            "p99": quantile_from_buckets(merged, 0.99)}


# -- SLOs and burn rates ------------------------------------------------------

class SLO:
    """One declared objective.  ``objective`` is the tolerated BAD
    fraction (0.05 → 95% of events must be good).  Latency SLOs carry
    a ``threshold``: an observation above it is bad.  Event SLOs
    (shed-rate, error-rate) have no threshold — callers mark bad
    events explicitly."""

    __slots__ = ("name", "objective", "threshold", "description")

    def __init__(self, name: str, objective: float,
                 threshold: Optional[float] = None,
                 description: str = ""):
        enforce(0.0 < objective <= 1.0,
                f"SLO {name}: objective must be in (0, 1]")
        self.name = name
        self.objective = float(objective)
        self.threshold = None if threshold is None else float(threshold)
        self.description = description


DEFAULT_SLOS: Tuple[SLO, ...] = (
    SLO("ttft", objective=0.05, threshold=1.0,
        description="95% of requests see their first token within 1s"),
    SLO("tpot", objective=0.05, threshold=0.1,
        description="95% of decode tokens arrive within 100ms"),
    SLO("shed_rate", objective=0.01,
        description="at most 1% of submissions shed"),
    SLO("error_rate", objective=0.01,
        description="at most 1% of requests end in error"),
)


class SLOTracker:
    """Multi-window burn-rate evaluation over declared ``SLO``s.  Each
    SLO gets a fast (~1 min) and a slow (~10 min) ``SlidingWindow`` of
    (events, bad events); burn rate = bad_fraction / objective and the
    SLO is BURNING only when the fast window exceeds ``fast_burn`` AND
    the slow one exceeds ``slow_burn`` — the fast window reacts, the
    slow one confirms."""

    def __init__(self, slos: Sequence[SLO] = DEFAULT_SLOS,
                 fast_window: float = 60.0, slow_window: float = 600.0,
                 slots: int = 12,
                 clock: Optional[Callable[[], float]] = None,
                 fast_burn: float = 2.0, slow_burn: float = 1.0):
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self._slos: Dict[str, SLO] = {s.name: s for s in slos}
        self._win: Dict[str, Dict[str, SlidingWindow]] = {
            s.name: {
                "fast": SlidingWindow(fast_window, slots, clock=clock),
                "slow": SlidingWindow(slow_window, slots, clock=clock),
            } for s in slos}

    @property
    def slos(self) -> Dict[str, SLO]:
        return dict(self._slos)

    def observe(self, name: str, value: float, n: int = 1):
        """Latency-SLO observation (``n``-weighted, the decode-window
        convention).  Unknown names no-op so instrumentation sites
        never depend on the declared set."""
        slo = self._slos.get(name)
        if slo is None or slo.threshold is None:
            return
        bad = n if float(value) > slo.threshold else 0
        for w in self._win[name].values():
            w.inc(n=n, bad=bad)

    def event(self, name: str, bad: bool = False, n: int = 1):
        """Event-SLO observation (shed-rate, error-rate)."""
        if name not in self._slos:
            return
        for w in self._win[name].values():
            w.inc(n=n, bad=n if bad else 0)

    def burn_rate(self, name: str, which: str = "fast"
                  ) -> Optional[float]:
        """bad_fraction / objective over the named window; ``None``
        with no events (unknown, not zero)."""
        slo = self._slos.get(name)
        if slo is None:
            return None
        frac = self._win[name][which].bad_fraction()
        return None if frac is None else frac / slo.objective

    def burning(self, name: str) -> bool:
        fast = self.burn_rate(name, "fast")
        slow = self.burn_rate(name, "slow")
        return (fast is not None and fast >= self.fast_burn and
                slow is not None and slow >= self.slow_burn)

    def status(self) -> dict:
        """JSON-able per-SLO state: window counts/fractions, burn
        rates, and the multi-window ``burning`` verdict."""
        out = {}
        for name, slo in self._slos.items():
            windows = {}
            for which, w in self._win[name].items():
                frac = w.bad_fraction()
                windows[which] = {
                    "window_seconds": w.window,
                    "events": w.count(), "bad": w.bad(),
                    "bad_fraction": frac,
                    "burn_rate": None if frac is None
                    else frac / slo.objective,
                }
            out[name] = {
                "objective": slo.objective,
                "threshold": slo.threshold,
                "description": slo.description,
                "windows": windows,
                "burning": self.burning(name),
            }
        return out


# -- goodput accounting -------------------------------------------------------

GOODPUT_BUCKETS: Tuple[str, ...] = (
    "productive_step", "data_stall", "checkpoint_save",
    "restart_replay", "compile", "other")


class _Region:
    """One timed goodput region (context manager)."""

    __slots__ = ("_meter", "_bucket", "_t0")

    def __init__(self, meter: "GoodputMeter", bucket: str):
        self._meter = meter
        self._bucket = bucket
        self._t0 = None

    def __enter__(self):
        self._t0 = self._meter._clock()
        return self

    def __exit__(self, *exc):
        self._meter.add(self._bucket, self._meter._clock() - self._t0)
        return False


class GoodputMeter:
    """Training wall-time classifier.  ``start()`` opens a run (and
    resets the buckets — each ``fit`` is one accounting window);
    ``region(bucket)`` times a with-block into a bucket; ``report()``
    computes fractions whose denominator is
    ``tracked + other`` with ``other = max(0, wall - tracked)`` — so
    the fractions sum to 1.0 by construction, and the buckets are
    exhaustive and disjoint as long as the instrumentation sites don't
    nest (they don't: data-stall is the loader fetch, the step region
    is the compiled dispatch, checkpoint/restore run between steps)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._t_start: Optional[float] = None
        self._t_stop: Optional[float] = None
        self._seconds: Dict[str, float] = {}
        self._attr: Dict[str, Dict[str, float]] = {}

    def start(self):
        """Open (or reopen) the accounting window, zeroing buckets."""
        with self._lock:
            self._t_start = self._clock()
            self._t_stop = None
            self._seconds = {b: 0.0 for b in GOODPUT_BUCKETS
                             if b != "other"}
            self._attr = {}

    def stop(self):
        with self._lock:
            if self._t_start is not None and self._t_stop is None:
                self._t_stop = self._clock()

    def region(self, bucket: str) -> _Region:
        enforce(bucket in GOODPUT_BUCKETS and bucket != "other",
                f"unknown goodput bucket {bucket!r}")
        return _Region(self, bucket)

    def add(self, bucket: str, seconds: float):
        with self._lock:
            if self._t_start is None:
                return                       # no run open: drop quietly
            self._seconds[bucket] = \
                self._seconds.get(bucket, 0.0) + max(0.0, seconds)

    def attribute(self, bucket: str, key: str, seconds: float):
        """Named sub-accounting WITHIN a bucket — the CompileWatch
        attributes the ``compile`` bucket per program name, so badput
        names its culprit instead of reporting one opaque total.  This
        is a parallel view: it never changes the bucket seconds the
        regions book (fractions still sum to 1.0)."""
        with self._lock:
            if self._t_start is None:
                return
            d = self._attr.setdefault(bucket, {})
            d[key] = d.get(key, 0.0) + max(0.0, seconds)

    def report(self) -> dict:
        """{total_seconds, seconds{bucket}, fractions{bucket},
        goodput, attribution{bucket}{key}} — fractions sum to 1.0
        (the ``other`` remainder absorbs unattributed wall time)."""
        with self._lock:
            if self._t_start is None:
                return {"running": False, "total_seconds": 0.0,
                        "seconds": {}, "fractions": {},
                        "attribution": {}, "goodput": None}
            end = self._t_stop if self._t_stop is not None \
                else self._clock()
            wall = max(0.0, end - self._t_start)
            seconds = dict(self._seconds)
            attribution = {b: dict(d) for b, d in self._attr.items()}
        tracked = sum(seconds.values())
        seconds["other"] = max(0.0, wall - tracked)
        denom = tracked + seconds["other"]
        fractions = {b: (seconds.get(b, 0.0) / denom if denom else 0.0)
                     for b in GOODPUT_BUCKETS}
        return {"running": self._t_stop is None,
                "total_seconds": wall, "seconds": seconds,
                "fractions": fractions, "attribution": attribution,
                "goodput": fractions["productive_step"]}


# -- anomaly sentinels --------------------------------------------------------

class AnomalySentinel:
    """Per-step scalar watcher (loss, global grad norm): NaN/Inf trips
    immediately; after ``warmup`` clean samples, a value above
    ``ewma_mean + spike_factor * max(ewma_dev, 5% of |mean|)`` trips
    as a spike regression.  Every trip records an ``anomaly`` flight-
    recorder event and dumps the recorder once; the returned action is
    the POLICY's word to the training loop:

    * ``warn`` — log and continue;
    * ``skip_step`` — exclude the poisoned step from metrics and the
      EWMA baseline and continue (the compiled update has already
      been applied — this is accounting exclusion, not a rollback);
    * ``halt`` — stop training cleanly after the in-flight step.
    """

    POLICIES = ("warn", "skip_step", "halt")

    def __init__(self, policy: str = "warn", ewma_alpha: float = 0.1,
                 spike_factor: float = 6.0, warmup: int = 20):
        enforce(policy in self.POLICIES,
                f"sentinel policy {policy!r} not in {self.POLICIES}")
        self.policy = policy
        self.alpha = float(ewma_alpha)
        self.spike_factor = float(spike_factor)
        self.warmup = int(warmup)
        self._lock = threading.Lock()
        self._state: Dict[str, dict] = {}     # metric -> {mean,dev,n}
        self.trips: List[dict] = []

    def _trip(self, metric: str, value: float, step, reason: str
              ) -> str:
        rec = {"metric": metric, "value": value, "step": step,
               "reason": reason, "policy": self.policy}
        with self._lock:
            self.trips.append(rec)
        _tracing.record_event("anomaly", **rec)
        fr = _tracing.get_flight_recorder()
        if fr is not None:
            try:
                fr.dump_once(f"anomaly:{metric}:{reason}")
            except Exception:
                pass                   # a failing dump can't stop the
                                       # policy verdict from landing
        return self.policy

    def check(self, step=None, **values) -> Optional[str]:
        """Feed this step's scalars (``loss=``, ``grad_norm=``);
        returns the policy action on a trip, else ``None``.  ``None``
        values are skipped (a caller without a grad-norm tap just
        doesn't pass one)."""
        for metric, value in values.items():
            if value is None:
                continue
            v = float(value)
            if math.isnan(v) or math.isinf(v):
                return self._trip(metric, v, step, "non_finite")
            spike_mean = None
            with self._lock:
                st = self._state.setdefault(
                    metric, {"mean": v, "dev": 0.0, "n": 0})
                if st["n"] >= self.warmup:
                    band = self.spike_factor * max(
                        st["dev"], 0.05 * abs(st["mean"]), 1e-12)
                    if v > st["mean"] + band:
                        # EWMA untouched: the spike must not become
                        # the new baseline
                        spike_mean = st["mean"]
                if spike_mean is None:
                    a = self.alpha
                    st["dev"] = (1 - a) * st["dev"] + \
                        a * abs(v - st["mean"])
                    st["mean"] = (1 - a) * st["mean"] + a * v
                    st["n"] += 1
            if spike_mean is not None:
                return self._trip(metric, v, step,
                                  f"ewma_spike(mean={spike_mean:.6g})")
        return None

    def snapshot(self) -> dict:
        with self._lock:
            return {"policy": self.policy,
                    "metrics": {k: dict(v)
                                for k, v in self._state.items()},
                    "trips": list(self.trips)}


# -- the hub and the disabled-is-free plumbing --------------------------------

class _NullRegion:
    """Shared no-op goodput region — the NULL_SPAN analog."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_REGION = _NullRegion()


class _NullGoodput:
    """No-op GoodputMeter stand-in riding on NULL_HEALTH."""

    __slots__ = ()

    def start(self):
        pass

    def stop(self):
        pass

    def add(self, bucket, seconds):
        pass

    def attribute(self, bucket, key, seconds):
        pass

    def region(self, bucket):
        return NULL_REGION

    def report(self):
        return {"running": False, "total_seconds": 0.0,
                "seconds": {}, "fractions": {}, "attribution": {},
                "goodput": None}


NULL_GOODPUT = _NullGoodput()


class _NullHealth:
    """The disabled plane: one shared instance, every method a no-op —
    instrumentation sites cost one global read and one no-op call."""

    __slots__ = ()

    enabled = False
    goodput = NULL_GOODPUT

    def observe_ttft(self, value):
        pass

    def observe_tpot(self, value, n=1):
        pass

    def event(self, name, bad=False, n=1):
        pass

    def sentinel_check(self, step=None, **values):
        return None

    def snapshot(self):
        return None


NULL_HEALTH = _NullHealth()


class HealthHub:
    """The enabled plane: windowed TTFT/TPOT views (for ``/statusz``),
    the ``SLOTracker``, the ``GoodputMeter`` and the
    ``AnomalySentinel``, plus registry publication
    (``serving_slo_burn_rate{slo,window}``,
    ``train_goodput_fraction{bucket}``,
    ``train_anomaly_trips_total{metric}``) refreshed on every
    ``snapshot()`` — one scrape covers the windowed plane too."""

    enabled = True

    def __init__(self, slos: Sequence[SLO] = DEFAULT_SLOS,
                 clock: Optional[Callable[[], float]] = None,
                 fast_window: float = 60.0, slow_window: float = 600.0,
                 slots: int = 12,
                 fast_burn: float = 2.0, slow_burn: float = 1.0,
                 sentinel_policy: str = "warn",
                 sentinel_spike_factor: float = 6.0,
                 sentinel_warmup: int = 20,
                 bounds: Sequence[float] = DEFAULT_BUCKETS,
                 enable_metrics: bool = True):
        self.slo = SLOTracker(slos, fast_window=fast_window,
                              slow_window=slow_window, slots=slots,
                              clock=clock, fast_burn=fast_burn,
                              slow_burn=slow_burn)
        self.windows: Dict[str, SlidingWindow] = {
            "ttft": SlidingWindow(fast_window, slots, bounds=bounds,
                                  clock=clock),
            "tpot": SlidingWindow(fast_window, slots, bounds=bounds,
                                  clock=clock),
        }
        self.goodput = GoodputMeter(clock=clock)
        self.sentinel = AnomalySentinel(
            policy=sentinel_policy, spike_factor=sentinel_spike_factor,
            warmup=sentinel_warmup)
        self._n_trips_seen = 0
        self._metrics = None
        if enable_metrics:
            reg = get_registry()
            self._metrics = {
                "burn": reg.gauge(
                    "serving_slo_burn_rate",
                    "Windowed SLO burn rate (bad fraction / "
                    "objective); 0 renders for an empty window.",
                    ("slo", "window")),
                "burning": reg.gauge(
                    "serving_slo_burning",
                    "1 while the SLO's fast AND slow windows both "
                    "exceed their burn thresholds.", ("slo",)),
                "goodput": reg.gauge(
                    "train_goodput_fraction",
                    "Fraction of training wall time in the bucket "
                    "(fractions sum to 1).", ("bucket",)),
                "trips": reg.counter(
                    "train_anomaly_trips_total",
                    "Anomaly sentinel trips (NaN/Inf or EWMA spike) "
                    "by watched metric.", ("metric",)),
            }

    # -- instrumentation surface ----------------------------------------------
    def observe_ttft(self, value: float):
        self.windows["ttft"].observe(value)
        self.slo.observe("ttft", value)

    def observe_tpot(self, value: float, n: int = 1):
        self.windows["tpot"].observe(value, n=n)
        self.slo.observe("tpot", value, n=n)

    def event(self, name: str, bad: bool = False, n: int = 1):
        self.slo.event(name, bad=bad, n=n)

    def sentinel_check(self, step=None, **values) -> Optional[str]:
        action = self.sentinel.check(step=step, **values)
        if self._metrics is not None:
            trips = self.sentinel.trips
            while self._n_trips_seen < len(trips):
                self._metrics["trips"].labels(
                    str(trips[self._n_trips_seen]["metric"])).inc()
                self._n_trips_seen += 1
        return action

    # -- reads ----------------------------------------------------------------
    def snapshot(self) -> dict:
        """The JSON-able windowed-plane view that rides in
        ``Scheduler.metrics_snapshot()["health"]`` (and therefore in
        every ``/v1/stats`` / ``/v1/metrics_snapshot`` scrape)."""
        slo = self.slo.status()
        goodput = self.goodput.report()
        if self._metrics is not None:
            for name, st in slo.items():
                for which, w in st["windows"].items():
                    self._metrics["burn"].labels(name, which).set(
                        w["burn_rate"] or 0.0)
                self._metrics["burning"].labels(name).set(
                    1.0 if st["burning"] else 0.0)
            for bucket, frac in goodput["fractions"].items():
                self._metrics["goodput"].labels(bucket).set(frac)
        return {"enabled": True,
                "windows": {k: w.snapshot()
                            for k, w in self.windows.items()},
                "slo": slo, "goodput": goodput,
                "sentinel": self.sentinel.snapshot()}


_HEALTH: Optional[HealthHub] = None


def enable_health(**kw) -> HealthHub:
    """Install the process-global health plane (see ``HealthHub`` for
    the knobs).  Replaces any previous hub — windows restart empty."""
    global _HEALTH
    _HEALTH = HealthHub(**kw)
    return _HEALTH


def disable_health() -> None:
    global _HEALTH
    _HEALTH = None


def get_health():
    """The active hub, or the shared ``NULL_HEALTH`` singleton — the
    one-global-read contract every instrumentation site relies on."""
    h = _HEALTH
    return h if h is not None else NULL_HEALTH


def goodput_region(bucket: str):
    """Timed goodput region for a with-block; the shared
    ``NULL_REGION`` singleton when the plane is off."""
    h = _HEALTH
    if h is None:
        return NULL_REGION
    return h.goodput.region(bucket)
