"""paddle.profiler — tracing facade over ``torch.profiler`` (counterpart
of ``paddle_tpu/profiler/__init__.py``).

The reference's surface: ``Profiler`` with the wait/warmup/active
``make_scheduler`` state machine, ``RecordEvent`` host ranges,
``export_chrome_tracing`` and ``load_profiler_result``.  Here device and
host tracing is ``torch.profiler.profile`` (CUPTI on the card): a
``Profiler`` opens one ``torch.profiler.profile`` session for each run
of RECORD steps and closes it when the schedule leaves them;
``RecordEvent`` is ``torch.profiler.record_function``, so a range shows
in that trace beside the kernels it launched, and, when the
observability tracer is on, also records as a span there.  The
scheduler state machine and the step table are host-side, with the
reference's semantics.  ``export_chrome_tracing(dir)`` writes the step
table, the ``RecordEvent`` ranges and the tracer's spans as
``steps.chrome_trace.json`` and each recorded session's own
``torch.profiler`` Chrome trace beside it.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from enum import Enum
from typing import Callable, Iterable, Optional

from ..observability import tracing as _tracing

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "load_profiler_result"]

# completed RecordEvent host ranges (name, t0, t1): a bounded ring, so
# always-on instrumentation (the serving engine's prefill and decode
# ranges) cannot grow memory; export_chrome_tracing writes the ranges of
# the profiler session
_HOST_EVENTS: deque = deque(maxlen=100_000)


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # last RECORD step of a cycle


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0) -> Callable:
    """paddle.profiler.make_scheduler: the state of each step."""
    cycle = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None
                          ) -> Callable:
    """``on_trace_ready`` handler: write the session into ``dir_name``.
    ``steps.chrome_trace.json`` holds the step table (track 0), the
    session's ``RecordEvent`` ranges (track 1) and the observability
    tracer's spans (track 2); each recorded ``torch.profiler`` session
    goes to ``<worker>.torch.<i>.chrome_trace.json``."""

    def handler(prof: "Profiler"):
        prof._export_dir = dir_name
        os.makedirs(dir_name, exist_ok=True)
        events = [{"name": f"step {i}", "ph": "X", "pid": 0, "tid": 0,
                   "ts": int(t0 * 1e6), "dur": int((t1 - t0) * 1e6)}
                  for i, (t0, t1) in enumerate(prof._step_times)]
        begin = prof._session_begin or 0.0
        events.extend(
            {"name": name, "ph": "X", "pid": 0, "tid": 1,
             "ts": int(t0 * 1e6), "dur": int((t1 - t0) * 1e6)}
            for name, t0, t1 in list(_HOST_EVENTS) if t0 >= begin)
        tracer = _tracing.get_tracer()
        if tracer is not None:
            events.extend(e for e in tracer.chrome_events(tid=2)
                          if e["ts"] >= int(begin * 1e6))
        with open(os.path.join(dir_name, "steps.chrome_trace.json"),
                  "w") as f:
            json.dump({"traceEvents": events}, f)
        worker = worker_name or f"worker{os.getpid()}"
        for i, session in enumerate(prof._sessions):
            session.export_chrome_trace(os.path.join(
                dir_name, f"{worker}.torch.{i}.chrome_trace.json"))

    handler._export_dir = dir_name
    return handler


class RecordEvent:
    """A host range (``torch.profiler.record_function``), visible in a
    ``torch.profiler`` trace around the kernels it launches.  With the
    observability tracer on, the range also records as a span, nested
    under the span active on this thread."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._rf = None
        self._t0 = None
        self._span = None

    def begin(self):
        import torch
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        sp = _tracing.span(self.name)
        self._span = sp if sp is not _tracing.NULL_SPAN else None
        self._t0 = time.perf_counter()

    def end(self):
        if self._span is not None:
            self._span.end()
            self._span = None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if self._t0 is not None:
            _HOST_EVENTS.append((self.name, self._t0,
                                 time.perf_counter()))
            self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


class Profiler:
    """paddle.profiler.Profiler over ``torch.profiler`` sessions.

        p = Profiler(scheduler=make_scheduler(closed=1, ready=1, record=2),
                     on_trace_ready=export_chrome_tracing("./prof"))
        p.start()
        for batch in loader:
            train_step(batch)
            p.step()
        p.stop()

    ``targets`` picks the activities (``ProfilerTarget.CPU`` and, on a
    machine with a CUDA device, ``ProfilerTarget.GPU``; by default
    both where the GPU exists).  ``timer_only`` keeps the step table
    and records no trace.  The recorded ``torch.profiler.profile``
    sessions stay on ``_sessions`` for the export handler."""

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False,
                 trace_dir: Optional[str] = None):
        if scheduler is None:
            self._schedule = lambda step: ProfilerState.RECORD
        elif isinstance(scheduler, (tuple, list)):  # paddle (start, end)
            lo, hi = scheduler
            self._schedule = make_scheduler(closed=lo, ready=0,
                                            record=hi - lo, repeat=1)
        else:
            self._schedule = scheduler
        self._targets = None if targets is None else list(targets)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        if trace_dir is None:
            trace_dir = getattr(on_trace_ready, "_export_dir",
                                "./profiler_log")
        self._trace_dir = trace_dir
        self._export_dir = trace_dir
        self.current_state = ProfilerState.CLOSED
        self._step_num = 0
        self._session = None
        self._sessions = []
        self._step_times = []
        self._step_begin = None
        self._session_begin = None

    def _activities(self):
        import torch
        from torch.profiler import ProfilerActivity
        targets = self._targets
        if targets is None:
            targets = [ProfilerTarget.CPU]
            if torch.cuda.is_available():
                targets.append(ProfilerTarget.GPU)
        acts = []
        if ProfilerTarget.CPU in targets:
            acts.append(ProfilerActivity.CPU)
        if ProfilerTarget.GPU in targets:
            acts.append(ProfilerActivity.CUDA)
        return acts

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self._step_num = 0
        self._apply_state(self._schedule(0))
        self._step_begin = time.perf_counter()
        self._session_begin = self._step_begin
        return self

    def stop(self):
        # the interval since the last step() (or start()) is a step too
        if self._step_begin is not None:
            now = time.perf_counter()
            if now > self._step_begin:
                self._step_times.append((self._step_begin, now))
            self._step_begin = None
        self._stop_trace()
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)
        return self

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._step_begin is not None:
            self._step_times.append((self._step_begin, now))
        self._step_begin = now
        self._step_num += 1
        self._apply_state(self._schedule(self._step_num))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- internals -----------------------------------------------------------
    def _apply_state(self, state: ProfilerState):
        recording = state in (ProfilerState.RECORD,
                              ProfilerState.RECORD_AND_RETURN)
        if recording and self._session is None and not self._timer_only:
            self._start_trace()
        elif not recording and self._session is not None:
            self._stop_trace()
        self.current_state = state

    def _start_trace(self):
        import torch
        self._session = torch.profiler.profile(
            activities=self._activities())
        self._session.__enter__()

    def _stop_trace(self):
        if self._session is not None:
            self._session.__exit__(None, None, None)
            self._sessions.append(self._session)
            self._session = None

    # -- summaries -----------------------------------------------------------
    def summary(self, sorted_by=None, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms"):
        """The step-timing table (host view; kernel detail is in the
        exported ``torch.profiler`` traces)."""
        if not self._step_times:
            return "no steps recorded"
        durs = [(t1 - t0) * 1e3 for t0, t1 in self._step_times]
        return ("step time (ms): "
                f"avg={sum(durs) / len(durs):.3f} min={min(durs):.3f} "
                f"max={max(durs):.3f} steps={len(durs)}")


def load_profiler_result(path: str):
    with open(path) as f:
        return json.load(f)
