"""VisualDL-shaped metric writer (counterpart of
``paddle_tpu/visualdl.py``, the same files).

The ``LogWriter`` the hapi callbacks log scalars to: scalars stream to
an append-only JSONL event file (``scalars.jsonl``: crash-safe,
greppable) and, when the installed ``tensorboard`` package exposes a
writer, mirror into TensorBoard event files.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["LogWriter"]


class LogWriter:
    def __init__(self, logdir: str = "./vdl_log", **kwargs):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        self._auto_step = 0      # monotonic default for step=None events
        try:  # optional TensorBoard mirror
            from tensorboard.summary.writer.event_file_writer import \
                EventFileWriter
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.compat.proto.event_pb2 import Event
            self._tb = EventFileWriter(logdir)
            self._Summary = Summary
            self._Event = Event
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: Optional[int] = None,
                   walltime: Optional[float] = None):
        wt = walltime if walltime is not None else time.time()
        rec = {"tag": tag, "value": float(value), "step": step, "time": wt}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        # the TB mirror needs SOME int step: pass the real step through
        # (`step or 0` squashed every step=None event onto step 0,
        # which TensorBoard renders as one overwritten point) and only
        # default — to a per-writer monotonic counter — when None
        if step is None:
            tb_step = self._auto_step
            self._auto_step += 1
        else:
            tb_step = int(step)
            self._auto_step = max(self._auto_step, tb_step + 1)
        if self._tb is not None:
            s = self._Summary(
                value=[self._Summary.Value(tag=tag,
                                           simple_value=float(value))])
            self._tb.add_event(self._Event(summary=s, step=tb_step,
                                           wall_time=wt))

    def flush(self):
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
