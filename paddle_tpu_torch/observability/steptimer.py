"""StepTimer: training-step wall time, throughput and MFU (counterpart
of ``paddle_tpu/observability/steptimer.py``, with its registry series
and ``summary()`` keys).

The asynchronous-launch trap: a CUDA train step returns before the card
finishes, so a host clock around the call measures the launches, not
the step.  ``stop(fence=...)`` takes the step's outputs (the state
and/or the loss) and synchronises the stream of every CUDA device they
live on before it reads the clock, so the interval is the step's
device-inclusive time.  The fence serialises the host with the card:
that is the point; attach the timer to every Nth step where the wait
matters.

MFU is ``flops_per_step / (step_time * peak_flops)``, FLOPs from
``CompiledTrainStep.step_flops`` (a counted forward and backward plus
the kernels' own FLOPs and the update's) and the card's peak from
``device_peak_flops()``: the dense bf16 tensor-core rate, so an f32
step's MFU is a share of a rate it cannot reach; treat it as a tracking
metric.  Without a known card (the CPU) no MFU is reported unless
``peak_flops`` is passed.

Every value goes to the metrics registry and, when given, a
visualdl-style writer (``add_scalar``).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from .metrics import MetricRegistry, get_registry

__all__ = ["StepTimer", "device_peak_flops"]

# dense bf16 tensor-core FLOP/s by torch.cuda.get_device_name substring
# (NVIDIA data sheets; the SXM part at its 700 W limit)
_PEAK_FLOPS = [("H100 80GB HBM3", 989e12), ("H100 SXM", 989e12)]

_STEP_BUCKETS = (.001, .0025, .005, .01, .025, .05, .1, .25, .5, 1.0,
                 2.5, 5.0, 10.0, 30.0)


def device_peak_flops() -> Optional[float]:
    """Dense bf16 peak FLOP/s of CUDA device 0, or None when there is
    no CUDA device or its name is not in the table."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    for sub, peak in _PEAK_FLOPS:
        if sub in name:
            return peak
    return None


def _fence(tree) -> None:
    """Synchronise the current stream of every CUDA device holding a
    tensor of ``tree`` (nested dicts, lists and tuples)."""
    devices, todo = set(), [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class StepTimer:
    """Usage:

        timer = StepTimer(prefix="train", writer=log_writer)
        timer.flops_per_step = step.step_flops(batch)   # optional, MFU
        step.attach_timer(timer)          # or by hand:
        timer.start(); loss = step(batch); timer.stop(fence=loss)
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 writer=None, prefix: str = "train",
                 tokens_per_step: Optional[int] = None,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None):
        reg = registry or get_registry()
        self.prefix = prefix
        self.writer = writer
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops if peak_flops is not None \
            else device_peak_flops()
        self._hist = reg.histogram(
            f"{prefix}_step_seconds",
            "Wall time per training step (stream-synchronised fence).",
            buckets=_STEP_BUCKETS)
        self._steps = reg.counter(f"{prefix}_steps_total",
                                  "Training steps timed.")
        self._tok_rate = reg.gauge(
            f"{prefix}_tokens_per_sec",
            "Token throughput of the last timed step (tokens_per_step "
            "over the step's time).")
        self._mfu = reg.gauge(
            f"{prefix}_mfu",
            "Estimated model FLOPs utilization of the last timed step "
            "(step_flops over the card's dense bf16 peak).")
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence=None) -> Optional[float]:
        """Record one step ended now.  ``fence`` holds the step's
        outputs or state; the streams of the CUDA devices they live on
        are synchronised before the clock is read (without it the
        measurement is launch-only)."""
        if self._t0 is None:
            return None
        if fence is not None:
            _fence(fence)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._hist.observe(dt)
        self._steps.inc()
        step_i = int(self._steps.value)
        scalars = {f"{self.prefix}/step_time_ms": dt * 1e3}
        if self.tokens_per_step:
            rate = self.tokens_per_step / dt if dt > 0 else 0.0
            self._tok_rate.set(rate)
            scalars[f"{self.prefix}/tokens_per_sec"] = rate
        if self.flops_per_step and self.peak_flops and dt > 0:
            mfu = self.flops_per_step / (dt * self.peak_flops)
            self._mfu.set(mfu)
            scalars[f"{self.prefix}/mfu"] = mfu
        if self.writer is not None:
            for tag, v in scalars.items():
                self.writer.add_scalar(tag, v, step=step_i)
        return dt

    # context-manager sugar: a fence must be handed to stop() directly
    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def summary(self) -> dict:
        return {"steps": int(self._steps.value),
                "step_seconds_mean": self._hist.mean,
                "tokens_per_sec": self._tok_rate.value,
                "mfu": self._mfu.value}
