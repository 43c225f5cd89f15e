"""Operations of the hand-written kernels' launches, counted for
``CompiledTrainStep.step_flops``.

``torch.utils.flop_counter.FlopCounterMode`` counts PyTorch's own
operators; a kernel launched through ctypes is invisible to it.  So each
training kernel's wrapper reports its operations here where it launches
(on the CPU the plain version runs, and the mode counts its operators).
The formulas are the ones ``chip_smoke.py``'s bounds use: a multiply-add
is two operations, attention counts the (query, key) pairs the kernel
visits.  The count is process-wide, not a thread's: CUDA backward
launches run on autograd's device threads.  Outside a ``counting()``
context a report costs one global read.

``OperatorFlops`` counts PyTorch's own operators with
``FlopCounterMode``'s formulas (``flop_registry``) but without its
module tracker, whose gradient hooks refuse the ``autograd.grad`` that a
recomputed region runs inside the backward (``jit/recompute.py``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["counting", "report", "attention_pairs", "OperatorFlops"]

_box: Optional[List[float]] = None
_lock = threading.Lock()


@contextlib.contextmanager
def counting():
    """Sum the operations reported inside the context into the yielded
    one-element list."""
    global _box
    prev, box = _box, [0.0]
    _box = box
    try:
        yield box
    finally:
        _box = prev


def report(fn, *args) -> None:
    """Add ``fn(*args)`` operations when counting (``fn`` is called only
    then)."""
    box = _box
    if box is not None:
        n = float(fn(*args))
        with _lock:
            box[0] += n


def attention_pairs(b, sq, sk, causal) -> int:
    """(query, key) pairs of ``b`` attentions of sq queries over sk keys,
    causal with the queries aligned to the last keys."""
    if not causal:
        return b * sq * sk
    off = sk - sq
    if off >= 0:
        return b * (sq * off + sq * (sq + 1) // 2)
    return b * (sk * (sk + 1) // 2)


class OperatorFlops(TorchDispatchMode):
    """Sums the operations of the PyTorch operators run inside it (the
    forward, and the backward that autograd runs) by
    ``torch.utils.flop_counter``'s per-operator formulas."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self._lock = threading.Lock()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = self._registry.get(func._overloadpacket)
        if fn is not None:
            n = int(fn(*args, **kwargs, out_val=out))
            with self._lock:
                self.total += n
        return out
