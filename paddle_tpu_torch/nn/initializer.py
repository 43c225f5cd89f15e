"""Parameter initializers (the ``Normal`` and ``XavierNormal`` of
``paddle_tpu/nn/initializer.py``).

An initializer is called with a shape and returns a new tensor drawn on
``device`` from ``generator`` (``torch.Generator``; the reference draws
from its global ``jax.random`` key, so the two frameworks give other
numbers from one seed).  Draws are in f32 and cast to ``dtype``, as
there.
"""
from __future__ import annotations

import math

import torch

from ..common.errors import enforce

__all__ = ["Normal", "XavierNormal"]


class Normal:
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, *, device, dtype, generator):
        w = torch.empty([int(s) for s in shape], device=device,
                        dtype=torch.float32)
        w.normal_(self.mean, self.std, generator=generator)
        return w.to(dtype)


class XavierNormal:
    """Normal with std ``sqrt(2 / (fan_in + fan_out))`` for a Linear
    weight ``[in, out]`` (or a vector, whose fans are its length)."""

    def __call__(self, shape, *, device, dtype, generator):
        enforce(len(shape) in (1, 2), "XavierNormal takes a Linear weight "
                                      "[in, out] or a vector")
        std = math.sqrt(2.0 / (int(shape[0]) + int(shape[-1])))
        return Normal(0.0, std)(shape, device=device, dtype=dtype,
                                generator=generator)
