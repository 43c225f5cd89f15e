"""Parameter initializers (the ``Constant``, ``Normal``, ``XavierNormal``,
``XavierUniform`` and ``KaimingNormal`` of
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

__all__ = ["Constant", "Normal", "XavierNormal", "XavierUniform",
           "KaimingNormal"]


def _fan_in_out(shape):
    """(fan_in, fan_out) of a vector, a Linear weight ``[in, out]`` or a
    convolution weight ``[out, in / groups, *kernel]``."""
    shape = [int(s) for s in shape]
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Constant:
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, *, device, dtype, generator):
        return torch.full([int(s) for s in shape], float(self.value),
                          device=device, dtype=dtype)


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


class XavierUniform:
    """Uniform in ``[-l, l]``, ``l = sqrt(6 / (fan_in + fan_out))``."""

    def __call__(self, shape, *, device, dtype, generator):
        fi, fo = _fan_in_out(shape)
        limit = math.sqrt(6.0 / (fi + fo))
        w = torch.empty([int(s) for s in shape], device=device,
                        dtype=torch.float32)
        w.uniform_(-limit, limit, generator=generator)
        return w.to(dtype)


class KaimingNormal:
    """Normal with std ``sqrt(2) / sqrt(fan_in)`` (the ReLU gain), the
    reference's default for a convolution weight."""

    def __call__(self, shape, *, device, dtype, generator):
        fi = _fan_in_out(shape)[0]
        return Normal(0.0, math.sqrt(2.0) / math.sqrt(fi))(
            shape, device=device, dtype=dtype, generator=generator)
