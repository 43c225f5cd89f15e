"""Int8 absmax quantize / dequantize primitives.

Counterpart of ``paddle_tpu/quantization/ops.py``, bit for bit:
symmetric absmax scaling (``scale = max(absmax, EPS) / QMAX``), values
``clip(round(x / scale), -127, 127)`` with round-half-to-even
(``torch.round``) and a true division, int8 storage, f32 scales.  The
int8 KV kernels (``csrc/int8_kv.cuh``) quantize rows in the same
operations, so a row quantized on the card and by :func:`quantize_rows`
gives the same codes and scale.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_absmax", "dequantize_absmax", "quantize_rows",
           "quantized_matmul", "QMAX", "EPS"]

QMAX = 127.0          # symmetric int8 range [-127, 127] (-128 unused)
EPS = 1e-8            # an all-zero channel quantizes to scale EPS / 127


@torch.no_grad()    # a weight's autograd graph would keep its f32 copies
def quantize_absmax(x, axis=0):
    """Per-channel absmax quantization to int8.  ``axis`` is the
    reduction axis the scale is shared over (for an ``[in, out]`` Linear
    weight, ``axis=0`` gives one scale per output channel).  Returns
    ``(q int8, scale f32 with axis removed)``."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the reference's division
    scale = absmax.clamp_min(EPS) / torch.full_like(absmax, QMAX)
    q = torch.round(xf / scale).clamp_(-QMAX, QMAX).to(torch.int8)
    return q, scale.squeeze(axis)


def dequantize_absmax(q, scale, axis=0, dtype=torch.float32):
    """Inverse of :func:`quantize_absmax` up to rounding."""
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


def quantize_rows(x):
    """One scale per row over the last axis (the KV pools' per-token
    granularity): x [..., D] -> (int8 [..., D], f32 [...])."""
    return quantize_absmax(x, axis=-1)


def quantized_matmul(x, qw, scale):
    """``x @ dequant(qw)`` with the per-output-channel scale folded into
    the product: ``(x @ qw) * scale``, the scale cast to the product's
    dtype first, as the reference does (in bf16 it multiplies by a
    bf16-rounded scale).  qw [in, out] int8, scale [out] f32."""
    y = x @ qw.to(x.dtype)
    return y * scale.to(y.dtype)
