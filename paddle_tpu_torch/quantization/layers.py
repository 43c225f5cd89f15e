"""Weight-only int8 layers and the in-place model converter.

Counterpart of ``paddle_tpu/quantization/layers.py``.
``QuantizedLinear`` keeps the ``[in, out]`` weight as an int8 ``qweight``
buffer with one f32 ``weight_scale`` per output channel (symmetric
absmax) and an optional float bias; ``quantize_model`` swaps every port
``Linear`` of a Llama or Qwen2-MoE decoder for one, in place.
``LLMEngine`` takes such a model as it is (its ``qweight`` /
``weight_scale`` pairs), and ``weight_dtype="int8"`` quantizes a float
model's projections the same way.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from ..common.errors import enforce
from ..nn.common import Linear
from .ops import dequantize_absmax, quantize_absmax, quantized_matmul

__all__ = ["QuantizedLinear", "quantize_model"]


class QuantizedLinear(nn.Module):
    """``y = x @ dequant(W_int8) + b``, inference only."""

    def __init__(self, in_features: int, out_features: int,
                 device=None, bias=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.register_buffer("qweight", torch.zeros(
            (in_features, out_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.bias = bias

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: Linear) -> "QuantizedLinear":
        """Quantize a float ``Linear``'s weight per output channel; the
        bias, if any, is carried over in float."""
        w = linear.weight
        q = cls(w.shape[0], w.shape[1], device=w.device, bias=linear.bias)
        q.qweight, q.weight_scale = quantize_absmax(w, axis=0)
        return q

    def dequantized_weight(self):
        """The f32 ``[in, out]`` weight this layer computes with."""
        return dequantize_absmax(self.qweight, self.weight_scale, axis=0)

    def forward(self, x):
        y = quantized_matmul(x, self.qweight, self.weight_scale)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def quantize_model(model: nn.Module, weight_dtype: str = "int8",
                   skip: Optional[Iterable[str]] = None) -> nn.Module:
    """Swap every port ``Linear`` under ``model`` for a
    ``QuantizedLinear`` of its int8-quantized weight, in place, and
    return the model.  ``skip``: name substrings to keep in float (e.g.
    ``("lm_head",)``)."""
    enforce(weight_dtype == "int8",
            f"unsupported weight_dtype {weight_dtype!r} (only 'int8')")
    skip = tuple(skip or ())
    for name, module in list(model.named_modules()):
        for child_name, child in list(module.named_children()):
            full = f"{name}.{child_name}" if name else child_name
            if not isinstance(child, Linear) or \
                    any(s in full for s in skip):
                continue
            setattr(module, child_name, QuantizedLinear.from_linear(child))
    return model
