"""Normalization layers (the ``LayerNorm`` and ``RMSNorm`` of
``paddle_tpu/nn/norm.py``).

Each has ``forward(x)`` and ``forward_residual(x, residual) -> (h, y)``
with ``h = residual + x`` and ``y = self(h)``: the residual add fused
into the norm, one launch of the add+norm kernel on the card
(``nn/functional.py`` -> ``ops/fused_train.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import _nn
from ..runtime.device import resolve_device
from . import functional as F

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes with f32
    statistics; ``weight_attr=False`` / ``bias_attr=False`` drop the
    scale (ones) / the shift (zeros)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, **kw))

    def forward(self, x):
        return _nn.layer_norm(x, self.normalized_shape, self.weight,
                              self.bias, self.epsilon)

    def forward_residual(self, x, residual):
        """``(h, y)``: ``h = residual + x``, ``y = self(h)``; one fused
        pass for a last-axis norm, the plain chain otherwise."""
        if len(self.normalized_shape) == 1:
            return F.add_layer_norm(x, residual, self.weight, self.bias,
                                    self.epsilon)
        h = residual + x
        return h, self.forward(h)


class RMSNorm(nn.Module):
    """The Llama-family norm: f32 statistics, scale by ``weight`` (ones
    at construction) in the input dtype."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return _nn.rms_norm(x, self.weight, epsilon=self.epsilon)

    def forward_residual(self, x, residual):
        """``(h, y)``: ``h = residual + x``, ``y = self(h)`` -- the
        Llama decoder's post-attention chain as one fused pass."""
        return F.add_rms_norm(x, residual, self.weight, self.epsilon)
