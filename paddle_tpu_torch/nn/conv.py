"""Convolution layers: ``Conv2D`` (counterpart of the ``Conv2D`` of
``paddle_tpu/nn/conv.py``).

Paddle's weight layout ``[out_channels, in_channels / groups, kH, kW]``
is PyTorch's, so a reference ``raw_state_dict()`` loads 1:1.  The
weight is drawn on ``device`` from ``generator`` (default
``KaimingNormal``, the reference's), the bias is zeros
(``bias_attr=False`` drops it).  The convolution is
``nn.functional.conv2d`` (``F.conv2d`` on cuDNN): the reference runs it
in XLA outside any Pallas kernel.  The other convolutions and the pools
are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F
from .common import _draw
from .initializer import Constant, KaimingNormal

__all__ = ["Conv2D"]


class Conv2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW", *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"Conv2D padding_mode {padding_mode!r} is not ported yet "
                "(ROADMAP 'Port: remaining modules')")
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = k
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        self.weight = _draw(weight_attr or KaimingNormal(),
                            [out_channels, in_channels // groups, *k],
                            device, dtype, generator)
        self.bias = None if bias_attr is False else _draw(
            bias_attr or Constant(0.0), [out_channels], device, dtype,
            generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"k={self.kernel_size}, s={self.stride}")
