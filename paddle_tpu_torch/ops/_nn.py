"""Plain tensor ops of the serving path (subset of ``paddle_tpu/ops/_nn.py``).

Neither is a kernel on the TPU either: both are elementwise passes the
compiler fuses there, and plain PyTorch here.
"""
from __future__ import annotations

import torch

__all__ = ["rms_norm", "silu"]


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6,
             axis: int = -1) -> torch.Tensor:
    """RMSNorm (Llama family) with f32 statistics whatever the input
    dtype: normalise in f32, cast back, then scale by ``weight`` in the
    input dtype — the reference's order of roundings."""
    dt = x.dtype
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(dt)
    if weight is not None:
        out = out * weight
    return out
