"""Gradient clipping strategies (counterpart of ``paddle_tpu/nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm`` (per tensor) and
``ClipGradByGlobalNorm`` (the LLM recipe's), with ``clip_grad_value_``
and ``clip_grad_norm_`` over parameters' ``.grad``.

Every value stays on the device: the norm, the scale and the clipped
gradients are tensors, so a train step that clips never waits for the
host.  Each strategy's ``transform`` takes a list of gradients and
returns the clipped list, each in its own dtype; ``__call__`` takes the
paddle signature, a list of (param, grad) pairs.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_value_", "clip_grad_norm_",
           "clip_scale", "global_norm_sq_f32", "norm_scale"]


def global_norm_sq_f32(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of squared L2 norms over grad leaves, with both the squaring
    and the accumulation in f32 whatever the leaf dtype (a bf16 running
    sum saturates near 256), leaf sums added one after another in the
    given order."""
    total = None
    for g in leaves:
        s = g.float().square().sum()
        total = s if total is None else total + s
    return total


def norm_scale(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """``min(1, clip_norm / max(norm, 1e-12))`` as an f32 device scalar."""
    # a true division: ``float / tensor`` would multiply by a reciprocal
    c = torch.full_like(norm, clip_norm)
    return torch.clamp(c / torch.clamp(norm, min=1e-12), max=1.0)


def clip_scale(leaves: Sequence[torch.Tensor],
               clip_norm: float) -> torch.Tensor:
    """The global-norm clip's scale over ``leaves``."""
    return norm_scale(torch.sqrt(global_norm_sq_f32(leaves)), clip_norm)


class ClipGradBase:
    def transform(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def __call__(self, params_and_grads):
        """paddle signature: a list of (param, grad) pairs; returns the
        pairs with each grad clipped."""
        clipped = self.transform([g for _, g in params_and_grads])
        return [(p, g) for (p, _), g in zip(params_and_grads, clipped)]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def transform(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Per-tensor L2 norm clip, the norm in f32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def transform(self, grads):
        out = []
        for g in grads:
            gf = g.float()
            scale = norm_scale(torch.sqrt(gf.square().sum()), self.clip_norm)
            out.append((gf * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Global L2 norm clip across all gradient leaves, the norm's sum in
    f32."""

    def __init__(self, clip_norm: float = 1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def transform(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The clipped gradients, each in its own dtype."""
        if not grads:
            return list(grads)
        scale = clip_scale(grads, self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.sqrt(global_norm_sq_f32(grads))


def clip_grad_value_(parameters, clip_value):
    """Clamp every parameter's ``.grad`` to [-clip_value, clip_value] in
    place."""
    clip = ClipGradByValue(clip_value)
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p.grad.copy_(clip.transform([p.grad])[0])


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False) -> torch.Tensor:
    """Clip the parameters' ``.grad`` in place by their global L2 norm
    (the reference's, whatever ``norm_type``); returns that norm as an
    f32 device scalar."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros((), dtype=torch.float32)
    clip = ClipGradByGlobalNorm(max_norm)
    grads = [p.grad for p in params]
    norm = clip.global_norm(grads)
    with torch.no_grad():
        for p, g in zip(params, clip.transform(grads)):
            p.grad.copy_(g)
    return norm
