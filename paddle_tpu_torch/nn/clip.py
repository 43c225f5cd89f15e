"""Gradient clipping by global norm (counterpart of the
``ClipGradByGlobalNorm`` half of ``paddle_tpu/nn/clip.py``).

Every value stays on the device: the norm, the scale and the clipped
gradients are tensors, so a train step that clips never waits for the
host.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["ClipGradByGlobalNorm", "clip_scale", "global_norm_sq_f32"]


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


def clip_scale(leaves: Sequence[torch.Tensor],
               clip_norm: float) -> torch.Tensor:
    """``min(1, clip_norm / max(global_norm, 1e-12))`` as an f32 device
    scalar."""
    gnorm = torch.sqrt(global_norm_sq_f32(leaves))
    # a true division: ``float / tensor`` would multiply by a reciprocal
    c = torch.full_like(gnorm, clip_norm)
    return torch.clamp(c / torch.clamp(gnorm, min=1e-12), max=1.0)


class ClipGradByGlobalNorm:
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
