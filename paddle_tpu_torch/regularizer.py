"""paddle.regularizer (L1Decay / L2Decay; the port's copy of
``paddle_tpu/regularizer.py``).

An optimizer given one as ``weight_decay=`` takes its ``coeff``: L2Decay
as the coupled ``grad += coeff * param`` (decoupled for AdamW and Lamb),
L1Decay as ``grad += coeff * sign(param)`` on the eager ``step`` path.
The train step's per-leaf and fused updates apply the L2 form for both,
as the reference's ``apply_gradients`` does.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """L1 weight decay: grad += coeff * sign(param)."""


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: grad += coeff * param (coupled form)."""
