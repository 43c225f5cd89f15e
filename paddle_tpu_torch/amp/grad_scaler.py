"""Dynamic loss scaling for float16 training (counterpart of
``paddle_tpu/amp/grad_scaler.py``): ``GradScaler`` over the port's eager
optimizer API (``Optimizer._parameter_list`` and each parameter's
``.grad``).

It makes the reference's decisions in the reference's order: scale the
loss; unscale every gradient by 1 / scale and look for inf or NaN; step
the optimizer only when none was found; then count good or bad steps,
back off by ``decr_ratio`` (never below 1) after
``decr_every_n_nan_or_inf`` bad ones in a row and grow by ``incr_ratio``
after ``incr_every_n_steps`` good ones.  The reference reads one flag a
parameter on the host; here the flags of all gradients are folded into
one device tensor (``torch.isfinite(...).all()`` a gradient, the results
stacked), read once a step.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler"]


class GradScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        """Every gradient times 1 / scale, in its own dtype; records
        whether any holds an inf or a NaN (one host read)."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        finite = []
        with torch.no_grad():
            for p in optimizer._parameter_list or []:
                if p.grad is None:
                    continue
                p.grad = p.grad * inv
                finite.append(torch.isfinite(p.grad).all())
        self._found_inf = bool(finite) and not bool(torch.stack(finite).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
