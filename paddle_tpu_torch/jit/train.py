"""The training step (counterpart of ``paddle_tpu/jit/train.py``).

``CompiledTrainStep`` keeps the reference's name and surface so a reader
finds the counterpart, but **runs eagerly**: forward, backward
(``torch.autograd.grad``), global-norm clip and the fused optimizer
update are issued op by op on the current stream, with no compile step.
One call is one optimizer step.  The loss comes back as a device tensor
and lr, step and clip scale reach the update kernel as device scalars,
so a step never waits for the host; reading the loss (``float(loss)``)
is the caller's sync.  The trainer owns the dropout stream: a
``torch.Generator`` on the model's device seeded from ``seed``, under
which (``ops.random.rng_guard``) every forward and backward runs, so
hidden and attention dropout are reproducible from ``seed``; their
draws stay on the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..ops.random import rng_guard
from ..optimizer.optimizer import Optimizer

__all__ = ["CompiledTrainStep"]


class CompiledTrainStep:
    """Owns ``state = {"params": {name: Parameter}, "opt": {"slots":
    {name: {...}}, "step": int32 tensor}}``; ``step(batch)`` is
    ``step.__call__``.

    ``loss_fn(model, batch)`` returns a scalar loss tensor; ``batch`` is
    the caller's dict, handed over as it is (tensors on the model's
    device; numpy arrays are copied there, which syncs the host once per
    call).  The parameters are the model's own: updates land in place
    and the model sees them at once."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer: Optimizer, seed: int = 0, donate: bool = True,
                 state_sharding_fn=None, has_aux: bool = False,
                 fused_step: bool = True, grad_norm_tap: bool = False):
        # reference keywords outside the slice; donate=True is what the
        # port does (updates land in place)
        todo = {"donate=False": (not donate, "Port: remaining modules"),
                "sharded train state (state_sharding_fn)": (
                    state_sharding_fn is not None, "Port: remaining modules"),
                "has_aux=True": (has_aux, "Port: remaining modules"),
                "grad_norm_tap=True": (grad_norm_tap,
                                       "Port: remaining modules")}
        for knob, (asked, item) in todo.items():
            if asked:
                raise NotImplementedError(
                    f"CompiledTrainStep {knob} is not ported yet (ROADMAP "
                    f"'{item}')")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        params = dict(model.named_parameters())
        self._device = next(iter(params.values())).device
        if not fused_step and self._device.type != "cpu":
            raise NotImplementedError(
                "fused_step=False (the per-leaf plain update) runs on CPU "
                "tensors only; on the card the update goes through the "
                "fused kernel (ROADMAP 'Port: remaining modules')")
        self.seed = seed
        self.generator = torch.Generator(device=self._device).manual_seed(
            seed)
        self.state: Dict[str, Any] = {
            "params": params, "opt": optimizer.init_state(params)}
        self._fused_step = fused_step
        # small-leaf packing: None = on where the update kernel runs
        self._fused_pack_small = None
        self._step_count = 0

    @property
    def step_count(self) -> int:
        """Optimizer updates applied (``__call__`` and ``apply_grads``)."""
        return self._step_count

    def _batch(self, batch):
        return {k: torch.as_tensor(v, device=self._device)
                for k, v in batch.items()}

    def grad_step(self, batch) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
        """Forward + backward only: (loss, {name: grad}), each grad in
        its parameter's dtype; nothing is updated."""
        params = self.state["params"]
        with torch.enable_grad(), rng_guard(self.generator):
            loss = self.loss_fn(self.model, self._batch(batch))
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}

    def apply_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """The optimizer update from given (e.g. accumulated) grads."""
        opt, st = self.optimizer, self.state
        if self._fused_step:
            _, st["opt"] = opt.apply_gradients_fused(
                st["params"], grads, st["opt"],
                pack_small=self._fused_pack_small)
        else:
            new_p, st["opt"] = opt.apply_gradients(st["params"], grads,
                                                   st["opt"])
            with torch.no_grad():
                for n, p in st["params"].items():
                    p.copy_(new_p[n])
        self._step_count += 1

    def __call__(self, batch) -> torch.Tensor:
        loss, grads = self.grad_step(batch)
        self.apply_grads(grads)
        return loss

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "train-state checkpoints are not ported yet (ROADMAP 'Port: "
            "remaining modules')")

    load_checkpoint = save_checkpoint
