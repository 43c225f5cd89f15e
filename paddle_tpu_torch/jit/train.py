"""The training step (counterpart of ``paddle_tpu/jit/train.py``).

``CompiledTrainStep`` keeps the reference's name and surface so a reader
finds the counterpart, but **runs eagerly**: forward, backward
(``torch.autograd.grad``), clip and optimizer update are issued op by op
on the current stream, with no compile step.  One call is one optimizer
step.  The loss comes back as a device tensor and lr, step and clip
scale reach the update as device scalars, so a step never waits for the
host; reading the loss (``float(loss)``) is the caller's sync.  The
trainer owns the dropout stream: a ``torch.Generator`` on the model's
device seeded from ``seed``, under which (``ops.random.rng_guard``) every
forward and backward runs, so hidden and attention dropout are
reproducible from ``seed``; their draws stay on the device.  The
generator's state is part of a checkpoint, so a resumed run draws the
masks the uninterrupted one would.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..nn.clip import global_norm_sq_f32
from ..observability import health as _health
from ..observability import tracing as _tracing
from ..ops import flops as _flops
from ..ops.random import rng_guard
from ..optimizer.optimizer import Optimizer

__all__ = ["CompiledTrainStep"]


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


class CompiledTrainStep:
    """Owns ``state = {"params": {name: tensor}, "opt": {"slots": {name:
    {...}}, "step": int32 tensor}}``; ``step(batch)`` is one update.

    ``loss_fn(model, batch)`` returns a scalar loss tensor (with
    ``has_aux``, a (loss, aux) pair: aux from the same forward comes back
    beside the loss); ``batch`` is the caller's dict, handed over as it
    is (tensors on the model's device; numpy arrays are copied there,
    which syncs the host once per call).

    ``state["params"]`` are the model's own parameters: updates land in
    place and the model sees them at once.  With ``donate=False`` each
    update writes into fresh tensors (params and slots cloned first,
    then updated), the model's parameters are pointed at them, and the
    ``state`` a caller held before the step keeps its values.

    The update is the optimizer's fused one (``fused_step=True``: the
    kernel's kinds with no clip or a global-norm clip launch the update
    kernel on CUDA tensors) or its per-leaf one (``fused_step=False``,
    and any optimizer or clip the kernel does not hold).  With
    ``grad_norm_tap`` the step keeps the f32 global norm of its
    gradients in ``last_grad_norm``, a device tensor (the same norm the
    clip's scale comes from), read by no one on the host.
    ``state_sharding_fn(state)`` returns the state the trainer keeps
    (``distributed.ShardedTrainStep`` passes its plan's, which keeps this
    rank's parts of the sharded leaves)."""

    _program_name = "train.compiled_step"

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer: Optimizer, seed: int = 0, donate: bool = True,
                 state_sharding_fn=None, has_aux: bool = False,
                 fused_step: bool = True, grad_norm_tap: bool = False):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = dict(model.named_parameters())
        self._device = next(iter(self._params.values())).device
        self.seed = seed
        self.generator = torch.Generator(device=self._device).manual_seed(
            seed)
        self._donate = donate
        self._has_aux = has_aux
        self._fused_step = fused_step
        # small-leaf packing: None = on where the update kernel runs
        self._fused_pack_small = None
        self._grad_norm_tap = bool(grad_norm_tap)
        self.last_grad_norm: Optional[torch.Tensor] = None
        self.state: Dict[str, Any] = {
            "params": self._state_params(),
            "opt": optimizer.init_state(self._params)}
        if state_sharding_fn is not None:
            # e.g. distributed.ShardingPlan.shard_state: this rank's parts
            self.state = state_sharding_fn(self.state)
        self._timer = None
        self._flops_cache: Optional[float] = None
        self._step_count = 0
        # the first call builds the kernels: the goodput meter books it
        # as "compile", every later step as "productive_step"
        self._compiled_once = False

    def _state_params(self) -> Dict[str, torch.Tensor]:
        if self._donate:
            return self._params
        return {n: p.detach() for n, p in self._params.items()}

    @property
    def step_count(self) -> int:
        """Optimizer updates applied (``__call__`` and ``apply_grads``)."""
        return self._step_count

    def _batch(self, batch):
        """The batch with every tensor and array on the model's device;
        dicts, lists and tuples (``hapi.Model``'s ``{"inputs": (...),
        "labels": (...)}``) keep their shape."""
        if isinstance(batch, dict):
            return {k: self._batch(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._batch(v) for v in batch)
        return torch.as_tensor(batch, device=self._device)

    # -- telemetry -----------------------------------------------------------
    def attach_timer(self, timer):
        """Attach an ``observability.StepTimer``: every ``__call__`` is
        then timed, fenced on its outputs and state (a stream sync: the
        device-inclusive step time)."""
        self._timer = timer

    def step_flops(self, batch) -> Optional[float]:
        """FLOPs of one step (the MFU numerator), counted once and
        cached: one forward and backward on ``batch`` under
        ``ops.flops.OperatorFlops`` (PyTorch's operators by
        ``FlopCounterMode``'s formulas; recomputed regions count twice,
        as they run), plus the operations the hand-written kernels report
        where they launch (``ops/flops.py``: invisible to the mode), plus
        the optimizer's ``update_flop_estimate``.  It applies no update
        and leaves the trainer's generator as it found it, so the
        dropout stream, and a resumed run, are unchanged.  None when
        nothing was counted."""
        if self._flops_cache is not None:
            return self._flops_cache if self._flops_cache > 0 else None
        rng = self.generator.get_state()
        try:
            with _flops.OperatorFlops() as counter, \
                    _flops.counting() as kernels:
                self.grad_step(batch)
            flops = float(counter.total) + kernels[0]
        finally:
            self.generator.set_state(rng)
        if flops > 0:
            flops += self.optimizer.update_flop_estimate(self._params)
        self._flops_cache = flops if flops > 0 else -1.0
        return flops if flops > 0 else None

    # -- the step --------------------------------------------------------------
    def _forward_backward(self, batch):
        params = self._params
        with torch.enable_grad(), rng_guard(self.generator):
            out = self.loss_fn(self.model, self._batch(batch))
            loss, aux = out if self._has_aux else (out, None)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        return loss.detach(), _detached(aux), {
            n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}

    def grad_step(self, batch) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
        """Forward + backward only: (loss, {name: grad}), each grad in
        its parameter's dtype; nothing is updated."""
        loss, _, grads = self._forward_backward(batch)
        return loss, grads

    def _fresh_state(self) -> Dict[str, Any]:
        """Clones of params and slots for a ``donate=False`` update."""
        st = self.state
        with torch.no_grad():
            return {"params": {n: t.detach().clone()
                               for n, t in st["params"].items()},
                    "opt": {"slots": {n: {k: v.clone() for k, v in s.items()}
                                      for n, s in st["opt"]["slots"].items()},
                            "step": st["opt"]["step"]}}

    def _update(self, grads: Dict[str, torch.Tensor],
                grad_norm: Optional[torch.Tensor] = None) -> None:
        opt = self.optimizer
        st = self.state if self._donate else self._fresh_state()
        if self._fused_step:
            _, st["opt"] = opt.apply_gradients_fused(
                st["params"], grads, st["opt"],
                pack_small=self._fused_pack_small, grad_norm=grad_norm)
        else:
            new_p, st["opt"] = opt.apply_gradients(st["params"], grads,
                                                   st["opt"])
            with torch.no_grad():
                for n, p in st["params"].items():
                    p.copy_(new_p[n])
        if not self._donate:
            for n, p in self._params.items():
                p.data = st["params"][n]
            self.state = st
        self._step_count += 1
        sched = opt._lr_scheduler
        if sched is not None:
            sched.step()

    def apply_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """The optimizer update from given (e.g. accumulated) grads; steps
        the scheduler."""
        self._update(grads)

    def __call__(self, batch):
        """One step: the loss (with ``has_aux``, (loss, aux)); steps the
        scheduler after the update."""
        # one span per optimizer step (covers the timer's fence when a
        # timer is attached); the shared NULL_SPAN when tracing is off
        span = _tracing.span(self._program_name)
        span.set_attr("step", self._step_count)
        with _health.goodput_region(
                "productive_step" if self._compiled_once else "compile"):
            if self._timer is not None:
                self._timer.start()
            loss, aux, grads = self._forward_backward(batch)
            gnorm = None
            if self._grad_norm_tap:
                gnorm = torch.sqrt(global_norm_sq_f32(
                    [grads[n] for n in sorted(grads)]))
                self.last_grad_norm = gnorm
            self._update(grads, grad_norm=gnorm)
            out = (loss, aux) if self._has_aux else loss
            if self._timer is not None:
                self._timer.stop(fence=(self.state, out))
        self._compiled_once = True
        span.end()
        return out

    def eval_step(self, eval_fn: Callable, batch):
        """``eval_fn(model, batch)`` with no grad and no update, its
        draws from the trainer's generator."""
        with torch.no_grad(), rng_guard(self.generator):
            return eval_fn(self.model, self._batch(batch))

    # -- checkpoint/resume ---------------------------------------------------
    def _ckpt_tree(self):
        """The resumable tensor state: params and the optimizer's slots
        and step, and the generator's state (under a key of its own: a
        ``torch.Generator``'s state is not the reference's jax key).
        Literal state rides in the manifest's literals."""
        return {"state": self.state,
                "torch_rng_state": self.generator.get_state()}

    def save_checkpoint(self, path: str, async_save: bool = False,
                        extra_state=None):
        """Checkpoint of the full training state (params, optimizer slots
        and step, the generator, the scheduler's position, the update
        count) in ``distributed.checkpoint``'s format, the reference's
        keys and layout.  ``extra_state`` (a JSON-able dict, e.g. the
        loop's epoch) comes back from ``load_checkpoint``.  The state is
        copied to the host before this returns; with ``async_save=True``
        the disk writes run behind an AsyncSaveHandle whose ``wait()``
        surfaces writer failures."""
        from ..distributed import checkpoint as dck
        sched = self.optimizer._lr_scheduler
        tree = self._ckpt_tree()
        # one JSON literal: scheduler state may hold lists (milestones,
        # boundaries) which must not be key-flattened into the manifest
        tree["lr_sched"] = json.dumps(sched.state_dict()) \
            if sched is not None else None
        tree["step_count"] = int(self._step_count)
        if extra_state is not None:
            tree["extra"] = json.dumps(extra_state)
        return dck.save_state_dict(tree, path, async_save=async_save)

    def load_checkpoint(self, path: str):
        """Restore from ``save_checkpoint`` output into the current state
        (in place: the model's parameters take the saved values).  The
        scheduler's state is restored only when both sides have one.
        Every chunk read is sha256-verified; corruption raises
        CorruptCheckpointError before any state changes.  Returns the
        saved ``extra_state`` (None if none was)."""
        from ..distributed import checkpoint as dck
        meta = dck.get_checkpoint_metadata(path)
        tree = self._ckpt_tree()
        dck.load_state_dict(tree, path, metadata=meta)
        self.generator.set_state(tree["torch_rng_state"])
        self._step_count = int(meta["literals"].get("step_count") or 0)
        sched = self.optimizer._lr_scheduler
        saved = meta["literals"].get("lr_sched")
        if sched is not None and saved:
            sched.set_state_dict(json.loads(saved))
        extra = meta["literals"].get("extra")
        return json.loads(extra) if extra else None

    # -- state sync with the model -------------------------------------------
    def sync_to_model(self):
        """Copy ``state["params"]`` into the model's parameters where a
        caller put other tensors there.  The trainer's own updates and
        loads already land in the model (the state holds its parameters,
        or with ``donate=False`` tensors that share their storage), so
        for those this copies nothing."""
        with torch.no_grad():
            for n, p in self._params.items():
                t = self.state["params"][n]
                if t is not p and t.data_ptr() != p.data_ptr():
                    p.copy_(t)

    def sync_from_model(self):
        """Point ``state["params"]`` at the model's current parameters
        (after the caller replaced or reloaded them); the optimizer's
        slots stay as they are."""
        self._params = dict(self.model.named_parameters())
        self.state["params"] = self._state_params()
