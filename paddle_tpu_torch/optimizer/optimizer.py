"""Optimizers: the functional core of ``paddle_tpu/optimizer/
optimizer.py`` for SGD, Momentum, Adam and AdamW.

Each optimizer defines ``init_slots(param)`` and ``update(param, grad,
slots, lr, step)`` in f32 tensor ops.  ``init_state`` / ``apply_
gradients`` are the reference's unfused per-leaf path: they return new
tensors and change nothing; ``apply_gradients`` takes CPU tensors only
(on the card an update goes through the kernel).  ``apply_gradients_fused`` is the train
step's path: global-norm clip folded into one pass over each (param,
grad, slots) triple, through the kernel of ``ops/fused_train.py`` on the
card and its plain version on the CPU; it updates the parameters and
slots **in place** (an 8B-wide model has no room for a second copy).

State is a dict ``{"slots": {name: {slot: f32 tensor}}, "step": int32
0-dim tensor}`` over a dict of named parameters, the reference's pytree
with names for leaves.  Nothing here syncs the host: lr, the step and
the clip scale stay device tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..common.errors import enforce
from ..nn.clip import ClipGradByGlobalNorm, clip_scale
from ..ops import fused_train as FT

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision: bool = True):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP "
                "'Port: remaining modules'); pass a float")
        enforce(grad_clip is None
                or isinstance(grad_clip, ClipGradByGlobalNorm),
                "the port clips by global norm only (ClipGradByGlobalNorm)")
        self._learning_rate = float(learning_rate)
        self._weight_decay = 0.0 if weight_decay is None else (
            weight_decay if isinstance(weight_decay, float) else
            getattr(weight_decay, "coeff", 0.0))
        self._grad_clip = grad_clip
        self._lr_cache: Optional[Tuple[Tuple, torch.Tensor]] = None

    # -- functional core (override in subclasses) -------------------------
    def init_slots(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def update(self, param, grad, slots, lr, step):
        raise NotImplementedError

    def _decoupled_weight_decay(self) -> bool:
        return False

    def get_lr(self) -> float:
        return self._learning_rate

    def _lr_tensor(self, lr, device) -> torch.Tensor:
        """lr as an f32 device scalar, made again only when the value or
        the device changes (a host-to-device copy each step would sync
        the host)."""
        if isinstance(lr, torch.Tensor):
            return lr.to(device=device, dtype=torch.float32)
        key = (device, float(lr))
        if self._lr_cache is None or self._lr_cache[0] != key:
            self._lr_cache = (key, torch.tensor(float(lr),
                                                dtype=torch.float32,
                                                device=device))
        return self._lr_cache[1]

    # -- the reference's unfused path ---------------------------------------
    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        dev = next(iter(params.values())).device if params else None
        with torch.no_grad():
            slots = {n: self.init_slots(p) for n, p in params.items()}
        return {"slots": slots,
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def apply_gradients(self, params, grads, state, lr=None):
        """One optimizer step over dicts of tensors; returns (new params,
        new state) and leaves its inputs alone."""
        names = sorted(params)
        if not names:
            return params, state
        dev = params[names[0]].device
        if dev.type != "cpu":
            raise NotImplementedError(
                "the per-leaf plain update (apply_gradients: "
                "CompiledTrainStep(fused_step=False), or an optimizer whose "
                "update has no fused kind) runs on CPU tensors only; on the "
                "card the update goes through the fused kernel "
                "(apply_gradients_fused; ROADMAP 'Port: remaining modules')")
        lr = self._lr_tensor(self.get_lr() if lr is None else lr, dev)
        step = state["step"] + 1
        gl = [grads[n] for n in names]
        if self._grad_clip is not None:
            gl = self._grad_clip.transform(gl)
        new_p, new_s = {}, {}
        with torch.no_grad():
            for n, g in zip(names, gl):
                p = params[n]
                gf, pf = g.float(), p.float()
                if self._weight_decay and not self._decoupled_weight_decay():
                    gf = gf + self._weight_decay * pf
                np_, ns = self.update(pf, gf, state["slots"][n], lr, step)
                new_p[n], new_s[n] = np_.to(p.dtype), ns
        return new_p, {"slots": new_s, "step": step}

    # -- the fused path (ops/fused_train) ------------------------------------
    _PACK_MAX_BYTES = 1 << 20   # leaves below this pack into flat buffers

    def _fused_kind(self) -> Optional[str]:
        """The fused-kernel family of this optimizer's ``update``, keyed
        on the function itself: a subclass that overrides the math takes
        the per-leaf path (CPU tensors only) instead of someone else's
        kernel."""
        upd = type(self).update
        if upd is SGD.update:
            return "sgd"
        if upd is Momentum.update:
            return "momentum"
        if upd in (Adam.update, AdamW.update):
            return "adam"
        return None

    def _fused_hyper(self) -> Dict[str, Any]:
        hp: Dict[str, Any] = {"weight_decay": self._weight_decay,
                              "decoupled": self._decoupled_weight_decay()}
        kind = self._fused_kind()
        if kind == "momentum":
            hp.update(momentum=self._momentum, nesterov=self._nesterov)
        elif kind == "adam":
            hp.update(beta1=self._beta1, beta2=self._beta2,
                      epsilon=self._eps)
        return hp

    def apply_gradients_fused(self, params, grads, state, lr=None,
                              pack_small: Optional[bool] = None):
        """One fused step: global grad norm -> clip scale -> one pass of
        clip-fold + update per (param, grad, slots) triple, **in place**
        on ``params`` and ``state["slots"]``; returns (params, state) with
        the step advanced.

        ``pack_small`` (None: on for CUDA tensors, where it saves kernel
        launches) packs the leaves under 1 MiB into one flat buffer per
        (param dtype, grad dtype), updates the buffer in one launch and
        copies the results back into every leaf and its slots."""
        kind = self._fused_kind()
        if kind is None:
            new_p, new_state = self.apply_gradients(params, grads, state,
                                                    lr=lr)
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(new_p[n])
            return params, new_state
        names = sorted(params)
        step = state["step"] + 1
        if not names:
            return params, {"slots": state["slots"], "step": step}
        dev = params[names[0]].device
        if pack_small is None:
            pack_small = dev.type == "cuda"
        clip = self._grad_clip
        gl = [grads[n] for n in names]
        scale = clip_scale(gl, clip.clip_norm) if clip is not None \
            else torch.ones((), dtype=torch.float32, device=dev)
        lr_t = self._lr_tensor(self.get_lr() if lr is None else lr, dev)
        scalars = torch.stack([lr_t, step.float(), scale.float()])
        hyper = self._fused_hyper()
        keys = FT.SLOT_KEYS[kind]
        slots = state["slots"]
        groups: Dict[Tuple[torch.dtype, torch.dtype], List[str]] = {}
        singles: List[str] = []
        for n in names:
            p = params[n]
            if pack_small and p.numel() * p.element_size() \
                    < self._PACK_MAX_BYTES:
                groups.setdefault((p.dtype, grads[n].dtype), []).append(n)
            else:
                singles.append(n)
        for members in list(groups.values()):
            if len(members) == 1:     # a lone leaf gains nothing from a pack
                singles.append(members.pop())
        with torch.no_grad():
            for n in singles:
                FT.fused_update_flat(
                    kind, params[n], grads[n].contiguous(), slots[n],
                    scalars=scalars, has_clip=clip is not None, hyper=hyper)
            for members in groups.values():
                if not members:
                    continue
                pc = torch.cat([params[n].reshape(-1) for n in members])
                gc = torch.cat([grads[n].reshape(-1) for n in members])
                sc = {k: torch.cat([slots[n][k].reshape(-1)
                                    for n in members]) for k in keys}
                FT.fused_update_flat(kind, pc, gc, sc, scalars=scalars,
                                     has_clip=clip is not None, hyper=hyper)
                off = 0
                for n in members:
                    m = params[n].numel()
                    params[n].copy_(pc[off:off + m].view_as(params[n]))
                    for k in keys:
                        slots[n][k].copy_(sc[k][off:off + m].view_as(
                            slots[n][k]))
                    off += m
        return params, {"slots": slots, "step": step}


def _zeros_f32(param):
    return torch.zeros(param.shape, dtype=torch.float32,
                       device=param.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def update(self, param, grad, slots, lr, step):
        return param - lr * grad, slots


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_slots(self, param):
        return {"velocity": _zeros_f32(param)}

    def update(self, param, grad, slots, lr, step):
        v = self._momentum * slots["velocity"] + grad
        if self._nesterov:
            new_p = param - lr * (grad + self._momentum * v)
        else:
            new_p = param - lr * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slots(self, param):
        return {"moment1": _zeros_f32(param), "moment2": _zeros_f32(param)}

    def update(self, param, grad, slots, lr, step):
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * grad
        v = self._beta2 * slots["moment2"] \
            + (1 - self._beta2) * torch.square(grad)
        step_f = step.float()
        bc1 = 1 - torch.pow(self._beta1, step_f)
        bc2 = 1 - torch.pow(self._beta2, step_f)
        mhat = m / bc1
        vhat = v / bc2
        new_p = param - lr * mhat / (torch.sqrt(vhat) + self._eps)
        return new_p, {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Adam with decoupled weight decay (the LLM recipe's optimizer)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None, **kw):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW lr_ratio / apply_decay_param_fun are not ported yet "
                "(ROADMAP 'Port: remaining modules')")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)

    def _decoupled_weight_decay(self):
        return True

    def update(self, param, grad, slots, lr, step):
        new_p, new_slots = super().update(param, grad, slots, lr, step)
        if self._weight_decay:
            new_p = new_p - lr * self._weight_decay * param
        return new_p, new_slots
