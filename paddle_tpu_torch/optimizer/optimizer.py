"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
SGD, Momentum, Adam, AdamW, Adagrad, Adamax, RMSProp, Lamb, Adadelta,
ASGD, Rprop, NAdam, RAdam and LBFGS.

Each optimizer defines ``init_slots(param)`` and ``update(param, grad,
slots, lr, step)`` in f32 tensor ops, the reference's arithmetic op for
op.  The same math drives three paths:

- the eager API over the ``parameters`` the optimizer was built with
  (``nn.Parameter``s, their gradient in ``.grad``): ``step``,
  ``clear_grad``, ``minimize``, ``state_dict`` / ``set_state_dict``;
  L1Decay takes its sign form here;
- ``init_state`` / ``apply_gradients``, the reference's per-leaf update
  over dicts of named tensors on any device: new tensors, inputs left
  alone;
- ``apply_gradients_fused``, the train step's path: for the kernel's
  kinds (SGD, Momentum, Adam, AdamW) with no clip or a global-norm
  clip, one pass of clip-fold + update per (param, grad, slots) triple
  through the kernel of ``ops/fused_train.py`` on CUDA tensors (its
  plain version on the CPU), **in place** on the parameters and slots
  (an 8B-wide model has no room for a second copy).  Any other
  optimizer or clip takes the per-leaf update, as the reference's
  dispatch does: the choice rests on the optimizer's kind, the clip's
  type and the caller, never on a failed launch.

State is a dict ``{"slots": {name: {slot: f32 tensor}}, "step": int32
0-dim tensor}`` over a dict of named parameters, the reference's pytree
with names for leaves.  Nothing here syncs the host on the train step's
paths: lr, the step and the clip scale stay device tensors.  A
scheduler's lr reaches the device through one persistent f32 scalar a
device, filled in place each step (a fill launch carries the value as an
argument: no host-to-device copy, no wait).
"""
from __future__ import annotations

import numbers
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..common.errors import enforce
from ..nn.clip import (ClipGradBase, ClipGradByGlobalNorm,
                       global_norm_sq_f32, norm_scale)
from ..ops import fused_train as FT
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adamax", "RMSProp", "Lamb", "Adadelta", "ASGD", "Rprop",
           "NAdam", "RAdam", "LBFGS"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None,
                 grad_clip: Optional[ClipGradBase] = None, name=None,
                 multi_precision: bool = True):
        enforce(isinstance(learning_rate, (numbers.Real, LRScheduler)),
                f"learning_rate must be a float or an LRScheduler, got "
                f"{type(learning_rate).__name__}")
        self._learning_rate = learning_rate
        # parameters: nn.Parameters, or (name, Parameter) pairs such as
        # ``model.named_parameters()`` (a torch tensor has no settable
        # ``name``): the names key ``state_dict`` and reach AdamW's
        # ``apply_decay_param_fun``
        plist = list(parameters) if parameters is not None else None
        self._param_names: Dict[int, str] = {}
        if plist and isinstance(plist[0], tuple):
            self._param_names = {id(p): n for n, p in plist}
            plist = [p for _, p in plist]
        self._parameter_list = plist
        self._weight_decay = 0.0 if weight_decay is None else (
            weight_decay if isinstance(weight_decay, float) else
            getattr(weight_decay, "coeff", 0.0))
        # paddle.regularizer.L1Decay means coeff * sign(param) on the
        # eager path, not the L2 form
        self._l1_decay = type(weight_decay).__name__ == "L1Decay"
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._slots: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        self._lr_dev: Dict[torch.device, torch.Tensor] = {}

    def _param_name(self, p, i: int) -> str:
        return self._param_names.get(id(p)) or f"param_{i}"

    # -- functional core (override in subclasses) -------------------------
    def init_slots(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def update(self, param, grad, slots, lr, step):
        raise NotImplementedError

    def _decoupled_weight_decay(self) -> bool:
        return False

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value: float):
        enforce(not isinstance(self._learning_rate, LRScheduler),
                "cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self) -> Optional[LRScheduler]:
        return self._learning_rate if isinstance(self._learning_rate,
                                                 LRScheduler) else None

    def _lr_tensor(self, lr, device) -> torch.Tensor:
        """lr as an f32 device scalar: one persistent scalar a device,
        filled with this step's value (the fill's argument carries it, so
        a schedule costs no copy and no wait)."""
        if isinstance(lr, torch.Tensor):
            return lr.to(device=device, dtype=torch.float32)
        dev = torch.device(device)
        t = self._lr_dev.get(dev)
        if t is None:
            t = self._lr_dev[dev] = torch.empty((), dtype=torch.float32,
                                                device=dev)
        return t.fill_(float(lr))

    # -- eager path ----------------------------------------------------------
    def step(self):
        """One update of every parameter with a ``.grad``, in place."""
        params = self._parameter_list
        enforce(params is not None,
                "optimizer constructed without a parameter list")
        lr = self.get_lr()
        self._step_count += 1
        with_grad = [p for p in params
                     if p.grad is not None and p.requires_grad]
        if not with_grad:
            return
        grads = [p.grad for p in with_grad]
        if self._grad_clip is not None:
            grads = self._grad_clip.transform(grads)
        scalars: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        with torch.no_grad():
            for p, g in zip(with_grad, grads):
                if p.device not in scalars:
                    scalars[p.device] = (
                        self._lr_tensor(lr, p.device),
                        torch.full((), self._step_count, dtype=torch.int32,
                                   device=p.device))
                lr_t, step_t = scalars[p.device]
                if g.dtype != p.dtype:
                    g = g.to(p.dtype)
                if self._weight_decay and not self._decoupled_weight_decay():
                    g = g + self._weight_decay * (
                        torch.sign(p) if self._l1_decay else p)
                slots = self._slots.get(id(p))
                if slots is None:
                    slots = self.init_slots(p)
                new_p, new_slots = self.update(p.detach(), g, slots, lr_t,
                                               step_t)
                p.copy_(new_p.to(p.dtype))
                self._slots[id(p)] = new_slots

    def clear_grad(self, set_to_zero: bool = False):
        if self._parameter_list is not None:
            for p in self._parameter_list:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # -- the reference's per-leaf path ----------------------------------------
    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        dev = next(iter(params.values())).device if params else None
        with torch.no_grad():
            slots = {n: self.init_slots(p) for n, p in params.items()}
        return {"slots": slots,
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def apply_gradients(self, params, grads, state, lr=None):
        """One optimizer step over dicts of tensors on any device;
        returns (new params, new state) and leaves its inputs alone."""
        names = sorted(params)
        if not names:
            return params, state
        dev = params[names[0]].device
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
        on the function itself: an optimizer whose math the kernel does
        not hold (and a subclass that overrides it) takes the per-leaf
        update instead of someone else's kernel."""
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

    def uses_fused_kernel(self) -> bool:
        """Whether ``apply_gradients_fused`` runs the kernel's update (a
        fused kind with no clip or a global-norm clip) rather than the
        per-leaf one."""
        clip = self._grad_clip
        return self._fused_kind() is not None and (
            clip is None or type(clip) is ClipGradByGlobalNorm)

    def apply_gradients_fused(self, params, grads, state, lr=None,
                              pack_small: Optional[bool] = None,
                              grad_norm: Optional[torch.Tensor] = None):
        """One fused step: global grad norm -> clip scale -> one pass of
        clip-fold + update per (param, grad, slots) triple, **in place**
        on ``params`` and ``state["slots"]``; returns (params, state) with
        the step advanced.  An optimizer or clip the kernel does not hold
        takes the per-leaf update and copies its result in.

        ``grad_norm`` (the f32 global norm of ``grads``, where the caller
        computed it already) is the norm the clip's scale comes from.
        ``pack_small`` (None: on for CUDA tensors, where it saves kernel
        launches) packs the leaves under 1 MiB into one flat buffer per
        (param dtype, grad dtype), updates the buffer in one launch and
        copies the results back into every leaf and its slots."""
        if not self.uses_fused_kernel():
            new_p, new_state = self.apply_gradients(params, grads, state,
                                                    lr=lr)
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(new_p[n])
            return params, new_state
        kind = self._fused_kind()
        names = sorted(params)
        step = state["step"] + 1
        if not names:
            return params, {"slots": state["slots"], "step": step}
        dev = params[names[0]].device
        if pack_small is None:
            pack_small = dev.type == "cuda"
        clip = self._grad_clip
        gl = [grads[n] for n in names]
        if clip is None:
            scale = torch.ones((), dtype=torch.float32, device=dev)
        else:
            if grad_norm is None:
                grad_norm = torch.sqrt(global_norm_sq_f32(gl))
            scale = norm_scale(grad_norm, clip.clip_norm)
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

    def update_flop_estimate(self, params) -> float:
        """Analytic FLOPs of one update (+ global-norm clip) over the
        named parameters: ``CompiledTrainStep.step_flops`` adds it to the
        forward and backward it counts."""
        n = sum(p.numel() for p in params.values())
        return FT.update_flop_estimate(self._fused_kind() or "adam", n,
                                       self._grad_clip is not None)

    # -- state dict ----------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"@step": self._step_count}
        if self._parameter_list is not None:
            for i, p in enumerate(self._parameter_list):
                slots = self._slots.get(id(p))
                if slots:
                    name = self._param_name(p, i)
                    for k, v in slots.items():
                        out[f"{name}.{k}"] = v
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return out

    def set_state_dict(self, state: Dict[str, Any]):
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        if self._parameter_list is not None:
            for i, p in enumerate(self._parameter_list):
                name = self._param_name(p, i)
                slots = {}
                for k, v in state.items():
                    if isinstance(k, str) and k.startswith(name + "."):
                        slots[k[len(name) + 1:]] = torch.as_tensor(
                            v, device=p.device)
                if slots:
                    self._slots[id(p)] = slots


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
    """Adam with decoupled weight decay (the LLM recipe's optimizer).

    ``apply_decay_param_fun(name)`` picks the parameters that decay on
    the eager ``step`` (by the name given with ``parameters`` as (name,
    Parameter) pairs, "" when unnamed), as in the reference; ``lr_ratio`` is taken as the reference takes it, which
    applies no ratio."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_weight_decay(self):
        return True

    def update(self, param, grad, slots, lr, step):
        new_p, new_slots = super().update(param, grad, slots, lr, step)
        if self._weight_decay:
            new_p = new_p - lr * self._weight_decay * param
        return new_p, new_slots

    def step(self):
        if self._apply_decay_param_fun is None:
            return super().step()
        wd = self._weight_decay
        skip = [p for p in self._parameter_list or []
                if not self._apply_decay_param_fun(
                    self._param_names.get(id(p), ""))]
        saved = [(p, p.detach().clone()) for p in skip]
        super().step()
        # add back the decay these parameters should not have taken
        lr = self.get_lr()
        with torch.no_grad():
            for p, old in saved:
                p.copy_(p + lr * wd * old)


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_slots(self, param):
        return {"moment": torch.full(param.shape, self._init_acc,
                                     dtype=torch.float32,
                                     device=param.device)}

    def update(self, param, grad, slots, lr, step):
        acc = slots["moment"] + torch.square(grad)
        new_p = param - lr * grad / (torch.sqrt(acc) + self._eps)
        return new_p, {"moment": acc}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slots(self, param):
        return {"moment": _zeros_f32(param), "inf_norm": _zeros_f32(param)}

    def update(self, param, grad, slots, lr, step):
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * grad
        u = torch.maximum(self._beta2 * slots["inf_norm"], torch.abs(grad))
        step_f = step.float()
        new_p = param - (lr / (1 - torch.pow(self._beta1, step_f))) * m \
            / (u + self._eps)
        return new_p, {"moment": m, "inf_norm": u}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.01, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_slots(self, param):
        slots = {"mean_square": _zeros_f32(param),
                 "momentum": _zeros_f32(param)}
        if self._centered:
            slots["mean_grad"] = _zeros_f32(param)
        return slots

    def update(self, param, grad, slots, lr, step):
        ms = self._rho * slots["mean_square"] \
            + (1 - self._rho) * torch.square(grad)
        out_slots = {"mean_square": ms}
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * grad
            denom = torch.sqrt(ms - torch.square(mg) + self._eps)
            out_slots["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._momentum * slots["momentum"] + lr * grad / denom
        out_slots["momentum"] = mom
        return param - mom, out_slots


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decoupled_weight_decay(self):
        return True

    def init_slots(self, param):
        return {"moment1": _zeros_f32(param), "moment2": _zeros_f32(param)}

    def update(self, param, grad, slots, lr, step):
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * grad
        v = self._beta2 * slots["moment2"] \
            + (1 - self._beta2) * torch.square(grad)
        step_f = step.float()
        mhat = m / (1 - torch.pow(self._beta1, step_f))
        vhat = v / (1 - torch.pow(self._beta2, step_f))
        r = mhat / (torch.sqrt(vhat) + self._eps) \
            + self._weight_decay * param
        w_norm = torch.sqrt(torch.sum(torch.square(param)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return param - lr * trust * r, {"moment1": m, "moment2": v}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._rho, self._eps = rho, epsilon

    def init_slots(self, param):
        return {"avg_sq_grad": _zeros_f32(param),
                "avg_sq_update": _zeros_f32(param)}

    def update(self, param, grad, slots, lr, step):
        asg = self._rho * slots["avg_sq_grad"] \
            + (1 - self._rho) * torch.square(grad)
        upd = torch.sqrt((slots["avg_sq_update"] + self._eps)
                         / (asg + self._eps)) * grad
        asu = self._rho * slots["avg_sq_update"] \
            + (1 - self._rho) * torch.square(upd)
        return param - lr * upd, {"avg_sq_grad": asg,
                                  "avg_sq_update": asu}


class ASGD(Optimizer):
    """Stochastic Average Gradient (paddle.optimizer.ASGD): keeps the
    last ``batch_num`` per-batch gradients and steps on their running
    sum; with batch_num=1 it is SGD.  The ring slot is picked on the
    device (``index_select`` / ``index_copy``), so the step stays a
    device tensor."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._batch_num = int(batch_num)

    def init_slots(self, param):
        return {"d": _zeros_f32(param),
                "ys": torch.zeros((self._batch_num,) + tuple(param.shape),
                                  dtype=torch.float32, device=param.device)}

    def update(self, param, grad, slots, lr, step):
        idx = ((step.to(torch.int64) - 1) % self._batch_num).reshape(1)
        old = slots["ys"].index_select(0, idx)[0]
        d = slots["d"] - old + grad
        ys = slots["ys"].index_copy(0, idx, grad.float()[None])
        n = torch.clamp(step.float(), max=float(self._batch_num))
        return param - lr * d / n, {"d": d, "ys": ys}


class Rprop(Optimizer):
    """Resilient backprop (sign-based per-weight step sizes)."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def init_slots(self, param):
        return {"prev_grad": _zeros_f32(param),
                "step_size": torch.full(param.shape, self.get_lr(),
                                        dtype=torch.float32,
                                        device=param.device)}

    def update(self, param, grad, slots, lr, step):
        sign = grad * slots["prev_grad"]
        one = torch.ones_like(sign)
        scale = torch.where(sign > 0, self._eta_pos * one,
                            torch.where(sign < 0, self._eta_neg * one, one))
        ss = torch.clamp(slots["step_size"] * scale, self._lr_min,
                         self._lr_max)
        # on a sign flip the step is skipped and the stored grad zeroed
        eff_grad = torch.where(sign < 0, torch.zeros_like(grad), grad)
        new_p = param - torch.sign(eff_grad) * ss
        return new_p, {"prev_grad": eff_grad, "step_size": ss}


class NAdam(Optimizer):
    """Adam with Nesterov momentum (Dozat 2016; paddle/torch NAdam
    schedule mu_t = beta1 * (1 - 0.5 * 0.96^(t*psi)))."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def init_slots(self, param):
        return {"moment1": _zeros_f32(param), "moment2": _zeros_f32(param),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=param.device)}

    def update(self, param, grad, slots, lr, step):
        t = step.float()
        mu_t = self._beta1 * (1 - 0.5 * torch.pow(0.96, t * self._psi))
        mu_next = self._beta1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * self._psi))
        mu_prod = slots["mu_product"] * mu_t
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * grad
        v = self._beta2 * slots["moment2"] \
            + (1 - self._beta2) * torch.square(grad)
        vhat = v / (1 - torch.pow(self._beta2, t))
        mhat = (mu_next * m / (1 - mu_prod * mu_next)
                + (1 - mu_t) * grad / (1 - mu_prod))
        new_p = param - lr * mhat / (torch.sqrt(vhat) + self._eps)
        return new_p, {"moment1": m, "moment2": v, "mu_product": mu_prod}


class RAdam(Optimizer):
    """Rectified Adam (Liu et al. 2020): un-adapted SGD with momentum
    while the variance estimate is untrustworthy."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slots(self, param):
        return {"moment1": _zeros_f32(param), "moment2": _zeros_f32(param)}

    def update(self, param, grad, slots, lr, step):
        t = step.float()
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * grad
        v = self._beta2 * slots["moment2"] \
            + (1 - self._beta2) * torch.square(grad)
        mhat = m / (1 - torch.pow(self._beta1, t))
        rho_inf = 2.0 / (1 - self._beta2) - 1
        b2t = torch.pow(self._beta2, t)
        rho_t = rho_inf - 2 * t * b2t / (1 - b2t)
        safe_rho = torch.clamp(rho_t, min=4.0 + 1e-3)  # sqrt arg finite
        r = torch.sqrt(((safe_rho - 4) * (safe_rho - 2) * rho_inf)
                       / ((rho_inf - 4) * (rho_inf - 2) * safe_rho))
        vhat = torch.sqrt(v / (1 - b2t)) + self._eps
        adaptive = lr * r * mhat / vhat
        plain = lr * mhat
        return param - torch.where(rho_t > 5.0, adaptive, plain), \
            {"moment1": m, "moment2": v}


class LBFGS(Optimizer):
    """Limited-memory BFGS with closure re-evaluation
    (paddle.optimizer.LBFGS: ``step(closure)`` returns the loss; the
    closure computes the loss, calls its ``backward()`` and returns it).

    Two-loop recursion over the last ``history_size`` (s, y) pairs on
    the flattened f32 parameter vector; line search is backtracking
    Armijo (``line_search_fn=None``/'armijo') or, with 'strong_wolfe',
    backtracking with a Wolfe curvature check (no bracket/zoom
    expansion).  A host loop around the closure, as in the reference:
    each line-search test and curvature product reads a scalar on the
    host."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._max_iter = max_iter
        self._max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self._tol_grad, self._tol_change = tolerance_grad, tolerance_change
        self._history = int(history_size)
        enforce(line_search_fn in (None, "armijo", "strong_wolfe"),
                f"line_search_fn must be None, 'armijo' or "
                f"'strong_wolfe', got {line_search_fn!r}")
        self._line_search = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []

    def _gather(self):
        return [p for p in self._parameter_list if p.requires_grad]

    @staticmethod
    def _flat(arrs):
        return torch.cat([a.detach().float().reshape(-1) for a in arrs])

    @staticmethod
    def _set_params(params, flat):
        off = 0
        with torch.no_grad():
            for p in params:
                n = p.numel()
                p.copy_(flat[off:off + n].view(p.shape).to(p.dtype))
                off += n

    def _eval(self, closure, params, flat):
        self._set_params(params, flat)
        for p in params:
            p.grad = None
        with torch.enable_grad():
            loss = closure()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip.transform(grads)
        if self._weight_decay:
            grads = [g + self._weight_decay
                     * (torch.sign(p.detach()) if self._l1_decay
                        else p.detach())
                     for g, p in zip(grads, params)]
        return float(loss.detach()), self._flat(grads)

    def step(self, closure=None):
        enforce(closure is not None, "LBFGS.step requires a closure")
        params = self._gather()
        x = self._flat(params)
        loss, g = self._eval(closure, params, x)
        evals = 1
        lr = self.get_lr()
        for _ in range(self._max_iter):
            if float(g.abs().max()) <= self._tol_grad:
                break
            # two-loop recursion
            q = -g
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / float(torch.dot(y, s))
                a = rho * float(torch.dot(s, q))
                alphas.append((a, rho, s, y))
                q = q - a * y
            if self._y:
                y_last, s_last = self._y[-1], self._s[-1]
                gamma = float(torch.dot(s_last, y_last)
                              / torch.dot(y_last, y_last))
                q = q * gamma
            for a, rho, s, y in reversed(alphas):
                b = rho * float(torch.dot(y, q))
                q = q + (a - b) * s
            d = q
            gtd = float(torch.dot(g, d))
            if gtd > -1e-32:       # not a descent direction: reset
                self._s.clear()
                self._y.clear()
                d = -g
                gtd = float(torch.dot(g, d))
            # line search
            t = lr
            c1, c2 = 1e-4, 0.9
            ok = False
            for _ls in range(10):
                new_loss, new_g = self._eval(closure, params, x + t * d)
                evals += 1
                if new_loss <= loss + c1 * t * gtd:
                    if self._line_search != "strong_wolfe" or \
                            abs(float(torch.dot(new_g, d))) <= c2 * abs(gtd):
                        ok = True
                        break
                t *= 0.5
                if evals >= self._max_eval:
                    break
            if not ok:
                new_loss, new_g = self._eval(closure, params, x + t * d)
                evals += 1
            x_new = x + t * d
            s = x_new - x
            y = new_g - g
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
            if abs(new_loss - loss) < self._tol_change:
                x, loss, g = x_new, new_loss, new_g
                break
            x, loss, g = x_new, new_loss, new_g
            if evals >= self._max_eval:
                break
        self._set_params(params, x)
        return torch.tensor(loss)
