"""Fused optimizer update: global-norm clip folded into one in-place pass
(counterpart of the update half of ``paddle_tpu/ops/pallas/
fused_train.py``; its add+norm and matmul+rope regions are the next
slice).

``_update_math`` is the single source of the optimizer arithmetic, op
for op the reference's: SGD, Momentum (plain or Nesterov) and Adam with
L2 decay or AdamW with decoupled decay, all in f32.
``fused_update_reference`` is the plain version of the kernel;
``fused_update_flat`` launches the kernel of ``csrc/fused_update.cu`` on
CUDA tensors (or raises) and runs the plain version on CPU tensors.
Unlike the reference, whose arrays are immutable, it updates the
parameter and its slots in place: an 8B-wide model cannot hold a second
copy of its optimizer state.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..common.errors import enforce
from . import _build

__all__ = ["SLOT_KEYS", "fused_update_flat", "fused_update_reference",
           "update_flop_estimate"]

SLOT_KEYS = {"sgd": (), "momentum": ("velocity",),
             "adam": ("moment1", "moment2")}

# analytic per-element FLOP counts (mul and add counted separately), the
# reference's figures for the update's share of a step's FLOPs
_UPDATE_FLOPS = {"sgd": 2, "momentum": 5, "adam": 16}
_CLIP_FLOPS = 4      # square+accumulate on the norm pass, scale+round fold

_SOURCE = "fused_update"
_KIND_CODE = {"sgd": 0, "momentum": 1, "adam": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def update_flop_estimate(kind: str, n_elems: int, has_clip: bool) -> float:
    per = _UPDATE_FLOPS.get(kind, 6)
    if has_clip:
        per += _CLIP_FLOPS
    return float(per) * float(n_elems)


def _clip_fold_f32(gf, clip_scale, grad_dtype):
    """Fold the global-norm clip scale into the f32 grad, replaying the
    rounding of the unfused path (the clipped grad materialised in the
    grad's dtype, then cast to f32 for the update)."""
    return (gf * clip_scale).to(grad_dtype).float()


def _update_math(kind, hp, pf, gf, slots, lr, step_f):
    """The optimizer arithmetic on f32 operands; ``lr`` and ``step_f``
    are f32 tensors (0-dim), hyper-parameters Python floats."""
    wd = hp.get("weight_decay", 0.0)
    if wd and not hp.get("decoupled", False):
        gf = gf + wd * pf
    if kind == "sgd":
        return pf - lr * gf, {}
    if kind == "momentum":
        mu = hp["momentum"]
        v = mu * slots["velocity"] + gf
        if hp.get("nesterov", False):
            new_p = pf - lr * (gf + mu * v)
        else:
            new_p = pf - lr * v
        return new_p, {"velocity": v}
    if kind == "adam":
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["epsilon"]
        m = b1 * slots["moment1"] + (1 - b1) * gf
        v = b2 * slots["moment2"] + (1 - b2) * torch.square(gf)
        bc1 = 1 - torch.pow(b1, step_f)
        bc2 = 1 - torch.pow(b2, step_f)
        mhat = m / bc1
        vhat = v / bc2
        new_p = pf - lr * mhat / (torch.sqrt(vhat) + eps)
        if wd and hp.get("decoupled", False):
            new_p = new_p - lr * wd * pf
        return new_p, {"moment1": m, "moment2": v}
    raise NotImplementedError(f"no fused update for optimizer kind {kind!r}")


def fused_update_reference(kind, p, g, slots, *, lr, step_f, clip_scale,
                           hyper):
    """Plain version of the kernel: returns (new_p in p's dtype, new
    slots f32) and leaves its inputs alone.  ``lr``, ``step_f`` and
    ``clip_scale`` (None: no clip) are f32 0-dim tensors."""
    gf = g.float()
    if clip_scale is not None:
        gf = _clip_fold_f32(gf, clip_scale, g.dtype)
    new_p, new_slots = _update_math(kind, hyper, p.float(), gf, slots, lr,
                                    step_f)
    return new_p.to(p.dtype), new_slots


def _kernel() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.fused_update
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int] + [ctypes.c_float] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_update_error_string.argtypes = [ctypes.c_int]
        lib.fused_update_error_string.restype = ctypes.c_char_p
    return lib


def fused_update_flat(kind: str, p: torch.Tensor, g: torch.Tensor,
                      slots: Dict[str, torch.Tensor], *,
                      scalars: torch.Tensor, has_clip: bool,
                      hyper: dict) -> None:
    """Clip-fold + update of one (param, grad, slots) triple of any
    shape, **in place** on ``p`` and ``slots``.

    ``scalars`` is an f32 tensor [lr, step, clip scale] on p's device
    (the clip scale is read only when ``has_clip``).  On CUDA tensors
    this launches the kernel of ``csrc/fused_update.cu``: p and g
    contiguous in float32/bfloat16/float16, slots contiguous f32, all
    16-byte aligned; anything else raises.  On CPU tensors it runs the
    plain version and copies the result in."""
    keys = SLOT_KEYS[kind]
    enforce(tuple(sorted(slots)) == tuple(sorted(keys)),
            f"{kind} takes slots {keys}, got {sorted(slots)}")
    enforce(g.shape == p.shape and all(slots[k].shape == p.shape
                                       for k in keys),
            "param, grad and slots must share one shape")
    if p.device.type == "cpu":
        new_p, new_slots = fused_update_reference(
            kind, p, g, slots, lr=scalars[0], step_f=scalars[1],
            clip_scale=scalars[2] if has_clip else None, hyper=hyper)
        with torch.no_grad():
            p.copy_(new_p)
            for k in keys:
                slots[k].copy_(new_slots[k])
        return
    enforce(p.dtype in _DTYPE_CODE and g.dtype in _DTYPE_CODE,
            f"the update kernel takes params and grads in "
            f"{list(_DTYPE_CODE)}")
    tensors = [p, g] + [slots[k] for k in keys]
    enforce(all(s.dtype == torch.float32 for s in tensors[2:]),
            "the update kernel takes f32 slots")
    enforce(all(t.device == p.device for t in tensors)
            and scalars.device == p.device
            and scalars.dtype == torch.float32 and scalars.numel() == 3,
            "update operands and the f32[3] scalars must share one CUDA "
            "device")
    enforce(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in tensors),
            "the update kernel needs contiguous, 16-byte aligned operands")
    s = [slots[k].data_ptr() for k in keys] + [None] * (2 - len(keys))
    hp = hyper
    b1, b2 = hp.get("beta1", 0.0), hp.get("beta2", 0.0)
    lib = _kernel()
    with torch.cuda.device(p.device):
        err = lib.fused_update(
            _KIND_CODE[kind], _DTYPE_CODE[p.dtype], _DTYPE_CODE[g.dtype],
            p.data_ptr(), g.data_ptr(), s[0], s[1], p.numel(),
            scalars.data_ptr(), int(has_clip),
            float(hp.get("weight_decay", 0.0)),
            int(bool(hp.get("decoupled", False))),
            float(hp.get("momentum", 0.0)),
            int(bool(hp.get("nesterov", False))),
            b1, 1 - b1, b2, 1 - b2, float(hp.get("epsilon", 0.0)),
            torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError("fused update launch failed: "
                           + lib.fused_update_error_string(err).decode())
    fused_update_flat.launches += 1


fused_update_flat.launches = 0
