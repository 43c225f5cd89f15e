"""Mixed precision (counterpart of ``paddle_tpu/amp/auto_cast.py``):
``auto_cast`` / ``amp_guard`` at O1 and O2, the white and black lists,
``amp_state`` and ``decorate``.

O1 casts by op name, as the reference's op dispatch does
(``paddle_tpu/tensor.py``'s ``apply_op``): inside ``auto_cast`` the
float32 inputs of a white-listed op are cast to the amp dtype, and the
16-bit inputs of a black-listed op to float32 (an op on both lists
counts as white).  The reference casts in the one function every op
goes through; the port has no such dispatch, so each of its functions
that bears a listed name calls :func:`amp_cast` at its head with the
tensors the reference hands its op positionally: ``F.linear`` (and so
``Linear``), ``F.conv2d``, ``flash_attention_raw`` (which every fused
attention route goes through, ``F.scaled_dot_product_attention``
included: the inputs are cast once, under the name of the reference's
kernel route), the plain ``F.scaled_dot_product_attention_ref`` under
``"scaled_dot_product_attention"`` and the losses of ``ops/_nn.py``.
Nothing else is hooked: no global ``TorchFunctionMode``, which would
also cast inside the port's plain versions (the reference casts only
the outer op) and put Python on every eager op of a step.  The
reference's ops API (``ops/_math``, ``_reduction`` ...) is not ported,
and the casts of its listed names (``log``, ``exp``, ``logsumexp``,
``cumsum`` ...) come with it (ROADMAP 'Port: remaining modules').

``decorate`` at O2 casts every floating parameter and buffer of the
model to the amp dtype, as the reference's ``Layer.to(dtype=...)`` does
(the rope tables included); at O1 it casts nothing.  Optimizer slots
stay f32 by construction (``optimizer/optimizer.py``), the reference's
always-on master weights.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Set

import torch

from ..common.errors import enforce

__all__ = ["auto_cast", "amp_guard", "decorate", "white_list",
           "black_list", "amp_state", "amp_restored", "amp_cast"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_HALF = (torch.bfloat16, torch.float16)

# ops whose float32 inputs are cast to the amp dtype in O1
WHITE_LIST: Set[str] = {
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "scaled_dot_product_attention",
    "flash_attention_raw",
}
# ops whose 16-bit inputs are cast to float32 in O1
BLACK_LIST: Set[str] = {
    "log", "log2", "log10", "log1p", "exp", "expm1", "pow", "square",
    "cross_entropy", "nll_loss", "binary_cross_entropy", "softmax_",
    "logsumexp", "norm", "mean_", "cumsum",
}


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


def _dtype(dtype) -> torch.dtype:
    dt = _DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    enforce(dt in _DTYPES.values(), f"unsupported amp dtype {dtype!r}")
    return dt


_state = threading.local()


def amp_state():
    """The active ``auto_cast`` context of this thread as a dict
    (``level``, ``dtype``, ``white``, ``black``), or None."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16", use_promote: bool = True):
    """``paddle.amp.auto_cast``: inside it, the ops of the white list
    (the defaults plus ``custom_white_list``) take their float32 inputs
    in ``dtype`` and those of the black list (plus
    ``custom_black_list``) their 16-bit inputs in float32, at either
    level, as the reference's dispatch does."""
    if not enable:
        yield
        return
    enforce(level in ("O0", "O1", "O2"), f"unknown amp level {level!r}")
    ctx = {"level": level, "dtype": _dtype(dtype),
           "white": WHITE_LIST | set(custom_white_list or ()),
           "black": BLACK_LIST | set(custom_black_list or ())}
    with amp_restored(ctx):
        yield


amp_guard = auto_cast


@contextlib.contextmanager
def amp_restored(ctx):
    """Run with ``ctx`` (a value of :func:`amp_state`, None for none) as
    this thread's ``auto_cast`` state: a recompute's backward replays its
    region under the state its forward ran in, which has exited by then
    (and autograd may run the backward on another thread)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def amp_cast(name: str, *tensors):
    """``tensors`` as the op ``name`` takes them under the active
    ``auto_cast``: float32 ones in the amp dtype for a white-listed name,
    16-bit ones in float32 for a black-listed one; each unchanged
    otherwise (None, integer tensors, no context).  Returns a tuple."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return tensors
    if name in ctx["white"]:
        dt = ctx["dtype"]
        return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                     and t.dtype == torch.float32 else t for t in tensors)
    if name in ctx["black"]:
        return tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype in _HALF else t for t in tensors)
    return tensors


def decorate(models, optimizers=None, level: str = "O2",
             dtype="bfloat16", master_weight=None, save_dtype=None):
    """At O2 cast ``models`` (one module or a list) to ``dtype``; at O1
    leave them as they are (``auto_cast`` casts by op).  Returns
    ``models``, or ``(models, optimizers)`` when optimizers are given."""
    enforce(level in ("O1", "O2"), f"unknown amp level {level!r}")
    dt = _dtype(dtype)
    if level == "O2":
        for m in (models if isinstance(models, (list, tuple))
                  else [models]):
            m.to(dtype=dt)
    if optimizers is None:
        return models
    return models, optimizers
