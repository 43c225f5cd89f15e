"""paddle.save / paddle.load (counterpart of
``paddle_tpu/framework/io.py``): pickle-based state persistence
(``.pdparams`` / ``.pdopt``) in the reference's layout.

A tensor is pickled (protocol 4) as the reference pickles its
``Tensor``: ``{"__paddle_tpu_tensor__": True, "data": ndarray,
"stop_gradient": bool, "name": ...}``; nested dicts, lists and tuples
round-trip, numpy arrays and python values pass as they are.  ``load``
gives CPU ``torch.Tensor``s (``stop_gradient`` is written, True unless
the tensor requires grad, and not read back) and plain numpy arrays
where the file holds them, so float32, float16
and integer state written by either package loads in the other.  A
reference ``.pdopt`` holds raw ``jax.Array``s; ``load`` reads each as
the numpy array it pickled, without JAX.

bfloat16: numpy has no such dtype here (no ``ml_dtypes``), so a bf16
tensor is stored as its raw 16-bit pattern (``data`` int16) with
``"dtype": "bfloat16"`` beside it, as ``distributed/checkpoint.py``
stores its extension dtypes, and ``load`` views it back.  Such a file
round-trips in the port; a bf16 file written by the reference (an
``ml_dtypes`` array) is not read (ROADMAP 'Port: remaining modules').
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_PROTOCOL = 4
# torch dtypes numpy cannot hold, stored as their raw bits
_RAW = {torch.bfloat16: ("bfloat16", np.int16, torch.int16)}
_FROM_RAW = {name: dt for dt, (name, _, _) in _RAW.items()}


def _to_saveable(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        rec = {"__paddle_tpu_tensor__": True,
               "stop_gradient": not obj.requires_grad, "name": None}
        raw = _RAW.get(t.dtype)
        if raw is not None:
            rec["data"] = t.view(raw[2]).numpy().copy()
            rec["dtype"] = raw[0]
        else:
            rec["data"] = t.numpy().copy()
        return rec
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get("__paddle_tpu_tensor__"):
            data = np.asarray(obj["data"])
            t = torch.from_numpy(np.array(data))
            dtype = obj.get("dtype")
            if dtype is not None:
                t = t.view(_FROM_RAW[dtype])
            return t
        return {k: _from_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_from_saveable(v) for v in obj)
    return obj


def _jax_array(fun, args, arr_state, aval_state):
    """The numpy array a pickled ``jax.Array`` carries (the reference's
    ``jax._src.array._reconstruct_array`` less the device put)."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "jax._src.array" and name == "_reconstruct_array":
            return _jax_array
        return super().find_class(module, name)


def save(obj: Any, path: str, protocol: int = _PROTOCOL, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path: str, **configs) -> Any:
    with open(path, "rb") as f:
        return _from_saveable(_Unpickler(f).load())
