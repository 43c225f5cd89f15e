"""Carry a reference model's parameters and optimizer state into the
port.

``load_raw_state_dict(model, arrays)`` takes the reference's
``raw_state_dict()`` converted to numpy (``{name: np.asarray(a)}``) and
copies it 1:1 into the port's parameters: the two trees share names and
the ``[in, out]`` Linear layout, so nothing is transposed.  A reference
model that went through ``quantize_model`` also hands over its
``QuantizedLinear`` buffers (``buffers=``: every ``qweight`` and
``weight_scale`` by name), which land in the port model after its own
``quantize_model``.
``load_optimizer_state(step, opt_arrays)`` does the same for a
reference ``CompiledTrainStep``'s ``state["opt"]`` (slots by parameter
name, plus ``step``), so both frameworks can resume from one mid-run
state.  Every name and shape is checked both ways; nothing here imports
JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..common.errors import enforce

__all__ = ["load_raw_state_dict", "load_optimizer_state"]


_QUANT_BUFFERS = ("qweight", "weight_scale")


def _copy_all(mine: Dict[str, torch.Tensor], arrays, what: str) -> None:
    missing = sorted(set(mine) - set(arrays))
    unexpected = sorted(set(arrays) - set(mine))
    enforce(not missing and not unexpected,
            f"{what} mismatch: missing {missing}, unexpected {unexpected}")
    for name, t in mine.items():
        a = np.asarray(arrays[name])
        enforce(tuple(a.shape) == tuple(t.shape),
                f"shape mismatch for {name}: {tuple(a.shape)} vs "
                f"{tuple(t.shape)}")
        t.copy_(torch.tensor(a, dtype=t.dtype))


@torch.no_grad()
def load_raw_state_dict(model: torch.nn.Module,
                        arrays: Dict[str, np.ndarray],
                        buffers: Optional[Dict[str, np.ndarray]] = None
                        ) -> None:
    _copy_all(dict(model.named_parameters()), arrays, "state dict")
    quant = {n: b for n, b in model.named_buffers()
             if n.rsplit(".", 1)[-1] in _QUANT_BUFFERS}
    if buffers is not None or quant:
        _copy_all(quant, buffers or {}, "quantized buffers")


@torch.no_grad()
def load_optimizer_state(step, opt_arrays: Dict) -> None:
    """Copy a reference optimizer state — ``{"slots": {name: {slot:
    array}}, "step": int}`` as numpy — into the port's
    ``CompiledTrainStep`` ``step``; its update count follows ``step``."""
    opt = step.state["opt"]
    slots = opt_arrays["slots"]
    enforce(set(slots) == set(opt["slots"]),
            f"optimizer state names differ: "
            f"{sorted(set(slots) ^ set(opt['slots']))}")
    for name, mine in opt["slots"].items():
        theirs = slots[name]
        enforce(set(theirs) == set(mine),
                f"slots of {name} differ: {sorted(theirs)} vs {sorted(mine)}")
        for k, t in mine.items():
            a = np.asarray(theirs[k])
            enforce(tuple(a.shape) == tuple(t.shape),
                    f"shape mismatch for {name}.{k}: {tuple(a.shape)} vs "
                    f"{tuple(t.shape)}")
            t.copy_(torch.tensor(a, dtype=t.dtype))
    n = int(np.asarray(opt_arrays["step"]))
    opt["step"].fill_(n)
    step._step_count = n
