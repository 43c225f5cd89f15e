"""Carry a reference model's parameters into the port.

``load_raw_state_dict(model, arrays)`` takes the reference's
``raw_state_dict()`` converted to numpy (``{name: np.asarray(a)}``) and
copies it 1:1 into the port's parameters: the two trees share names and
the ``[in, out]`` Linear layout, so nothing is transposed.  Every name
and shape is checked both ways; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..common.errors import enforce

__all__ = ["load_raw_state_dict"]


@torch.no_grad()
def load_raw_state_dict(model: torch.nn.Module,
                        arrays: Dict[str, np.ndarray]) -> None:
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unexpected = sorted(set(arrays) - set(params))
    enforce(not missing and not unexpected,
            f"state dict mismatch: missing {missing}, unexpected "
            f"{unexpected}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        enforce(tuple(a.shape) == tuple(p.shape),
                f"shape mismatch for {name}: {tuple(a.shape)} vs "
                f"{tuple(p.shape)}")
        p.copy_(torch.tensor(a, dtype=p.dtype))
