"""Mixed precision: ``decorate`` (the O2 half of
``paddle_tpu/amp/auto_cast.py``).

O2 casts every floating parameter and buffer of the model to the amp
dtype, as the reference's ``Layer.to(dtype=...)`` does (the rope tables
included).  Optimizer slots stay f32 by construction
(``optimizer/optimizer.py``), the reference's always-on master weights.
"""
from __future__ import annotations

import torch

from ..common.errors import enforce

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def decorate(models, optimizers=None, level: str = "O2",
             dtype="bfloat16", master_weight=None, save_dtype=None):
    """Cast ``models`` (one module or a list) to ``dtype``.  Returns
    ``models``, or ``(models, optimizers)`` when optimizers are given."""
    if level != "O2":
        raise NotImplementedError(
            f"amp level {level!r} (per-op casting under auto_cast) is not "
            f"ported yet (ROADMAP 'Port: remaining modules')")
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    enforce(dt in _DTYPES.values(), f"unsupported amp dtype {dtype!r}")
    for m in (models if isinstance(models, (list, tuple)) else [models]):
        m.to(dtype=dt)
    if optimizers is None:
        return models
    return models, optimizers
