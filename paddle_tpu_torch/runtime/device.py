"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/runtime/device.py``.  There the device
runtime is the PJRT plugin JAX loads; here it is PyTorch's CUDA
runtime.  Entry points (``LlamaForCausalLM``, ``LLMEngine``) take a
``device`` argument and resolve it here: ``None`` means the GPU, and a
machine without one raises instead of quietly running on the CPU.  The
CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..common.errors import UnavailableError

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` and ``"cuda"`` mean the current CUDA device; ``"cuda:N"``
    a given one; ``"cpu"`` the CPU.  A CUDA request on a machine with
    no CUDA device raises ``UnavailableError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise UnavailableError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise UnavailableError(f"unsupported device {dev}")
    return dev
