"""Common layers: ``Linear``, ``Embedding`` and ``Dropout`` (counterpart
of ``paddle_tpu/nn/common.py``).

Paddle's layouts are kept: a ``Linear`` weight is ``[in_features,
out_features]`` and computes ``x @ W + b``; an ``Embedding`` weight is
``[num_embeddings, embedding_dim]``.  Operands of two float dtypes meet
in the wider one, as jnp promotes them in the reference (under amp O2 an
f32 input to a bf16 ``Linear`` gives an f32 output).  Parameters are
drawn on ``device``
(default: the GPU; ``device="cpu"`` on request) from ``generator``, or
from the dropout stream's generator of that device (``ops/random.py``,
the reference's global key) when none is given.  ``weight_attr`` is an
initializer of ``nn/initializer.py`` (default ``XavierNormal`` for
``Linear``, ``Normal(0, 1)`` for ``Embedding``); ``bias_attr=False``
drops the bias, which is zeros otherwise.  A ``Linear`` computes
``F.linear`` (under ``amp.auto_cast`` O1 its f32 operands in the amp
dtype, as the reference's), whose product is a "dot" to the recompute
policies (``names``, ``jit/recompute.py``).

``Init`` is the models' parameter factory: one device, dtype and seeded
generator, from which every parameter is drawn in construction order.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import random as _random
from ..runtime.device import resolve_device
from . import functional as F
from .initializer import Normal, XavierNormal
from .norm import LayerNorm, RMSNorm

__all__ = ["Linear", "Embedding", "Dropout", "Init"]


def _draw(init, shape, device, dtype, generator):
    dev = resolve_device(device)
    gen = generator if generator is not None else _random.generator_for(dev)
    return nn.Parameter(init(shape, device=dev, dtype=dtype, generator=gen))


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W``: ``[in_features, out_features]``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 names=("dot",)):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.names = names
        self.weight = _draw(weight_attr or XavierNormal(),
                            [in_features, out_features], device, dtype,
                            generator)
        if bias_attr is False:
            self.bias = None
        elif bias_attr is None:
            self.bias = nn.Parameter(torch.zeros(
                out_features, device=self.weight.device, dtype=dtype))
        else:
            self.bias = _draw(bias_attr, [out_features], device, dtype,
                              generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias, self.names)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    """A table lookup; rows of ``padding_idx`` read as zeros."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "sparse embedding gradients are not ported yet (ROADMAP "
                "'Port: remaining modules')")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = _draw(weight_attr or Normal(0.0, 1.0),
                            [num_embeddings, embedding_dim], device, dtype,
                            generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    """Element dropout with the reference's modes
    (``"upscale_in_train"``, ``"downscale_in_infer"``), active while the
    module is training."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        if axis is not None:
            raise NotImplementedError(
                "Dropout along an axis is not ported yet (ROADMAP 'Port: "
                "remaining modules')")
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Init:
    """Where and from what a model's parameters are drawn: each on
    ``device`` in ``dtype`` from ``generator``, in construction order."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator):
        self.device, self.dtype, self.gen = device, dtype, generator
        self.kw = dict(device=device, dtype=dtype, generator=generator)

    @classmethod
    def on(cls, device=None, dtype: torch.dtype = torch.float32,
           generator: Optional[torch.Generator] = None) -> "Init":
        """An ``Init`` on ``device`` (default: the GPU) drawing from
        ``generator``, or from a new one there seeded with 0."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return cls(dev, dtype, generator)

    def normal(self, shape, std: float) -> nn.Parameter:
        return nn.Parameter(Normal(0.0, std)(
            shape, device=self.device, dtype=self.dtype,
            generator=self.gen))

    def linear(self, d_in: int, d_out: int, std: float, *, bias: bool,
               names=("dot",)) -> Linear:
        return Linear(d_in, d_out, weight_attr=Normal(0.0, std),
                      bias_attr=None if bias else False, names=names,
                      **self.kw)

    def embedding(self, vocab: int, dim: int, std: float) -> Embedding:
        return Embedding(vocab, dim, weight_attr=Normal(0.0, std),
                         **self.kw)

    def layer_norm(self, dim: int, eps: float) -> LayerNorm:
        return LayerNorm(dim, epsilon=eps, device=self.device,
                         dtype=self.dtype)

    def rms_norm(self, dim: int, eps: float) -> RMSNorm:
        return RMSNorm(dim, eps, device=self.device, dtype=self.dtype)
