"""The attention and fused-region entry points of
``paddle.nn.functional`` (a subset of ``paddle_tpu/nn/functional.py``).

``scaled_dot_product_attention`` routes through the flash kernels and
their autograd Function (``ops/flash_attention.py``): on the card the
forward, dQ and dK/dV kernels, on the CPU their plain versions.  The
reference's context-parallel (``sep`` mesh axis) branch has no
counterpart: the port has no device mesh yet.

``add_rms_norm``, ``add_layer_norm`` and ``qkv_rope`` are the fused step
regions of ``ops/fused_train.py`` (the add+norm and matmul+rope
kernels).
"""
from __future__ import annotations

import math

import torch

from ..ops import fused_train as _ft
from ..ops.flash_attention import flash_attention_raw

__all__ = ["scaled_dot_product_attention",
           "scaled_dot_product_attention_ref", "add_rms_norm",
           "add_layer_norm", "qkv_rope"]

_NEG_INF = -1e30


def _additive(attn_mask):
    """A boolean mask (True = attend) as an additive f32 bias, as the
    reference hands one to its flash kernel."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.zeros(attn_mask.shape, dtype=torch.float32,
                       device=attn_mask.device).masked_fill_(
                           ~attn_mask, _NEG_INF)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Fused attention on ``[B, S, H, D]`` (GQA when K/V have fewer
    heads): the flash forward, differentiable through the backward
    kernels.  ``attn_mask`` is additive ``[B|1, H|1, Sq|1, Sk]`` or
    boolean; a mask that requires grad and dropout raise (not ported)."""
    dp = float(dropout_p) if training else 0.0
    return flash_attention_raw(query, key, value, causal=is_causal,
                               mask=_additive(attn_mask), dropout_p=dp)


def scaled_dot_product_attention_ref(query, key, value, attn_mask=None,
                                     dropout_p: float = 0.0,
                                     is_causal: bool = False,
                                     training: bool = True):
    """Plain attention in autograd ops (the reference's jnp oracle,
    ``use_flash_attention=False``): f32 scores and softmax, the
    probabilities cast to the query's dtype before the value product."""
    if dropout_p and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP 'Port: the "
            "GPT-2 training path')")
    b, sq, h, d = query.shape
    sk = key.shape[1]
    q, k, v = (x.transpose(1, 2) for x in (query, key, value))
    if k.shape[1] != h:
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=query.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(query.dtype)
    return (probs @ v).transpose(1, 2)


# -- fused step regions (ops/fused_train) ------------------------------------

def add_rms_norm(x, residual, weight, epsilon=1e-6):
    """Fused ``h = residual + x; y = rms_norm(h, weight)``; returns
    ``(h, y)`` -- the residual -> RMSNorm chain of a pre-norm decoder
    block (``RMSNorm.forward_residual`` routes here)."""
    return _ft.add_rms_norm_raw(x, residual, weight, epsilon=epsilon)


def add_layer_norm(x, residual, weight, bias, epsilon=1e-5):
    """Fused ``h = residual + x; y = layer_norm(h)`` over the last axis;
    returns ``(h, y)`` (``LayerNorm.forward_residual`` routes here)."""
    return _ft.add_layer_norm_raw(x, residual, weight, bias,
                                  epsilon=epsilon)


def qkv_rope(x, wq, wk, wv, cos, sin, *, n_heads, n_kv, head_dim,
             interleaved=False):
    """The fused rotary -> QKV chain: q and k projections with rope
    applied to the product's output tile, v a plain projection.  Returns
    ``(q, k, v)`` shaped ``[B, S, heads, head_dim]`` (``models/llama.py``
    routes here)."""
    return _ft.qkv_rope_raw(x, wq, wk, wv, cos, sin, n_heads=n_heads,
                            n_kv=n_kv, head_dim=head_dim,
                            interleaved=interleaved)
