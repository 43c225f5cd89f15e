"""The attention, dropout, activation and fused-region entry points of
``paddle.nn.functional`` (a subset of ``paddle_tpu/nn/functional.py``).

``scaled_dot_product_attention`` routes through the flash kernels and
their autograd Functions (``ops/flash_attention.py``): on the card the
forward, dQ, dK/dV and (for a trained bias) dbias kernels, on the CPU
their plain versions.  Its dropout runs inside the kernels, with a
per-call seed drawn on the device from the guarded generator
(``ops/random.py``) and passed through ``jit.recompute.kept``, so a
recomputed forward draws the same mask.  The reference's
context-parallel (``sep`` mesh axis) branch has no counterpart: the
port has no device mesh yet.

``add_rms_norm``, ``add_layer_norm`` and ``qkv_rope`` are the fused step
regions of ``ops/fused_train.py`` (the add+norm and matmul+rope
kernels); ``dropout``, ``gelu``, ``linear``, ``embedding`` and
``cross_entropy`` are plain PyTorch, as the reference's are jnp.
"""
from __future__ import annotations

import math

import torch

from ..jit.recompute import kept
from ..ops import _nn
from ..ops import fused_train as _ft
from ..ops import random as _random
from ..ops.flash_attention import dropout_keep, flash_attention_raw

__all__ = ["scaled_dot_product_attention",
           "scaled_dot_product_attention_ref", "dropout", "gelu",
           "embedding", "cross_entropy", "add_rms_norm", "add_layer_norm",
           "qkv_rope"]

dropout = _nn.dropout
gelu = _nn.gelu
cross_entropy = _nn.cross_entropy


def embedding(ids, weight, padding_idx=None):
    """Rows of ``weight`` by ``ids``; ids equal to ``padding_idx`` read
    as zeros (the reference's rule)."""
    out = torch.nn.functional.embedding(ids, weight)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def _attention_seed(query, dropout_p):
    """The per-call dropout seed (a device int64), or None at p = 0.  It
    is drawn in every run, so the generator advances alike in a first
    run and its recompute, and the recompute gets the first run's seed
    back through ``kept``."""
    if not dropout_p:
        return None
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    seed = _random.next_seed(query.device)
    return kept(("dropout_seed",), lambda: seed)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Fused attention on ``[B, S, H, D]`` (GQA when K/V have fewer
    heads): the flash forward, differentiable through the backward
    kernels.  ``attn_mask`` is additive ``[B|1, H|1, Sq|1, Sk]`` or
    boolean (True = attend); an additive mask that requires grad is a
    trained bias and gets its gradient (the bias-gradient kernel).
    ``dropout_p`` applies while ``training``."""
    dp = float(dropout_p) if training else 0.0
    return flash_attention_raw(query, key, value, causal=is_causal,
                               mask=attn_mask, dropout_p=dp,
                               seed=_attention_seed(query, dp))


def scaled_dot_product_attention_ref(query, key, value, attn_mask=None,
                                     dropout_p: float = 0.0,
                                     is_causal: bool = False,
                                     training: bool = True):
    """Plain attention in autograd ops (the reference's jnp oracle,
    ``use_flash_attention=False``): f32 scores and softmax, dropout with
    the kernels' element-indexed keep mask from a seed drawn as the
    fused entry draws it (so the same generator state gives the same
    mask), the probabilities cast to the query's dtype before the value
    product."""
    dp = float(dropout_p) if training else 0.0
    seed = _attention_seed(query, dp)
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
    probs = torch.softmax(logits, dim=-1)
    if seed is not None:
        keep = dropout_keep(seed, dp, b, h, sq, sk)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dp)),
                            torch.zeros((), device=probs.device))
    return (probs.to(query.dtype) @ v).transpose(1, 2)


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
