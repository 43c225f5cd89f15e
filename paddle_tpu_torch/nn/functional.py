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

Operands of two float dtypes meet in the wider one, as jnp promotes
them: q, k and v of mixed dtypes (an amp O2 decoder's bf16 queries
against its f32 ``Cache``) are cast to their common dtype, and the
output is in it.  Under ``amp.auto_cast`` the white-listed
``scaled_dot_product_attention`` and ``linear`` take their f32 inputs in
the amp dtype (``amp/auto_cast.py``).

``add_rms_norm``, ``add_layer_norm`` and ``qkv_rope`` are the fused step
regions of ``ops/fused_train.py`` (the add+norm and matmul+rope
kernels); ``linear``, ``dropout``, ``gelu``, ``silu``, ``embedding``,
``conv2d``, ``group_norm``, ``interpolate`` and the losses
(``cross_entropy`` with its whole signature, ``nll_loss``, ``kl_div``,
``ctc_loss`` ... the functions of the reference's loss layers) are plain
PyTorch, as the reference's are jnp and XLA convolutions (no Pallas
kernel computes any of them).
"""
from __future__ import annotations

import math

import torch

from ..amp.auto_cast import amp_cast
from ..jit.recompute import kept, product
from ..ops import _nn
from ..ops import fused_train as _ft
from ..ops import random as _random
from ..ops.flash_attention import dropout_keep, flash_attention_raw

_LOSSES = ["cross_entropy", "mse_loss", "fused_linear_cross_entropy",
           "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "l1_loss", "smooth_l1_loss",
           "kl_div", "label_smooth", "hinge_embedding_loss",
           "cosine_embedding_loss", "margin_ranking_loss",
           "pairwise_distance", "triplet_margin_loss",
           "triplet_margin_with_distance_loss", "soft_margin_loss",
           "multi_label_soft_margin_loss", "poisson_nll_loss",
           "gaussian_nll_loss", "ctc_loss", "multi_margin_loss",
           "softmax_with_cross_entropy", "adaptive_log_softmax_with_loss"]

__all__ = ["scaled_dot_product_attention",
           "scaled_dot_product_attention_ref", "flash_attention", "linear",
           "dropout", "gelu", "silu", "embedding", "conv2d", "group_norm",
           "interpolate", "add_rms_norm", "add_layer_norm",
           "qkv_rope"] + _LOSSES

dropout = _nn.dropout
gelu = _nn.gelu
silu = _nn.silu
conv2d = _nn.conv2d
group_norm = _nn.group_norm
interpolate = _nn.interpolate
globals().update({name: getattr(_nn, name) for name in _LOSSES})


def linear(x, weight, bias=None, names=("dot",)):
    """Paddle's ``F.linear``: ``x @ weight + bias`` with ``weight``
    ``[in, out]``.  Operands of two float dtypes meet in the wider one
    (jnp's promotion: an f32 input to a 16-bit weight under amp O2
    computes in f32); under ``auto_cast`` its f32 operands are in the amp
    dtype first (white-listed ``"linear"``).  The product is a "dot" to
    the recompute policies (``names``, ``jit/recompute.py``)."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    y = product(x, weight, names)
    return y if bias is None else y + bias


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
    ``dropout_p`` applies while ``training``.  Under ``amp.auto_cast``
    the inputs are cast once, in ``flash_attention_raw``."""
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
    product, which runs in the operands' common dtype."""
    query, key, value = amp_cast("scaled_dot_product_attention", query,
                                 key, value)
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
    probs = probs.to(query.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    return (probs.to(dt) @ v.to(dt)).transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True):
    """Paddle's ``F.flash_attention``: ``scaled_dot_product_attention``
    with ``dropout`` and ``causal``; ``(out, None)`` with
    ``return_softmax``, as the reference."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return (out, None) if return_softmax else out


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
