"""Transformer layers (counterpart of ``paddle_tpu/nn/transformer.py``):
``MultiHeadAttention`` (with ``Cache`` / ``StaticCache``),
``TransformerEncoderLayer`` and ``TransformerDecoderLayer`` in pre- and
post-norm form, ``TransformerEncoder``, ``TransformerDecoder`` and the
encoder-decoder ``Transformer`` (its defaults: the base model of
Vaswani et al. 2017).

Attention goes through ``nn.functional.scaled_dot_product_attention``
(the flash kernels): an additive ``attn_mask`` that requires grad is a
trained bias and gets its gradient from the bias-gradient kernel, and
attention dropout runs inside the kernels while the layer trains.  The
post-norm layers fuse each residual add into its LayerNorm
(``LayerNorm.forward_residual``: the add+norm kernel's LayerNorm body on
the card, two calls an encoder layer and three a decoder layer; under
amp O1 the add meets a 16-bit block output and an f32 residual, the
kernel's mixed-dtype mode).  The decoder's self attention grows a
``Cache`` (f32 zeros at first, as the reference's, so an amp O2 decoder
attends with bf16 queries over f32 keys, promoted), its cross attention
reads a ``StaticCache`` of the memory's keys and values.  Layers take
``device`` (default: the GPU), ``dtype`` and a ``generator`` for their
weights, as ``nn/common.py``'s.
"""
from __future__ import annotations

import collections
import copy
from typing import Optional

import torch
from torch import nn

from . import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

from ..runtime.device import resolve_device

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(nn.Module):
    """``paddle.nn.MultiHeadAttention``: inputs ``[B, S, E]``; the q/k/v
    projections keep Paddle's ``[in, out]`` layout.  ``Cache`` (k/v
    grown by each call) and ``StaticCache`` (k/v computed once, e.g.
    from an encoder's memory) match the reference's incremental-decoding
    API."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        k = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                        dtype=torch.float32, device=key.device)
        return self.Cache(k, torch.zeros_like(k))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, cache
        return out


_ACTIVATIONS = {"relu": torch.relu, "gelu": F.gelu,
                "silu": torch.nn.functional.silu}


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with dropout on its
    output and a residual add: pre-norm (``normalize_before=True``)
    normalises each block's input; post-norm normalises after the add,
    through the fused ``LayerNorm.forward_residual``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        dev = self.linear1.weight.device
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev,
                               dtype=dtype)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev,
                               dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        if self.normalize_before:
            src = residual + self.dropout1(src)
        else:
            src = self.norm1.forward_residual(self.dropout1(src),
                                              residual)[1]
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        if self.normalize_before:
            src = residual + self.dropout2(src)
        else:
            src = self.norm2.forward_residual(self.dropout2(src),
                                              residual)[1]
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself, the rest deep copies with equal weights, as the reference),
    then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self attention over the target, cross attention over the encoder's
    ``memory`` and a feed-forward block, each with dropout on its output
    and a residual add (pre-norm normalises each block's input;
    post-norm normalises after the add, through the fused
    ``LayerNorm.forward_residual``).  With ``cache`` (from
    :meth:`gen_cache`: a ``Cache`` for the self attention, a
    ``StaticCache`` of the memory for the cross attention) it decodes
    incrementally and returns ``(output, new cache)``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        dev = self.linear1.weight.device
        self.norm1, self.norm2, self.norm3 = (
            LayerNorm(d_model, epsilon=layer_norm_eps, device=dev,
                      dtype=dtype) for _ in range(3))
        self.dropout1, self.dropout2, self.dropout3 = (
            Dropout(dropout) for _ in range(3))
        self.activation = _ACTIVATIONS[activation]

    def _residual(self, norm, out, residual):
        if self.normalize_before:
            return residual + out
        return norm.forward_residual(out, residual)[1]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, new_inc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = self._residual(self.norm1, self.dropout1(tgt), residual)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                              None if cache is None else cache[1])
        tgt = self._residual(self.norm2, self.dropout2(tgt), residual)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = self._residual(self.norm3, self.dropout3(tgt), residual)
        return tgt if cache is None else (tgt, (new_inc, cache[1]))

    def gen_cache(self, memory):
        """``(Cache, StaticCache)``: an empty self-attention cache and
        the cross attention's keys and values of ``memory``."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer`` (deep copies with equal
    weights, as the reference), then ``norm`` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    """The encoder-decoder Transformer; the defaults are Vaswani et al.
    2017's base model (d_model 512, 8 heads, 6 + 6 layers, d_ff 2048,
    dropout 0.1, post-norm, relu).  ``forward(src, tgt, ...)`` takes
    embedded ``[B, S, d_model]`` sequences: the embeddings, positions
    and output projection are the caller's, as in the reference."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)

        def final_norm():
            return LayerNorm(d_model, device=device, dtype=dtype) \
                if normalize_before else None

        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                final_norm())
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                final_norm())
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The additive causal mask ``[length, length]`` f32: 0 on and
        below the diagonal, -inf above, on ``device`` (default: the
        GPU)."""
        return torch.full((length, length), float("-inf"),
                          device=resolve_device(device)).triu(1)
