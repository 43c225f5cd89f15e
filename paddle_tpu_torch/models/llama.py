"""Llama-3 model family: configuration, parameter tree, the training
forward and the model's own cached decode.

Counterpart of ``paddle_tpu/models/llama.py``.  The module tree carries
the reference's parameter names (``llama.layers.0.self_attn.q_proj.
weight`` ...) and Paddle's ``[in, out]`` Linear layout, so a reference
``raw_state_dict()`` loads 1:1 (``models/from_jax.py``) and every
projection computes ``x @ W``.

Parameters are created directly on the requested device from a seeded
``torch.Generator`` (an 8B model's weights never pass through host
memory) and are trainable.  The serving engine reads them layer by layer
under ``torch.no_grad`` (``inference/engine.py``).

``LlamaForCausalLM.forward`` is the reference's training forward on its
``cache is None`` path: RMSNorm with f32 statistics, projections, rope
in f32 on ``[B, S, H, D]``, causal flash attention (its forward and
backward kernels), SwiGLU, and the chunked linear + cross-entropy when
``labels`` are given.  With ``fuse_norm_rope`` (the default) it takes
the reference's fused chain: q and k through the matmul+rope kernel,
the post-attention residual add through the add+RMSNorm kernel
(``nn/functional.py`` -> ``ops/fused_train.py``); the input and final
norms stay plain, as there.  ``recompute`` recomputes every decoder
layer in the backward under ``recompute_granularity`` ("full",
"core_attn" or "dots", ``jit/recompute.py``).  ``sequence_parallel``
and the other model-family knobs raise.

The cached forwards of the reference are here too: concat caches
(``gen_caches``; each call appends its K/V and attends causally as the
last rows) and the static caches of ``generate`` (``gen_static_caches``,
``forward(ids, caches=..., pos=..., prefill=...)``: a prefill through
the flash path, then one token a call through ``cached_attention_raw``;
``nn/generation.py``).  ``LlamaForCausalLM`` takes ``GenerationMixin``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..common.errors import enforce
from ..jit.recompute import recompute
from ..nn import functional as F
from ..nn.common import Init
from ..nn.generation import (GenerationMixin, StaticCache,
                             cached_attention_raw, write_cache_raw)
from ..ops import _nn
from ..ops.fused_train import _rotate_half
from ..runtime.device import resolve_device

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama3_8b_config",
           "llama_tiny_config"]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    rope_interleaved: bool = False
    fuse_qkv: bool = False
    # fused step regions (ops/fused_train): rope applied in the q/k
    # projections' output write + residual add fused into the
    # post-attention RMSNorm; the reference documents them bit-identical
    # to False (the unfused chain)
    fuse_norm_rope: bool = True
    use_flash_attention: bool = True
    sequence_parallel: bool = False
    recompute: bool = False
    recompute_granularity: str = "full"   # "full" | "core_attn" | "dots"
    fuse_linear_cross_entropy: bool = True


# knobs the port does not take yet: (setting, asked, ROADMAP item).
# ``LlamaAttention`` takes ``attention_bias`` (the Qwen2-MoE decoder
# builds it so); ``LlamaForCausalLM`` still refuses a biased Llama.
def _model_knobs(c: LlamaConfig):
    return [("attention_bias=True", c.attention_bias,
             "Port: remaining modules"),
            ("rope_interleaved=True", c.rope_interleaved,
             "Port: remaining modules"),
            ("fuse_qkv=True", c.fuse_qkv, "Port: remaining modules")]


def _forward_knobs(c: LlamaConfig):
    return [("sequence_parallel=True", c.sequence_parallel,
             "Port: remaining modules")]


def _refuse(knobs, where):
    for setting, asked, item in knobs:
        if asked:
            raise NotImplementedError(
                f"LlamaConfig {setting} is not ported yet{where} (ROADMAP "
                f"'{item}')")


def llama3_8b_config() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny_config() -> LlamaConfig:
    return LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=128,
                       rope_theta=10000.0)


def _rope_cos_sin(seq_len: int, head_dim: int, theta: float,
                  dtype=np.float32) -> np.ndarray:
    """Rotary angles [S, D] in the cat(freqs, freqs) layout, computed in
    float64 and rounded once — the reference's table bit for bit."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                          dtype=np.float64) / head_dim))
    t = np.arange(seq_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)                      # [S, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)      # [S, D]
    return emb.astype(dtype)


def _apply_rope(q, k, cos, sin):
    """q/k ``[B, S, H, D]``; cos/sin ``[S, D]`` (cat(freqs, freqs)
    layout), applied in f32 and cast back."""
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    qf, kf = q.float(), k.float()
    return ((qf * cos + _rotate_half(qf) * sin).to(q.dtype),
            (kf * cos + _rotate_half(kf) * sin).to(k.dtype))


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, init: Init):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        std = c.initializer_range
        out_std = std / math.sqrt(2 * c.num_hidden_layers)
        bias = c.attention_bias                 # q/k/v biases, no o bias
        self.q_proj = init.linear(c.hidden_size,
                                  self.num_heads * self.head_dim, std,
                                  bias=bias)
        self.k_proj = init.linear(c.hidden_size,
                                  self.num_kv_heads * self.head_dim, std,
                                  bias=bias)
        self.v_proj = init.linear(c.hidden_size,
                                  self.num_kv_heads * self.head_dim, std,
                                  bias=bias)
        # its output is the reference's "attn_out" (the residual that
        # "core_attn" remat keeps)
        self.o_proj = init.linear(self.num_heads * self.head_dim,
                                  c.hidden_size, out_std, bias=False,
                                  names=("dot", "attn_out"))
        self.use_flash = c.use_flash_attention
        # as in the reference, a biased attention (Qwen2's) takes the
        # unfused rope path; the port refuses fuse_qkv at construction
        self.fuse_norm_rope = c.fuse_norm_rope and not bias

    def _attend(self, q, k, v):
        """Causal attention, the queries as the last rows of the keys."""
        if self.use_flash:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        if q.device.type == "cpu":
            return F.scaled_dot_product_attention_ref(q, k, v,
                                                      is_causal=True)
        raise NotImplementedError(
            "use_flash_attention=False selects the plain attention, "
            "which runs on CPU tensors only; on the card attention goes "
            "through the flash kernels (ROADMAP 'Port: remaining "
            "modules')")

    def forward(self, x, cos_sin, cache=None, pos=None, prefill=False):
        """Training / full forward with neither ``cache`` nor ``pos``.
        With ``pos`` (the static-cache protocol of ``nn/generation.py``)
        ``cache`` is a ``StaticCache``: a prefill (``prefill`` and more
        than one row, at position 0) attends causally over the prompt
        through the flash path and then writes the prompt's K/V; any
        other call goes through ``cached_attention_raw``.  Returns (out,
        StaticCache).  With ``cache`` alone it is a concat cache ``(k,
        v)`` ``[B, past, KVH, D]``: the new K/V are appended and the
        queries attend causally as the last rows; returns (out, (k,
        v))."""
        b, s, _ = x.shape
        cos, sin = cos_sin
        if self.fuse_norm_rope:
            # rope rides the q/k projections' output write (the
            # matmul+rope kernel); v is a plain projection
            q, k, v = F.qkv_rope(
                x, self.q_proj.weight, self.k_proj.weight,
                self.v_proj.weight, cos, sin, n_heads=self.num_heads,
                n_kv=self.num_kv_heads, head_dim=self.head_dim)
        else:
            q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
            k = self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
            v = self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
            q, k = _apply_rope(q, k, cos, sin)
        if pos is not None:
            if prefill and s > 1:
                out = self._attend(q, k, v)
                kb, vb = write_cache_raw(k, v, cache.k, cache.v, pos)
            else:
                out, kb, vb = cached_attention_raw(q, k, v, cache.k,
                                                   cache.v, pos)
            out = out.reshape(b, s, self.num_heads * self.head_dim)
            return self.o_proj(out), StaticCache(kb, vb)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = self.o_proj(self._attend(q, k, v).reshape(
            b, s, self.num_heads * self.head_dim))
        return out if cache is None else (out, (k, v))


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, init: Init):
        super().__init__()
        std = c.initializer_range
        out_std = std / math.sqrt(2 * c.num_hidden_layers)
        self.gate_proj = init.linear(c.hidden_size, c.intermediate_size,
                                     std, bias=False)
        self.up_proj = init.linear(c.hidden_size, c.intermediate_size, std,
                                   bias=False)
        self.down_proj = init.linear(c.intermediate_size, c.hidden_size,
                                     out_std, bias=False)

    def forward(self, x):
        return self.down_proj(_nn.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, init: Init):
        super().__init__()
        self.input_layernorm = init.rms_norm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = LlamaAttention(c, init)
        self.post_attention_layernorm = init.rms_norm(c.hidden_size,
                                                      c.rms_norm_eps)
        self.mlp = LlamaMLP(c, init)
        self.fuse_chain = c.fuse_norm_rope

    def _post_attn(self, x, attn):
        """Residual add + post-attention RMSNorm + MLP residual."""
        if self.fuse_chain:
            # the attention residual's write and the norm's read share
            # one pass (the add+norm kernel)
            x, hn = self.post_attention_layernorm.forward_residual(attn, x)
            return x + self.mlp(hn)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, cos_sin, cache=None, pos=None, prefill=False):
        if cache is None:
            return self._post_attn(
                x, self.self_attn(self.input_layernorm(x), cos_sin))
        attn, new_cache = self.self_attn(self.input_layernorm(x), cos_sin,
                                         cache, pos=pos, prefill=prefill)
        return self._post_attn(x, attn), new_cache


class LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, init: Init):
        super().__init__()
        self.config = c
        self.embed_tokens = init.embedding(c.vocab_size, c.hidden_size,
                                           c.initializer_range)
        self.layers = nn.ModuleList([LlamaDecoderLayer(c, init)
                                     for _ in range(c.num_hidden_layers)])
        self.norm = init.rms_norm(c.hidden_size, c.rms_norm_eps)
        head_dim = c.hidden_size // c.num_attention_heads
        rope = _rope_cos_sin(c.max_position_embeddings, head_dim,
                             c.rope_theta)
        # f32 tables, the reference's np.cos/np.sin of the f32 angles
        self.register_buffer("rope_cos", torch.from_numpy(
            np.cos(rope)).to(init.device), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(
            np.sin(rope)).to(init.device), persistent=False)

    def forward(self, input_ids, caches=None, pos=None, prefill=False):
        """Final-norm hidden states; with ``caches`` also the new caches
        (static ones at ``pos``, or concat ones after their length)."""
        c = self.config
        _refuse(_forward_knobs(c), " in the forward")
        s = input_ids.shape[1]
        x = self.embed_tokens(input_ids)
        if caches is None:
            cos_sin = (self.rope_cos[:s], self.rope_sin[:s])
            for layer in self.layers:
                if c.recompute:
                    gran = c.recompute_granularity
                    x = recompute(layer, x, cos_sin,
                                  policy=None if gran == "full" else gran)
                else:
                    x = layer(x, cos_sin)
            return self.norm(x)
        start = int(pos) if pos is not None else (
            caches[0][0].shape[1] if caches[0] is not None else 0)
        cos_sin = (self.rope_cos[start:start + s],
                   self.rope_sin[start:start + s])
        new_caches = []
        for i, layer in enumerate(self.layers):
            x, cache = layer(x, cos_sin, caches[i], pos=pos, prefill=prefill)
            new_caches.append(cache)
        return self.norm(x), new_caches


class LlamaForCausalLM(GenerationMixin, nn.Module):
    """Llama parameters on ``device`` (default: the GPU; raises on a
    machine without one unless ``device="cpu"`` is passed).

    ``generator`` seeds the random weights; it must live on ``device``.
    Without one, a generator seeded with 0 is made there."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _refuse(_model_knobs(config), "")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init = Init(dev, dtype, generator)
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = None if config.tie_word_embeddings else init.linear(
            config.hidden_size, config.vocab_size, config.initializer_range,
            bias=False)

    def forward(self, input_ids, caches=None, labels=None, pos=None,
                prefill=False):
        """Logits ``[B, S, V]``, or with ``labels`` (-100 = ignored) the
        mean cross-entropy: chunked and fused with the head product when
        ``fuse_linear_cross_entropy`` (the f32 logits never exist
        whole), else through ``LlamaPretrainingCriterion``.  With
        ``caches`` (concat ones from ``gen_caches``, or static ones from
        ``gen_static_caches`` at position ``pos``) it returns (logits or
        loss, new caches)."""
        tied = self.lm_head is None
        head_w = self.llama.embed_tokens.weight if tied \
            else self.lm_head.weight
        if caches is None:
            hidden, new_caches = self.llama(input_ids), None
        else:
            hidden, new_caches = self.llama(input_ids, caches, pos=pos,
                                            prefill=prefill)
        if labels is not None and self.config.fuse_linear_cross_entropy:
            out = _nn.fused_linear_cross_entropy(
                hidden, head_w, labels, transpose_weight=tied)
        else:
            out = hidden @ (head_w.t() if tied else head_w)
            if labels is not None:
                out = LlamaPretrainingCriterion()(out, labels)
        return out if caches is None else (out, new_caches)

    def gen_caches(self, batch_size: int):
        """Empty concat caches, one ``(k, v)`` ``[B, 0, KVH, D]`` a
        layer."""
        c = self.config
        w = self.llama.embed_tokens.weight
        shape = (batch_size, 0, c.num_key_value_heads,
                 c.hidden_size // c.num_attention_heads)
        return [(w.new_zeros(shape), w.new_zeros(shape))
                for _ in range(c.num_hidden_layers)]

    def gen_static_caches(self, batch_size: int, total_len: int):
        """Fixed-size decode buffers ``[B, total_len, KVH, D]`` in the
        weights' dtype, one ``StaticCache`` a layer (the
        ``GenerationMixin`` protocol)."""
        c = self.config
        enforce(total_len <= c.max_position_embeddings,
                f"prompt + max_new_tokens = {total_len} exceeds "
                f"max_position_embeddings = {c.max_position_embeddings} "
                "(the RoPE table would clamp and rotations would be wrong)")
        w = self.llama.embed_tokens.weight
        shape = (batch_size, total_len, c.num_key_value_heads,
                 c.hidden_size // c.num_attention_heads)
        return [StaticCache(w.new_zeros(shape), w.new_zeros(shape))
                for _ in range(c.num_hidden_layers)]


class LlamaPretrainingCriterion(nn.Module):
    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        return _nn.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1),
                                 ignore_index=self.ignore_index)
