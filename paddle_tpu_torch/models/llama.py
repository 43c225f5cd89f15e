"""Llama-3 model family: configuration, parameter tree and the training
forward.

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
``labels`` are given.  The reference's fused step regions
(``fuse_norm_rope=True``, bit-identical to the unfused chain there) and
its remat, sequence-parallel and other model-family knobs raise here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn import functional as F
from ..ops import _nn
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
    # the reference's fused add+norm and matmul+rope regions; the port's
    # training forward takes only the unfused chain (False), which the
    # reference documents as bit-identical
    fuse_norm_rope: bool = True
    use_flash_attention: bool = True
    sequence_parallel: bool = False
    recompute: bool = False
    recompute_granularity: str = "full"
    fuse_linear_cross_entropy: bool = True


# knobs the port does not take yet: (setting, asked, ROADMAP item)
def _model_knobs(c: LlamaConfig):
    return [("attention_bias=True", c.attention_bias,
             "Port: remaining modules"),
            ("rope_interleaved=True", c.rope_interleaved,
             "Port: remaining modules"),
            ("fuse_qkv=True", c.fuse_qkv, "Port: remaining modules")]


def _forward_knobs(c: LlamaConfig):
    return [("fuse_norm_rope=True", c.fuse_norm_rope,
             "Port: fused step regions and recompute"),
            ("recompute=True", c.recompute,
             "Port: fused step regions and recompute"),
            ("sequence_parallel=True", c.sequence_parallel,
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


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class _Init:
    """Seeded parameter factory: every tensor is drawn on ``device``
    from one generator, in module-construction order."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator):
        self.device, self.dtype, self.gen = device, dtype, generator

    def normal(self, shape, std: float) -> nn.Parameter:
        w = torch.empty(shape, device=self.device, dtype=self.dtype)
        w.normal_(0.0, std, generator=self.gen)
        return nn.Parameter(w)

    def ones(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, device=self.device,
                                       dtype=self.dtype))


class Linear(nn.Module):
    """Bias-free projection with Paddle's ``[in, out]`` weight."""

    def __init__(self, init: _Init, d_in: int, d_out: int, std: float):
        super().__init__()
        self.weight = init.normal((d_in, d_out), std)

    def forward(self, x):
        return x @ self.weight


class Embedding(nn.Module):
    def __init__(self, init: _Init, vocab: int, dim: int, std: float):
        super().__init__()
        self.weight = init.normal((vocab, dim), std)

    def forward(self, ids):
        return nn.functional.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, init: _Init, dim: int, eps: float):
        super().__init__()
        self.weight = init.ones((dim,))
        self.eps = eps

    def forward(self, x):
        return _nn.rms_norm(x, self.weight, epsilon=self.eps)


def _apply_rope(q, k, cos, sin):
    """q/k ``[B, S, H, D]``; cos/sin ``[S, D]`` (cat(freqs, freqs)
    layout), applied in f32 and cast back."""
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    qf, kf = q.float(), k.float()
    return ((qf * cos + _rotate_half(qf) * sin).to(q.dtype),
            (kf * cos + _rotate_half(kf) * sin).to(k.dtype))


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, init: _Init):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        std = c.initializer_range
        out_std = std / math.sqrt(2 * c.num_hidden_layers)
        self.q_proj = Linear(init, c.hidden_size,
                             self.num_heads * self.head_dim, std)
        self.k_proj = Linear(init, c.hidden_size,
                             self.num_kv_heads * self.head_dim, std)
        self.v_proj = Linear(init, c.hidden_size,
                             self.num_kv_heads * self.head_dim, std)
        self.o_proj = Linear(init, self.num_heads * self.head_dim,
                             c.hidden_size, out_std)
        self.use_flash = c.use_flash_attention

    def forward(self, x, cos_sin):
        b, s, _ = x.shape
        cos, sin = cos_sin
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        q, k = _apply_rope(q, k, cos, sin)
        if self.use_flash:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        elif x.device.type == "cpu":
            out = F.scaled_dot_product_attention_ref(q, k, v, is_causal=True)
        else:
            raise NotImplementedError(
                "use_flash_attention=False selects the plain attention, "
                "which runs on CPU tensors only; on the card attention goes "
                "through the flash kernels (ROADMAP 'Port: remaining "
                "modules')")
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, init: _Init):
        super().__init__()
        std = c.initializer_range
        out_std = std / math.sqrt(2 * c.num_hidden_layers)
        self.gate_proj = Linear(init, c.hidden_size, c.intermediate_size,
                                std)
        self.up_proj = Linear(init, c.hidden_size, c.intermediate_size,
                              std)
        self.down_proj = Linear(init, c.intermediate_size, c.hidden_size,
                                out_std)

    def forward(self, x):
        return self.down_proj(_nn.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, init: _Init):
        super().__init__()
        self.input_layernorm = RMSNorm(init, c.hidden_size, c.rms_norm_eps)
        self.self_attn = LlamaAttention(c, init)
        self.post_attention_layernorm = RMSNorm(init, c.hidden_size,
                                                c.rms_norm_eps)
        self.mlp = LlamaMLP(c, init)

    def forward(self, x, cos_sin):
        x = x + self.self_attn(self.input_layernorm(x), cos_sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, init: _Init):
        super().__init__()
        self.config = c
        self.embed_tokens = Embedding(init, c.vocab_size, c.hidden_size,
                                      c.initializer_range)
        self.layers = nn.ModuleList([LlamaDecoderLayer(c, init)
                                     for _ in range(c.num_hidden_layers)])
        self.norm = RMSNorm(init, c.hidden_size, c.rms_norm_eps)
        head_dim = c.hidden_size // c.num_attention_heads
        rope = _rope_cos_sin(c.max_position_embeddings, head_dim,
                             c.rope_theta)
        # f32 tables, the reference's np.cos/np.sin of the f32 angles
        self.register_buffer("rope_cos", torch.from_numpy(
            np.cos(rope)).to(init.device), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(
            np.sin(rope)).to(init.device), persistent=False)

    def forward(self, input_ids):
        _refuse(_forward_knobs(self.config), " in the training forward")
        s = input_ids.shape[1]
        cos_sin = (self.rope_cos[:s], self.rope_sin[:s])
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, cos_sin)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
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
        init = _Init(dev, dtype, generator)
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            init, config.hidden_size, config.vocab_size,
            config.initializer_range)

    def forward(self, input_ids, labels=None):
        """Logits ``[B, S, V]``, or with ``labels`` (-100 = ignored) the
        mean cross-entropy: chunked and fused with the head product when
        ``fuse_linear_cross_entropy`` (the f32 logits never exist
        whole), else through ``LlamaPretrainingCriterion``."""
        hidden = self.llama(input_ids)
        tied = self.lm_head is None
        head_w = self.llama.embed_tokens.weight if tied \
            else self.lm_head.weight
        if labels is not None and self.config.fuse_linear_cross_entropy:
            return _nn.fused_linear_cross_entropy(
                hidden, head_w, labels, transpose_weight=tied)
        logits = hidden @ (head_w.t() if tied else head_w)
        if labels is not None:
            return LlamaPretrainingCriterion()(logits, labels)
        return logits


class LlamaPretrainingCriterion(nn.Module):
    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        return _nn.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1),
                                 ignore_index=self.ignore_index)
