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
``labels`` are given.  With ``fuse_norm_rope`` (the default) it takes
the reference's fused chain: q and k through the matmul+rope kernel,
the post-attention residual add through the add+RMSNorm kernel
(``nn/functional.py`` -> ``ops/fused_train.py``); the input and final
norms stay plain, as there.  ``recompute`` recomputes every decoder
layer in the backward under ``recompute_granularity`` ("full",
"core_attn" or "dots", ``jit/recompute.py``).  ``sequence_parallel``
and the other model-family knobs raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..jit.recompute import recompute
from ..nn import functional as F
from ..nn.common import Init
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

    def forward(self, x, cos_sin):
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

    def forward(self, x, cos_sin):
        return self._post_attn(
            x, self.self_attn(self.input_layernorm(x), cos_sin))


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

    def forward(self, input_ids):
        c = self.config
        _refuse(_forward_knobs(c), " in the training forward")
        s = input_ids.shape[1]
        cos_sin = (self.rope_cos[:s], self.rope_sin[:s])
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            if c.recompute:
                gran = c.recompute_granularity
                x = recompute(layer, x, cos_sin,
                              policy=None if gran == "full" else gran)
            else:
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
        init = Init(dev, dtype, generator)
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = None if config.tie_word_embeddings else init.linear(
            config.hidden_size, config.vocab_size, config.initializer_range,
            bias=False)

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
