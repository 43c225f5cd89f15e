"""Llama-3 model family: configuration and parameter tree.

Counterpart of ``paddle_tpu/models/llama.py``.  The module tree carries
the reference's parameter names (``llama.layers.0.self_attn.q_proj.
weight`` ...) and Paddle's ``[in, out]`` Linear layout, so a reference
``raw_state_dict()`` loads 1:1 (``models/from_jax.py``) and every
projection computes ``x @ W``.

Parameters are created directly on the requested device from a seeded
``torch.Generator``: an 8B model's weights never pass through host
memory.

Only the parameters are ported here.  The serving engine reads them
layer by layer (``inference/engine.py``); the model's own training
forward, which runs the fused norm/rope kernels and causal flash
attention in the reference, belongs to the training slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..runtime.device import resolve_device

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "llama3_8b_config", "llama_tiny_config"]


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
        return nn.Parameter(w, requires_grad=False)

    def ones(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, device=self.device,
                                       dtype=self.dtype),
                            requires_grad=False)


class Linear(nn.Module):
    """Bias-free projection with Paddle's ``[in, out]`` weight."""

    def __init__(self, init: _Init, d_in: int, d_out: int, std: float):
        super().__init__()
        self.weight = init.normal((d_in, d_out), std)


class Embedding(nn.Module):
    def __init__(self, init: _Init, vocab: int, dim: int, std: float):
        super().__init__()
        self.weight = init.normal((vocab, dim), std)


class RMSNorm(nn.Module):
    def __init__(self, init: _Init, dim: int):
        super().__init__()
        self.weight = init.ones((dim,))


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


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, init: _Init):
        super().__init__()
        self.input_layernorm = RMSNorm(init, c.hidden_size)
        self.self_attn = LlamaAttention(c, init)
        self.post_attention_layernorm = RMSNorm(init, c.hidden_size)
        self.mlp = LlamaMLP(c, init)


class LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, init: _Init):
        super().__init__()
        self.config = c
        self.embed_tokens = Embedding(init, c.vocab_size, c.hidden_size,
                                      c.initializer_range)
        self.layers = nn.ModuleList([LlamaDecoderLayer(c, init)
                                     for _ in range(c.num_hidden_layers)])
        self.norm = RMSNorm(init, c.hidden_size)
        head_dim = c.hidden_size // c.num_attention_heads
        rope = _rope_cos_sin(c.max_position_embeddings, head_dim,
                             c.rope_theta)
        # f32 tables, the reference's np.cos/np.sin of the f32 angles
        self.register_buffer("rope_cos", torch.from_numpy(
            np.cos(rope)).to(init.device), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(
            np.sin(rope)).to(init.device), persistent=False)


class LlamaForCausalLM(nn.Module):
    """Llama parameters on ``device`` (default: the GPU; raises on a
    machine without one unless ``device="cpu"`` is passed).

    ``generator`` seeds the random weights; it must live on ``device``.
    Without one, a generator seeded with 0 is made there."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init = _Init(dev, dtype, generator)
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            init, config.hidden_size, config.vocab_size,
            config.initializer_range)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "LlamaForCausalLM.forward (the training forward) is not "
            "ported yet (ROADMAP 'Port: training/forward slice'); serve "
            "through inference.engine.LLMEngine")
