"""GPT-2 model family: configuration, parameter tree and the training
forward (counterpart of ``paddle_tpu/models/gpt.py``; config #1 of
BASELINE.json, GPT-2 124M).

The canonical pre-LN GPT-2: learned positional embeddings, a fused qkv
projection with bias, causal attention with attention dropout, a tanh
GELU MLP, hidden dropout after the embeddings and each residual branch,
and the LM head tied to the token embedding (``logits = h @
wte.weight.T``).  The module tree carries the reference's parameter
names (``gpt.h.0.attn.qkv_proj.weight`` ...) and Paddle's ``[in, out]``
Linear layout, so a reference ``raw_state_dict()`` loads 1:1
(``models/from_jax.py``).

Parameters are drawn on the requested device (default: the GPU; raises
on a machine without one unless ``device="cpu"`` is passed) from a
seeded ``torch.Generator``, with the reference's ``Normal`` stds: the
initializer range for the embeddings, qkv and MLP input, and the range
over ``sqrt(2 L)`` for the attention output and MLP output projections.

Attention goes through ``nn.functional.scaled_dot_product_attention``:
the flash kernels, with the attention dropout inside them while the
model trains.  Hidden dropout is plain (``nn/common.py`` ``Dropout``).
Both draw from the guarded generator of ``ops/random.py``, which
``CompiledTrainStep`` seeds from its ``seed``.  The model's own cached
decode (``caches``, ``gen_caches``) raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..nn import functional as F
from ..nn.common import Dropout, Init
from ..runtime.device import resolve_device

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt2_124m_config", "gpt2_tiny_config"]

_CACHED_DECODE = ("the model's own cached decode (caches, gen_caches) is "
                  "not ported yet (ROADMAP §A 1 'Port: the rest of "
                  "serving', 'The model's own cached decode')")


@dataclass
class GPTConfig:
    vocab_size: int = 50304  # 50,257 padded to a multiple of 64
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True


def gpt2_124m_config() -> GPTConfig:
    return GPTConfig()


def gpt2_tiny_config() -> GPTConfig:
    return GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=128, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)


def _stds(c: GPTConfig):
    return c.initializer_range, \
        c.initializer_range / math.sqrt(2 * c.num_hidden_layers)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, init: Init):
        super().__init__()
        c = config
        std, proj_std = _stds(c)
        self.num_heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.qkv_proj = init.linear(c.hidden_size, 3 * c.hidden_size, std,
                                    bias=True)
        self.out_proj = init.linear(c.hidden_size, c.hidden_size, proj_std,
                                    bias=True)
        self.dropout_p = c.attention_probs_dropout_prob

    def forward(self, x, cache=None):
        if cache is not None:
            raise NotImplementedError(_CACHED_DECODE)
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.dropout_p if self.training else 0.0,
            is_causal=True, training=self.training)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, init: Init):
        super().__init__()
        c = config
        std, proj_std = _stds(c)
        self.fc_in = init.linear(c.hidden_size, c.intermediate_size, std,
                                 bias=True)
        self.fc_out = init.linear(c.intermediate_size, c.hidden_size,
                                  proj_std, bias=True)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, init: Init):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = init.layer_norm(config.hidden_size, eps)
        self.attn = GPTAttention(config, init)
        self.ln_2 = init.layer_norm(config.hidden_size, eps)
        self.mlp = GPTMLP(config, init)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, cache=None):
        if cache is not None:
            raise NotImplementedError(_CACHED_DECODE)
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, init: Init):
        super().__init__()
        c = config
        self.config = c
        std = c.initializer_range
        self.wte = init.embedding(c.vocab_size, c.hidden_size, std)
        self.wpe = init.embedding(c.max_position_embeddings, c.hidden_size,
                                  std)
        self.drop = Dropout(c.hidden_dropout_prob)
        self.h = nn.ModuleList([GPTBlock(c, init)
                                for _ in range(c.num_hidden_layers)])
        self.ln_f = init.layer_norm(c.hidden_size, c.layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None, caches=None):
        if caches is not None:
            raise NotImplementedError(_CACHED_DECODE)
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT-2 parameters on ``device`` (default: the GPU; raises on a
    machine without one unless ``device="cpu"`` is passed).

    ``generator`` seeds the random weights; it must live on ``device``.
    Without one, a generator seeded with 0 is made there."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init = Init(dev, dtype, generator)
        self.config = config
        self.gpt = GPTModel(config, init)
        self.lm_head = None if config.tie_word_embeddings else \
            init.linear(config.hidden_size, config.vocab_size,
                        config.initializer_range, bias=False)

    def forward(self, input_ids, position_ids=None, caches=None):
        """Logits ``[B, S, V]`` in the parameters' dtype."""
        hidden = self.gpt(input_ids, position_ids, caches)
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return hidden @ self.gpt.wte.weight.t()

    def gen_caches(self, batch_size):
        raise NotImplementedError(_CACHED_DECODE)


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy: ``logits [B, S, V]`` against ``labels
    [B, S]`` (the caller shifts them), ``ignore_index`` rows count 0."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1),
                               ignore_index=self.ignore_index)
