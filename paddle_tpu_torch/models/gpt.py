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
``CompiledTrainStep`` seeds from its ``seed``.

The model's own cached decode is the reference's concat cache:
``gen_caches`` gives every block an empty ``(k, v)`` ``[B, 0, NH, D]``,
and a forward with ``caches`` appends its K/V to them, attends causally
with its queries as the last rows, takes positions after the cached
length and returns ``(logits, new caches)``.  As in the reference, GPT-2
has no ``generate``.
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
        """With a concat ``cache`` ``(k, v)`` the new K/V are appended
        and (out, (k, v)) returned."""
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.dropout_p if self.training else 0.0,
            is_causal=True, training=self.training)
        out = self.out_proj(out.reshape(b, s, h))
        return out if cache is None else (out, (k, v))


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
        if cache is None:
            x = x + self.dropout(self.attn(self.ln_1(x)))
            return x + self.dropout(self.mlp(self.ln_2(x)))
        attn, cache = self.attn(self.ln_1(x), cache)
        x = x + self.dropout(attn)
        return x + self.dropout(self.mlp(self.ln_2(x))), cache


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
        """Final-norm hidden states; with ``caches`` also the new
        caches."""
        s = input_ids.shape[1]
        past = 0 if caches is None or caches[0] is None else \
            caches[0][0].shape[1]
        if position_ids is None:
            position_ids = torch.arange(past, past + s,
                                        device=input_ids.device)[None]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if caches is None:
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        new_caches = []
        for i, block in enumerate(self.h):
            x, cache = block(x, caches[i])
            new_caches.append(cache)
        return self.ln_f(x), new_caches


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
        """Logits ``[B, S, V]`` in the parameters' dtype; with ``caches``
        (``gen_caches``) (logits, new caches)."""
        out = self.gpt(input_ids, position_ids, caches)
        hidden = out if caches is None else out[0]
        if self.lm_head is not None:
            logits = self.lm_head(hidden)
        else:
            logits = hidden @ self.gpt.wte.weight.t()
        return logits if caches is None else (logits, out[1])

    def gen_caches(self, batch_size):
        """Empty concat caches, one ``(k, v)`` ``[B, 0, NH, D]`` a
        block, in the weights' dtype."""
        c = self.config
        w = self.gpt.wte.weight
        shape = (batch_size, 0, c.num_attention_heads,
                 c.hidden_size // c.num_attention_heads)
        return [(w.new_zeros(shape), w.new_zeros(shape))
                for _ in range(c.num_hidden_layers)]


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
