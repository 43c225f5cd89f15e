"""Qwen2-MoE model family (counterpart of
``paddle_tpu/models/qwen2_moe.py``).

Llama-style attention with q/k/v biases (``models/llama.py``
``LlamaAttention``, which takes the unfused rope path when biased, as
the reference's does) and an MoE FFN with a gated shared expert
(``nn/moe.py``, the grouped dropless dispatch), the router's aux loss
added to the training loss.  The default ``Qwen2MoeConfig()`` is
Qwen1.5-MoE-A2.7B (Hugging Face ``Qwen/Qwen1.5-MoE-A2.7B``): hidden
2048, 24 layers, 16 heads and 16 KV heads, 60 experts top-4 of width
1408, a shared expert of 5632, vocab 151,936.

The module tree carries the reference's parameter names
(``layers.0.mlp.experts.gate_w`` ...), so a reference ``raw_state_dict()``
loads 1:1 (``models/from_jax.py``).  Parameters are drawn on the
requested device from a seeded ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..jit.recompute import recompute
from ..nn.moe import MoELayer
from ..ops import _nn
from ..runtime.device import resolve_device
from ..nn.common import Init
from .llama import (LlamaAttention, LlamaConfig, LlamaPretrainingCriterion,
                    _rope_cos_sin)

__all__ = ["Qwen2MoeConfig", "Qwen2MoeDecoderLayer", "Qwen2MoeForCausalLM",
           "qwen2_moe_tiny_config"]


@dataclass
class Qwen2MoeConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    num_experts: int = 60
    num_experts_per_tok: int = 4
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    norm_topk_prob: bool = False     # HF Qwen2-MoE convention
    use_shared_expert_gate: bool = True
    attention_bias: bool = True      # Qwen2 qkv biases
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    fuse_linear_cross_entropy: bool = True
    recompute: bool = False
    sequence_parallel: bool = False
    tie_word_embeddings: bool = False
    # MoELayer dispatch: auto | grouped (dense | grouped_ep raise)
    moe_dispatch_mode: str = "auto"
    ep_capacity_factor: Optional[float] = 2.0

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.moe_intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range,
            attention_bias=self.attention_bias,
            use_flash_attention=self.use_flash_attention)


def qwen2_moe_tiny_config() -> Qwen2MoeConfig:
    return Qwen2MoeConfig(vocab_size=256, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, moe_intermediate_size=32,
                          shared_expert_intermediate_size=64,
                          num_experts=8, num_experts_per_tok=2,
                          max_position_embeddings=128, rope_theta=10000.0)


class Qwen2MoeDecoderLayer(nn.Module):
    def __init__(self, c: Qwen2MoeConfig, init: Init):
        super().__init__()
        self.input_layernorm = init.rms_norm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = LlamaAttention(c.as_llama(), init)
        self.post_attention_layernorm = init.rms_norm(c.hidden_size,
                                                      c.rms_norm_eps)
        self.mlp = MoELayer(
            c.hidden_size, c.num_experts, c.moe_intermediate_size,
            k=c.num_experts_per_tok, capacity_factor=c.capacity_factor,
            shared_expert_intermediate=c.shared_expert_intermediate_size,
            balance_loss_weight=1.0,  # scaled by the aux coef in the model
            init_std=c.initializer_range,
            num_layers_scale=c.num_hidden_layers,
            norm_topk_prob=c.norm_topk_prob,
            use_shared_expert_gate=c.use_shared_expert_gate,
            dispatch_mode=c.moe_dispatch_mode,
            ep_capacity_factor=c.ep_capacity_factor, init=init)

    def forward(self, x, cos_sin):
        x = x + self.self_attn(self.input_layernorm(x), cos_sin)
        x = x + self.mlp(self.post_attention_layernorm(x))
        # aux returned explicitly so that it survives recompute
        return x, self.mlp.aux_loss


class Qwen2MoeForCausalLM(nn.Module):
    """Qwen2-MoE parameters on ``device`` (default: the GPU; raises on a
    machine without one unless ``device="cpu"`` is passed), drawn from
    ``generator`` (on ``device``; without one, a generator seeded with 0
    is made there).  ``recompute`` recomputes every decoder layer in the
    backward (the "full" policy, as the reference)."""

    def __init__(self, config: Qwen2MoeConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        if c.sequence_parallel:
            raise NotImplementedError(
                "Qwen2MoeConfig sequence_parallel=True is not ported yet "
                "(ROADMAP 'Port: remaining modules')")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init = Init(dev, dtype, generator)
        self.config = c
        self.embed_tokens = init.embedding(c.vocab_size, c.hidden_size,
                                           c.initializer_range)
        self.layers = nn.ModuleList([Qwen2MoeDecoderLayer(c, init)
                                     for _ in range(c.num_hidden_layers)])
        self.norm = init.rms_norm(c.hidden_size, c.rms_norm_eps)
        self.lm_head = None if c.tie_word_embeddings else init.linear(
            c.hidden_size, c.vocab_size, c.initializer_range, bias=False)
        rope = _rope_cos_sin(c.max_position_embeddings,
                             c.hidden_size // c.num_attention_heads,
                             c.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(
            np.cos(rope)).to(dev), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(
            np.sin(rope)).to(dev), persistent=False)

    def _head_w(self):
        return self.embed_tokens.weight if self.lm_head is None \
            else self.lm_head.weight

    def forward(self, input_ids, labels=None):
        """Logits ``[B, S, V]``, or with ``labels`` (-100 = ignored) the
        mean cross-entropy plus ``router_aux_loss_coef`` times the sum of
        the layers' aux losses."""
        c = self.config
        s = input_ids.shape[1]
        x = self.embed_tokens(input_ids)
        cos_sin = (self.rope_cos[:s], self.rope_sin[:s])
        aux_losses = []
        for layer in self.layers:
            if c.recompute:
                x, aux = recompute(layer, x, cos_sin)
            else:
                x, aux = layer(x, cos_sin)
            aux_losses.append(aux)
        x = self.norm(x)
        tied = self.lm_head is None
        if labels is None:
            return x @ (self._head_w().t() if tied else self._head_w())
        if c.fuse_linear_cross_entropy:
            loss = _nn.fused_linear_cross_entropy(
                x, self._head_w(), labels, transpose_weight=tied)
        else:
            logits = x @ (self._head_w().t() if tied else self._head_w())
            loss = LlamaPretrainingCriterion()(logits, labels)
        aux = aux_losses[0]
        for a in aux_losses[1:]:
            aux = aux + a
        return loss + c.router_aux_loss_coef * aux
