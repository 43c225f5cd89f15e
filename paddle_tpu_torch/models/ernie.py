"""ERNIE-4.5 model family (counterpart of ``paddle_tpu/models/ernie.py``).

The Llama backbone (RMSNorm, rope, GQA attention, SwiGLU) with
ERNIE-4.5's heterogeneous MoE: the first ``moe_layer_start_index``
layers are dense, the rest MoE layers with shared experts and a top-k
router whose load-balance loss, times ``moe_aux_loss_coef``, joins the
training loss.  The attention is ``models/llama.py``'s: q and k through
the matmul+rope kernel (``fuse_norm_rope`` is on, as in the reference's
``as_llama``), causal flash attention; the MoE FFN is ``nn/moe.py``'s
dropless grouped dispatch (the grouped matmul kernels), which is what
the reference runs on one TPU.

ERNIE-4.5 checkpoints pair rope lanes GPT-J style.
``rope_interleaved=True`` runs them as they are (the plain rope, as the
reference's); ``models/convert.py`` ``convert_hf_ernie45`` permutes the
q/k lanes once so the model runs the contiguous rope with equal
attention scores.

The module tree carries the reference's parameter names (``layers.N``
at the top level, ``layers.N.mlp.experts.gate_w`` ...), so a reference
``raw_state_dict()`` loads 1:1 (``models/from_jax.py``).  Parameters
are drawn on ``device`` (default: the GPU) from a seeded
``torch.Generator``.  ``Ernie45ForCausalLMPipe`` (the TP+PP recipe)
needs a device mesh and raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..jit.recompute import recompute
from ..nn.common import Init
from ..nn.moe import MoELayer
from ..ops import _nn
from .llama import (LlamaAttention, LlamaConfig, LlamaMLP,
                    LlamaPretrainingCriterion, _rope_cos_sin)

__all__ = ["Ernie45Config", "Ernie45DecoderLayer", "Ernie45ForCausalLM",
           "Ernie45ForCausalLMPipe", "ernie45_tiny_config",
           "ernie45_a3b_config"]


@dataclass
class Ernie45Config:
    vocab_size: int = 103424
    hidden_size: int = 2560
    intermediate_size: int = 12288
    num_hidden_layers: int = 28
    num_attention_heads: int = 20
    num_key_value_heads: int = 4
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # ERNIE-4.5 checkpoints use GPT-J-interleaved rope; the converter
    # permutes q/k lanes so the model runs the contiguous rope with
    # identical numerics (True only for unconverted weights)
    rope_interleaved: bool = False
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    recompute: bool = False
    fuse_linear_cross_entropy: bool = True
    # heterogeneous MoE (0 experts = dense model)
    moe_num_experts: int = 0
    moe_k: int = 6
    moe_intermediate_size: int = 1536
    moe_num_shared_experts: int = 2
    moe_layer_start_index: int = 1      # leading layers stay dense
    moe_aux_loss_coef: float = 0.001

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range,
            tie_word_embeddings=self.tie_word_embeddings,
            rope_interleaved=self.rope_interleaved,
            use_flash_attention=self.use_flash_attention,
            recompute=self.recompute,
            fuse_linear_cross_entropy=self.fuse_linear_cross_entropy)


def ernie45_a3b_config() -> Ernie45Config:
    """ERNIE-4.5-21B-A3B-class shape: 64 experts top-6 + 2 shared,
    first layer dense."""
    return Ernie45Config(moe_num_experts=64, moe_k=6,
                         moe_num_shared_experts=2,
                         moe_layer_start_index=1)


def ernie45_tiny_config(moe: bool = False) -> Ernie45Config:
    return Ernie45Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0,
        moe_num_experts=8 if moe else 0, moe_k=2,
        moe_intermediate_size=32, moe_num_shared_experts=1,
        moe_layer_start_index=1)


class Ernie45DecoderLayer(nn.Module):
    """Pre-norm attention and FFN residuals; the FFN is the dense SwiGLU
    or, from ``moe_layer_start_index`` on, the MoE layer (built as the
    reference builds it: balance weight 1, the shared expert
    ``moe_num_shared_experts x moe_intermediate_size`` wide).
    ``forward`` returns ``(x, aux)``, aux None for a dense layer, so the
    aux loss survives recompute."""

    def __init__(self, c: Ernie45Config, layer_idx: int, init: Init):
        super().__init__()
        lc = c.as_llama()
        self.input_layernorm = init.rms_norm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = LlamaAttention(lc, init)
        self.post_attention_layernorm = init.rms_norm(c.hidden_size,
                                                      c.rms_norm_eps)
        self.is_moe = (c.moe_num_experts > 0
                       and layer_idx >= c.moe_layer_start_index)
        if self.is_moe:
            self.mlp = MoELayer(
                c.hidden_size, c.moe_num_experts, c.moe_intermediate_size,
                k=c.moe_k,
                shared_expert_intermediate=(c.moe_num_shared_experts
                                            * c.moe_intermediate_size),
                balance_loss_weight=1.0, init_std=c.initializer_range,
                num_layers_scale=c.num_hidden_layers, init=init)
        else:
            self.mlp = LlamaMLP(lc, init)

    def forward(self, x, cos_sin):
        x = x + self.self_attn(self.input_layernorm(x), cos_sin)
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, (self.mlp.aux_loss if self.is_moe else None)


class Ernie45ForCausalLM(nn.Module):
    """ERNIE-4.5 causal LM (dense or heterogeneous MoE) on ``device``
    (default: the GPU; raises on a machine without one unless
    ``device="cpu"`` is passed), drawn from ``generator`` (on
    ``device``; without one, a generator seeded with 0 is made there).
    ``recompute`` recomputes every decoder layer in the backward (the
    "full" policy, as the reference)."""

    # the reference annotates it for tensor parallelism (dist_spec);
    # fleet.distributed_model refuses it at mp > 1 (not split here)
    _mp_annotated = True

    def __init__(self, config: Ernie45Config, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.config = config
        init = Init.on(device, dtype, generator)
        dev = init.device
        self.embed_tokens = init.embedding(c.vocab_size, c.hidden_size,
                                           c.initializer_range)
        self.layers = nn.ModuleList([Ernie45DecoderLayer(c, i, init)
                                     for i in range(c.num_hidden_layers)])
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

    def forward(self, input_ids, labels=None):
        """Logits ``[B, S, V]``, or with ``labels`` (-100 = ignored) the
        mean cross-entropy plus ``moe_aux_loss_coef`` times the sum of
        the MoE layers' aux losses."""
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
            if aux is not None:
                aux_losses.append(aux)
        x = self.norm(x)
        aux_total = None
        if aux_losses:
            aux_total = aux_losses[0]
            for a in aux_losses[1:]:
                aux_total = aux_total + a
            aux_total = aux_total * c.moe_aux_loss_coef
        tied = self.lm_head is None
        head_w = self.embed_tokens.weight if tied else self.lm_head.weight
        if labels is not None and c.fuse_linear_cross_entropy:
            loss = _nn.fused_linear_cross_entropy(x, head_w, labels,
                                                  transpose_weight=tied)
        else:
            logits = x @ (head_w.t() if tied else head_w)
            if labels is None:
                return logits
            loss = LlamaPretrainingCriterion()(logits, labels)
        return loss if aux_total is None else loss + aux_total


class Ernie45ForCausalLMPipe(nn.Module):
    """The reference's TP+PP recipe (the dense backbone through its
    SPMD GPipe engine over a device mesh).  The port has no mesh yet."""

    def __init__(self, config: Ernie45Config, n_microbatches: int = 4):
        super().__init__()
        raise NotImplementedError(
            "Ernie45ForCausalLMPipe (pipeline and tensor parallel over a "
            "device mesh) is not ported yet (ROADMAP 'Multi-device'); "
            "Ernie45ForCausalLM trains the same model on one card")
