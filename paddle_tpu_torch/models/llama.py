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

Tensor parallelism: the parameters carry the reference's ``dist_spec``
(q/k/v and gate/up by columns, o/down by rows, the embedding by vocab
rows, the untied head by vocab columns).  ``fleet.distributed_model``
calls ``shard_for_mp``, which keeps this rank's part of each over the
mp group and turns the Megatron forward on (at any mp degree, so a gang
of one runs the same collectives): attention holds ``heads / mp`` and
``kv_heads / mp`` heads, the column inputs pass ``_c_identity``, o_proj
and down_proj end in one all-reduce each, the embedding is
vocab-parallel (one all-reduce) and the head's cross-entropy takes three
all-reduces a chunk (``ops/_nn.py``): 4 a layer a step, plus the
embedding's, the head's input gradient's and the chunks'.

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
from ..distributed import collective as _coll
from ..distributed import parallel_layers as _pl
from ..jit.recompute import product, recompute
from ..nn import functional as F
from ..nn.common import Init
from ..nn.generation import (GenerationMixin, StaticCache,
                             cached_attention_raw, write_cache_raw)
from ..ops import _nn
from ..ops.fused_train import (_interleaved_tables, _rotate_half,
                               _rotate_half_interleaved)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama3_8b_config",
           "llama_tiny_config", "apply_rotary_pos_emb"]


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
    # a pipeline-parallel knob the port does not read (no pipeline
    # yet); kept so that a config hashes the same in both packages
    # (``observability.capsule.model_fingerprint``)
    pp_stash_residuals: bool = True


# knobs the port does not take yet: (setting, asked, ROADMAP item)
def _forward_knobs(c: LlamaConfig):
    return [("sequence_parallel=True", c.sequence_parallel,
             "Port: remaining modules")]


def _refuse(knobs, where):
    for setting, asked, item in knobs:
        if asked:
            raise NotImplementedError(
                f"LlamaConfig {setting} is not ported yet{where} (ROADMAP "
                f"'{item}')")


def _refuse_mp(c: LlamaConfig, mp: int):
    """The splits tensor parallelism needs: whole heads, KV heads,
    MLP columns and vocabulary rows a rank."""
    for what, n in (("num_key_value_heads", c.num_key_value_heads),
                    ("num_attention_heads", c.num_attention_heads),
                    ("intermediate_size", c.intermediate_size),
                    ("vocab_size", c.vocab_size)):
        if n % mp:
            raise NotImplementedError(
                f"LlamaConfig {what}={n} does not split over mp_degree "
                f"{mp}: an uneven tensor-parallel split is not ported "
                f"(ROADMAP 'Multi-device')")


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


def apply_rotary_pos_emb(q, k, cos, sin, interleaved: bool = False):
    """q/k ``[B, S, H, D]``; cos/sin ``[S, D]`` (cat(freqs, freqs)
    layout), applied in f32 and cast back.  ``interleaved`` is the
    GPT-J / ERNIE-4.5 pairing: lanes (2i, 2i+1) rotate together by angle
    i, the angles repeated from the tables' first half."""
    if interleaved:
        cos, sin = _interleaved_tables(cos, sin)
    rot = _rotate_half_interleaved if interleaved else _rotate_half
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    qf, kf = q.float(), k.float()
    return ((qf * cos + rot(qf) * sin).to(q.dtype),
            (kf * cos + rot(kf) * sin).to(k.dtype))


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
        # Megatron layout (the reference's annotations)
        for proj in (self.q_proj, self.k_proj, self.v_proj):
            proj.weight.dist_spec = (None, "mp")
        self.o_proj.weight.dist_spec = ("mp", None)
        self.mp = None                # the mp group, once split
        self.use_flash = c.use_flash_attention
        self.rope_interleaved = c.rope_interleaved
        self.fuse_qkv = c.fuse_qkv
        # as in the reference, a biased attention (Qwen2's) and the
        # one-product qkv take the unfused rope path; interleaved rope
        # goes into the fused chain, which takes its plain rope for it
        self.fuse_norm_rope = c.fuse_norm_rope and not bias \
            and not c.fuse_qkv

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

    def shard_for_mp(self, group):
        """Keep this rank's heads: q/k/v columns (and biases), o_proj
        rows."""
        for proj in (self.q_proj, self.k_proj, self.v_proj):
            _pl.keep_part(proj.weight, 1, group, (None, "mp"))
            if proj.bias is not None:
                _pl.keep_part(proj.bias, 0, group, ("mp",))
        _pl.keep_part(self.o_proj.weight, 0, group, ("mp", None))
        self.num_heads //= group.nranks
        self.num_kv_heads //= group.nranks
        self.mp = group

    def _qkv_one_product(self, x):
        """``fuse_qkv``: one ``x @ [Wq | Wk | Wv]`` product (the weights
        stay three parameters, concatenated per call, as the
        reference), plus the concatenated biases; split back into q, k
        and v."""
        projs = (self.q_proj, self.k_proj, self.v_proj)
        w = torch.cat([p.weight for p in projs], dim=1)
        qkv = product(x, w)
        if self.q_proj.bias is not None:
            qkv = qkv + torch.cat([p.bias for p in projs])
        return qkv.split([p.weight.shape[1] for p in projs], dim=-1)

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
        if self.mp is not None:
            x = _coll._c_identity(x, self.mp)
        if self.fuse_norm_rope:
            # rope rides the q/k projections' output write (the
            # matmul+rope kernel); v is a plain projection
            q, k, v = F.qkv_rope(
                x, self.q_proj.weight, self.k_proj.weight,
                self.v_proj.weight, cos, sin, n_heads=self.num_heads,
                n_kv=self.num_kv_heads, head_dim=self.head_dim,
                interleaved=self.rope_interleaved)
        else:
            if self.fuse_qkv:
                q, k, v = self._qkv_one_product(x)
            else:
                q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
            q = q.reshape(b, s, self.num_heads, self.head_dim)
            k = k.reshape(b, s, self.num_kv_heads, self.head_dim)
            v = v.reshape(b, s, self.num_kv_heads, self.head_dim)
            q, k = apply_rotary_pos_emb(q, k, cos, sin,
                                        interleaved=self.rope_interleaved)
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
        out = self._attend(q, k, v).reshape(b, s,
                                            self.num_heads * self.head_dim)
        if self.mp is not None:
            out = _pl.row_parallel_linear(out, self.o_proj.weight, None,
                                          self.mp, self.o_proj.names)
        else:
            out = self.o_proj(out)
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
        self.gate_proj.weight.dist_spec = (None, "mp")
        self.up_proj.weight.dist_spec = (None, "mp")
        self.down_proj.weight.dist_spec = ("mp", None)
        self.mp = None

    def shard_for_mp(self, group):
        _pl.keep_part(self.gate_proj.weight, 1, group, (None, "mp"))
        _pl.keep_part(self.up_proj.weight, 1, group, (None, "mp"))
        _pl.keep_part(self.down_proj.weight, 0, group, ("mp", None))
        self.mp = group

    def forward(self, x):
        if self.mp is None:
            return self.down_proj(_nn.silu(self.gate_proj(x)) *
                                  self.up_proj(x))
        x = _coll._c_identity(x, self.mp)
        return _pl.row_parallel_linear(
            _nn.silu(self.gate_proj(x)) * self.up_proj(x),
            self.down_proj.weight, None, self.mp, self.down_proj.names)


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
        self.embed_tokens.weight.dist_spec = ("mp", None)
        self.mp = None
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
        if self.mp is None:
            x = self.embed_tokens(input_ids)
        else:
            enforce(caches is None,
                    "the cached forwards of a tensor-parallel Llama are "
                    "not ported (serve through LLMEngine(mesh=); ROADMAP "
                    "'Multi-device')", error_cls=NotImplementedError)
            x = _pl.vocab_parallel_embedding(
                input_ids, self.embed_tokens.weight, self.mp)
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
        init = Init.on(device, dtype, generator)
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = None if config.tie_word_embeddings else init.linear(
            config.hidden_size, config.vocab_size, config.initializer_range,
            bias=False)
        if self.lm_head is not None:
            self.lm_head.weight.dist_spec = (None, "mp")
        self.mp_group = None

    def shard_for_mp(self, group):
        """Keep this rank's part of every annotated parameter over the mp
        group ``group`` (a ``CommGroup``; ``fleet.distributed_model``
        passes the topology's) and take the tensor-parallel forward.
        Raises ``NotImplementedError`` where a split is uneven."""
        enforce(self.mp_group is None, "the model is split already")
        _refuse_mp(self.config, group.nranks)
        for layer in self.llama.layers:
            layer.self_attn.shard_for_mp(group)
            layer.mlp.shard_for_mp(group)
        _pl.keep_part(self.llama.embed_tokens.weight, 0, group,
                      ("mp", None))
        self.llama.mp = group
        if self.lm_head is not None:
            _pl.keep_part(self.lm_head.weight, 1, group, (None, "mp"))
        self.mp_group = group

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
        g = self.mp_group
        if g is not None:
            # the head's columns are this rank's vocabulary
            hidden = _coll._c_identity(hidden, g)
            if labels is not None and \
                    self.config.fuse_linear_cross_entropy:
                out = _nn.fused_linear_cross_entropy(
                    hidden, head_w, labels, transpose_weight=tied,
                    mp_group=g)
            else:
                out = hidden @ (head_w.t() if tied else head_w)
                if labels is None:
                    out = _coll._c_concat(out, g)
                else:
                    tok = _pl.vocab_parallel_cross_entropy(out, labels, g)
                    out = tok.sum() / (labels != -100).sum().clamp(min=1)
        elif labels is not None and self.config.fuse_linear_cross_entropy:
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
