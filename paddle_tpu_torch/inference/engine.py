"""LLMEngine — continuous-batching serving loop over the paged KV cache.

Counterpart of ``paddle_tpu/inference/engine.py`` for the Llama serving
path.  Requests of ragged lengths share one page pool
(``inference/paged_cache.py``); host-side work per step is page-table
bookkeeping and the packing of one flat token batch.

``step()`` is the ragged unified step: one forward over a flat batch of
``T = max_seqs + prefill_token_budget`` rows that carries every active
decode slot (one row each) plus pending ``begin_request`` prefill
chunks, packed up to the prefill budget without crossing page
boundaries.  Each layer's attention is one call of the ragged kernel
(``ops/paged_attention.py``): it appends every row's K/V into its page
and attends each row over its own sequence, so prefill rides beside
decode instead of stalling it.  ``steps_per_sync > 1`` runs pure-decode
windows as host-chained single-token steps, the reference's
``scan_decode=False`` order, which the reference holds bit-identical to
its on-device window.

``add_request`` is the synchronous admission path: the prompt runs in
page-sized chunks, each writing one whole page and attending over the
sequence's pages so far through the flash-forward kernel
(``ops/flash_attention.py``) under an additive position mask; the first
token comes back at once.

Automatic prefix caching: admission looks up the longest cached
page-aligned prefix of the prompt, maps those pages into the new slot
(host-side only) and prefills only the tail.

MoE backbones (Qwen2-MoE, ``inference/backbone.py``): every decoder
layer's FFN is the dropless grouped dispatch of
``inference/moe_dispatch.py`` (kernel #11 for the gate, up and down
projections) on both forwards, with the q/k/v biases of the model; the
routed slots of every (layer, expert) are summed into
``self._moe_counts`` [L, E] on the device.  Padding rows route nowhere.

``unified_step=False`` is the split path: ``add_request`` prefills as
above and ``step()`` decodes one token for every active request a
forward, the batch padded to ``max_seqs`` rows (pad rows: length 0,
table 0, writing into the pad page), each layer's attention one call of
the fused decode kernel #7 (append the row's K/V at its length, attend
over the sequence).  ``steps_per_sync > 1`` runs power-of-two windows of
host-chained forwards that stop early once every live row has hit its
EOS or its budget (the reference's ``_paged_decode_window``).

Quantized serving: ``kv_dtype="int8"`` keeps the pools as int8 codes
with one f32 scale per token row; every kernel quantizes the rows it
appends (bit-equal to ``quantization/ops.py``) and dequantizes the pages
it reads, and the synchronous prefill quantizes its chunk's rows before
the page write and attends, through the flash kernel in f32, over the
dequantized pages, its own rows included.  ``weight_dtype="int8"``
quantizes every decoder projection and an untied head per (layer,
output channel) (the embedding, norms, router and biases stay float);
a model that went through ``quantization.quantize_model`` is taken as it
is.  An int8 weight is widened to the activation's dtype for the product
and its scale folds into the output (``quantization.ops.
quantized_matmul``); an MoE expert stack widens to bf16 for #11.
KV pools in another float dtype than the weights: ``dtype`` (float32 by
default, as the reference's) or a float ``kv_dtype`` name ("float32",
"bfloat16", "float16") sets the pools' dtype whatever the weights'; the
reference's serving benches run f32 weights over bf16 pools.  Every
kernel takes q and the new rows in the activation dtype, casts the rows
to the pool dtype as it writes them and attends in f32 (the kernels'
mixed-dtype mode); the synchronous prefill writes its chunk into the
pool dtype and attends in f32 over the pages when the dtypes differ.

Preemption: ``suspend`` takes an active request out of the batch,
swapping its private pages into the cache's host pool (as many pages as
the device pool unless ``swap_pool_pages`` says otherwise; 0 disables
swap), or only releasing them when the pool is full; ``resume`` swaps
them back in, or recomputes the KV from the token history: the prompt
through the chunked prefill, the generated tokens through the split
path's decode forward (kernel #7), in power-of-two windows.
``export_request``/``import_request`` move a suspended request to
another engine (its swap entry as a portable blob).

Sampling (``decode_strategy="sampling"`` with ``top_k``, ``top_p``,
``temperature`` and ``seed``) keeps the reference's key discipline on
the threefry stream of ``common/prng.py``, so a seed gives the
reference's tokens: the engine key splits once at each synchronous
admission (the first token drawn as row 0), once a ``step()`` on the
unified path and once a window on the split path, and the window key
once a forward (``inference/sampling.py``); row i of a forward draws on
``fold_row(step_key, i)``.  Only the rows whose tokens are kept are
drawn (a row's draw does not depend on the others).  Recompute replay
feeds the recorded tokens and leaves the key alone.

Speculative decoding (``draft_model``, ``spec_k``): a dense draft
backbone over its own ``PagedKVCache`` proposes ``k`` tokens a sequence
through the split path's forward (kernel #7), the target verifies ``[last,
d_1 .. d_k]`` of every sequence in one ragged forward (kernel #1, ``k +
1`` query rows a sequence) and ``inference/speculative.py`` accepts:
greedily (the plain greedy tokens) or by rejection sampling (the
target's distribution); rejected suffixes roll back on both caches.

Knobs of the reference engine that this port does not take yet raise
``NotImplementedError`` naming their ROADMAP item; metrics, tracing
spans and request capsules are not ported.

Weights are read per layer from the model's own parameters (no stacked
copy), and the engine runs on the model's device: the GPU by default,
the CPU only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..common import prng
from ..common.errors import enforce
from ..models.llama import _rotate_half
from ..nn.generation import filtered_probs, sample_logits
from ..ops import _nn
from ..ops.flash_attention import flash_attention_raw
from ..ops.paged_attention import (paged_decode_append_attend,
                                   ragged_paged_append_attend)
from ..quantization.layers import QuantizedLinear
from ..quantization.ops import (quantize_absmax, quantize_rows,
                                quantized_matmul)
from ..runtime.device import resolve_device
from .backbone import resolve_backbone
from .moe_dispatch import MoEArch, moe_ffn
from . import speculative as _spec_mod
from .paged_cache import PagedKVCache
from .sampling import spec_window_keys, split_step

__all__ = ["LLMEngine", "GenRequest"]

# float pool dtypes that ``kv_dtype`` may name
_FLOAT_KV = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}


class GenRequest:
    def __init__(self, rid, prompt_ids, max_new_tokens, eos_token_id):
        self.rid = rid
        self.prompt = list(prompt_ids)
        self.max_new = max_new_tokens
        self.eos = eos_token_id
        self.out: List[int] = []
        self.slot: Optional[int] = None
        self.done = False
        self.cancelled = False
        # deferred admission (begin_request): next prompt position to
        # prefill
        self.pf_pos = 0
        # preemption: a suspended request holds no slot or device pages;
        # its swap entry (None: resume recomputes)
        self.suspended = False
        self.swap_handle: Optional[int] = None
        # speculative decoding: the draft cache's slot, attached at the
        # request's first speculative window
        self.draft_slot: Optional[int] = None


def _rope(x, cos, sin):
    """Rotary embedding in f32, cast back to x's dtype."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def _mm(x, w):
    """x @ w for a float weight or an int8 ``(values, scale)`` pair,
    whose per-output-channel scale folds into the product."""
    return quantized_matmul(x, *w) if isinstance(w, tuple) else x @ w


def _wout(w) -> int:
    """Output width of a float weight or an int8 pair."""
    return (w[0] if isinstance(w, tuple) else w).shape[-1]


def _rope_tables(spec, page_size: int):
    """A backbone's f32 rope tables, and the same padded to a page
    multiple for the chunked prefill, which slices a full page of rows
    at the last chunk's base (the padded rows back padding ids only)."""
    rope = (spec.rope_cos.float(), spec.rope_sin.float())
    maxpos = rope[0].shape[0]
    pad_to = -(-max(maxpos, page_size) // page_size) * page_size
    return rope, tuple(torch.nn.functional.pad(r, (0, 0, 0, pad_to - maxpos))
                       for r in rope)


def _head(x, head_w, tied):
    return x @ head_w.T if tied else _mm(x, head_w)


def _ffn(x, pln, gw, uw, dw, eps):
    hn = _nn.rms_norm(x, pln, epsilon=eps)
    return x + _mm(_nn.silu(_mm(hn, gw)) * _mm(hn, uw), dw)


def _unpack(lp, arch):
    """One layer's weights: (iln, qw, qb, kw, kb, vw, vb, ow, pln, ffn)
    with ``ffn`` the dense (gw, uw, dw) or, under an MoE ``arch``, the
    MoE tuple of ``moe_ffn``; the biases are None without them."""
    if arch is None:
        iln, qw, kw, vw, ow, pln, gw, uw, dw = lp
        return iln, qw, None, kw, None, vw, None, ow, pln, (gw, uw, dw)
    iln, qw, qb, kw, kb, vw, vb, ow, pln, *mw = lp
    return iln, qw, qb, kw, kb, vw, vb, ow, pln, tuple(mw)


def _proj(x, w, b):
    return _mm(x, w) if b is None else _mm(x, w) + b


def _layer_scales(k_scales, v_scales, li):
    return (None, None) if k_scales is None else (k_scales[li],
                                                  v_scales[li])


def _attn_qkv(x, iln, qw, qb, kw, kb, vw, vb, cos, sin, eps, kvh,
              head_dim):
    """Input norm, q/k/v projections and rope of a layer's rows: q
    [N, NH, D], k and v [N, KVH, D], all in x's dtype."""
    n = x.shape[0]
    hn = _nn.rms_norm(x, iln, epsilon=eps)
    nh = _wout(qw) // head_dim
    q = _rope(_proj(hn, qw, qb).view(n, nh, head_dim), cos, sin)
    k = _rope(_proj(hn, kw, kb).view(n, kvh, head_dim), cos, sin)
    v = _proj(hn, vw, vb).view(n, kvh, head_dim)
    return q, k, v


def _ffn_block(x, pln, ffn, eps, arch, live, counts):
    """The post-attention FFN with its residual: dense SwiGLU, or the
    MoE FFN, whose routed-slot counts are appended to ``counts``."""
    if arch is None:
        return _ffn(x, pln, *ffn, eps)
    out, cnt = moe_ffn(_nn.rms_norm(x, pln, epsilon=eps), ffn, arch, live)
    counts.append(cnt)
    return x + out


@torch.no_grad()
def _paged_prefill_chunk(layers, norm_w, head_w, embed_w, rope,
                         k_pages, v_pages, ids, table, prev_len: int,
                         page_slot: int, last_in_chunk: int, *,
                         eps: float, kvh: int, head_dim: int,
                         tied: bool, arch: Optional[MoEArch] = None,
                         k_scales=None, v_scales=None):
    """Chunked prefill of ``ids`` [C] — one page-sized chunk of one
    prompt — against the paged cache.  The chunk's K/V fill exactly one
    page (``page_slot``; C == page_size), written whole, and its queries
    attend over all of the sequence's pages (``table`` [maxp]) through
    the flash kernel under an additive mask: chunk row r (position
    prev_len + r) sees kv positions <= prev_len + r.  The pools are
    updated in place.  ``last_in_chunk`` is the row whose logits matter
    on the final chunk.  Returns logits [V]; under an MoE ``arch`` also
    the routed-slot counts [L, E] (the chunk's real rows, ``<=
    last_in_chunk``, are the ones routed).  With the scale pools
    ``k_scales``/``v_scales`` [L, KVH, n_pages, P] the pools are int8:
    the chunk's rows are quantized per token before the page write, and
    the attention runs in f32 over the dequantized pages (the chunk's
    own rows after their round trip through int8)."""
    cos_t, sin_t = rope
    c = ids.shape[0]
    maxp = table.shape[0]
    s_kv = maxp * c
    x = embed_w[ids]                                   # [C, H]
    cos = cos_t[prev_len:prev_len + c][:, None, :]
    sin = sin_t[prev_len:prev_len + c][:, None, :]
    kvpos = torch.arange(s_kv, device=ids.device)
    allow = kvpos[None, :] <= prev_len + torch.arange(
        c, device=ids.device)[:, None]
    amask = torch.zeros(allow.shape, dtype=torch.float32,
                        device=ids.device).masked_fill_(~allow, -1e30)
    live = None if arch is None else \
        torch.arange(c, device=ids.device) <= last_in_chunk
    counts = []
    for li, lp in enumerate(layers):
        iln, qw, qb, kw, kb, vw, vb, ow, pln, ffn = _unpack(lp, arch)
        kp, vp = k_pages[li], v_pages[li]
        ksp, vsp = _layer_scales(k_scales, v_scales, li)
        q, k, v = _attn_qkv(x, iln, qw, qb, kw, kb, vw, vb, cos, sin, eps,
                            kvh, head_dim)
        # whole-page write: [C, KVH, D] -> page [KVH, C(=P), D]; this
        # sequence's pages, chunk included, as [S_kv, KVH, D] views
        if ksp is None:
            kp[:, page_slot] = k.transpose(0, 1)
            vp[:, page_slot] = v.transpose(0, 1)
            k_full, v_full = (
                pool[:, table].reshape(kvh, s_kv, head_dim).transpose(0, 1)
                for pool in (kp, vp))
        else:
            for pool, spool, rows in ((kp, ksp, k), (vp, vsp, v)):
                codes, scale = quantize_rows(rows)     # [C, KVH, D], [C, KVH]
                pool[:, page_slot] = codes.transpose(0, 1)
                spool[:, page_slot] = scale.transpose(0, 1)
            k_full, v_full = (
                (pool[:, table].float() * spool[:, table][..., None])
                .reshape(kvh, s_kv, head_dim).transpose(0, 1)
                for pool, spool in ((kp, ksp), (vp, vsp)))
        qa = q
        if k_full.dtype != q.dtype:
            # int8 (dequantized) or another float dtype's pages: attend
            # in f32, as the reference does (the flash kernel takes one
            # dtype)
            qa, k_full, v_full = q.float(), k_full.float(), v_full.float()
        attn = flash_attention_raw(qa[None], k_full[None], v_full[None],
                                   causal=False,
                                   mask=amask[None, None])[0].to(q.dtype)
        x = x + _mm(attn.reshape(c, -1), ow)
        x = _ffn_block(x, pln, ffn, eps, arch, live, counts)
    x = _nn.rms_norm(x, norm_w, epsilon=eps)
    logits = _head(x[last_in_chunk], head_w, tied)
    return logits if arch is None else (logits, torch.stack(counts))


@torch.no_grad()
def _mixed_forward(layers, norm_w, head_w, embed_w, rope, k_pages,
                   v_pages, ids, positions, q_start, q_len, kv_len,
                   desc_tables, desc_of_row, off_of_row, *, eps: float,
                   kvh: int, head_dim: int, tied: bool,
                   arch: Optional[MoEArch] = None, k_scales=None,
                   v_scales=None):
    """One forward of the ragged unified step over a flat batch of T
    rows: every row appends its K/V at its own position and attends over
    its own sequence's pages (the ragged kernel, pools updated in
    place); descriptor outputs gather back to flat rows through
    (desc_of_row, off_of_row).  ids/positions [T]; q_start/q_len/kv_len
    [S] and desc_tables [S, maxp] int32 with ``q_len == 0`` marking
    unused descriptors.  Returns logits [T, V]; under an MoE ``arch``
    also the routed-slot counts [L, E] (rows past their descriptor's
    ``q_len`` are padding and route nowhere).  Scale pools make the
    pools int8 (the ragged kernel's int8 mode)."""
    cos_t, sin_t = rope
    t = ids.shape[0]
    x = embed_w[ids]                                   # [T, H]
    cos = cos_t[positions][:, None, :]                 # [T, 1, D]
    sin = sin_t[positions][:, None, :]
    live = None if arch is None else off_of_row < q_len.long()[desc_of_row]
    counts = []
    for li, lp in enumerate(layers):
        iln, qw, qb, kw, kb, vw, vb, ow, pln, ffn = _unpack(lp, arch)
        q, k, v = _attn_qkv(x, iln, qw, qb, kw, kb, vw, vb, cos, sin, eps,
                            kvh, head_dim)
        ksp, vsp = _layer_scales(k_scales, v_scales, li)
        blocks = ragged_paged_append_attend(
            q, k_pages[li], v_pages[li], k, v, q_start, q_len, kv_len,
            desc_tables, ksp, vsp)
        attn = blocks[desc_of_row, off_of_row]         # [T, NH, D]
        x = x + _mm(attn.reshape(t, -1), ow)
        x = _ffn_block(x, pln, ffn, eps, arch, live, counts)
    x = _nn.rms_norm(x, norm_w, epsilon=eps)
    logits = _head(x, head_w, tied)
    return logits if arch is None else (logits, torch.stack(counts))


@torch.no_grad()
def _decode_forward(layers, norm_w, head_w, embed_w, rope, k_pages,
                    v_pages, tokens, tables, lens, *, eps: float, kvh: int,
                    head_dim: int, tied: bool,
                    arch: Optional[MoEArch] = None, live=None,
                    k_scales=None, v_scales=None):
    """One decode token for each of B rows, the split path's step: row b
    (token ``tokens[b]`` at position ``lens[b]``) appends its K/V at
    ``lens[b]`` and attends over ``lens[b] + 1`` tokens through kernel
    #7 in every layer, pools updated in place (scale pools: int8).
    tokens [B] long, tables [B, maxp] and lens [B] int32.  Returns
    logits [B, V]; under an MoE ``arch`` also the routed-slot counts
    [L, E] (``live`` [B] bool: the rows that route)."""
    cos_t, sin_t = rope
    b = tokens.shape[0]
    x = embed_w[tokens]                                # [B, H]
    pos = lens.long()
    cos = cos_t[pos][:, None, :]
    sin = sin_t[pos][:, None, :]
    counts = []
    for li, lp in enumerate(layers):
        iln, qw, qb, kw, kb, vw, vb, ow, pln, ffn = _unpack(lp, arch)
        q, k, v = _attn_qkv(x, iln, qw, qb, kw, kb, vw, vb, cos, sin, eps,
                            kvh, head_dim)
        ksp, vsp = _layer_scales(k_scales, v_scales, li)
        attn = paged_decode_append_attend(
            q, k_pages[li], v_pages[li], k, v, tables, lens, ksp, vsp)
        x = x + _mm(attn.reshape(b, -1), ow)
        x = _ffn_block(x, pln, ffn, eps, arch, live, counts)
    x = _nn.rms_norm(x, norm_w, epsilon=eps)
    logits = _head(x, head_w, tied)
    return logits if arch is None else (logits, torch.stack(counts))


class LLMEngine:
    """Continuous batching for Llama-family and Qwen2-MoE models, greedy
    or sampled, optionally speculative.

    ``dtype`` is the KV pools' dtype (float32 by default, as the
    reference's, whatever the weights' dtype; a float ``kv_dtype`` name
    overrides it).  ``swap_pool_pages`` sizes the host swap pool for
    preemption (``None``: as many pages as the device pool; 0 disables
    swap).
    ``device`` defaults to the GPU and must hold the model.
    ``moe_dispatch`` ("grouped", or "dense": the per-row comparator, CPU
    tensors only) and ``moe_dropless`` (only True) apply to MoE
    backbones.  The reference's other keywords are taken at the value
    the port runs (``scan_decode=False``: the host-chained decode window,
    which gives the reference's tokens; no metrics; no mesh and the
    default ``tp_axis``) and raise otherwise."""

    def __init__(self, model, max_seqs: int = 8, max_len: int = 2048,
                 page_size: int = 128, n_pages: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 decode_strategy: str = "greedy_search",
                 top_k: int = 0, top_p: float = 1.0,
                 temperature: float = 1.0, seed: int = 0,
                 steps_per_sync: int = 1,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 enable_metrics: bool = False,
                 enable_prefix_caching: bool = True,
                 swap_pool_pages: Optional[int] = None,
                 unified_step: bool = True,
                 prefill_token_budget: Optional[int] = None,
                 scan_decode: bool = False,
                 mesh=None, tp_axis: str = "tp", draft_model=None,
                 spec_k: int = 4, device=None,
                 moe_dispatch: str = "grouped", moe_dropless: bool = True,
                 moe_capacity_factor: Optional[float] = None):
        serving = "Port: the rest of serving"
        devices = "Multi-device"
        todo = {
            "scan_decode=True (the decode window as one device program)": (
                scan_decode, "Port: speed of what is ported"),
            "enable_metrics=True (engine metrics)": (
                enable_metrics, serving),
            "mesh (tensor-parallel serving)": (mesh is not None, devices),
            "tp_axis (tensor-parallel serving)": (tp_axis != "tp", devices),
            "moe_dropless=False (capacity-factor MoE dispatch)": (
                not moe_dropless, serving),
            "moe_capacity_factor (capacity-factor MoE dispatch)": (
                moe_capacity_factor is not None, serving),
        }
        for knob, (asked, item) in todo.items():
            if asked:
                raise NotImplementedError(
                    f"LLMEngine {knob} is not ported yet (ROADMAP "
                    f"'{item}')")
        enforce(decode_strategy in ("greedy_search", "sampling"),
                f"unsupported decode_strategy {decode_strategy!r}")
        enforce(kv_dtype in (None, "int8") or kv_dtype in _FLOAT_KV,
                f"unsupported kv_dtype {kv_dtype!r}")
        enforce(weight_dtype in (None, "int8"),
                f"unsupported weight_dtype {weight_dtype!r}")
        enforce(steps_per_sync >= 1, "steps_per_sync must be >= 1")
        enforce(moe_dispatch in ("grouped", "dense"),
                f"unsupported moe_dispatch {moe_dispatch!r}")
        self.device = resolve_device(device)
        spec = resolve_backbone(model)
        c = spec.config
        self.config = c
        embed = spec.embed_tokens.weight
        enforce(embed.device == self.device,
                f"model parameters live on {embed.device}, the engine on "
                f"{self.device}")
        dtype = _FLOAT_KV.get(kv_dtype, dtype)
        enforce(dtype in _FLOAT_KV.values(),
                f"unsupported pool dtype {dtype!r}")
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.unified_step = bool(unified_step)
        self.last_window_steps = 0     # forwards of the last split window
        self.steps_per_sync = steps_per_sync
        self.decode_strategy = decode_strategy
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.temperature = float(temperature)
        self._key = prng.prng_key(seed)
        self.max_seqs = max_seqs
        self.max_len = max_len
        self.enable_prefix_caching = bool(enable_prefix_caching)
        # the static prefill budget sizes the flat batch (T = max_seqs +
        # budget rows); the runtime ``prefill_token_budget`` attribute
        # may be lowered per step without changing T
        self._pf_budget_static = int(prefill_token_budget) \
            if prefill_token_budget is not None else page_size
        enforce(self._pf_budget_static >= 1,
                "prefill_token_budget must be >= 1")
        self.prefill_token_budget = self._pf_budget_static
        self._prefilling: List[GenRequest] = []
        self.prefix_stats = {"hit_tokens": 0, "miss_tokens": 0,
                             "shared_pages": 0, "hit_requests": 0,
                             "miss_requests": 0}
        self.eps = c.rms_norm_eps
        self.kvh = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        if n_pages is None:
            n_pages = max_seqs * (max_len // page_size) + 1
        # host swap pool for preemption: as many pages as the device
        # pool by default (0 disables swap: every resume recomputes)
        if swap_pool_pages is None:
            swap_pool_pages = n_pages
        self.cache = PagedKVCache(
            n_pages=n_pages, page_size=page_size, n_kv_heads=self.kvh,
            head_dim=self.head_dim, max_seqs=max_seqs, max_len=max_len,
            dtype=dtype, num_layers=len(spec.layers),
            kv_dtype="int8" if kv_dtype == "int8" else None,
            swap_pool_pages=swap_pool_pages, device=self.device)
        # per-layer references to the model's own weights: a stacked
        # copy would duplicate every weight (16 GB at 8B).  Int8 weights
        # are (values, scale) pairs: a quantize_model'd model's buffers,
        # or quantized here under weight_dtype="int8"
        self._arch = None
        if spec.moe is None:
            self._layers = self._dense_layers(spec.layers)
        else:
            m = spec.moe
            self._arch = MoEArch(
                num_experts=m["num_experts"], top_k=m["top_k"],
                norm_topk=m["norm_topk"], shared=m["shared"],
                shared_gate=m["shared_gate"], attn_bias=spec.attn_bias,
                dispatch=moe_dispatch)
            self._layers = [self._moe_layer(l) for l in spec.layers]
            self._moe_counts = torch.zeros(
                (len(spec.layers), m["num_experts"]), dtype=torch.int64,
                device=self.device)
        self._norm_w = spec.norm.weight
        self._tied = spec.lm_head is None
        self._embed_w = embed
        self._head_w = embed if self._tied else self._weight(spec.lm_head)
        self._rope, self._rope_prefill = _rope_tables(spec, page_size)
        self.requests: Dict[object, GenRequest] = {}
        self._active: List[GenRequest] = []
        self._spec = None
        if draft_model is not None:
            self._init_spec(draft_model, spec_k, dtype, page_size)

    # -- internals -------------------------------------------------------------
    def _dense_layers(self, layers):
        """Each dense decoder layer's weights: (iln, qw, kw, vw, ow, pln,
        gw, uw, dw)."""
        w = self._weight
        return [(l.input_layernorm.weight, w(l.self_attn.q_proj),
                 w(l.self_attn.k_proj), w(l.self_attn.v_proj),
                 w(l.self_attn.o_proj), l.post_attention_layernorm.weight,
                 w(l.mlp.gate_proj), w(l.mlp.up_proj), w(l.mlp.down_proj))
                for l in layers]

    def _weight(self, mod):
        """A projection's weight [in, out] as the forwards take it: the
        float parameter itself, or an int8 ``(values, scale)`` pair with
        one scale per output channel (a ``QuantizedLinear``'s buffers,
        or quantized here under ``weight_dtype="int8"``)."""
        if mod is None:
            return None
        if isinstance(mod, QuantizedLinear):
            return (mod.qweight, mod.weight_scale)
        if self.weight_dtype == "int8":
            return quantize_absmax(mod.weight, axis=0)
        return mod.weight

    def _stack(self, w):
        """An expert stack [E, in, out]; int8 per (expert, output
        channel) under ``weight_dtype="int8"``."""
        return quantize_absmax(w, axis=1) \
            if self.weight_dtype == "int8" else w

    def _moe_layer(self, l):
        """One MoE decoder layer's weights: (iln, qw, qb, kw, kb, vw, vb,
        ow, pln, rw, egw, euw, edw, sgw, suw, sdw, seg); biases and
        shared-expert weights a model lacks are None (the arch flags
        skip them).  The router stays float."""
        a, mlp = l.self_attn, l.mlp
        ex = mlp.experts
        w = self._weight
        shared = mlp.shared_gate is not None
        return (l.input_layernorm.weight, w(a.q_proj), a.q_proj.bias,
                w(a.k_proj), a.k_proj.bias, w(a.v_proj),
                a.v_proj.bias, w(a.o_proj),
                l.post_attention_layernorm.weight, mlp.gate.weight,
                self._stack(ex.gate_w), self._stack(ex.up_w),
                self._stack(ex.down_w),
                w(mlp.shared_gate), w(mlp.shared_up) if shared else None,
                w(mlp.shared_down) if shared else None,
                w(mlp.shared_expert_gate))

    def _note_expert_counts(self, out):
        """Split an MoE forward's (logits, counts [L, E]) and add the
        counts to ``self._moe_counts`` on the device (no host copy)."""
        if self._arch is None:
            return out
        logits, counts = out
        self._moe_counts += counts
        return logits

    def _dev(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _prefill_seq(self, slot, seq, start_chunk: int):
        """Run the chunked prefill over ``seq`` in ``slot`` from chunk
        ``start_chunk`` on (earlier chunks' pages are already written —
        the prefix-cache hit).  Returns the last real token's logits."""
        P = self.cache.page_size
        plen = len(seq)
        table = self._dev(self.cache.page_table[slot], torch.long)
        logits = None
        for ci in range(start_chunk, -(-plen // P)):
            base = ci * P
            chunk = np.zeros(P, np.int64)
            real = min(P, plen - base)
            chunk[:real] = seq[base:base + real]
            logits = self._note_expert_counts(_paged_prefill_chunk(
                self._layers, self._norm_w, self._head_w, self._embed_w,
                self._rope_prefill, self.cache.k_pages, self.cache.v_pages,
                self._dev(chunk, torch.long), table, base,
                int(self.cache.page_table[slot, ci]),
                min(plen - 1 - base, P - 1), **self._fwd_kw()))
        return logits

    def _split_batch(self, slots):
        """Lengths [max_seqs] int32 and tables [max_seqs, maxp] of
        ``slots`` padded to ``max_seqs`` rows, as the split path runs
        them (pad rows: length 0, table 0: they write into the pad
        page)."""
        pad = self.max_seqs - len(slots)
        maxp = self.cache.page_table.shape[1]
        lens = np.concatenate([self.cache.seq_lens[slots],
                               np.zeros(pad, np.int32)]).astype(np.int32)
        tables = np.concatenate([self.cache.page_table[slots],
                                 np.zeros((pad, maxp), np.int32)])
        return lens, tables

    def _decode(self, tokens, dtables, lens, live):
        """One split-path forward (kernel #7 in every layer) of the padded
        batch: tokens [max_seqs] host ints at lengths ``lens``.  Returns
        logits [max_seqs, V]."""
        return self._note_expert_counts(_decode_forward(
            self._layers, self._norm_w, self._head_w, self._embed_w,
            self._rope, self.cache.k_pages, self.cache.v_pages,
            self._dev(tokens, torch.long), dtables, self._dev(lens),
            live=live, **self._fwd_kw()))

    def _replay_decode(self, slot, toks):
        """Recompute-resume tail: re-append the KV of the already
        generated ``toks`` through the split path's forward (kernel #7 in
        every layer), in the reference's power-of-two windows of
        host-chained forwards over the padded batch (1-token windows
        under sampling, as the reference's).  Each forward takes the
        recorded token; its logits are dropped and the engine key is
        left alone."""
        i = 0
        while i < len(toks):
            nsteps = min(self.steps_per_sync, len(toks) - i)
            if self.decode_strategy != "greedy_search":
                nsteps = 1
            while nsteps & (nsteps - 1):
                nsteps &= nsteps - 1
            self.cache.extend(slot, nsteps)
            lens, tables = self._split_batch([slot])
            dtables = self._dev(tables)
            live = self._dev(lens > 0, torch.bool)
            for tok in toks[i:i + nsteps]:
                tokens = np.zeros(self.max_seqs, np.int64)
                tokens[0] = tok
                self._decode(tokens, dtables, lens, live)
                lens = lens + 1
            self.cache.advance([slot], nsteps)
            i += nsteps

    def _fwd_kw(self):
        """The keyword arguments every forward takes."""
        return dict(eps=self.eps, kvh=self.kvh, head_dim=self.head_dim,
                    tied=self._tied, arch=self._arch,
                    k_scales=self.cache.k_scales,
                    v_scales=self.cache.v_scales)

    def _sample(self, logits, key, rows):
        """Tokens of the flat rows ``rows`` of ``logits`` [T, V], row r
        drawn on ``fold_row(key, r)`` (greedy: the arg max).  Returns a
        host int64 array over all T rows, zero where not drawn."""
        rows = np.asarray(rows, np.int64)
        out = np.zeros(logits.shape[0], np.int64)
        if rows.size:
            tok, _ = sample_logits(
                logits[self._dev(rows, torch.long)], key,
                strategy=self.decode_strategy, top_k=self.top_k,
                top_p=self.top_p, temperature=self.temperature,
                row_ids=rows)
            out[rows] = tok.cpu().numpy()
        return out

    def _admit(self, rid, prompt_ids, max_new_tokens, eos_token_id):
        """Shared admission: validate, look up the cached prefix and
        reserve the slot with the request's full page budget.  Returns
        (request, cached tokens, shared pages)."""
        enforce(rid not in self.requests, f"duplicate request id {rid!r}")
        enforce(max_new_tokens >= 1, "max_new_tokens must be >= 1")
        req = GenRequest(rid, prompt_ids, max_new_tokens, eos_token_id)
        plen = len(req.prompt)
        enforce(plen >= 1, "empty prompt")
        total = plen + max_new_tokens
        limit = min(self.max_len, self.config.max_position_embeddings)
        enforce(total <= limit,
                f"prompt ({plen}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine/model limit {limit}")
        cached, shared_pages = self._cached_prefix(req.prompt)
        req.slot = self.cache.allocate(total, shared_pages=shared_pages)
        st = self.prefix_stats
        st["hit_tokens"] += cached
        st["miss_tokens"] += plen - cached
        st["shared_pages"] += len(shared_pages)
        st["hit_requests" if cached else "miss_requests"] += 1
        return req, cached

    def _finish_prefill(self, req, first: int):
        """Bookkeeping once a prompt is fully prefilled: set the length,
        publish its full pages, record the first token, and join the
        decode batch (or retire at once)."""
        P = self.cache.page_size
        plen = len(req.prompt)
        self.cache.set_len(req.slot, plen)
        if self.enable_prefix_caching:
            self.cache.register_prefix(req.slot, req.prompt,
                                       upto=(plen // P) * P)
        req.out.append(first)
        if (req.eos is not None and first == req.eos) or req.max_new <= 1:
            req.done = True
            self.cache.release(req.slot)
        else:
            self._active.append(req)

    # -- speculative decoding --------------------------------------------------
    def _init_spec(self, draft_model, spec_k: int, dtype, page_size: int):
        """Attach a draft backbone: its weights (int8 under
        ``weight_dtype="int8"``, as the target's), a second
        ``PagedKVCache`` of its geometry with no swap pool, and the
        acceptance counts ``spec_stats``.  A request's draft slot
        attaches at its first speculative window, and retire, suspend
        and abort release it."""
        enforce(spec_k >= 1, "spec_k must be >= 1")
        dspec = resolve_backbone(draft_model)
        enforce(dspec.moe is None,
                "speculative draft must be a dense backbone "
                "(MoE drafts defeat the point of a small draft)")
        c, dc = self.config, dspec.config
        enforce(dc.vocab_size == c.vocab_size,
                f"draft vocab ({dc.vocab_size}) must match target "
                f"vocab ({c.vocab_size})")
        d_maxpos = int(dspec.rope_cos.shape[0])
        t_maxpos = int(self._rope[0].shape[0])
        enforce(d_maxpos >= min(self.max_len, t_maxpos),
                f"draft max_position_embeddings ({d_maxpos}) too short "
                f"for the engine's sequence limit "
                f"({min(self.max_len, t_maxpos)})")
        dembed = dspec.embed_tokens.weight
        enforce(dembed.device == self.device,
                f"draft parameters live on {dembed.device}, the engine on "
                f"{self.device}")
        self.spec_k = int(spec_k)
        self._spec_mode = "greedy" \
            if self.decode_strategy == "greedy_search" else "rejection"
        dkvh = dc.num_key_value_heads
        dhd = dc.hidden_size // dc.num_attention_heads
        self._spec_cache = PagedKVCache(
            n_pages=self.max_seqs * (self.max_len // page_size) + 1,
            page_size=page_size, n_kv_heads=dkvh, head_dim=dhd,
            max_seqs=self.max_seqs, max_len=self.max_len, dtype=dtype,
            num_layers=len(dspec.layers),
            kv_dtype="int8" if self.kv_dtype == "int8" else None,
            swap_pool_pages=0, device=self.device)
        tied = dspec.lm_head is None
        rope, rope_prefill = _rope_tables(dspec, page_size)
        self._spec = {
            "layers": self._dense_layers(dspec.layers),
            "norm_w": dspec.norm.weight, "embed_w": dembed,
            "head_w": dembed if tied else self._weight(dspec.lm_head),
            "rope": rope, "rope_prefill": rope_prefill,
            "kw": dict(eps=dc.rms_norm_eps, kvh=dkvh, head_dim=dhd,
                       tied=tied, arch=None)}
        # ``accepted`` counts surviving draft tokens; the correction or
        # bonus token rides ``delivered``
        self.spec_stats = {"windows": 0, "proposed": 0, "accepted": 0,
                           "delivered": 0}

    def _draft_kw(self):
        d = self._spec_cache
        return dict(self._spec["kw"], k_scales=d.k_scales,
                    v_scales=d.v_scales)

    def _draft_decode(self, tokens, dtables, lens):
        """One split-path forward of the draft (kernel #7 in every layer)
        over the padded batch (host tokens and lengths, device tables);
        returns logits [max_seqs, V]."""
        sp, d = self._spec, self._spec_cache
        return _decode_forward(
            sp["layers"], sp["norm_w"], sp["head_w"], sp["embed_w"],
            sp["rope"], d.k_pages, d.v_pages, self._dev(tokens, torch.long),
            dtables, self._dev(lens), **self._draft_kw())

    def _spec_prefill(self, dslot, seq):
        """Chunked prefill of ``seq`` into draft slot ``dslot``
        (``_prefill_seq`` over the draft's weights and cache)."""
        sp, d = self._spec, self._spec_cache
        P = d.page_size
        plen = len(seq)
        table = self._dev(d.page_table[dslot], torch.long)
        for ci in range(-(-plen // P)):
            base = ci * P
            chunk = np.zeros(P, np.int64)
            real = min(P, plen - base)
            chunk[:real] = seq[base:base + real]
            _paged_prefill_chunk(
                sp["layers"], sp["norm_w"], sp["head_w"], sp["embed_w"],
                sp["rope_prefill"], d.k_pages, d.v_pages,
                self._dev(chunk, torch.long), table, base,
                int(d.page_table[dslot, ci]), min(plen - 1 - base, P - 1),
                **self._draft_kw())
        d.set_len(dslot, plen)

    def _spec_attach(self, req):
        """Attach the request's draft slot at its first speculative
        window: reserve its full page budget on the draft cache and
        prefill ``prompt + out[:-1]``, the draft's mirror of the target
        (K/V through ``cur - 1``, next input ``out[-1]``)."""
        req.draft_slot = self._spec_cache.allocate(
            len(req.prompt) + req.max_new)
        self._spec_prefill(req.draft_slot, list(req.prompt) + req.out[:-1])

    def _spec_release(self, req):
        """Drop the request's draft slot (a no-op without one)."""
        if self._spec is not None and req.draft_slot is not None:
            self._spec_cache.release(req.draft_slot)
            req.draft_slot = None

    def _spec_window(self, rows, sub, k_run):
        """One speculative window over ``rows`` (dicts with the target
        ``slot``, the draft ``dslot``, the ``last`` input token, the
        ``cur`` K/V length, the full token ``seq`` and the draw id
        ``row``): draft catch-up and propose, one ragged verify, accept,
        and the advance / rollback of both caches.  ``sub`` is the
        window's fork of the engine key; ``k_run`` (<= ``spec_k``) the
        draft length.  Returns ``[(tokens, n_accepted)]`` in the order of
        ``rows``."""
        d = self._spec_cache
        sampled = self._spec_mode == "rejection"
        draft_root, accept_root, resample_root = spec_window_keys(sub)
        B = self.max_seqs
        maxp_d = d.page_table.shape[1]

        # draft catch-up: teacher-force the draft level with the target
        # (one behind after a fully accepted window, more after plain
        # windows), one forward a level; level rows ride as pad rows
        while True:
            lag = [r for r in rows if int(d.seq_lens[r["dslot"]]) < r["cur"]]
            if not lag:
                break
            ids = np.zeros(B, np.int64)
            tabs = np.zeros((B, maxp_d), np.int32)
            lens = np.zeros(B, np.int32)
            for j, r in enumerate(lag):
                dl = int(d.seq_lens[r["dslot"]])
                d.extend(r["dslot"], 1)
                ids[j] = r["seq"][dl]
                tabs[j] = d.page_table[r["dslot"]]
                lens[j] = dl
            self._draft_decode(ids, self._dev(tabs), lens)
            d.advance([r["dslot"] for r in lag], 1)

        # propose: k_run free-running draft tokens a row (later draft
        # steps would not change these)
        ids = np.zeros(B, np.int64)
        tabs = np.zeros((B, maxp_d), np.int32)
        lens = np.zeros(B, np.int32)
        for j, r in enumerate(rows):
            d.extend(r["dslot"], k_run)
            ids[j] = r["last"]
            tabs[j] = d.page_table[r["dslot"]]
            lens[j] = r["cur"]
        dtabs = self._dev(tabs)
        toks_d, q_all = _spec_mod._paged_draft_propose(
            lambda t, ln: self._draft_decode(t, dtabs, ln), ids, lens,
            draft_root, rows[0]["row"] if len(rows) == 1 else 0,
            n_live=len(rows), n_steps=k_run,
            strategy=self.decode_strategy, top_k=self.top_k,
            top_p=self.top_p, temperature=self.temperature,
            collect_probs=sampled)
        d.advance([r["dslot"] for r in rows], k_run)

        # verify: one ragged forward over k_run + 1 rows a sequence
        # [last, d_1 .. d_k], descriptors split at page boundaries (a
        # descriptor's index is its first flat row)
        P = self.cache.page_size
        maxp = self.cache.page_table.shape[1]
        T = self.max_seqs * (self.spec_k + 1)
        kw = k_run + 1
        v_ids = np.zeros(T, np.int64)
        positions = np.zeros(T, np.int64)
        q_start = np.zeros(T, np.int32)
        q_len = np.zeros(T, np.int32)
        kv_len = np.zeros(T, np.int32)
        desc_tables = np.zeros((T, maxp), np.int32)
        desc_of_row = np.arange(T, dtype=np.int64)
        off_of_row = np.zeros(T, np.int64)
        for i, r in enumerate(rows):
            self.cache.extend(r["slot"], kw)
            tbl = self.cache.page_table[r["slot"]]
            r0 = i * kw
            v_ids[r0] = r["last"]
            v_ids[r0 + 1:r0 + kw] = toks_d[:k_run, i]
            positions[r0:r0 + kw] = np.arange(r["cur"], r["cur"] + kw)
            s = 0
            while s < kw:
                pos0 = r["cur"] + s
                seg = min(kw - s, P - pos0 % P)
                dsc = r0 + s
                q_start[dsc] = dsc
                q_len[dsc] = seg
                kv_len[dsc] = pos0
                desc_tables[dsc] = tbl
                desc_of_row[dsc:dsc + seg] = dsc
                off_of_row[dsc:dsc + seg] = np.arange(seg)
                s += seg
        logits = self._note_expert_counts(_mixed_forward(
            self._layers, self._norm_w, self._head_w, self._embed_w,
            self._rope, self.cache.k_pages, self.cache.v_pages,
            self._dev(v_ids, torch.long), self._dev(positions, torch.long),
            self._dev(q_start), self._dev(q_len), self._dev(kv_len),
            self._dev(desc_tables), self._dev(desc_of_row, torch.long),
            self._dev(off_of_row, torch.long), **self._fwd_kw()))
        live = logits[:len(rows) * kw]
        if sampled:
            p_all = filtered_probs(
                live, strategy=self.decode_strategy, top_k=self.top_k,
                top_p=self.top_p, temperature=self.temperature
            ).double().cpu().numpy()
        else:
            nxt = torch.argmax(live, dim=-1).cpu().numpy()
        self.cache.advance([r["slot"] for r in rows], kw)

        # accept, and roll back the rejected suffix on both caches: the
        # target keeps [last, d_1 .. d_a]; the draft [last, d_1 ..
        # d_{a-1}] when a < k_run, one short after full acceptance (the
        # next catch-up teacher-forces d_k)
        out = []
        for i, r in enumerate(rows):
            r0 = i * kw
            if sampled:
                toks, a = _spec_mod.rejection_accept(
                    toks_d[:k_run, i], q_all[:, i], p_all[r0:r0 + kw],
                    accept_root, resample_root, r["row"])
            else:
                toks, a = _spec_mod.greedy_accept(toks_d[:k_run, i],
                                                  nxt[r0:r0 + kw])
            self.cache.rollback(r["slot"], k_run - a)
            if a < k_run:
                d.rollback(r["dslot"], k_run - a - 1)
            out.append((toks, a))
        return out

    def _step_spec(self) -> Dict[object, List[int]]:
        """The speculative window: propose ``k_run`` draft tokens for
        every active request, verify them in one ragged forward and
        deliver the accepted prefix plus the correction or bonus token.
        Greedy acceptance gives the plain greedy tokens; rejection
        acceptance keeps the target's filtered distribution.  With
        prefill pending it runs the plain unified step (drafts catch up
        at the next window)."""
        if self._prefilling:
            return self._step_mixed()
        if not self._active:
            return {}
        batch = list(self._active)
        for req in batch:
            if req.draft_slot is None:
                self._spec_attach(req)
        # never draft past the tightest budget: the window delivers at
        # most k_run + 1 tokens and the merge truncates the last one
        k_run = max(min([self.spec_k] +
                        [r.max_new - len(r.out) for r in batch]), 1)
        self._key, sub = prng.split(self._key)
        rows = [{"slot": r.slot, "dslot": r.draft_slot, "last": r.out[-1],
                 "cur": len(r.prompt) + len(r.out) - 1,
                 "seq": list(r.prompt) + r.out, "row": i}
                for i, r in enumerate(batch)]
        results = self._spec_window(rows, sub, k_run)
        out = self._retire_tokens(batch, [toks for toks, _ in results])
        self.last_window_steps = max((len(v) for v in out.values()),
                                     default=0)
        st = self.spec_stats
        st["windows"] += 1
        st["proposed"] += len(batch) * k_run
        st["accepted"] += sum(a for _, a in results)
        st["delivered"] += sum(len(v) for v in out.values())
        return out

    # -- admission -------------------------------------------------------------
    def add_request(self, rid, prompt_ids, max_new_tokens: int = 64,
                    eos_token_id: Optional[int] = None):
        """Prefill the prompt into pages now (page-size chunks through
        the flash kernel); the request joins the decode batch at the
        next ``step()``.  The longest cached page-aligned prefix is
        mapped in without device work and only the tail prefills."""
        req, cached = self._admit(rid, prompt_ids, max_new_tokens,
                                  eos_token_id)
        P = self.cache.page_size
        try:
            logits = self._prefill_seq(req.slot, req.prompt, cached // P)
            # one split of the engine key; the first token draws as row 0
            self._key, sub = prng.split(self._key)
            first = int(self._sample(logits[None], sub, [0])[0])
        except BaseException:
            # the slot and its page references must not leak
            self.cache.release(req.slot)
            raise
        self.requests[rid] = req
        self._finish_prefill(req, first)
        return rid

    def begin_request(self, rid, prompt_ids, max_new_tokens: int = 64,
                      eos_token_id: Optional[int] = None):
        """Deferred admission: reserve the slot and page budget now and
        prefill the prompt inside later ``step()`` calls, page-sized
        chunks riding the same mixed batch as the ongoing decodes, up to
        ``prefill_token_budget`` tokens a step.  The first token arrives
        in a later ``step()`` return value.  The split path
        (``unified_step=False``) admits through ``add_request`` only."""
        enforce(self.unified_step,
                "begin_request requires unified_step=True (the split "
                "path admits synchronously via add_request)")
        req, cached = self._admit(rid, prompt_ids, max_new_tokens,
                                  eos_token_id)
        req.pf_pos = cached
        self.requests[rid] = req
        self._prefilling.append(req)
        return rid

    # -- decode loop -----------------------------------------------------------
    def step(self) -> Dict[object, List[int]]:
        """One serving step: returns {request_id: [new tokens]} and
        retires finished requests.

        Unified (default): one mixed-batch forward packs every active
        decode slot plus up to ``prefill_token_budget`` tokens of pending
        ``begin_request`` prefill chunks (chunks never cross a page
        boundary, so one request may contribute several descriptors).
        When no prefill is pending, a window of up to ``steps_per_sync``
        decode steps runs host-chained, each step's tokens fed back as
        the next input.  Split (``unified_step=False``): a decode window
        of the split path (``_step_split``).  With a draft model, a
        speculative window (``_step_spec``)."""
        if self._spec is not None:
            return self._step_spec()
        if not self.unified_step:
            return self._step_split()
        return self._step_mixed()

    def _step_mixed(self) -> Dict[object, List[int]]:
        """The unified step of ``step()``: one key split, then one
        ``split_step`` a forward; every decode row and each finishing
        prefill chunk's last row draws on its own flat row id."""
        if not self._active and not self._prefilling:
            return {}
        P = self.cache.page_size
        maxp = self.cache.page_table.shape[1]
        t_cap = self.max_seqs + self._pf_budget_static
        batch = list(self._active)
        n = len(batch)

        # prefill plan: (req, pos, chunk_len, first_row, descriptor).
        # The runtime budget is clamped to the static one (T is fixed)
        # and floored when only prefill is pending, so a zero budget
        # cannot livelock has_work().
        budget = max(0, min(int(self.prefill_token_budget),
                            self._pf_budget_static))
        if not batch and budget == 0:
            budget = min(P, self._pf_budget_static)
        plan = []
        finishing = []                        # (req, last_row)
        cursor, desc_i, used = n, n, 0
        for req in self._prefilling:
            plen = len(req.prompt)
            pos = req.pf_pos
            while pos < plen and used < budget:
                cl = min(P - pos % P, plen - pos, budget - used)
                plan.append((req, pos, cl, cursor, desc_i))
                pos += cl
                cursor += cl
                used += cl
                desc_i += 1
            if pos >= plen:
                finishing.append((req, cursor - 1))
            if used >= budget:
                break
        if not batch and not plan:
            return {}

        nsteps = 1 if plan or n == 0 else self._window(batch)
        slots = np.array([r.slot for r in batch], np.int64)
        for r in batch:
            self.cache.extend(r.slot, nsteps)

        ids = np.zeros(t_cap, np.int32)
        positions = np.zeros(t_cap, np.int32)
        q_start = np.zeros(t_cap, np.int32)
        q_len = np.zeros(t_cap, np.int32)
        kv_len = np.zeros(t_cap, np.int32)
        desc_tables = np.zeros((t_cap, maxp), np.int32)
        # padding rows point at their own (q_len == 0) descriptor, whose
        # kernel output block is zeroed — never garbage
        desc_of_row = np.arange(t_cap, dtype=np.int32)
        off_of_row = np.zeros(t_cap, np.int32)
        if n:
            ids[:n] = [r.out[-1] for r in batch]
            lens = self.cache.seq_lens[slots]
            positions[:n] = lens
            q_start[:n] = np.arange(n)
            q_len[:n] = 1
            kv_len[:n] = lens
            desc_tables[:n] = self.cache.page_table[slots]
        for req, pos, cl, row0, d in plan:
            ids[row0:row0 + cl] = req.prompt[pos:pos + cl]
            positions[row0:row0 + cl] = np.arange(pos, pos + cl)
            q_start[d] = row0
            q_len[d] = cl
            kv_len[d] = pos
            desc_tables[d] = self.cache.page_table[req.slot]
            desc_of_row[row0:row0 + cl] = d
            off_of_row[row0:row0 + cl] = np.arange(cl)

        dq_start, dq_len = self._dev(q_start), self._dev(q_len)
        ddesc_tables = self._dev(desc_tables)
        ddesc_of_row = self._dev(desc_of_row, torch.long)
        doff_of_row = self._dev(off_of_row, torch.long)
        # rows whose tokens are kept: the decode rows, and on the first
        # forward the last row of each finishing prefill chunk
        first_rows = list(range(n)) + [row for _, row in finishing]
        self._key, key = prng.split(self._key)
        toks_all = []
        for si in range(nsteps):
            logits = self._note_expert_counts(_mixed_forward(
                self._layers, self._norm_w, self._head_w, self._embed_w,
                self._rope, self.cache.k_pages, self.cache.v_pages,
                self._dev(ids, torch.long), self._dev(positions, torch.long),
                dq_start, dq_len, self._dev(kv_len), ddesc_tables,
                ddesc_of_row, doff_of_row, **self._fwd_kw()))
            key, sub = split_step(key)
            nxt = self._sample(logits, sub,
                               first_rows if si == 0 else range(n))
            toks_all.append(nxt)
            if n:
                self.cache.advance(slots, 1)
            if si + 1 < nsteps:
                # host-chained window (pure decode): feed each slot's
                # token back as the next input
                ids[:n] = nxt[:n]
                positions[:n] += 1
                kv_len[:n] += 1

        out = self._retire_tokens(batch, [[int(t[i]) for t in toks_all]
                                          for i in range(n)])
        # prefill bookkeeping after the forward succeeded — a raise
        # above leaves every pf_pos where it was
        for req, pos, cl, row0, d in plan:
            req.pf_pos = pos + cl
        for req, last_row in finishing:
            self._prefilling.remove(req)
            self._finish_prefill(req, int(toks_all[0][last_row]))
            out[req.rid] = [req.out[-1]]
        return out

    def _window(self, batch) -> int:
        """Decode steps of a pure-decode window: ``steps_per_sync``,
        capped by every request's remaining budget, rounded down to a
        power of two."""
        nsteps = max(1, min([self.steps_per_sync] +
                            [r.max_new - len(r.out) for r in batch]))
        while nsteps & (nsteps - 1):
            nsteps &= nsteps - 1
        return nsteps

    def _retire_tokens(self, batch, toks) -> Dict[object, List[int]]:
        """Merge a window's tokens (``toks[i]``: row i's, in order) into
        the requests, stopping each at its EOS or budget and releasing
        it; returns {rid: new tokens}."""
        out = {}
        for req, row_toks in zip(batch, toks):
            new_toks = []
            for tok in row_toks:
                if req.done:
                    break
                req.out.append(tok)
                new_toks.append(tok)
                if (req.eos is not None and tok == req.eos) or \
                        len(req.out) >= req.max_new:
                    req.done = True
                    self.cache.release(req.slot)
                    self._spec_release(req)
                    self._active.remove(req)
            if new_toks:
                out[req.rid] = new_toks
        return out

    def _step_split(self) -> Dict[object, List[int]]:
        """The split path's decode window: up to ``_window`` host-chained
        single-token forwards (kernel #7 in every layer) over every
        active request, the batch padded to ``max_seqs`` rows (pad rows:
        token 0, length 0, table 0: they write into the pad page and are
        discarded).  The window stops early once every live row has hit
        its EOS or its budget, and the cache advances by the steps run
        (``last_window_steps``), as the reference's
        ``_paged_decode_window`` does.  Row i draws on ``fold_row(key,
        i)``."""
        if not self._active:
            return {}
        batch = list(self._active)
        n, pad = len(batch), self.max_seqs - len(batch)
        nsteps = self._window(batch)
        slots = np.array([r.slot for r in batch], np.int64)
        for s in slots:
            self.cache.extend(int(s), nsteps)
        tokens = np.array([r.out[-1] for r in batch] + [0] * pad, np.int64)
        lens, tables = self._split_batch(slots)
        # the window-start lengths fix which rows route (MoE)
        live = self._dev(lens > 0, torch.bool)
        eos = np.array([-1 if r.eos is None else r.eos for r in batch]
                       + [-1] * pad)
        budgets = np.array([r.max_new - len(r.out) for r in batch]
                           + [1] * pad)
        done = np.arange(self.max_seqs) >= n
        emitted = np.zeros(self.max_seqs, np.int64)
        dtables = self._dev(tables)
        # one split of the engine key a window, one of the window key a
        # forward
        self._key, key = prng.split(self._key)
        toks = []
        for _ in range(nsteps):
            logits = self._decode(tokens, dtables, lens, live)
            key, sub = split_step(key)
            nxt = self._sample(logits, sub, range(n))
            toks.append(nxt)
            fresh = ~done
            emitted += fresh
            done |= fresh & (((eos >= 0) & (nxt == eos))
                             | (emitted >= budgets))
            tokens = nxt.astype(np.int64)
            lens = lens + 1
            if done.all():
                break
        self.cache.advance(slots, len(toks))
        self.last_window_steps = len(toks)
        return self._retire_tokens(batch, [[int(t[i]) for t in toks]
                                           for i in range(n)])

    def has_work(self) -> bool:
        return bool(self._active or self._prefilling)

    def free_slots(self) -> int:
        """Sequence slots available for admission right now.  A request
        fits iff ``free_slots() >= 1`` and ``cache.free_pages() >=
        ceil((len(prompt) + max_new_tokens) / page_size)``: admission
        reserves the full page budget."""
        return self.cache.free_slot_count()

    def capacity(self) -> tuple:
        """Admission snapshot ``(free_slots, free_pages)`` in one call,
        exact until the next capacity-changing call (``add_request``,
        ``step``, ``abort``, ``suspend``, ``resume``)."""
        return self.cache.free_slot_count(), self.cache.free_pages()

    def suspended_count(self) -> int:
        """Live requests preempted out of the decode batch (they hold no
        slot or device pages)."""
        return sum(1 for r in self.requests.values()
                   if r.suspended and not r.done)

    def _live(self, rid) -> GenRequest:
        enforce(rid in self.requests,
                f"unknown request id {rid!r} (never admitted to this "
                f"engine)")
        return self.requests[rid]

    # -- preemption ------------------------------------------------------------
    def suspend(self, rid) -> bool:
        """Preempt an active request: its tokens so far stay on the
        request, its KV pages swap into the cache's host pool (or are
        only released when the pool is full: resume then recomputes),
        and its slot frees, so another request can admit now.  A request
        still prefilling (``begin_request``) releases its pages and
        restarts its prefill on resume.  Returns True when the swap path
        is armed.  A suspended request's ``result`` raises, and it can
        be ``abort``-ed (its swap entry is dropped)."""
        req = self._live(rid)
        enforce(not req.done, f"request {rid!r} already retired")
        enforce(not req.suspended, f"request {rid!r} already suspended")
        if req in self._prefilling:
            self._prefilling.remove(req)
            self.cache.release(req.slot)
            req.swap_handle = None
            req.pf_pos = 0
        else:
            self._active.remove(req)
            # the draft slot never swaps: the next speculative window
            # prefills it again
            self._spec_release(req)
            req.swap_handle = self.cache.swap_out(req.slot)
        req.slot = None
        req.suspended = True
        return req.swap_handle is not None

    def resume(self, rid) -> str:
        """Re-admit a suspended request; it rejoins the batch at the
        next ``step()``.  Returns the restore path: ``"swap_in"`` (host
        pages copied back) or ``"recompute"`` (the prompt through the
        chunked prefill, the generated tokens through ``_replay_decode``;
        a request suspended mid-prefill rejoins the prefill queue).  The
        full page budget is re-reserved, as at admission: check
        ``capacity()`` first."""
        req = self._live(rid)
        enforce(req.suspended and not req.done,
                f"request {rid!r} is not suspended")
        plen = len(req.prompt)
        total = plen + req.max_new
        if not req.out:
            cached, shared_pages = self._cached_prefix(req.prompt)
            req.slot = self.cache.allocate(total,
                                           shared_pages=shared_pages)
            req.pf_pos = cached
            req.suspended = False
            self._prefilling.append(req)
            return "recompute"
        path, slot = "recompute", None
        if req.swap_handle is not None:
            slot = self.cache.swap_in(req.swap_handle, total)
            req.swap_handle = None             # consumed either way
            if slot is not None:
                # prompt + generated so far, less the last token: the
                # next step appends its KV
                self.cache.set_len(slot, plen + len(req.out) - 1)
                path = "swap_in"
        if slot is None:
            slot = self._recompute_resume(req)
        req.slot = slot
        req.suspended = False
        self._active.append(req)
        return path

    def _cached_prefix(self, prompt):
        """(cached tokens, shared pages) of the prompt's longest cached
        page-aligned prefix (none without prefix caching), capped at the
        last page boundary strictly below its length so the chunk holding
        the last prompt token always runs (its logits seed decoding;
        shared pages stay immutable)."""
        if not self.enable_prefix_caching:
            return 0, []
        P = self.cache.page_size
        return self.cache.lookup_prefix(prompt[:((len(prompt) - 1) // P)
                                               * P])

    def _recompute_resume(self, req):
        """Swapless resume: re-derive the request's KV from its token
        history, the prompt through the chunked prefill (prefix-cache
        hits still apply) and the generated tokens but the last through
        ``_replay_decode``.  Returns the new slot."""
        plen = len(req.prompt)
        P = self.cache.page_size
        cached, shared_pages = self._cached_prefix(req.prompt)
        slot = self.cache.allocate(plen + req.max_new,
                                   shared_pages=shared_pages)
        try:
            self._prefill_seq(slot, req.prompt, cached // P)
            self.cache.set_len(slot, plen)
            if self.enable_prefix_caching:
                self.cache.register_prefix(slot, req.prompt,
                                           upto=(plen // P) * P)
            self._replay_decode(slot, req.out[:-1])
        except BaseException:
            self.cache.release(slot)
            raise
        return slot

    # -- migration -------------------------------------------------------------
    def export_request(self, rid) -> dict:
        """Package a suspended request for another engine: its token
        history and its swap entry as a portable blob
        (``PagedKVCache.export_swap``), or ``swap=None`` when it has none
        (the destination then recomputes).  The request leaves this
        engine."""
        req = self._live(rid)
        enforce(req.suspended and not req.done,
                f"request {rid!r} is not suspended — suspend() before "
                f"export_request()")
        blob = self.cache.export_swap(req.swap_handle)
        req.swap_handle = None
        del self.requests[rid]
        return {"rid": rid, "prompt": list(req.prompt),
                "out": list(req.out), "max_new": req.max_new,
                "eos": req.eos, "swap": blob}

    def import_request(self, pkg: dict):
        """Adopt a migration package: the request registers here
        suspended, its swap blob imported into this cache's host pool
        when it fits; ``resume`` then restores it.  Raises when it
        exceeds this engine's limits or the blob's geometry differs.
        Returns the rid."""
        rid = pkg["rid"]
        enforce(rid not in self.requests, f"duplicate request id {rid!r}")
        plen = len(pkg["prompt"])
        enforce(plen >= 1, "empty prompt in migration package")
        total = plen + pkg["max_new"]
        limit = min(self.max_len, self.config.max_position_embeddings)
        enforce(total <= limit,
                f"migrated request {rid!r}: prompt ({plen}) + "
                f"max_new_tokens ({pkg['max_new']}) exceeds this engine's "
                f"limit {limit}")
        need = -(-total // self.cache.page_size)
        enforce(need <= self.cache.n_pages - 1,
                f"migrated request {rid!r} needs {need} KV pages but this "
                f"cache holds {self.cache.n_pages - 1} usable")
        req = GenRequest(rid, pkg["prompt"], pkg["max_new"], pkg["eos"])
        req.out = list(pkg["out"])
        enforce(len(req.out) >= 1,
                f"migrated request {rid!r} carries no generated tokens — "
                f"it was never admitted; resubmit it instead")
        req.suspended = True
        req.swap_handle = self.cache.import_swap(pkg.get("swap"))
        self.requests[rid] = req
        return rid

    def abort(self, rid) -> bool:
        """Cancel a request: release its pages (a suspended request: drop
        its swap entry) and retire it with ``cancelled=True``.  Returns
        True if it was live, False if it had already retired; unknown ids
        raise."""
        req = self._live(rid)
        if req.done:
            return False
        req.done = True
        req.cancelled = True
        if req.suspended:
            self.cache.drop_swap(req.swap_handle)
            req.swap_handle = None
            req.suspended = False
            return True
        if req in self._active:
            self._active.remove(req)
            self._spec_release(req)
        else:
            self._prefilling.remove(req)
        self.cache.release(req.slot)
        return True

    def result(self, rid) -> List[int]:
        """Final token list of a retired request (EOS, budget, or
        ``abort``); raises while it is still generating or suspended, and
        for unknown ids.  Results stay readable until ``pop_result``."""
        req = self._live(rid)
        enforce(req.done,
                f"request {rid!r} is still generating ({len(req.out)} "
                f"tokens so far) — consume step() output to stream, "
                f"or call result() after it retires")
        return list(req.out)

    def pop_result(self, rid) -> List[int]:
        """``result(rid)``, then forget the request."""
        out = self.result(rid)
        del self.requests[rid]
        return out
