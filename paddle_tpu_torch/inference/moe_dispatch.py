"""The MoE FFN of the serving step (counterpart of
``paddle_tpu/inference/moe_dispatch.py``, dropless dispatch).

:func:`moe_ffn` replaces the dense SwiGLU FFN in every decoder layer of
the engine's forwards when the backbone is an MoE family: top-k router,
the routed slots sorted by expert into the tile-aligned dropless layout
(``ops/grouped_matmul.py``), one grouped matmul (kernel #11) for each of
the gate, up and down projections, the top-k combine, and the always-on
shared expert.  Routing stays on the device: the plan's ``tile_expert``
and ``counts`` are device tensors the kernel reads, the padded row count
is fixed by the shapes, and nothing is copied to the host.  The numerics
are the reference's: the sorted buffer and the expert products are f32
(the bf16 expert weights widened inside the kernel), SwiGLU runs in f32.

``dispatch="grouped"`` is the path; ``"dense"`` is the reference's
per-row comparator (each slot gathers its expert's weights), which runs
on CPU tensors only.  Capacity-factor dispatch is not ported (the engine
refuses it).

Int8 weights (``weight_dtype="int8"``): an expert stack arrives as
``(values [E, in, out] int8, scale [E, out] f32)``, one scale per
(expert, output channel) over the contraction axis.  The grouped path
widens the values to bf16 for #11 (exact: |q| <= 127) and folds each
sorted row's expert scale into the product, as the reference does; the
shared expert and its gate take ``(values, scale)`` pairs through
``_mm``.  The router stays in float.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.grouped_matmul import _auto_tm, gmm_raw, make_dropless_plan_rows
from ..quantization.ops import quantized_matmul

__all__ = ["MoEArch", "moe_ffn"]


class MoEArch(NamedTuple):
    """The MoE dispatch configuration of an engine: the router geometry,
    the shared expert, the attention biases, and the dispatch mode
    (dropless: the reference's capacity field is not ported)."""
    num_experts: int
    top_k: int
    norm_topk: bool
    shared: bool
    shared_gate: bool
    attn_bias: bool
    dispatch: str


def _mm(x, w):
    """x @ w in x's dtype (an f32 x widens a bf16 weight); an int8
    ``(values, scale)`` pair folds its per-output-channel scale into the
    product."""
    if isinstance(w, tuple):
        return quantized_matmul(x, *w)
    return x @ w.to(x.dtype)


def _expert_rows_mm(x, w, row_expert):
    """Row i of x [M, K] against ``w[row_expert[i]]`` in f32: the dense
    comparator's per-row contraction (an int8 pair times its expert's
    scale after)."""
    if isinstance(w, tuple):
        qw, sc = w
        return _expert_rows_mm(x, qw, row_expert) * sc[row_expert]
    return torch.einsum("mk,mkn->mn", x.float(), w[row_expert].float())


def _gmm(xs, w, tile_expert, counts):
    """#11 over the sorted buffer; an int8 stack is widened to bf16 for
    the kernel and each row times its tile's expert scale."""
    if not isinstance(w, tuple):
        return gmm_raw(xs, w, tile_expert, counts=counts)
    qw, sc = w
    y = gmm_raw(xs, qw.to(torch.bfloat16), tile_expert, counts=counts)
    tm = xs.shape[0] // tile_expert.shape[0]
    return y * sc[tile_expert.long()].repeat_interleave(tm, dim=0)


def moe_ffn(hn, mw, arch: MoEArch, live):
    """The MoE FFN of one serving forward.

    hn [T, H] post-attention-norm rows; ``mw`` the layer's ``(rw, egw,
    euw, edw, sgw, suw, sdw, seg)`` (router [H, E]; expert stacks [E, H,
    F] / [E, F, H]; shared-expert weights, unused when ``arch.shared`` is
    off; int8 ``(values, scale)`` pairs under ``weight_dtype="int8"``);
    ``live`` [T] bool masks padding rows out of routing (their output is
    not read).  Returns ``(ffn_out [T, H] in hn's dtype,
    counts [E] int32)``: the routed slots of each expert."""
    rw, egw, euw, edw, sgw, suw, sdw, seg = mw
    t, h = hn.shape
    e, k = arch.num_experts, arch.top_k
    xf = hn.float()

    logits = xf @ rw.float()
    probs = torch.softmax(logits, dim=-1)                   # [T, E]
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    if arch.norm_topk:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)
    eidx = expert_idx.reshape(-1)
    keep = live.repeat_interleave(k)                        # dropless
    row_expert = torch.where(keep, eidx, torch.full_like(eidx, e))

    if arch.dispatch == "grouped":
        tm = _auto_tm(e, t * k)
        order, dest, valid_sorted, tile_expert, counts, m_pad = \
            make_dropless_plan_rows(row_expert, e, tm)
        # invalid slots land in a spare row past the buffer
        xs = xf.new_zeros((m_pad + 1, h)).index_copy_(
            0, dest, xf[order // k])[:m_pad]
        hg = _gmm(xs, egw, tile_expert, counts)
        hu = _gmm(xs, euw, tile_expert, counts)
        hs = torch.nn.functional.silu(hg) * hu
        ys = _gmm(hs, edw, tile_expert, counts)
        y_sorted = torch.where(valid_sorted[:, None],
                               ys[dest.clamp(max=m_pad - 1)], 0.0)
        y = xf.new_zeros((t * k, h)).index_copy_(0, order, y_sorted)
    elif arch.dispatch == "dense":
        if hn.device.type != "cpu":
            raise NotImplementedError(
                "moe_dispatch='dense' (the per-row comparator, plain "
                "PyTorch) runs on CPU tensors only; on the card the MoE "
                "FFN goes through the grouped matmul kernel")
        counts = torch.zeros(e + 1, dtype=torch.int32).scatter_add_(
            0, row_expert, torch.ones_like(row_expert, dtype=torch.int32))[:e]
        xdup = xf.repeat_interleave(k, dim=0)               # [T*k, H]
        hs = torch.nn.functional.silu(_expert_rows_mm(xdup, egw, eidx)) \
            * _expert_rows_mm(xdup, euw, eidx)
        y = torch.where(keep[:, None], _expert_rows_mm(hs, edw, eidx), 0.0)
    else:
        raise ValueError(f"unsupported MoE dispatch {arch.dispatch!r}")

    out = torch.einsum("tk,tkh->th", gate_vals, y.view(t, k, h))
    if arch.shared:
        # shared-expert SwiGLU with its sigmoid token gate, in f32
        shared = _mm(torch.nn.functional.silu(_mm(xf, sgw)) * _mm(xf, suw),
                     sdw)
        if arch.shared_gate:
            shared = shared * torch.sigmoid(_mm(xf, seg))
        out = out + shared
    return out.to(hn.dtype), counts
