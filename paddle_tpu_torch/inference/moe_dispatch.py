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
on CPU tensors only.  Capacity-factor dispatch and int8 expert stacks
are not ported (the engine refuses them).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.grouped_matmul import _auto_tm, gmm_raw, make_dropless_plan_rows

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
    """x @ w in x's dtype (an f32 x widens a bf16 weight)."""
    return x @ w.to(x.dtype)


def _expert_rows_mm(x, w, row_expert):
    """Row i of x [M, K] against ``w[row_expert[i]]`` in f32: the dense
    comparator's per-row contraction."""
    return torch.einsum("mk,mkn->mn", x.float(), w[row_expert].float())


def moe_ffn(hn, mw, arch: MoEArch, live):
    """The MoE FFN of one serving forward.

    hn [T, H] post-attention-norm rows; ``mw`` the layer's ``(rw, egw,
    euw, edw, sgw, suw, sdw, seg)`` (router [H, E]; expert stacks [E, H,
    F] / [E, F, H]; shared-expert weights, unused when ``arch.shared`` is
    off); ``live`` [T] bool masks padding rows out of routing (their
    output is not read).  Returns ``(ffn_out [T, H] in hn's dtype,
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
        hg = gmm_raw(xs, egw, tile_expert, counts=counts)
        hu = gmm_raw(xs, euw, tile_expert, counts=counts)
        hs = torch.nn.functional.silu(hg) * hu
        ys = gmm_raw(hs, edw, tile_expert, counts=counts)
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
