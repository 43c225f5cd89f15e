"""Mixture-of-Experts layer (counterpart of ``paddle_tpu/nn/moe.py``).

A top-k router, stacked per-expert SwiGLU FFNs and, for the Qwen2-MoE
family, a shared expert with a sigmoid gate.  The experts run on the
reference's **grouped** dropless dispatch: routed slots are sorted by
expert into a tile-aligned buffer and the FFN is the fused gate/up and
the down grouped matmul (``ops/grouped_matmul.py``, kernels #12 and
#11, with #11 and #13 in the backward) -- no capacity padding and no
dropped tokens.  ``dispatch_mode="auto"`` resolves to it on every
device, as the reference does on one TPU; the reference's ``dense``
(GShard capacity einsums, which drop tokens) and ``grouped_ep``
(expert-parallel all-to-all) dispatches raise.

The router's aux loss for the step is ``self.aux_loss`` after a
forward, and models add it to the training loss; a decoder layer also
returns it, so that it survives recompute.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..common.errors import enforce
from ..ops import _nn
from ..ops.grouped_matmul import dropless_moe_ffn
from .common import Init

__all__ = ["TopKGate", "ExpertFFN", "MoELayer"]


def _router_parts(x, wg, *, k, norm_topk=True):
    """Router math: x [T, H], wg [H, E] -> gate_vals [T, k] (f32),
    expert_idx [T, k], and the per-token means the aux loss is made of:
    density [E] (the share of routed slots on each expert, over the full
    top-k assignment), density_proxy [E] (mean router probability) and
    zsq (mean squared logsumexp of the logits).  The softmax runs in f32
    over all experts; ``norm_topk`` renormalises the top-k gate values
    (Mixtral; Qwen2-MoE ships it off)."""
    e = wg.shape[1]
    logits = x.float() @ wg.float()
    probs = torch.softmax(logits, dim=-1)                    # [T, E]
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    if norm_topk:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)
    onehot = torch.nn.functional.one_hot(expert_idx, e).float()
    density = onehot.sum(dim=1).mean(dim=0) / k
    density_proxy = probs.mean(dim=0)
    zsq = torch.logsumexp(logits, dim=-1).square().mean()
    return gate_vals, expert_idx, density, density_proxy, zsq


def _assemble_aux(density, density_proxy, zsq, *, balance_coef, z_coef):
    e = density.shape[0]
    aux = balance_coef * e * torch.sum(density * density_proxy)
    if z_coef:
        aux = aux + z_coef * zsq
    return aux


def _router_topk(x, wg, *, k, balance_coef, z_coef, norm_topk=True):
    """x [T, H], wg [H, E] -> gate_vals [T, k] (f32), expert_idx [T, k],
    aux_loss (f32 scalar): the load-balance loss plus the router
    z-loss."""
    gate_vals, expert_idx, density, proxy, zsq = _router_parts(
        x, wg, k=k, norm_topk=norm_topk)
    aux = _assemble_aux(density, proxy, zsq, balance_coef=balance_coef,
                        z_coef=z_coef)
    return gate_vals, expert_idx, aux


def _default_init(init, device, dtype, generator):
    return init if init is not None else Init.on(device, dtype, generator)


class TopKGate(nn.Module):
    """Top-k router: ``weight`` [H, E] (normal, std 0.02)."""

    def __init__(self, hidden_size: int, num_experts: int, k: int = 2,
                 capacity_factor: float = 1.25,
                 balance_loss_weight: float = 0.01,
                 z_loss_weight: float = 0.0, norm_topk_prob: bool = True,
                 *, init: Optional[Init] = None, device=None,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        init = _default_init(init, device, dtype, generator)
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.balance_loss_weight = balance_loss_weight
        self.z_loss_weight = z_loss_weight
        self.norm_topk_prob = norm_topk_prob
        self.weight = init.normal((hidden_size, num_experts), 0.02)

    def forward(self, x):
        """(gate_vals [T, k] f32, expert_idx [T, k], aux_loss) for x
        [T, H]."""
        return _router_topk(x, self.weight, k=self.k,
                            balance_coef=self.balance_loss_weight,
                            z_coef=self.z_loss_weight,
                            norm_topk=self.norm_topk_prob)


class ExpertFFN(nn.Module):
    """Stacked per-expert SwiGLU weights: ``gate_w``/``up_w`` [E, H, F]
    (normal, ``init_std``) and ``down_w`` [E, F, H] (normal,
    ``init_std / sqrt(2 * num_layers_scale)``).  The grouped dispatch of
    :class:`MoELayer` runs them; the reference's dense batched forward
    over [E, C, H] capacity buffers is not ported."""

    def __init__(self, num_experts: int, hidden_size: int,
                 intermediate_size: int, init_std: float = 0.02,
                 num_layers_scale: int = 1, *,
                 init: Optional[Init] = None, device=None,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        init = _default_init(init, device, dtype, generator)
        e, h, f = num_experts, hidden_size, intermediate_size
        out_std = init_std / math.sqrt(2 * num_layers_scale)
        self.gate_w = init.normal((e, h, f), init_std)
        self.up_w = init.normal((e, h, f), init_std)
        self.down_w = init.normal((e, f, h), out_std)


def _xavier_std(d_in, d_out):
    return math.sqrt(2.0 / (d_in + d_out))


class MoELayer(nn.Module):
    """``forward(x [B, S, H]) -> [B, S, H]``; the router's aux loss of
    the call is ``self.aux_loss``.  The shared expert (when
    ``shared_expert_intermediate``) is a SwiGLU over Xavier-normal
    ``[in, out]`` Linears, gated by ``sigmoid(x @ W)`` with
    ``use_shared_expert_gate`` (HF Qwen2-MoE).  ``group_tile`` sets the
    grouped matmuls' row tile (None: the reference's rule).

    Parameters are drawn from ``init`` (the models' seeded factory) or,
    without one, on ``device`` in ``dtype`` from ``generator``."""

    def __init__(self, hidden_size: int, num_experts: int,
                 intermediate_size: int, k: int = 2,
                 capacity_factor: float = 1.25,
                 shared_expert_intermediate: int = 0,
                 balance_loss_weight: float = 0.01,
                 init_std: float = 0.02, num_layers_scale: int = 1,
                 gate: Optional[TopKGate] = None, experts=None,
                 dispatch_mode: str = "auto",
                 group_tile: Optional[int] = None,
                 norm_topk_prob: bool = True,
                 use_shared_expert_gate: bool = False,
                 ep_capacity_factor: Optional[float] = 2.0, *,
                 init: Optional[Init] = None, device=None,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        enforce(dispatch_mode in ("auto", "dense", "grouped", "grouped_ep"),
                f"bad dispatch_mode {dispatch_mode!r}")
        init = _default_init(init, device, dtype, generator)
        self.dispatch_mode = dispatch_mode
        self.group_tile = group_tile
        self.ep_capacity_factor = ep_capacity_factor
        self.gate = gate or TopKGate(
            hidden_size, num_experts, k=k, capacity_factor=capacity_factor,
            balance_loss_weight=balance_loss_weight,
            norm_topk_prob=norm_topk_prob, init=init)
        self.experts = experts or ExpertFFN(
            num_experts, hidden_size, intermediate_size, init_std=init_std,
            num_layers_scale=num_layers_scale, init=init)
        self.shared_gate = self.shared_expert_gate = None
        if shared_expert_intermediate:
            h, f = hidden_size, shared_expert_intermediate
            self.shared_gate = init.linear(h, f, _xavier_std(h, f),
                                           bias=False)
            self.shared_up = init.linear(h, f, _xavier_std(h, f), bias=False)
            self.shared_down = init.linear(f, h, _xavier_std(f, h),
                                           bias=False)
            if use_shared_expert_gate:
                self.shared_expert_gate = init.linear(
                    h, 1, _xavier_std(h, 1), bias=False)
        self.aux_loss: Optional[torch.Tensor] = None

    def _resolve_dispatch(self) -> str:
        mode = self.dispatch_mode
        custom = not (isinstance(self.gate, TopKGate)
                      and isinstance(self.experts, ExpertFFN))
        if mode == "auto":
            mode = "dense" if custom else "grouped"
        if mode == "dense":
            raise NotImplementedError(
                "dense MoE dispatch (GShard capacity einsums; also what "
                "'auto' picks for a custom gate or experts) is not ported "
                "yet (ROADMAP 'Port: remaining modules')")
        if mode == "grouped_ep":
            raise NotImplementedError(
                "grouped_ep MoE dispatch (expert-parallel all-to-all) is "
                "not ported yet (ROADMAP 'Port: remaining modules')")
        return mode

    def forward(self, x):
        b, s, h = x.shape
        self._resolve_dispatch()
        flat = x.reshape(b * s, h)
        g, ex = self.gate, self.experts
        gate_vals, expert_idx, aux = _router_topk(
            flat, g.weight, k=g.k, balance_coef=g.balance_loss_weight,
            z_coef=g.z_loss_weight, norm_topk=g.norm_topk_prob)
        out = dropless_moe_ffn(flat, gate_vals, expert_idx, ex.gate_w,
                               ex.up_w, ex.down_w, tm=self.group_tile)
        self.aux_loss = aux
        if self.shared_gate is not None:
            shared = self.shared_down(_nn.silu(self.shared_gate(flat))
                                      * self.shared_up(flat))
            if self.shared_expert_gate is not None:
                shared = shared * torch.sigmoid(
                    self.shared_expert_gate(flat))
            out = out + shared
        return out.reshape(b, s, h)
