"""Plain tensor ops of the serving and training paths (subset of
``paddle_tpu/ops/_nn.py``).

None of these is a Pallas kernel in the reference either: the norms,
activations and dropout are elementwise passes the compiler fuses there,
and the losses' matrix products are left to XLA.  Here they are plain
PyTorch, with the products on ``torch.matmul``.
"""
from __future__ import annotations

import torch

from ..common.errors import enforce
from . import random as _random

__all__ = ["rms_norm", "layer_norm", "silu", "gelu", "dropout",
           "cross_entropy", "fused_linear_cross_entropy"]


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s
    and GPT-2's)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train") -> torch.Tensor:
    """The reference's dropout: ``x`` unchanged when not training or at
    p = 0; else each element is kept with probability 1 - p, drawn from
    the guarded generator (``ops/random.py``), and scaled by 1 / (1 - p)
    under ``"upscale_in_train"`` (``"downscale_in_infer"`` keeps it as
    it is)."""
    enforce(mode in ("upscale_in_train", "downscale_in_infer"),
            f"unsupported dropout mode {mode!r}")
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=_random.generator_for(x.device),
                      device=x.device) < keep
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, zero)
    return torch.where(mask, x, zero)


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6,
             axis: int = -1) -> torch.Tensor:
    """RMSNorm (Llama family) with f32 statistics whatever the input
    dtype: normalise in f32, cast back, then scale by ``weight`` in the
    input dtype — the reference's order of roundings."""
    dt = x.dtype
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(dt)
    if weight is not None:
        out = out * weight
    return out


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` axes with f32
    statistics: normalise in f32, cast back, then scale and shift in the
    input dtype -- the reference's order of roundings (its variance is
    the mean squared deviation, ``jnp.var``)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.dim() - len(list(normalized_shape)), x.dim()))
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    d = xf - mean
    var = d.square().mean(dim=axes, keepdim=True)
    out = (d * torch.rsqrt(var + epsilon)).to(dt)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _reduce(per_tok, count, reduction):
    if reduction == "sum":
        return per_tok.sum()
    if reduction == "mean":
        return per_tok.sum() / count.clamp(min=1.0)
    return per_tok


def _check_reduction(reduction):
    enforce(reduction in ("mean", "sum", "none"),
            f"reduction must be 'mean', 'sum' or 'none', got {reduction!r}")


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100,
                  reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy over the last axis of ``input`` (logits),
    hard integer labels; rows whose label is ``ignore_index`` count 0
    and "mean" divides by the number of the other rows (at least 1).
    The log-softmax runs in f32 whatever the logits' dtype."""
    _check_reduction(reduction)
    logp = torch.log_softmax(input.float(), dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return _reduce(loss, valid.sum().float(), reduction)


def _chunk_logits(xc, weight, transpose_weight):
    """f32 logits of one chunk, never rounded to a narrower dtype: the
    reference's ``jnp.dot(..., preferred_element_type=f32)``.  On the
    card a bf16/f16 product writes f32 output straight from cuBLAS's f32
    accumulator (``out_dtype``); on the CPU the operands are widened
    first, which gives the same exact products summed in f32."""
    w = weight.t() if transpose_weight else weight
    if xc.dtype == torch.float32:
        return xc @ w
    if xc.device.type == "cuda":
        return torch.mm(xc, w, out_dtype=torch.float32)
    return xc.float() @ w.float()


class _FusedLinearCE(torch.autograd.Function):
    """Chunked LM-head product + softmax cross-entropy.  The forward
    keeps only each token's log-sum-exp; the backward recomputes each
    chunk's logits, so the f32 ``[N, V]`` logits never exist whole."""

    @staticmethod
    def forward(ctx, x2, weight, lab, transpose_weight, chunk, ignore_index,
                reduction):
        n = x2.shape[0]
        per_tok = torch.empty(n, dtype=torch.float32, device=x2.device)
        lse_all = torch.empty_like(per_tok)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
        chunk_sums = []
        for c0 in range(0, n, chunk):
            sl = slice(c0, c0 + chunk)
            logits = _chunk_logits(x2[sl], weight, transpose_weight)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, safe[sl, None])[:, 0]
            tok = torch.where(valid[sl], lse - tgt, torch.zeros_like(lse))
            per_tok[sl] = tok
            lse_all[sl] = lse
            chunk_sums.append(tok.sum())
        count = valid.sum().float()
        ctx.save_for_backward(x2, weight, safe, valid, lse_all, count)
        ctx.cfg = (transpose_weight, chunk, reduction)
        if reduction == "none":
            return per_tok
        total = torch.stack(chunk_sums).sum()
        return total if reduction == "sum" else total / count.clamp(min=1.0)

    @staticmethod
    def backward(ctx, g):
        x2, weight, safe, valid, lse_all, count = ctx.saved_tensors
        transpose_weight, chunk, reduction = ctx.cfg
        if reduction == "none":
            tok_scale = g.float() * valid
        else:
            gs = g.float() / count.clamp(min=1.0) if reduction == "mean" \
                else g.float()
            tok_scale = gs * valid
        dx = torch.empty_like(x2) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(weight) if ctx.needs_input_grad[1] else None
        n = x2.shape[0]
        for c0 in range(0, n, chunk):
            sl = slice(c0, c0 + chunk)
            xc = x2[sl]
            # d(lse - logit[label]) / d logits = softmax - onehot(label)
            dl = _chunk_logits(xc, weight, transpose_weight)
            dl.sub_(lse_all[sl, None]).exp_()
            rows = torch.arange(dl.shape[0], device=dl.device)
            dl[rows, safe[sl]] -= 1.0
            dl.mul_(tok_scale[sl, None])
            dl = dl.to(x2.dtype)
            if dx is not None:
                dx[sl] = dl @ (weight if transpose_weight else weight.t())
            if dw is not None:
                if transpose_weight:
                    dw.addmm_(dl.t(), xc)
                else:
                    dw.addmm_(xc.t(), dl)
        return dx, dw, None, None, None, None, None


def fused_linear_cross_entropy(x: torch.Tensor, weight: torch.Tensor,
                               label: torch.Tensor, bias=None,
                               ignore_index: int = -100,
                               reduction: str = "mean",
                               transpose_weight: bool = False,
                               chunk_size: int = 1024) -> torch.Tensor:
    """LM-head product + softmax cross-entropy, chunked over tokens
    (counterpart of the reference's ``fused_linear_cross_entropy``).

    x: ``[..., H]``; weight: ``[H, V]`` (Paddle Linear layout) or
    ``[V, H]`` with ``transpose_weight=True`` (a tied embedding); label:
    ``[...]`` ints.  Chunks of ``chunk_size`` tokens are the unit of
    work: at most one chunk's f32 logits ``[chunk, V]`` lives at a time,
    in the forward and again in the backward, which recomputes them."""
    _check_reduction(reduction)
    if bias is not None:
        raise NotImplementedError(
            "fused_linear_cross_entropy with a bias is not ported yet "
            "(ROADMAP 'Port: remaining modules')")
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    lab = label.reshape(-1)
    enforce(lab.shape[0] == x2.shape[0],
            f"{lab.shape[0]} labels for {x2.shape[0]} tokens")
    out = _FusedLinearCE.apply(x2, weight, lab, bool(transpose_weight),
                               int(min(chunk_size, x2.shape[0])),
                               int(ignore_index), reduction)
    return out.reshape(label.shape) if reduction == "none" else out
