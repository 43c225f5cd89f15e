"""Plain tensor ops of the serving and training paths (subset of
``paddle_tpu/ops/_nn.py``).

None of these is a Pallas kernel in the reference either: the norms,
activations and dropout are elementwise passes the compiler fuses there,
and the losses' matrix products are left to XLA.  Here they are plain
PyTorch, with the products on ``torch.matmul``.  The losses are the
reference's, op for op (the functions its 20 loss layers call, plus
``label_smooth`` and ``softmax_with_cross_entropy``); each passes its
tensors through ``amp.auto_cast``'s ``amp_cast`` under its reference
name, so amp O1 casts what the reference's dispatch casts (the black
list holds ``cross_entropy``, ``nll_loss`` and
``binary_cross_entropy``).
"""
from __future__ import annotations

import math

import torch

from ..amp.auto_cast import amp_cast
from ..common.errors import enforce
from . import random as _random

__all__ = ["rms_norm", "layer_norm", "group_norm", "silu", "gelu",
           "dropout", "conv2d", "interpolate", "cross_entropy",
           "mse_loss", "fused_linear_cross_entropy", "nll_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "l1_loss", "smooth_l1_loss", "kl_div", "label_smooth",
           "hinge_embedding_loss", "cosine_embedding_loss",
           "margin_ranking_loss", "pairwise_distance",
           "triplet_margin_loss", "triplet_margin_with_distance_loss",
           "soft_margin_loss", "multi_label_soft_margin_loss",
           "poisson_nll_loss", "gaussian_nll_loss", "ctc_loss",
           "multi_margin_loss", "softmax_with_cross_entropy",
           "adaptive_log_softmax_with_loss"]


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


def _nchw_only(data_format):
    if data_format != "NCHW":
        raise NotImplementedError(
            f"data_format {data_format!r} is not ported yet (ROADMAP "
            "'Port: remaining modules'); the models use NCHW")


def group_norm(x: torch.Tensor, num_groups: int, weight=None, bias=None,
               epsilon: float = 1e-5,
               data_format: str = "NCHW") -> torch.Tensor:
    """GroupNorm over ``[N, C, *spatial]`` (NCHW) with f32 statistics (the
    variance is the mean squared deviation): normalise in f32, cast
    back, then scale and shift per channel in the input dtype -- the
    reference's order of roundings.  ``torch.nn.functional.group_norm``
    does the f32 normalisation (no TPU kernel does it in the reference
    either: XLA fuses it there)."""
    _nchw_only(data_format)
    dt = x.dtype
    out = torch.nn.functional.group_norm(x.float(), num_groups,
                                         eps=epsilon).to(dt)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
           padding=0, dilation=1, groups: int = 1,
           data_format: str = "NCHW") -> torch.Tensor:
    """Paddle's ``conv2d``: weight ``[C_out, C_in / groups, kH, kW]``
    (PyTorch's layout).  Under amp O2 a 16-bit weight pulls the input to
    its dtype, as the reference's ``_match_conv_dtypes``; the bias is
    added after the convolution.  ``torch.nn.functional.conv2d`` runs it
    (cuDNN on the card): the reference leaves it to XLA, outside any
    Pallas kernel."""
    _nchw_only(data_format)
    x, weight, bias = amp_cast("conv2d", x, weight, bias)
    if isinstance(padding, str):
        padding = padding.lower()
    if x.dtype != weight.dtype:
        x = x.to(weight.dtype)
    out = torch.nn.functional.conv2d(x, weight, None, stride, padding,
                                     dilation, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def interpolate(x: torch.Tensor, size=None, scale_factor=None,
                mode: str = "nearest", align_corners: bool = False,
                data_format: str = "NCHW") -> torch.Tensor:
    """Nearest-neighbour resize of ``[N, C, H, W]`` to ``size`` or by
    ``scale_factor`` (the reference's ``jax.image.resize`` nearest: at
    an integer factor each output pixel repeats input pixel
    ``i // factor``, as PyTorch's ``"nearest"``)."""
    _nchw_only(data_format)
    if mode != "nearest":
        raise NotImplementedError(
            f"interpolate mode {mode!r} is not ported yet (ROADMAP 'Port: "
            "remaining modules')")
    h, w = x.shape[2], x.shape[3]
    if size is None:
        sf = (scale_factor, scale_factor) \
            if isinstance(scale_factor, (int, float)) else scale_factor
        size = (int(h * sf[0]), int(w * sf[1]))
    elif isinstance(size, int):
        size = (size, size)
    return torch.nn.functional.interpolate(x, size=tuple(size),
                                           mode="nearest")


def mse_loss(input: torch.Tensor, label: torch.Tensor,
             reduction: str = "mean") -> torch.Tensor:
    """Squared error, reduced by ``reduction``."""
    _check_reduction(reduction)
    input, label = amp_cast("mse_loss", input, label)
    return _reduced((input - label).square(), reduction)


def _check_reduction(reduction):
    enforce(reduction in ("mean", "sum", "none"),
            f"reduction must be 'mean', 'sum' or 'none', got {reduction!r}")


def _reduced(loss, reduction):
    """The reference's ``_reduce``: the mean, the sum or the loss as it
    is."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Paddle's ``F.cross_entropy`` with the reference's whole signature,
    in f32 whatever the logits' dtype.  ``input`` holds logits
    (``use_softmax``) or probabilities (their log, clipped at 1e-30),
    classes along ``axis``.  ``soft_label``: the label is a distribution
    over the classes, and every row counts.  Hard labels (with or
    without a trailing axis of 1): ``label_smoothing`` mixes the one-hot
    target with the uniform one, then rows whose label is
    ``ignore_index`` count 0 -- smoothed first, ignored after, as the
    reference orders them; ``weight`` scales each row by its class's
    weight, and "mean" divides by the summed weights of the rows kept
    (else by their number, at least 1)."""
    _check_reduction(reduction)
    input, label = amp_cast("cross_entropy", input, label)
    x = input.float()
    ax = axis % x.dim()
    logp = torch.log_softmax(x, dim=ax) if use_softmax \
        else torch.log(x.clamp(min=1e-30))
    if soft_label:
        return _reduced(-(label.float() * logp).sum(ax), reduction)
    lbl = label.squeeze(ax) if label.dim() == logp.dim() else label
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
    if label_smoothing > 0.0:
        nclass = x.shape[ax]
        cls = torch.arange(nclass, device=x.device).view(
            [nclass if i == ax else 1 for i in range(x.dim())])
        onehot = (lbl.unsqueeze(ax) == cls).float()
        smoothed = onehot * (1 - label_smoothing) + label_smoothing / nclass
        loss = -(smoothed * logp).sum(ax)
    else:
        loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    loss = torch.where(valid, loss, zero)
    if weight is not None:
        w = torch.where(valid, weight[safe], torch.zeros_like(weight[safe]))
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp(min=1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp(min=1.0)
    return _reduced(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean"):
    """The negative of ``input`` (log-probabilities, classes last) at
    each label; rows labelled ``ignore_index`` count 0 and "mean"
    divides by the others' number.  ``weight`` is taken and not applied,
    as in the reference."""
    _check_reduction(reduction)
    input, label = amp_cast("nll_loss", input, label)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -input.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp(min=1.0)
    return _reduced(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """``-(y log p + (1 - y) log(1 - p))`` of probabilities ``input``
    (f32, clipped to [1e-12, 1 - 1e-12])."""
    input, label = amp_cast("binary_cross_entropy", input, label)
    x = input.float().clamp(1e-12, 1 - 1e-12)
    loss = -(label * torch.log(x) + (1 - label) * torch.log1p(-x))
    if weight is not None:
        loss = loss * weight
    return _reduced(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """The stable form ``max(x, 0) - x y + log1p(exp(-|x|))`` in f32;
    ``pos_weight`` scales each element by ``(pos_weight - 1) y + 1``, as
    the reference does."""
    logit, label = amp_cast("binary_cross_entropy_with_logits", logit,
                            label)
    x, lbl = logit.float(), label.float()
    loss = x.clamp(min=0) - x * lbl + torch.log1p(torch.exp(-x.abs()))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1) * lbl + 1)
    if weight is not None:
        loss = loss * weight
    return _reduced(loss, reduction)


def l1_loss(input, label, reduction="mean"):
    input, label = amp_cast("l1_loss", input, label)
    return _reduced((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    """Huber's loss: ``d^2 / (2 delta)`` below ``delta``, ``|d| - delta
    / 2`` above."""
    input, label = amp_cast("smooth_l1_loss", input, label)
    d = input - label
    loss = torch.where(d.abs() < delta, 0.5 * d * d / delta,
                       d.abs() - 0.5 * delta)
    return _reduced(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False):
    """``label (log label - input)`` with ``input`` log-probabilities
    (``log_target``: the label's log too); "batchmean" divides the sum
    by the batch."""
    input, label = amp_cast("kl_div", input, label)
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(label.clamp(min=1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduced(loss, reduction)


def label_smooth(label, prior_dist=None, epsilon=0.1):
    """``(1 - epsilon) label + epsilon`` times the uniform distribution
    over the last axis, or times ``prior_dist``."""
    n = label.shape[-1]
    if prior_dist is None:
        return (1 - epsilon) * label + epsilon / n
    return (1 - epsilon) * label + epsilon * prior_dist


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    input, label = amp_cast("hinge_embedding_loss", input, label)
    loss = torch.where(label == 1.0, input, (margin - input).clamp(min=0.0))
    return _reduced(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    """``1 - cos`` for pairs labelled 1, ``max(0, cos - margin)`` for the
    others; cos over the last axis."""
    input1, input2, label = amp_cast("cosine_embedding_loss", input1,
                                     input2, label)
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1)).clamp(min=1e-12)
    loss = torch.where(label == 1.0, 1.0 - cos, (cos - margin).clamp(min=0.0))
    return _reduced(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    input, other, label = amp_cast("margin_ranking_loss", input, other,
                                   label)
    return _reduced((-label * (input - other) + margin).clamp(min=0.0),
                    reduction)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """The ``p``-norm of ``x - y + epsilon`` over the last axis."""
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    input, positive, negative = amp_cast("triplet_margin_loss", input,
                                         positive, negative)
    dp = pairwise_distance(input, positive, p, epsilon)
    dn = pairwise_distance(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, pairwise_distance(positive, negative, p,
                                                 epsilon))
    return _reduced((dp - dn + margin).clamp(min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean"):
    """As ``triplet_margin_loss`` with ``distance_function`` (default:
    the Euclidean norm of the difference over the last axis)."""
    input, positive, negative = amp_cast(
        "triplet_margin_with_distance_loss", input, positive, negative)
    dist = distance_function or (
        lambda a, b: torch.linalg.vector_norm(a - b, dim=-1))
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduced((dp - dn + margin).clamp(min=0.0), reduction)


def soft_margin_loss(input, label, reduction="mean"):
    input, label = amp_cast("soft_margin_loss", input, label)
    return _reduced(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    input, label = amp_cast("multi_label_soft_margin_loss", input, label)
    ls = torch.nn.functional.logsigmoid
    loss = -(label * ls(input) + (1.0 - label) * ls(-input))
    if weight is not None:
        loss = loss * weight
    return _reduced(loss.mean(-1), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean"):
    """``exp(x) - y x`` for a log rate ``x`` (else ``x - y log(x +
    epsilon)``); ``full`` adds Stirling's term where ``y > 1``."""
    input, label = amp_cast("poisson_nll_loss", input, label)
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label + epsilon) - label
                    + 0.5 * torch.log(2.0 * math.pi * (label + epsilon)))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduced(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    input, label, variance = amp_cast("gaussian_nll_loss", input, label,
                                      variance)
    var = variance.clamp(min=epsilon)
    loss = 0.5 * (torch.log(var) + (input - label).square() / var)
    if full:
        loss = loss + 0.5 * math.log(2.0 * math.pi)
    return _reduced(loss, reduction)


_CTC_NEG = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC's negative log-likelihood by the forward recursion in the log
    semiring, a time step at a time (paddle's layout: ``log_probs`` [T,
    B, C] logits, log-softmaxed here in f32; ``labels`` [B, L]).  A
    sequence past its ``input_lengths`` keeps its last state; "mean"
    divides each sequence's loss by its label length first."""
    log_probs, labels, input_lengths, label_lengths = amp_cast(
        "ctc_loss", log_probs, labels, input_lengths, label_lengths)
    t_max, b, _ = log_probs.shape
    dev = log_probs.device
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    s = 2 * labels.shape[1] + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    bidx = torch.arange(b, device=dev)
    neg = torch.full((b, 1), _CTC_NEG, device=dev)
    first = torch.where(label_lengths > 0, lp[0, bidx, ext[:, 1]],
                        neg[:, 0]) if s > 1 else None
    alpha = torch.cat([lp[0, bidx, ext[:, 0]][:, None]]
                      + ([first[:, None], neg.expand(b, s - 2)]
                         if s > 1 else []), dim=1)
    same = torch.cat([torch.ones((b, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)[:, :s]
    for t in range(1, t_max):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg.expand(b, 2), alpha[:, :-2]], dim=1)[:, :s]
        prev2 = torch.where(same, neg, prev2)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = merged + lp[t].gather(1, ext)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    last = 2 * label_lengths.long()
    end1 = alpha[bidx, last]
    end2 = torch.where(label_lengths > 0,
                       alpha[bidx, (last - 1).clamp(min=0)], neg[:, 0])
    nll = -torch.logaddexp(end1, end2)
    if norm_by_times:
        nll = nll / input_lengths.float().clamp(min=1.0)
    if reduction == "mean":
        return (nll / label_lengths.float().clamp(min=1.0)).mean()
    return _reduced(nll, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    """The hinge ``max(0, margin - x[y] + x[j])^p`` summed over the
    wrong classes j and divided by the number of classes; ``weight``
    scales a row by its label's weight."""
    input, label, weight = amp_cast("multi_margin_loss", input, label,
                                    weight)
    n, c = input.shape
    tgt = input.gather(1, label.long()[:, None])
    m = (margin - tgt + input).clamp(min=0.0) ** p
    if weight is not None:
        m = m * weight[label.long()][:, None]
    wrong = torch.arange(c, device=input.device)[None, :] != \
        label.long()[:, None]
    return _reduced((m * wrong).sum(1) / c, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """The legacy fused op: the unreduced loss of each row with the
    class axis kept (length 1), in the logits' dtype; with
    ``return_softmax`` also the softmax."""
    logits, label = amp_cast("softmax_with_cross_entropy", logits, label)
    ax = axis % logits.dim()
    logp = torch.log_softmax(logits, dim=ax)
    if soft_label:
        loss = -(label * logp).sum(ax, keepdim=True)
    else:
        lbl = label.squeeze(ax) if label.dim() == logits.dim() else label
        ignored = (lbl == ignore_index).unsqueeze(ax)
        safe = torch.where(lbl == ignore_index, torch.zeros_like(lbl),
                           lbl).long()
        picked = logp.gather(ax, safe.unsqueeze(ax))
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    if return_softmax:
        return loss, torch.softmax(logits, dim=ax)
    return loss


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None):
    """Adaptive softmax (Grave et al.): the classes below ``cutoffs[0]``
    and one slot a cluster in the head, each cluster's classes in a
    tail ``input @ proj @ w``.  Returns (each row's log-probability of
    its label, their mean negative); every row computes every cluster,
    masked, as the reference does."""
    input, label, head_weight = amp_cast(
        "adaptive_log_softmax_with_loss", input, label, head_weight)
    head = input @ head_weight
    if head_bias is not None:
        head = head + head_bias
    head_logp = torch.log_softmax(head, dim=-1)
    lbl = label.long()
    in_head = lbl < cutoffs[0]
    out = head_logp.gather(
        1, torch.where(in_head, lbl, torch.zeros_like(lbl))[:, None])[:, 0]
    out = torch.where(in_head, out, torch.zeros_like(out))
    for i, (proj, w) in enumerate(tail_weights):
        lo = cutoffs[i]
        hi = cutoffs[i + 1] if i + 1 < len(cutoffs) else lo + w.shape[-1]
        in_c = (lbl >= lo) & (lbl < hi)
        tail_logp = torch.log_softmax(input @ proj @ w, dim=-1)
        safe = torch.where(in_c, lbl - lo, torch.zeros_like(lbl))
        lp = head_logp[:, cutoffs[0] + i] + \
            tail_logp.gather(1, safe[:, None])[:, 0]
        out = torch.where(in_c, lp, out)
    return out, -out.mean()


def _chunk_logits(xc, weight, bias, transpose_weight):
    """f32 logits of one chunk, never rounded to a narrower dtype: the
    reference's ``jnp.dot(..., preferred_element_type=f32)``, plus the
    bias in f32.  On the card a bf16/f16 product writes f32 output
    straight from cuBLAS's f32 accumulator (``out_dtype``); on the CPU
    the operands are widened first, which gives the same exact products
    summed in f32."""
    w = weight.t() if transpose_weight else weight
    if xc.dtype == torch.float32:
        logits = xc @ w
    elif xc.device.type == "cuda":
        logits = torch.mm(xc, w, out_dtype=torch.float32)
    else:
        logits = xc.float() @ w.float()
    return logits if bias is None else logits + bias.float()


class _FusedLinearCE(torch.autograd.Function):
    """Chunked LM-head product + softmax cross-entropy.  The forward
    keeps only each token's log-sum-exp; the backward recomputes each
    chunk's logits, so the f32 ``[N, V]`` logits never exist whole."""

    @staticmethod
    def forward(ctx, x2, weight, bias, lab, transpose_weight, chunk,
                ignore_index, reduction, group):
        n = x2.shape[0]
        per_tok = torch.empty(n, dtype=torch.float32, device=x2.device)
        lse_all = torch.empty_like(per_tok)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
        mine = None
        if group is not None:
            # the vocabulary is split: this rank's rows of the labels
            from ..distributed import parallel_layers as _pl
            safe, mine = _pl.vocab_part(
                safe, weight.shape[0 if transpose_weight else 1], group)
            mine &= valid
        chunk_sums = []
        for c0 in range(0, n, chunk):
            sl = slice(c0, c0 + chunk)
            logits = _chunk_logits(x2[sl], weight, bias, transpose_weight)
            tgt = logits.gather(1, safe[sl, None])[:, 0]
            if group is None:
                lse = torch.logsumexp(logits, dim=-1)
            else:
                lse, tgt = _pl.split_vocab_lse(logits, tgt, mine[sl], group)
            tok = torch.where(valid[sl], lse - tgt, torch.zeros_like(lse))
            per_tok[sl] = tok
            lse_all[sl] = lse
            chunk_sums.append(tok.sum())
        count = valid.sum().float()
        ctx.save_for_backward(x2, weight, bias, safe, valid, lse_all, count,
                              mine)
        ctx.cfg = (transpose_weight, chunk, reduction)
        if reduction == "none":
            return per_tok
        total = torch.stack(chunk_sums).sum()
        return total if reduction == "sum" else total / count.clamp(min=1.0)

    @staticmethod
    def backward(ctx, g):
        x2, weight, bias, safe, valid, lse_all, count, mine = \
            ctx.saved_tensors
        transpose_weight, chunk, reduction = ctx.cfg
        if reduction == "none":
            tok_scale = g.float() * valid
        else:
            gs = g.float() / count.clamp(min=1.0) if reduction == "mean" \
                else g.float()
            tok_scale = gs * valid
        dx = torch.empty_like(x2) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(weight) if ctx.needs_input_grad[1] else None
        db = torch.zeros(weight.shape[0 if transpose_weight else 1],
                         dtype=torch.float32, device=x2.device) \
            if ctx.needs_input_grad[2] else None
        n = x2.shape[0]
        for c0 in range(0, n, chunk):
            sl = slice(c0, c0 + chunk)
            xc = x2[sl]
            # d(lse - logit[label]) / d logits = softmax - onehot(label)
            dl = _chunk_logits(xc, weight, bias, transpose_weight)
            dl.sub_(lse_all[sl, None]).exp_()
            if mine is None:
                rows = torch.arange(dl.shape[0], device=dl.device)
                dl[rows, safe[sl]] -= 1.0
            else:
                # the onehot only where this rank holds the label's id
                dl.scatter_add_(1, safe[sl, None],
                                -mine[sl, None].to(dl.dtype))
            dl.mul_(tok_scale[sl, None])
            if db is not None:
                db += dl.sum(0)
            dl = dl.to(x2.dtype)
            if dx is not None:
                dx[sl] = dl @ (weight if transpose_weight else weight.t())
            if dw is not None:
                if transpose_weight:
                    dw.addmm_(dl.t(), xc)
                else:
                    dw.addmm_(xc.t(), dl)
        return dx, dw, None if db is None else db.to(bias.dtype), None, \
            None, None, None, None, None


def fused_linear_cross_entropy(x: torch.Tensor, weight: torch.Tensor,
                               label: torch.Tensor, bias=None,
                               ignore_index: int = -100,
                               reduction: str = "mean",
                               transpose_weight: bool = False,
                               chunk_size: int = 1024,
                               mp_group=None) -> torch.Tensor:
    """LM-head product + softmax cross-entropy, chunked over tokens
    (counterpart of the reference's ``fused_linear_cross_entropy``).

    x: ``[..., H]``; weight: ``[H, V]`` (Paddle Linear layout) or
    ``[V, H]`` with ``transpose_weight=True`` (a tied embedding); label:
    ``[...]`` ints.  Chunks of ``chunk_size`` tokens are the unit of
    work: at most one chunk's f32 logits ``[chunk, V]`` lives at a time,
    in the forward and again in the backward, which recomputes them.
    ``bias`` ``[V]`` is added to the f32 logits.

    ``mp_group`` (a tensor-parallel group): ``weight`` (and ``bias``)
    hold this rank's part of the vocabulary, rank ``r`` ids ``[r * v, (r
    + 1) * v)``; each chunk's loss takes three all-reduces over the group
    (its f32 logits never exist whole across the vocabulary either), the
    backward none: ``x``'s gradient is this rank's part of the sum, which
    the caller's ``_c_identity`` on ``x`` all-reduces."""
    _check_reduction(reduction)
    x, weight, label, bias = amp_cast("fused_linear_cross_entropy", x,
                                      weight, label, bias)
    h = x.shape[-1]
    if bias is not None:
        vocab = weight.shape[0 if transpose_weight else 1]
        enforce(tuple(bias.shape) == (vocab,),
                f"bias {tuple(bias.shape)} must be [{vocab}]")
    x2 = x.reshape(-1, h)
    lab = label.reshape(-1)
    enforce(lab.shape[0] == x2.shape[0],
            f"{lab.shape[0]} labels for {x2.shape[0]} tokens")
    out = _FusedLinearCE.apply(x2, weight, bias, lab,
                               bool(transpose_weight),
                               int(min(chunk_size, x2.shape[0])),
                               int(ignore_index), reduction, mp_group)
    return out.reshape(label.shape) if reduction == "none" else out
