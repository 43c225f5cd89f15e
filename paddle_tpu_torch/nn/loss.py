"""Loss layers (counterpart of ``paddle_tpu/nn/loss.py``): the
reference's 20 layers, each a ``torch.nn.Module`` that calls its
function of ``nn.functional`` (``ops/_nn.py``) with the arguments the
reference's layer passes.  ``AdaptiveLogSoftmaxWithLoss`` holds
parameters under the reference's names (``head_weight``, ``head_bias``,
``tail_proj_<i>``, ``tail_w_<i>``), so ``models.from_jax`` carries a
reference layer's weights in as they are; they are drawn XavierNormal
(biases zeros) on ``device`` from ``generator`` (or the dropout
stream's generator of that device, as ``nn/common.py``'s).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..runtime.device import resolve_device
from . import functional as F
from .common import _draw
from .initializer import XavierNormal

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
           "MarginRankingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "TripletMarginWithDistanceLoss",
           "MultiLabelSoftMarginLoss", "HingeEmbeddingLoss",
           "SoftMarginLoss", "MultiMarginLoss", "PoissonNLLLoss",
           "GaussianNLLLoss", "CTCLoss", "AdaptiveLogSoftmaxWithLoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, reduction=self.reduction)


class L1Loss(nn.Module):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, reduction=self.reduction)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, weight=self.weight,
                          ignore_index=self.ignore_index,
                          reduction=self.reduction)


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, weight=self.weight,
                                      reduction=self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, reduction=self.reduction,
            pos_weight=self.pos_weight)


class KLDivLoss(nn.Module):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction = reduction
        self.log_target = log_target

    def forward(self, input, label):
        return F.kl_div(input, label, reduction=self.reduction,
                        log_target=self.log_target)


class SmoothL1Loss(nn.Module):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, reduction=self.reduction,
                                delta=self.delta)


class MarginRankingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CosineEmbeddingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(nn.Module):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self._a)


class TripletMarginWithDistanceLoss(nn.Module):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(input, positive,
                                                   negative, *self._a)


class MultiLabelSoftMarginLoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(
            input, label, weight=self.weight, reduction=self.reduction)


class HingeEmbeddingLoss(nn.Module):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class SoftMarginLoss(nn.Module):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiMarginLoss(nn.Module):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._a = (p, margin, weight, reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, *self._a)


class PoissonNLLLoss(nn.Module):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._kw = dict(log_input=log_input, full=full, epsilon=epsilon,
                        reduction=reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, **self._kw)


class GaussianNLLLoss(nn.Module):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._kw = dict(full=full, epsilon=epsilon, reduction=reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, **self._kw)


class CTCLoss(nn.Module):
    """``norm_by_times`` is taken by ``forward`` and not passed on, as in
    the reference's layer."""

    def __init__(self, blank=0, reduction="mean", name=None):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, logits, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(logits, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction)


class AdaptiveLogSoftmaxWithLoss(nn.Module):
    """Adaptive softmax: a head over the classes below ``cutoffs[0]`` and
    one slot a tail cluster, each cluster a down-projection
    (``in_features / div_value^(i + 1)`` wide) and its classes.
    ``forward(input, label)`` returns (each row's log-probability of its
    label, their mean negative)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, weight_attr=None, bias_attr=None,
                 name=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)

        def param(shape):
            return _draw(weight_attr or XavierNormal(), shape, dev, dtype,
                         generator)

        self.cutoffs = list(cutoffs)
        n_clusters = len(self.cutoffs)
        head_size = self.cutoffs[0] + n_clusters
        self.head_weight = param([in_features, head_size])
        self.head_bias = nn.Parameter(torch.zeros(
            head_size, device=dev, dtype=dtype)) if head_bias else None
        ext = self.cutoffs + [n_classes]
        self._n_tails = n_clusters
        for i in range(n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            self.register_parameter(f"tail_proj_{i}",
                                    param([in_features, hsz]))
            self.register_parameter(f"tail_w_{i}",
                                    param([hsz, ext[i + 1] - ext[i]]))

    @property
    def tail_weights(self):
        return [(getattr(self, f"tail_proj_{i}"), getattr(self, f"tail_w_{i}"))
                for i in range(self._n_tails)]

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            head_bias=self.head_bias)
