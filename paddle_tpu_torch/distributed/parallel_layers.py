"""Tensor-parallel (Megatron) layers and the sequence-parallel utilities
(counterpart of ``paddle_tpu/distributed/parallel_layers.py``).

The reference's layers only annotate their weights (``dist_spec``) and
let GSPMD emit the collectives.  One process drives one card here, so a
layer holds **this rank's part** of its weight and issues the
collectives itself, Megatron's pattern as upstream Paddle's ``mp_ops``
writes it (``distributed/collective.py``):

- ``ColumnParallelLinear``: the weight's columns ``[in, out / mp]``; the
  input passes ``_c_identity`` (its gradient is all-reduced), and with
  ``gather_output`` the output's parts are put together (``_c_concat``).
- ``RowParallelLinear``: the weight's rows ``[in / mp, out]``; an input
  that is not parallel yet is split (``_c_split``); the partial products
  are all-reduced and the bias, which every rank holds whole, is added
  once after the sum.
- ``VocabParallelEmbedding``: rows ``[vocab / mp, hidden]``; an id
  outside this rank's rows reads zeros, then one all-reduce.
- ``ParallelCrossEntropy``: the cross-entropy of vocab-parallel logits
  (reduction "none"): all-reduces of the row maximum, of the sum of
  exponentials and of the label's logit; the backward needs none.

Each layer draws its whole weight from its generator (the reference's
initialisers on the global shape) and keeps its slice, so a gang's
weights put together equal one process's; ``dist_spec`` stays on the
parameter, as in the reference.  Without ``fleet.init`` (and no
``mp_group``) a layer is the plain layer on the whole weight.

``mark_as_sequence_parallel_parameter`` and ``sharding_constraint`` are
no-ops, as the reference's are outside tracing; ``ScatterOp`` /
``GatherOp`` cut the sequence (dim 1) into this rank's part and put the
parts back together.

The functions ``row_parallel_linear``, ``vocab_parallel_embedding`` and
``vocab_parallel_cross_entropy`` are the layers' computations on a
given group; the models' tensor-parallel forwards call them.
``keep_part`` cuts a parameter to its rank's part and marks it
(``mp_part``, which ``ShardingPlan`` and ``ShardedTrainStep`` read);
``vocab_part`` and ``split_vocab_lse`` are the vocabulary split that
this module's cross-entropy and the chunked
``ops/_nn.fused_linear_cross_entropy`` share.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..amp.auto_cast import amp_cast
from ..jit.recompute import product
from ..nn import functional as F
from ..nn.common import _draw
from ..nn.initializer import Normal, XavierNormal
from . import collective as C
from .collective import ReduceOp, _c_concat, _c_identity, _c_split
from .topology import CommGroup

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "mark_as_sequence_parallel_parameter", "ScatterOp", "GatherOp",
           "sharding_constraint", "row_parallel_linear",
           "vocab_parallel_embedding", "vocab_parallel_cross_entropy",
           "keep_part", "vocab_part", "split_vocab_lse"]


def _mp_group(mp_group) -> Optional[CommGroup]:
    """``mp_group`` if given, else fleet's model-parallel group, else None
    (no topology: the plain layer)."""
    if mp_group is not None:
        return mp_group
    from .fleet import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


def keep_part(p: nn.Parameter, dim: int, group: Optional[CommGroup],
              spec) -> nn.Parameter:
    """Cut ``p`` (whole) down to this rank's contiguous part on ``dim``
    over ``group`` (a group of one keeps it whole), set its
    ``dist_spec`` and, under a group, ``mp_part``: the parameter holds
    its rank's part, which ``ShardingPlan`` and ``ShardedTrainStep``
    read.  Without a group it stays whole and plain."""
    if group is not None:
        if group.nranks > 1:
            n = p.shape[dim]
            enforce_divides(n, group.nranks,
                            f"dim {dim} of {tuple(p.shape)}")
            k = n // group.nranks
            p.data = p.data.narrow(dim, group.rank * k, k).clone(
                memory_format=torch.contiguous_format)
        p.mp_part = True
    p.dist_spec = spec
    return p


def enforce_divides(n: int, parts: int, what: str) -> None:
    if n % parts:
        raise NotImplementedError(
            f"{what} does not split over {parts} tensor-parallel ranks; an "
            f"uneven split is not ported (ROADMAP 'Multi-device')")


def row_parallel_linear(x, weight, bias, group: CommGroup,
                        names=("dot",)) -> torch.Tensor:
    """``x @ weight`` over this rank's rows, summed over ``group``
    (Megatron's forward all-reduce, on the product's own buffer; the
    gradient is the product's), plus ``bias`` (whole) once after the
    sum: ``F.linear``'s casts and promotion, its product a "dot" to the
    recompute policies.  In a recomputed region the sum is kept (every
    policy keeps "mp_reduce", ``jit/recompute.py``), so a recompute
    re-issues no collective."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    y = product(x, weight, tuple(names) + ("mp_reduce",),
                reduce=lambda t: C.mp_all_reduce_(t, group))
    return y if bias is None else y + bias


def vocab_part(ids: torch.Tensor, v: int, group: CommGroup):
    """(this rank's row of each id, whether this rank holds it): rank
    ``r`` of ``group`` holds ids ``[r * v, (r + 1) * v)``; the row of an
    id it does not hold is 0."""
    local = ids.long() - group.rank * v
    mine = (local >= 0) & (local < v)
    return torch.where(mine, local, torch.zeros_like(local)), mine


def split_vocab_lse(x: torch.Tensor, tgt: torch.Tensor, mine: torch.Tensor,
                    group: CommGroup):
    """The log-sum-exp over the whole vocabulary and the label's logit,
    from f32 logits ``x`` ``[..., v]`` that hold this rank's part of it
    and ``tgt``, this rank's logit at the label's row (read where
    ``mine``): three all-reduces over ``group`` (the row maximum, the
    sum of exponentials, the label's logit, which one rank holds), in
    ``torch.logsumexp``'s order of operations."""
    m = x.amax(-1)
    C.mp_all_reduce_(m, group, ReduceOp.MAX)
    se = (x - m[..., None]).exp_().sum(-1)
    C.mp_all_reduce_(se, group)
    tgt = torch.where(mine, tgt, torch.zeros_like(tgt))
    C.mp_all_reduce_(tgt, group)
    return se.log_().add_(m), tgt


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             group: CommGroup) -> torch.Tensor:
    """Rows of the vocab-parallel table: ``weight`` holds rows ``[r * v,
    (r + 1) * v)`` on rank ``r``; an id outside them reads zeros; the
    parts are summed over ``group``."""
    rows, mine = vocab_part(ids, weight.shape[0], group)
    out = F.embedding(rows, weight)
    return C._mp_allreduce(out.masked_fill(~mine[..., None], 0.0), group)


class _VocabParallelCE(torch.autograd.Function):
    """Softmax cross-entropy of logits split over the vocabulary (f32):
    three all-reduces forward (``split_vocab_lse``), none backward."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        x = logits.float()
        valid = label != ignore_index
        rows, mine = vocab_part(label, x.shape[-1], group)
        mine &= valid
        lse, tgt = split_vocab_lse(x, x.gather(-1, rows[..., None])[..., 0],
                                   mine, group)
        ctx.save_for_backward(x, lse, rows, mine, valid)
        ctx.dtype = logits.dtype
        return torch.where(valid, lse - tgt, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, g):
        x, lse, rows, mine, valid = ctx.saved_tensors
        d = (x - lse[..., None]).exp_()
        d.scatter_add_(-1, rows[..., None], -mine.float()[..., None])
        d.mul_((g.float() * valid)[..., None])
        return d.to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                                 group: CommGroup,
                                 ignore_index: int = -100) -> torch.Tensor:
    """Each row's cross-entropy (0 where the label is ``ignore_index``)
    of logits whose last dim is this rank's part of the vocabulary
    (rank ``r`` of ``group`` holds ``[r * v, (r + 1) * v)``); ``label``
    holds global ids, with or without a trailing dim of 1."""
    if label.dim() == logits.dim():
        label = label.squeeze(-1)
    return _VocabParallelCE.apply(logits, label, group, int(ignore_index))


class ColumnParallelLinear(nn.Module):
    """Weight ``[in, out]`` split by columns over the mp group; the
    output stays split (``gather_output=False``, the input of a
    ``RowParallelLinear``) or is put back together."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = True, fuse_matmul_bias: bool = False,
                 mp_group=None, name: Optional[str] = None, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.is_mp = True
        self.weight = keep_part(
            _draw(weight_attr or XavierNormal(), [in_features, out_features],
                  device, dtype, generator), 1, self.group, (None, "mp"))
        self.bias = keep_part(nn.Parameter(torch.zeros(
            out_features, device=self.weight.device, dtype=dtype)), 0,
            self.group, ("mp",)) if has_bias else None

    def forward(self, x):
        if self.group is None:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(_c_identity(x, self.group), self.weight, self.bias)
        return _c_concat(out, self.group) if self.gather_output else out


class RowParallelLinear(nn.Module):
    """Weight ``[in, out]`` split by rows over the mp group: the partial
    products are all-reduced, then the bias is added."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None,
                 name: Optional[str] = None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.is_mp = True
        self.weight = keep_part(
            _draw(weight_attr or XavierNormal(), [in_features, out_features],
                  device, dtype, generator), 0, self.group, ("mp", None))
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=self.weight.device, dtype=dtype)) \
            if has_bias else None

    def forward(self, x):
        if self.group is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _c_split(x, self.group)
        return row_parallel_linear(x, self.weight, self.bias, self.group)


class VocabParallelEmbedding(nn.Module):
    """Embedding ``[vocab, hidden]`` split by vocabulary rows."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name: Optional[str] = None,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = keep_part(
            _draw(weight_attr or Normal(0.0, 0.02),
                  [num_embeddings, embedding_dim], device, dtype, generator),
            0, self.group, ("mp", None))

    def forward(self, ids):
        if self.group is None:
            return F.embedding(ids, self.weight)
        return vocab_parallel_embedding(ids, self.weight, self.group)


class ParallelCrossEntropy(nn.Module):
    """Cross-entropy (reduction "none") of vocab-parallel logits."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if self.group is None:
            from ..ops import _nn
            if label.dim() == input.dim():
                label = label.squeeze(-1)
            return _nn.cross_entropy(input, label, reduction="none",
                                     ignore_index=self.ignore_index)
        return vocab_parallel_cross_entropy(input, label, self.group,
                                            self.ignore_index)


# -- sequence parallel (Megatron-SP) --------------------------------------------

def mark_as_sequence_parallel_parameter(parameter):
    """A no-op, as the reference's (its gradient bookkeeping is the
    sequence-parallel axis's, ROADMAP 'Multi-device')."""
    return parameter


def sharding_constraint(x, *spec_entries):
    """A no-op: the reference's activation hint acts only while tracing."""
    return x


class ScatterOp:
    """Enter a sequence-parallel region: this rank's part of dim 1 over
    the mp group (the gradient is all-gathered)."""

    @staticmethod
    def apply(x, group=None):
        g = _mp_group(group)
        return x if g is None else C.scatter_seq(x, g)


class GatherOp:
    """Leave a sequence-parallel region: every rank's part of dim 1 put
    together (the gradient is split back)."""

    @staticmethod
    def apply(x, group=None):
        g = _mp_group(group)
        return x if g is None else C.gather_seq(x, g)
