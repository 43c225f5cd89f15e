"""ZeRO stage 1-3 planning (counterpart of
``paddle_tpu/distributed/sharding.py``).

The reference turns each stage into static sharding specs on its mesh:
stage 1/2 keep the parameters replicated over the ``sharding`` axis and
shard the optimizer moments; stage 3 shards the parameters themselves.
A leaf is sharded on the largest dim the sharding degree divides that
is not sharded yet (``_shardable_dim``); a leaf with no such dim stays
replicated (it is not padded).  The plan here computes the same dims
(so a checkpoint's chunk boxes equal the reference's) and slices this
rank's part: the ``sharding`` coordinate ``s`` of ``n`` holds rows
``[s * d / n, (s + 1) * d / n)`` of the sharded dim ``d``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["ShardingPlan", "plan_param_spec", "group_sharded_parallel",
           "TPShardings", "shard_slice", "shard_boxes"]

_AXIS = "sharding"


class TPShardings:
    """The reference's tensor-parallel serving plan: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TPShardings (tensor-parallel serving) is not ported yet "
            "(ROADMAP 'Multi-device')")


def _shardable_dim(shape: Tuple[int, ...], size: int,
                   taken: Tuple[Optional[object], ...]) -> Optional[int]:
    """Largest dim divisible by ``size`` that is not already sharded."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if taken[i] is None and shape[i] % size == 0 and shape[i] >= size:
            return i
    return None


def plan_param_spec(shape, degree: int, stage: int
                    ) -> Tuple[Optional[str], ...]:
    """The parameter's spec, one entry a dim (``"sharding"`` or None):
    at stage 3 and a degree above 1 the shardable dim is sharded."""
    base: List[Optional[str]] = [None] * len(shape)
    if stage >= 3 and degree > 1:
        dim = _shardable_dim(tuple(shape), degree, tuple(base))
        if dim is not None:
            base[dim] = _AXIS
    return tuple(base)


def _slot_spec(param_spec, shape, degree: int, stage: int
               ) -> Tuple[Optional[str], ...]:
    """An optimizer moment's spec: the parameter's, plus (any stage) the
    sharding axis where the parameter is replicated."""
    base = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if stage >= 1 and degree > 1 and _AXIS not in base:
        dim = _shardable_dim(tuple(shape), degree, tuple(base))
        if dim is not None:
            base[dim] = _AXIS
    return tuple(base)


def _dim(spec) -> Optional[int]:
    return spec.index(_AXIS) if _AXIS in spec else None


def shard_slice(t: torch.Tensor, dim: Optional[int], index: int,
                count: int) -> torch.Tensor:
    """Part ``index`` of ``count`` of ``t`` on ``dim`` (the whole of
    ``t`` when ``dim`` is None), as a view."""
    if dim is None:
        return t
    n = t.shape[dim] // count
    return t.narrow(dim, index * n, n)


def shard_boxes(shape, dim: Optional[int], count: int
                ) -> List[Tuple[Tuple[int, int], ...]]:
    """The index boxes of the ``count`` parts of an array of ``shape``
    sharded on ``dim``, in part order (one whole box when ``dim`` is
    None)."""
    whole = [(0, int(d)) for d in shape]
    if dim is None:
        return [tuple(whole)]
    n = int(shape[dim]) // count
    out = []
    for i in range(count):
        box = list(whole)
        box[dim] = (i * n, (i + 1) * n)
        out.append(tuple(box))
    return out


class ShardingPlan:
    """The sharded dims of every parameter and its optimizer slots, for
    ``stage`` over a sharding degree (``degree``, this rank's coordinate
    ``index`` on that axis)."""

    def __init__(self, model, degree: int = 1, stage: int = 1,
                 index: int = 0):
        self.model = model
        self.degree = int(degree)
        self.stage = int(stage)
        self.index = int(index)
        self.param_specs: Dict[str, Tuple[Optional[str], ...]] = {}
        self.slot_specs: Dict[str, Tuple[Optional[str], ...]] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            spec = plan_param_spec(shape, self.degree, self.stage)
            self.shapes[name] = shape
            self.param_specs[name] = spec
            self.slot_specs[name] = _slot_spec(spec, shape, self.degree,
                                               self.stage)

    @classmethod
    def for_topology(cls, model, hcg, stage: int) -> "ShardingPlan":
        return cls(model, hcg.get_sharding_parallel_world_size(), stage,
                   hcg.get_sharding_parallel_rank())

    def param_dim(self, name: str) -> Optional[int]:
        return _dim(self.param_specs[name])

    def slot_dim(self, name: str) -> Optional[int]:
        return _dim(self.slot_specs[name])

    def local(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """A copy of this rank's part of ``t`` on ``dim`` (``t`` itself
        when ``dim`` is None): it holds none of ``t``'s storage, so the
        whole of ``t`` can be freed."""
        return t if dim is None else shard_slice(
            t, dim, self.index, self.degree).clone(
                memory_format=torch.contiguous_format)

    def shard_state(self, state):
        """The train state with every sharded parameter (stage 3) and
        slot replaced by this rank's part."""
        params = {n: self.local(t.detach(), self.param_dim(n))
                  if self.param_dim(n) is not None else t
                  for n, t in state["params"].items()}
        slots = {n: {k: self.local(v, self.slot_dim(n))
                     for k, v in s.items()}
                 for n, s in state["opt"]["slots"].items()}
        return {"params": params,
                "opt": {"slots": slots, "step": state["opt"]["step"]}}


def group_sharded_parallel(model, optimizer, level: str = "os_g",
                           scaler=None, group=None, offload=False,
                           sync_buffers=False, buffer_max_size=2 ** 23,
                           segment_size=2 ** 20, sync_comm=False):
    """paddle.distributed.sharding.group_sharded_parallel: level 'os' is
    stage 1, 'os_g' stage 2, 'p_g_os' stage 3.  Returns (model,
    optimizer, scaler) with the stage attached; ``ShardedTrainStep``
    reads ``model._sharding_stage``."""
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}[level]
    model._sharding_stage = stage
    optimizer._sharding_stage = stage
    return model, optimizer, scaler
