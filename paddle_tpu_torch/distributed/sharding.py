"""ZeRO stage 1-3 planning (counterpart of
``paddle_tpu/distributed/sharding.py``).

The reference turns each stage into static sharding specs on its mesh:
stage 1/2 keep the parameters replicated over the ``sharding`` axis and
shard the optimizer moments; stage 3 shards the parameters themselves.
A leaf is sharded on the largest dim the sharding degree divides that
is not sharded yet (``_shardable_dim``); a leaf with no such dim stays
replicated (it is not padded).  A parameter's tensor-parallel
``dist_spec`` (``"mp"`` on a dim) is folded in first, so one leaf may be
split on two dims: mp on one, sharding on another.  The plan here
computes the same dims (so a checkpoint's chunk boxes equal the
reference's) and slices this rank's part: the ``sharding`` coordinate
``s`` of ``n`` holds rows ``[s * d / n, (s + 1) * d / n)`` of the
sharded dim ``d``, of the mp part this rank holds.
``TPShardings`` is the tensor-parallel serving plan over a serving mesh.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..common.errors import enforce

__all__ = ["ShardingPlan", "plan_param_spec", "group_sharded_parallel",
           "TPShardings", "shard_slice", "shard_boxes", "part_boxes"]

_AXIS = "sharding"


class TPShardings:
    """The tensor-parallel serving plan over a 1-D serving mesh (the
    reference's ``TPShardings``; ``topology.serving_mesh`` builds the
    mesh).

    The reference commits arrays onto its mesh (``put``) and constrains
    traced values (``constrain``); with one process a card its two
    halves are this rank's part of a weight and an eager all-gather:

    - ``put(w, dim)``: a contiguous copy of this rank's slice of ``w``
      on ``dim`` (rank ``r`` of ``tp`` holds ``[r * n / tp, (r + 1) * n
      / tp)``), on ``device`` when given; the whole of ``w`` where
      ``dim`` is None or ``tp`` does not divide ``w.shape[dim]`` (the
      reference's ``_put``).  An int8 ``(values, scales)`` pair is
      sliced together.  Where the slice is the whole tensor on its own
      device and contiguous, ``w``'s own storage comes back (nothing is
      copied).
    - ``gather(x, dim)``: every rank's ``x`` concatenated on ``dim``
      (``collective.all_gather_concat``): moves bits and adds no floats,
      so every product downstream runs whole on one rank.  ``comm``
      counts the gathers and the bytes this rank sent.

    Equal plans hash alike (the mesh's ranks and axis)."""

    __slots__ = ("mesh", "axis", "comm")

    def __init__(self, mesh, axis: str = "tp"):
        from .topology import ServingMesh
        enforce(isinstance(mesh, ServingMesh),
                f"mesh must be a serving mesh "
                f"(paddle.distributed.topology.serving_mesh), got "
                f"{type(mesh).__name__}")
        self.mesh = mesh
        self.axis = axis
        self.comm = {"gathers": 0, "bytes": 0}

    @property
    def tp(self) -> int:
        return self.mesh.shape.get(self.axis, 1)

    @property
    def rank(self) -> int:
        """This process's index on the mesh (-1 outside it)."""
        return self.mesh.rank

    @property
    def group(self):
        return self.mesh

    def put(self, w, dim: Optional[int] = None, device=None):
        if isinstance(w, tuple):
            return tuple(self.put(a, dim, device) for a in w)
        if w is None:
            return None
        if dim is not None and w.shape[dim] % self.tp == 0:
            w = shard_slice(w, dim % w.dim(), self.rank, self.tp)
        w = w.detach()
        if device is not None:
            w = w.to(device)
        return w.contiguous()

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        from .collective import all_gather_concat
        self.comm["gathers"] += 1
        self.comm["bytes"] += x.numel() * x.element_size()
        return all_gather_concat(x, dim, self.mesh)

    def __hash__(self):
        return hash((tuple(self.mesh.ranks), self.mesh.axis_names,
                     self.axis))

    def __eq__(self, other):
        return (isinstance(other, TPShardings)
                and self.mesh.ranks == other.mesh.ranks
                and self.mesh.axis_names == other.mesh.axis_names
                and self.axis == other.axis)

    def __repr__(self):
        return f"TPShardings(tp={self.tp}, axis={self.axis!r})"


def _shardable_dim(shape: Tuple[int, ...], size: int,
                   taken: Tuple[Optional[object], ...]) -> Optional[int]:
    """Largest dim divisible by ``size`` that is not already sharded."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if taken[i] is None and shape[i] % size == 0 and shape[i] >= size:
            return i
    return None


def plan_param_spec(shape, degree: int, stage: int, dist_spec=None,
                    mp: int = 1) -> Tuple[Optional[str], ...]:
    """The parameter's spec, one entry a dim (``"mp"``, ``"sharding"`` or
    None), from its global ``shape``: the tensor-parallel ``dist_spec``
    entries (``"mp"``) where ``mp`` divides the dim (the reference drops
    an axis a dim cannot divide over), then at stage 3 and a sharding
    degree above 1 the shardable dim among the rest."""
    base: List[Optional[str]] = [None] * len(shape)
    for i, entry in enumerate(tuple(dist_spec or ())[:len(shape)]):
        if entry == "mp" and shape[i] % mp == 0:
            base[i] = "mp"
    if stage >= 3 and degree > 1:
        dim = _shardable_dim(tuple(shape), degree, tuple(base))
        if dim is not None:
            base[dim] = _AXIS
    return tuple(base)


def _slot_spec(param_spec, shape, degree: int, stage: int
               ) -> Tuple[Optional[str], ...]:
    """An optimizer moment's spec: the parameter's, plus (any stage) the
    sharding axis where the parameter is replicated over it."""
    base = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if stage >= 1 and degree > 1 and _AXIS not in base:
        dim = _shardable_dim(tuple(shape), degree, tuple(base))
        if dim is not None:
            base[dim] = _AXIS
    return tuple(base)


def _dim(spec, axis: str = _AXIS) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def shard_slice(t: torch.Tensor, dim: Optional[int], index: int,
                count: int) -> torch.Tensor:
    """Part ``index`` of ``count`` of ``t`` on ``dim`` (the whole of
    ``t`` when ``dim`` is None), as a view."""
    if dim is None:
        return t
    n = t.shape[dim] // count
    return t.narrow(dim, index * n, n)


def part_boxes(shape, cuts) -> List[Tuple[Tuple[int, int], ...]]:
    """The index boxes of an array of ``shape`` cut on several dims:
    ``cuts`` is ``[(dim, count), ...]``; the boxes come in row-major
    order of the cuts (the last cut fastest)."""
    boxes = [[(0, int(d)) for d in shape]]
    for dim, count in cuts:
        n = int(shape[dim]) // count
        out = []
        for box in boxes:
            for i in range(count):
                b = list(box)
                b[dim] = (box[dim][0] + i * n, box[dim][0] + (i + 1) * n)
                out.append(b)
        boxes = out
    return [tuple(b) for b in boxes]


def shard_boxes(shape, dim: Optional[int], count: int
                ) -> List[Tuple[Tuple[int, int], ...]]:
    """The index boxes of the ``count`` parts of an array of ``shape``
    sharded on ``dim``, in part order (one whole box when ``dim`` is
    None)."""
    return part_boxes(shape, [] if dim is None else [(dim, count)])


class ShardingPlan:
    """The sharded dims of every parameter and its optimizer slots, for
    ``stage`` over a sharding degree (``degree``, this rank's coordinate
    ``index`` on that axis) and a tensor-parallel degree ``mp`` (this
    rank's coordinate ``mp_index``).

    A parameter's spec comes from its global shape and its ``dist_spec``
    (``plan_param_spec``).  A parameter that ``fleet.distributed_model``
    cut to this rank's mp part (``mp_part`` set) has a global shape
    ``mp`` times its own on the mp dim; any other is whole.  ``shapes``
    holds the shape this rank keeps before ZeRO sharding (the mp part),
    ``global_shapes`` the whole one."""

    def __init__(self, model, degree: int = 1, stage: int = 1,
                 index: int = 0, mp: int = 1, mp_index: int = 0):
        self.model = model
        self.degree = int(degree)
        self.stage = int(stage)
        self.index = int(index)
        self.mp = int(mp)
        self.mp_index = int(mp_index)
        self.param_specs: Dict[str, Tuple[Optional[str], ...]] = {}
        self.slot_specs: Dict[str, Tuple[Optional[str], ...]] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.global_shapes: Dict[str, Tuple[int, ...]] = {}
        for name, p in model.named_parameters():
            shape = list(p.shape)
            dist_spec = getattr(p, "dist_spec", None)
            cut = getattr(p, "mp_part", False)
            if cut and "mp" in tuple(dist_spec or ()):
                shape[tuple(dist_spec).index("mp")] *= self.mp
            spec = plan_param_spec(tuple(shape), self.degree, self.stage,
                                   dist_spec, self.mp)
            local = list(shape)
            if self.mp > 1 and "mp" in spec:
                local[spec.index("mp")] //= self.mp
            self.global_shapes[name] = tuple(shape)
            self.shapes[name] = tuple(local)
            self.param_specs[name] = spec
            self.slot_specs[name] = _slot_spec(spec, shape, self.degree,
                                               self.stage)

    @classmethod
    def for_topology(cls, model, hcg, stage: int) -> "ShardingPlan":
        return cls(model, hcg.get_sharding_parallel_world_size(), stage,
                   hcg.get_sharding_parallel_rank(),
                   hcg.get_model_parallel_world_size(),
                   hcg.get_model_parallel_rank())

    def param_dim(self, name: str) -> Optional[int]:
        return _dim(self.param_specs[name])

    def slot_dim(self, name: str) -> Optional[int]:
        return _dim(self.slot_specs[name])

    def mp_dim(self, name: str) -> Optional[int]:
        """The dim split over the mp group (None where the parameter is
        whole on every mp rank, and at mp 1)."""
        return _dim(self.param_specs[name], "mp") if self.mp > 1 else None

    def replicated(self, name: str) -> bool:
        """Whole on every rank (neither ZeRO- nor mp-sharded)."""
        return self.param_dim(name) is None and self.mp_dim(name) is None

    def boxes(self, name: str, dim: Optional[int], count: int):
        """(every part's box in the global array, this rank's index among
        them) of a leaf of ``name`` cut on the mp dim and on ``dim`` into
        ``count`` parts (ZeRO's)."""
        cuts, at = [], 0
        md = self.mp_dim(name)
        if md is not None:
            cuts.append((md, self.mp))
            at = self.mp_index
        if dim is not None:
            cuts.append((dim, count))
            at = at * count + self.index
        return part_boxes(self.global_shapes[name], cuts), at

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
