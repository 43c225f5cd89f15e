"""Paddle's eager collective API over ``torch.distributed`` (counterpart
of ``paddle_tpu/distributed/collective.py``).

Each rank is one process, so these are the reference's multi-process
semantics (``jax.process_count() > 1``): every rank contributes its own
tensor, and a non-member of the group gets its tensor back as it was.
Tensors are reduced, broadcast and scattered in place where Paddle does
so and returned; numpy inputs become tensors on this rank's device.  A
group is a ``CommGroup`` (``new_group``, fleet's topology), a
topology axis name, or None for the whole world.  A group with no
process group (one rank of a larger world) runs locally.

The reference's traced forms (``psum``, ``pmean``, ``pmax`` inside
``shard_map``) are the eager reductions over the group here.
Point-to-point transfers (``send`` / ``recv`` / ``isend`` / ``irecv``,
``ppermute``) and ``axis_index`` raise: pipeline parallelism brings
them (ROADMAP 'Multi-device').

The tensor-parallel (mp) operators are autograd functions over a
group, with the names of upstream Paddle's ``mp_ops``: ``_c_identity``
(identity forward, all-reduce of the gradient), ``_mp_allreduce``
(all-reduce forward, identity backward), ``_c_split`` / ``_c_concat``
(this rank's part of the last dim / every rank's parts put together)
and ``scatter_seq`` / ``gather_seq``, the same pair on dim 1 (the
sequence).  The reference's GSPMD program emits these collectives
itself; here ``parallel_layers`` and the models call them.  Each call
that reaches a backend is counted into every counter that
``count_mp`` has open (a ``ShardedTrainStep``'s ``comm``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as _dist

from ..common.errors import enforce
from .topology import CommGroup

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_gather_concat",
           "reduce_scatter", "all_to_all", "alltoall", "broadcast",
           "scatter", "reduce",
           "barrier", "new_group", "get_group", "send", "recv", "isend",
           "irecv", "wait", "all_to_all_single", "alltoall_single",
           "gather", "destroy_process_group", "all_gather_object",
           "broadcast_object_list", "scatter_object_list", "psum", "pmean",
           "pmax", "ppermute", "axis_index", "stream", "count_mp",
           "mp_all_reduce_", "mp_all_gather", "_c_identity",
           "_mp_allreduce", "_c_split", "_c_concat", "scatter_seq",
           "gather_seq"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: _dist.ReduceOp.SUM,
              ReduceOp.MAX: _dist.ReduceOp.MAX,
              ReduceOp.MIN: _dist.ReduceOp.MIN,
              ReduceOp.PROD: _dist.ReduceOp.PRODUCT}

_GROUPS: Dict[int, CommGroup] = {}


def _world() -> CommGroup:
    enforce(_dist.is_available() and _dist.is_initialized(),
            "call paddle.distributed.init_parallel_env() (or fleet.init()) "
            "before collectives")
    return CommGroup(range(_dist.get_world_size()), _dist.group.WORLD, (),
                     _dist.get_rank())


def _group(group) -> CommGroup:
    if group is None:
        return _world()
    if isinstance(group, CommGroup):
        return group
    if isinstance(group, (str, tuple)):
        from .fleet import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        enforce(hcg is not None, "fleet.init() first")
        return hcg._group(*((group,) if isinstance(group, str) else group))
    raise TypeError(f"not a group: {group!r}")


def _device() -> torch.device:
    from . import env
    return env.get_device() or torch.device("cpu")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=_device())


def _is_nccl(g: CommGroup) -> bool:
    return g.pg is not None and _dist.get_backend(g.pg) == "nccl"


def _divide(t: torch.Tensor, n: int) -> None:
    if t.is_floating_point() or t.is_complex():
        t.div_(n)
    else:
        t.copy_(torch.div(t, n, rounding_mode="floor"))


def _reduce_(t: torch.Tensor, op, g: CommGroup) -> torch.Tensor:
    enforce(op in _TORCH_OPS or op == ReduceOp.AVG,
            f"unsupported ReduceOp {op!r}")
    if g.pg is None:
        return t
    if op == ReduceOp.AVG:
        if _is_nccl(g):
            _dist.all_reduce(t, _dist.ReduceOp.AVG, group=g.pg)
        else:
            _dist.all_reduce(t, _dist.ReduceOp.SUM, group=g.pg)
            _divide(t, g.nranks)
        return t
    _dist.all_reduce(t, _TORCH_OPS[op], group=g.pg)
    return t


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def new_group(ranks: Optional[List[int]] = None, backend=None,
              axis: Optional[Union[str, Sequence[str]]] = None) -> CommGroup:
    """paddle.distributed.new_group.  ``axis`` names a topology axis (or
    axes) of ``fleet.init``'s groups; ``ranks`` a subset of the world
    (every rank must call this, members or not, in one order); neither,
    or every rank, is the world."""
    if axis is not None:
        g = _group(axis if isinstance(axis, str) else tuple(axis))
    else:
        world = _world()
        if ranks is None or sorted(ranks) == world.ranks:
            g = world
        else:
            ranks = sorted(int(r) for r in ranks)
            enforce(all(0 <= r < world.nranks for r in ranks),
                    f"new_group ranks {ranks} outside the world of "
                    f"{world.nranks}")
            pg = _dist.new_group(ranks) if len(ranks) > 1 else None
            g = CommGroup(ranks, pg, (), _dist.get_rank())
    _GROUPS[id(g)] = g
    return g


def get_group(gid=None) -> CommGroup:
    """The group registered under ``gid`` (``id(group)``), else the
    world."""
    return _GROUPS.get(gid) or _world()


def destroy_process_group(group=None):
    """Tear down ``group``'s process group, or with None every group,
    the world's process group, fleet's topology and the store."""
    if group is not None:
        _GROUPS.pop(id(group), None)
        if group.pg is not None and group.pg is not _dist.group.WORLD:
            _dist.destroy_process_group(group.pg)
        return
    _GROUPS.clear()
    from . import env, fleet
    fleet.reset()
    if _dist.is_available() and _dist.is_initialized():
        _dist.destroy_process_group()
    env._reset()


# ---------------------------------------------------------------------------
# reductions, gathers, scatters
# ---------------------------------------------------------------------------

def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op: bool = True):
    """Reduce ``tensor`` over the group, in place; returns it."""
    g = _group(group)
    if not g.is_member:
        return tensor
    return _reduce_(_as_tensor(tensor), op, g)


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None,
           sync_op: bool = True):
    """paddle.distributed.reduce: ``dst`` gets the reduction.  As in the
    reference, every member gets it."""
    return all_reduce(tensor, op, group, sync_op)


def _gather_list(t: torch.Tensor, g: CommGroup) -> List[torch.Tensor]:
    if g.pg is None:
        return [t.clone()]
    out = [torch.empty_like(t) for _ in range(g.nranks)]
    _dist.all_gather(out, t.contiguous(), group=g.pg)
    return out


def all_gather(tensor_or_list, tensor=None, group=None,
               sync_op: bool = True):
    """Both signatures: Paddle's ``all_gather(tensor_list, tensor)``
    (the list is extended with every member's tensor, in group order)
    and the functional ``out = all_gather(tensor)`` (them concatenated
    on dim 0)."""
    g = _group(group)
    if isinstance(tensor_or_list, list) and tensor is not None:
        t = _as_tensor(tensor)
        tensor_or_list.extend(_gather_list(t, g) if g.is_member else
                              [t])
        return None
    t = _as_tensor(tensor_or_list)
    if not g.is_member:
        return t
    return torch.cat(_gather_list(t, g), dim=0)


def all_gather_concat(x: torch.Tensor, dim: int, group=None
                      ) -> torch.Tensor:
    """Every member's ``x`` (one shape and dtype on every member)
    concatenated on ``dim`` in group order, the tensor-parallel
    engine's gather.  c10d gathers on dim 0: one
    ``all_gather_into_tensor`` into a flat buffer of ``n`` parts, then
    one copy that moves the part axis beside ``dim`` (none when ``dim``
    is 0 or the group holds one rank).  The copy is kept rather than
    reordering the consuming weight's rows at load, which would turn the
    next product into a sum over parts in another order than one card's:
    the gathered rows are what a single card's product reads."""
    g = _group(group)
    x = x.contiguous()
    n = g.nranks
    flat = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    if g.pg is None:
        flat.copy_(x.view(-1))
    else:
        _dist.all_gather_into_tensor(flat, x.view(-1), group=g.pg)
    d = dim % x.dim()
    buf = flat.view((n,) + tuple(x.shape))
    shape = x.shape[:d] + (n * x.shape[d],) + x.shape[d + 1:]
    return buf.movedim(0, d).reshape(shape)


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None,
                   sync_op: bool = True):
    """The functional form (the reference's): reduce ``tensor`` over the
    group and return this member's chunk of dim 0.  Paddle's list form,
    ``reduce_scatter(out, tensor_list, op)``, reduces member ``i``'s
    share ``tensor_list[i]`` into ``out`` in place."""
    if isinstance(op, (list, tuple)):
        out, parts = tensor, [_as_tensor(p) for p in op]
        g = _group(group)
        if not g.is_member:
            return out
        red = reduce_scatter(torch.cat([p.reshape(-1) for p in parts]),
                             group=g)
        out.copy_(red.view_as(out))
        return out
    g = _group(group)
    t = _as_tensor(tensor)
    if not g.is_member:
        return t
    n = g.nranks
    enforce(t.shape[0] % n == 0,
            f"reduce_scatter: dim 0 ({t.shape[0]}) is not a multiple of "
            f"the group's {n} ranks")
    if g.pg is None:
        return t.clone()
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    if op == ReduceOp.AVG and not _is_nccl(g):
        _dist.reduce_scatter_tensor(out, t.contiguous(),
                                    _dist.ReduceOp.SUM, group=g.pg)
        _divide(out, n)
        return out
    _dist.reduce_scatter_tensor(
        out, t.contiguous(), _dist.ReduceOp.AVG if op == ReduceOp.AVG
        else _TORCH_OPS[op], group=g.pg)
    return out


def _all_to_all(t: torch.Tensor, g: CommGroup) -> torch.Tensor:
    enforce(t.shape[0] % g.nranks == 0,
            f"all_to_all: dim 0 ({t.shape[0]}) is not a multiple of the "
            f"group's {g.nranks} ranks")
    if g.pg is None:
        return t.clone()
    out = torch.empty_like(t)
    _dist.all_to_all_single(out, t.contiguous(), group=g.pg)
    return out


def all_to_all(out_tensor_list, in_tensor_list=None, group=None,
               sync_op: bool = True):
    """Paddle's list form (member ``j`` gets ``in_tensor_list[j]``;
    ``out_tensor_list`` is extended with what each member sent) and the
    functional form on one tensor split on dim 0."""
    g = _group(group)
    if in_tensor_list is None:
        t = _as_tensor(out_tensor_list)
        return _all_to_all(t, g) if g.is_member else t
    parts = [_as_tensor(p) for p in in_tensor_list]
    if not g.is_member:
        out_tensor_list.extend(parts)
        return None
    enforce(len(parts) == g.nranks,
            f"all_to_all needs one tensor a member ({g.nranks}), got "
            f"{len(parts)}")
    shape = parts[0].shape
    got = _all_to_all(torch.stack(parts), g)
    out_tensor_list.extend(got[i].reshape(shape) for i in range(g.nranks))
    return None


alltoall = all_to_all


def all_to_all_single(out_tensor, in_tensor, out_split_sizes=None,
                      in_split_sizes=None, group=None,
                      sync_op: bool = True):
    """One-tensor all-to-all with equal splits (as the reference's:
    ragged exchange is expert parallelism's, ROADMAP 'Multi-device');
    the result lands in ``out_tensor`` where it has the shape."""
    enforce(out_split_sizes is None and in_split_sizes is None,
            "all_to_all_single takes equal splits; a ragged exchange is "
            "expert parallelism's (ROADMAP 'Multi-device')")
    res = all_to_all(in_tensor, group=group, sync_op=sync_op)
    if isinstance(out_tensor, torch.Tensor) and \
            out_tensor.shape == res.shape:
        out_tensor.copy_(res)
        return out_tensor
    return res


alltoall_single = all_to_all_single


def broadcast(tensor, src: int = 0, group=None, sync_op: bool = True):
    """``src``'s (global rank) tensor into every member's, in place."""
    g = _group(group)
    t = _as_tensor(tensor)
    if not g.is_member or g.pg is None:
        return t
    enforce(src in g.ranks, f"broadcast src {src} not in group {g.ranks}")
    _dist.broadcast(t, src=src, group=g.pg)
    return t


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op: bool = True):
    """Member ``i`` gets ``src``'s ``tensor_list[i]`` in ``tensor``."""
    g = _group(group)
    t = _as_tensor(tensor)
    if not g.is_member:
        return t
    enforce(src in g.ranks, f"scatter src {src} not in group {g.ranks}")
    parts = None
    if _dist.get_rank() == src:
        parts = [_as_tensor(p).to(t.dtype).contiguous()
                 for p in tensor_list]
        enforce(len(parts) == g.nranks,
                f"scatter needs one tensor a member ({g.nranks}), got "
                f"{len(parts)}")
    if g.pg is None:
        t.copy_(parts[0])
        return t
    _dist.scatter(t, parts, src=src, group=g.pg)
    return t


def gather(tensor, gather_list=None, dst: int = 0, group=None,
           sync_op: bool = True):
    """``dst`` gets every member's tensor; as in the reference, every
    member does."""
    if gather_list is None:
        gather_list = []
    all_gather(gather_list, tensor, group)
    return gather_list


def barrier(group=None):
    g = _group(group)
    if g.is_member and g.pg is not None:
        if _is_nccl(g):
            _dist.barrier(group=g.pg,
                          device_ids=[torch.cuda.current_device()])
        else:
            _dist.barrier(group=g.pg)


def wait(tensor, group=None, use_calc_stream: bool = True):
    """Collectives here return when issued on the stream: wait for the
    tensor's device to finish them."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def _p2p(name):
    raise NotImplementedError(
        f"point-to-point {name} is not ported yet: pipeline parallelism "
        f"brings it (ROADMAP 'Multi-device')")


def send(tensor, dst: int, group=None, sync_op: bool = True):
    _p2p("send")


def recv(tensor, src: int, group=None, sync_op: bool = True):
    _p2p("recv")


def isend(tensor, dst: int, group=None):
    _p2p("isend")


def irecv(tensor, src: int, group=None):
    _p2p("irecv")


# -- the reference's traced primitives, eager here ---------------------------

def psum(x, group):
    return all_reduce(_as_tensor(x).clone(), ReduceOp.SUM, group)


def pmean(x, group):
    return all_reduce(_as_tensor(x).clone(), ReduceOp.AVG, group)


def pmax(x, group):
    return all_reduce(_as_tensor(x).clone(), ReduceOp.MAX, group)


def ppermute(x, group, perm):
    _p2p("ppermute")


def axis_index(group):
    raise NotImplementedError(
        "axis_index (a traced mesh coordinate) has no eager counterpart: "
        "use the group's rank (ROADMAP 'Multi-device')")


# -- tensor-parallel (mp) operators ---------------------------------------------

_MP_COUNTERS: List[Dict[str, int]] = []


@contextlib.contextmanager
def count_mp(comm: Dict[str, int]):
    """While the block runs, each mp collective that reaches a backend
    adds one to ``comm["collectives"]`` and ``comm["mp_collectives"]``
    and its input's bytes to ``comm["bytes"]`` and ``comm["mp_bytes"]``.
    Yields ``comm``."""
    for k in ("collectives", "bytes", "mp_collectives", "mp_bytes"):
        comm.setdefault(k, 0)
    _MP_COUNTERS.append(comm)
    try:
        yield comm
    finally:
        _MP_COUNTERS.remove(comm)


def _count(t: torch.Tensor) -> None:
    n = t.numel() * t.element_size()
    for c in _MP_COUNTERS:
        c["collectives"] += 1
        c["mp_collectives"] += 1
        c["bytes"] += n
        c["mp_bytes"] += n


def mp_all_reduce_(t: torch.Tensor, g: CommGroup, op=ReduceOp.SUM
                   ) -> torch.Tensor:
    """``t`` reduced over the mp group ``g`` in place (counted); a group
    with no process group leaves it as it is."""
    if g.pg is None:
        return t
    _count(t)
    _dist.all_reduce(t, _TORCH_OPS[op], group=g.pg)
    return t


def mp_all_gather(x: torch.Tensor, dim: int, g: CommGroup) -> torch.Tensor:
    """Every member's ``x`` put together on ``dim`` (counted)."""
    if g.pg is None:
        return x
    _count(x)
    return all_gather_concat(x, dim, g)


def _part(x: torch.Tensor, dim: int, g: CommGroup) -> torch.Tensor:
    """This member's contiguous part of ``x`` on ``dim``."""
    n = x.shape[dim]
    enforce(n % g.nranks == 0,
            f"dim {dim} of {tuple(x.shape)} does not split over the mp "
            f"group's {g.nranks} ranks")
    k = n // g.nranks
    return x.narrow(dim, g.rank * k, k).contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return mp_all_reduce_(dy.contiguous().clone(), ctx.g), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return mp_all_reduce_(x.contiguous().clone(), g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _part(x, dim, g)

    @staticmethod
    def backward(ctx, dy):
        return mp_all_gather(dy.contiguous(), ctx.dim, ctx.g), None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return mp_all_gather(x.contiguous(), dim, g)

    @staticmethod
    def backward(ctx, dy):
        return _part(dy, ctx.dim, ctx.g), None, None


def _c_identity(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """Identity; the gradient is all-reduced over ``group`` (a column-
    parallel layer's input)."""
    return _Identity.apply(x, group)


def _mp_allreduce(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """The sum over ``group``; the gradient passes as it is (a
    row-parallel layer's output)."""
    return _AllReduce.apply(x, group)


def _c_split(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """This rank's part of the last dim; the gradient is all-gathered."""
    return _Split.apply(x, x.dim() - 1, group)


def _c_concat(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """Every rank's part of the last dim put together in rank order; the
    gradient is split back."""
    return _Concat.apply(x, x.dim() - 1, group)


def scatter_seq(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """This rank's part of the sequence (dim 1): a sequence-parallel
    region's entry (``parallel_layers.ScatterOp``)."""
    return _Split.apply(x, 1, group)


def gather_seq(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """The whole sequence (dim 1) from every rank's part: a
    sequence-parallel region's exit (``parallel_layers.GatherOp``)."""
    return _Concat.apply(x, 1, group)


# -- object collectives --------------------------------------------------------

def all_gather_object(object_list, obj, group=None):
    """Extend ``object_list`` with every member's ``obj``."""
    g = _group(group)
    if not g.is_member or g.pg is None:
        object_list.append(obj)
        return object_list
    out = [None] * g.nranks
    _dist.all_gather_object(out, obj, group=g.pg)
    object_list.extend(out)
    return object_list


def broadcast_object_list(object_list, src: int = 0, group=None):
    """``src``'s list (of any length) replaces every member's, in
    place."""
    g = _group(group)
    if not g.is_member or g.pg is None:
        return object_list
    enforce(src in g.ranks, f"broadcast src {src} not in group {g.ranks}")
    holder = [list(object_list)]
    _dist.broadcast_object_list(holder, src=src, group=g.pg)
    object_list[:] = holder[0]
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Each member receives ``src``'s ``in_object_list[its group
    rank]``."""
    g = _group(group)
    enforce(g.is_member, f"rank {_dist.get_rank()} is not a member of "
                         f"group {g.ranks}")
    src_list = list(in_object_list) if in_object_list is not None else []
    broadcast_object_list(src_list, src=src, group=g)
    enforce(g.rank < len(src_list),
            f"scatter_object_list needs one object per group rank: got "
            f"{len(src_list)} for rank {g.rank}")
    out_object_list[:] = [src_list[g.rank]]
    return out_object_list


class stream:
    """paddle.distributed.stream.*: the same collectives."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    alltoall = staticmethod(all_to_all)
