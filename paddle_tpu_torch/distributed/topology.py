"""The hybrid-parallel topology as a grid of ranks (counterpart of
``paddle_tpu/distributed/topology.py``).

The reference lays its devices out as one ``jax.sharding.Mesh`` with the
axes ``(pp, dp, sharding, ep, sep, mp)`` and lets GSPMD emit the
collectives.  Here one process drives one card, so the same axis order
lays out *ranks*: rank ``r`` sits at the coordinate of ``r`` in a
row-major grid of that shape.  ``HybridCommunicateGroup`` creates one
``torch.distributed`` group for each line of each axis of more than one
rank, Paddle's own design (every rank creates every group, in one
order, as ``new_group`` requires); a line of one rank in a larger world
gets a group with no process group behind it, on which the collectives
are local.  In a world of one rank every group is the world's process
group, so a gang of one runs its collectives through the backend as a
larger gang does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as _dist

from ..common.errors import enforce
from .strategy import HybridConfig

__all__ = ["HybridCommunicateGroup", "CommGroup", "AXES", "rank_grid",
           "serving_mesh"]

AXES = ("pp", "dp", "sharding", "ep", "sep", "mp")


def serving_mesh(tp: int, axis: str = "tp", devices=None):
    """The reference's tensor-parallel serving mesh: not ported."""
    raise NotImplementedError(
        "serving_mesh (tensor-parallel serving) is not ported yet "
        "(ROADMAP 'Multi-device')")


def rank_grid(hybrid: HybridConfig) -> np.ndarray:
    """Ranks in a grid of shape (pp, dp, sharding, ep, sep, mp)."""
    shape = tuple(getattr(hybrid, f"{a}_degree") for a in AXES)
    return np.arange(int(np.prod(shape))).reshape(shape)


class CommGroup:
    """A group of ranks: ``ranks`` (global, in group order), the
    ``torch.distributed`` process group (None for a group of one, where
    collectives are local), ``nranks`` and this process's ``rank`` in
    it (-1 when it is not a member)."""

    def __init__(self, ranks: Sequence[int], pg=None,
                 axis_names: Tuple[str, ...] = (), my_rank: int = 0):
        self.ranks = [int(r) for r in ranks]
        self.pg = pg
        self.axis_names = tuple(axis_names)
        self._my_rank = int(my_rank)

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        return self.ranks.index(self._my_rank) \
            if self._my_rank in self.ranks else -1

    @property
    def is_member(self) -> bool:
        return self._my_rank in self.ranks

    @property
    def axis_name(self):
        return self.axis_names[0] if len(self.axis_names) == 1 \
            else self.axis_names

    def __repr__(self):
        return (f"CommGroup(axes={self.axis_names}, ranks={self.ranks}, "
                f"rank={self.rank})")


def _world_group(my_rank: int, world: int, axes) -> CommGroup:
    return CommGroup(range(world), _dist.group.WORLD, axes, my_rank)


def _line_groups(grid: np.ndarray, axes: Tuple[int, ...], my_rank: int,
                 names: Tuple[str, ...], made: Dict) -> CommGroup:
    """Every rank builds the group of every line of ``grid`` along the
    axes ``axes`` (in one order: ``new_group`` is collective) and keeps
    the one that holds it; a line of ranks some earlier axis already
    has (``made``) reuses its process group."""
    other = [i for i in range(grid.ndim) if i not in axes]
    lines = np.transpose(grid, other + list(axes)).reshape(
        -1, int(np.prod([grid.shape[i] for i in axes])))
    if lines.shape[1] == grid.size:
        return _world_group(my_rank, grid.size, names)
    if lines.shape[1] == 1:
        return CommGroup([my_rank], None, names, my_rank)
    mine = None
    for line in lines:
        ranks = [int(r) for r in line]
        if tuple(ranks) not in made:
            made[tuple(ranks)] = _dist.new_group(ranks)
        pg = made[tuple(ranks)]
        if my_rank in ranks:
            mine = CommGroup(ranks, pg, names, my_rank)
    return mine


class HybridCommunicateGroup:
    """fleet's topology: degrees, this rank's coordinate and one group a
    parallel axis.  Needs the process group to be up (``fleet.init``
    brings it up) with as many ranks as the degrees multiply to."""

    def __init__(self, hybrid: HybridConfig):
        self._hybrid = hybrid
        self.grid = rank_grid(hybrid)
        world = _dist.get_world_size() if _dist.is_initialized() else 1
        my = _dist.get_rank() if _dist.is_initialized() else 0
        enforce(self.grid.size == world,
                f"topology {dict(zip(AXES, self.grid.shape))} needs "
                f"{self.grid.size} ranks, the world has {world}")
        self.coord: Dict[str, int] = dict(zip(
            AXES, (int(c) for c in np.argwhere(self.grid == my)[0])))
        self._groups: Dict[Tuple[str, ...], CommGroup] = {}
        made: Dict[Tuple[int, ...], object] = {}
        for names in [(a,) for a in AXES] + [("dp", "sharding"), AXES]:
            idx = tuple(AXES.index(a) for a in names)
            self._groups[names] = _line_groups(self.grid, idx, my, names,
                                               made)

    def _group(self, *names) -> CommGroup:
        return self._groups[tuple(names)]

    # -- degrees (fleet API names) ------------------------------------------
    def get_data_parallel_world_size(self) -> int:
        return self._hybrid.dp_degree

    def get_model_parallel_world_size(self) -> int:
        return self._hybrid.mp_degree

    def get_pipe_parallel_world_size(self) -> int:
        return self._hybrid.pp_degree

    def get_sharding_parallel_world_size(self) -> int:
        return self._hybrid.sharding_degree

    def get_sep_parallel_world_size(self) -> int:
        return self._hybrid.sep_degree

    def get_expert_parallel_world_size(self) -> int:
        return self._hybrid.ep_degree

    # -- this rank's coordinate ---------------------------------------------
    def get_data_parallel_rank(self) -> int:
        return self.coord["dp"]

    def get_sharding_parallel_rank(self) -> int:
        return self.coord["sharding"]

    def data_coordinate(self) -> Tuple[int, int]:
        """(index, count) of this rank's slice of the global batch: the
        batch splits over (dp, sharding), dp major."""
        s = self._hybrid.sharding_degree
        return (self.coord["dp"] * s + self.coord["sharding"],
                self._hybrid.dp_degree * s)

    # -- groups --------------------------------------------------------------
    def get_data_parallel_group(self) -> CommGroup:
        return self._group("dp")

    def get_model_parallel_group(self) -> CommGroup:
        return self._group("mp")

    def get_pipe_parallel_group(self) -> CommGroup:
        return self._group("pp")

    def get_sharding_parallel_group(self) -> CommGroup:
        return self._group("sharding")

    def get_sep_parallel_group(self) -> CommGroup:
        return self._group("sep")

    def get_expert_parallel_group(self) -> CommGroup:
        if self._hybrid.ep_degree > 1:
            return self._group("ep")
        # expert parallelism folds onto dp x sharding (DeepSpeed-MoE)
        return self._group("dp", "sharding")

    def get_data_sharding_group(self) -> CommGroup:
        """The ranks that split the batch: dp x sharding."""
        return self._group("dp", "sharding")

    def get_check_parallel_group(self) -> CommGroup:
        return self._group(*AXES)

    def data_axes(self) -> Tuple[str, ...]:
        return ("dp", "sharding")

    def topology(self) -> Dict[str, int]:
        return dict(zip(AXES, self.grid.shape))
