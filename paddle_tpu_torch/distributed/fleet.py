"""paddle.distributed.fleet, the hybrid-parallel entry point
(counterpart of ``paddle_tpu/distributed/fleet.py``).

``init`` joins the process group (``env.init_parallel_env``: NCCL on
the card by default, gloo with ``device="cpu"``) and builds the rank
topology from the strategy's degrees; with no degrees given, every rank
is data parallel.  This slice runs data parallelism and ZeRO sharding
(``dp_degree``, ``sharding_degree``); tensor, pipeline, sequence and
expert parallelism raise (ROADMAP 'Multi-device').
``distributed_model`` / ``distributed_optimizer`` attach the topology;
``distributed.trainer.ShardedTrainStep`` does the communication.
"""
from __future__ import annotations

from typing import Optional

from ..common.errors import enforce
from . import env as dist_env
from .strategy import DistributedStrategy
from .topology import HybridCommunicateGroup

__all__ = ["init", "reset", "fleet", "DistributedStrategy",
           "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group", "get_strategy",
           "worker_num", "worker_index", "is_first_worker", "barrier_worker"]

_HCG: Optional[HybridCommunicateGroup] = None
_STRATEGY: Optional[DistributedStrategy] = None

_OUTSIDE = ("mp_degree", "pp_degree", "sep_degree", "ep_degree")


def reset():
    """Forget the topology and strategy (the process group stays up)."""
    global _HCG, _STRATEGY
    _HCG = None
    _STRATEGY = None


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO",
         device=None):
    """fleet.init: join the process group on ``device`` (None: this
    rank's card) and lay the ranks out by ``strategy.hybrid_configs``.
    Returns the ``HybridCommunicateGroup``."""
    global _HCG, _STRATEGY
    strategy = strategy or DistributedStrategy()
    hybrid = strategy.hybrid
    for knob in _OUTSIDE:
        if getattr(hybrid, knob) > 1:
            raise NotImplementedError(
                f"fleet {knob} > 1 (tensor, pipeline, sequence or expert "
                f"parallelism) is not ported yet (ROADMAP 'Multi-device')")
    dist_env.init_parallel_env(device=device)
    n_have = dist_env.get_world_size()
    if hybrid.dp_degree * hybrid.sharding_degree == 1 and n_have > 1:
        # no topology given: every rank is data parallel (persisted, so
        # the strategy agrees with the topology)
        hybrid.dp_degree = n_have
        strategy.hybrid_configs["dp_degree"] = n_have
    _STRATEGY = strategy
    _HCG = HybridCommunicateGroup(hybrid)
    return _HCG


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG


def get_strategy() -> Optional[DistributedStrategy]:
    return _STRATEGY


def distributed_model(model):
    """Attach the topology to the model (the step does the
    communication: no wrapper module)."""
    enforce(_HCG is not None, "fleet.init() first")
    model._hcg = _HCG
    return model


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    enforce(_HCG is not None, "fleet.init() first")
    optimizer._hcg = _HCG
    return optimizer


def worker_num() -> int:
    return dist_env.get_world_size()


def worker_index() -> int:
    return dist_env.get_rank()


def is_first_worker() -> bool:
    return worker_index() == 0


def barrier_worker():
    from .collective import barrier
    barrier()


class _FleetFacade:
    """``paddle.distributed.fleet`` object-style access (fleet.init, ...)"""
    init = staticmethod(init)
    reset = staticmethod(reset)
    distributed_model = staticmethod(distributed_model)
    distributed_optimizer = staticmethod(distributed_optimizer)
    worker_num = staticmethod(worker_num)
    worker_index = staticmethod(worker_index)
    is_first_worker = staticmethod(is_first_worker)
    barrier_worker = staticmethod(barrier_worker)
    get_hybrid_communicate_group = staticmethod(get_hybrid_communicate_group)
    get_strategy = staticmethod(get_strategy)
    DistributedStrategy = DistributedStrategy


fleet = _FleetFacade()
