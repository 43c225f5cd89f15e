"""paddle_tpu_torch.distributed (counterpart of ``paddle_tpu/distributed``):
the process-group runtime (``env``: ranks, ``init_parallel_env``,
``spawn``; ``store``: the TCPStore; ``launch``), the collectives, the
rank topology and ``fleet``, ZeRO stages 1-3 (``sharding``,
``trainer.ShardedTrainStep``) and train-state checkpoints (sharded ones
too) with the ``CheckpointManager``, and tensor-parallel serving's mesh
and plan (``topology.serving_mesh``, ``sharding.TPShardings``, which
``inference.LLMEngine(mesh=)`` takes), and tensor-parallel training
(``parallel_layers``: Megatron's layers over the mp group and the mp
operators of ``collective``; fleet's ``mp_degree``, which
``ShardedTrainStep`` runs over dp x mp x sharding).  One process drives
one card: NCCL on the card, gloo when the caller asks for the CPU.
Pipeline, sequence, context and expert parallelism and ``auto_parallel``
are not ported (ROADMAP 'Multi-device'): they are not exported, and
their knobs raise."""
import torch.distributed as _dist

from . import checkpoint
from . import collective
from . import env
from . import parallel_layers
from . import sharding
from . import strategy
from . import topology
from .checkpoint import (AsyncSaveHandle, CorruptCheckpointError,
                         ShardedArray, get_checkpoint_metadata,
                         load_state_dict, save_state_dict,
                         validate_checkpoint)
from .ckpt_manager import CheckpointManager
from .collective import (ReduceOp, all_gather, all_gather_object,
                         all_reduce, all_to_all, all_to_all_single,
                         alltoall, alltoall_single, barrier, broadcast,
                         broadcast_object_list, destroy_process_group,
                         gather, get_group, irecv, isend, new_group, recv,
                         reduce, reduce_scatter, scatter,
                         scatter_object_list, send, stream, wait)
from .env import ParallelEnv, get_rank, get_world_size, spawn
from .fleet import fleet
from .parallel_layers import (ColumnParallelLinear, GatherOp,
                              ParallelCrossEntropy, RowParallelLinear,
                              ScatterOp, VocabParallelEmbedding,
                              mark_as_sequence_parallel_parameter,
                              sharding_constraint)
from .sharding import ShardingPlan, group_sharded_parallel
from .store import TCPStore
from .strategy import DistributedStrategy
from .topology import CommGroup, HybridCommunicateGroup
from .trainer import ShardedTrainStep


def init_parallel_env(device=None):
    """paddle.distributed.init_parallel_env: join the gang's process
    group (NCCL on this rank's card; ``device="cpu"``: gloo) and lay
    every rank out as data parallel.  Returns fleet's
    ``HybridCommunicateGroup``."""
    return fleet.init(device=device)


def is_initialized() -> bool:
    return _dist.is_available() and _dist.is_initialized()


def get_backend() -> str:
    """The process group's backend: "nccl" or "gloo"."""
    return _dist.get_backend()


__all__ = ["checkpoint", "collective", "env", "parallel_layers",
           "sharding", "strategy",
           "topology", "AsyncSaveHandle", "CorruptCheckpointError",
           "ShardedArray", "get_checkpoint_metadata", "load_state_dict",
           "save_state_dict", "validate_checkpoint", "CheckpointManager",
           "ReduceOp", "all_gather", "all_gather_object", "all_reduce",
           "all_to_all", "all_to_all_single", "alltoall", "alltoall_single",
           "barrier", "broadcast", "broadcast_object_list",
           "destroy_process_group", "gather", "get_group", "irecv", "isend",
           "new_group", "recv", "reduce", "reduce_scatter", "scatter",
           "scatter_object_list", "send", "stream", "wait", "ParallelEnv",
           "get_rank", "get_world_size", "spawn", "fleet", "ShardingPlan",
           "group_sharded_parallel", "TCPStore", "DistributedStrategy",
           "CommGroup", "HybridCommunicateGroup", "ShardedTrainStep",
           "init_parallel_env", "is_initialized", "get_backend",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "ScatterOp",
           "GatherOp", "mark_as_sequence_parallel_parameter",
           "sharding_constraint"]
