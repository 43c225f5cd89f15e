"""paddle_tpu_torch.distributed — train-state checkpoints at world size 1
(counterpart of ``paddle_tpu/distributed``'s ``checkpoint`` and
``ckpt_manager``): the reference's on-disk format, atomic commit,
sha256-verified loads, async saves and the step-numbered
``CheckpointManager``.  Meshes, collectives and sharded train steps are
ROADMAP 'Multi-device'."""
from . import checkpoint
from .checkpoint import (AsyncSaveHandle, CorruptCheckpointError,
                         get_checkpoint_metadata, load_state_dict,
                         save_state_dict, validate_checkpoint)
from .ckpt_manager import CheckpointManager

__all__ = ["checkpoint", "AsyncSaveHandle", "CorruptCheckpointError",
           "get_checkpoint_metadata", "load_state_dict", "save_state_dict",
           "validate_checkpoint", "CheckpointManager"]
