"""``python -m paddle_tpu_torch.distributed.launch``: start and supervise
a gang of trainer processes, one a card (counterpart of
``paddle_tpu/distributed/launch``)."""
from .controller import Controller, LaunchConfig, free_port
from .main import launch, parse_args

__all__ = ["Controller", "LaunchConfig", "free_port", "launch",
           "parse_args"]
