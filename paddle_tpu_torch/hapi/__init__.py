"""paddle.hapi (counterpart of ``paddle_tpu/hapi``): ``Model`` and its
callbacks."""
from . import callbacks
from .callbacks import (Callback, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ProgBarLogger, VisualDL)
from .model import Model

__all__ = ["Model", "callbacks", "Callback", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRScheduler", "VisualDL"]
