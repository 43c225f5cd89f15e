"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``, the
reference's code): Callback/CallbackList, ProgBarLogger,
ModelCheckpoint, EarlyStopping, LRScheduler, VisualDL.  Pure-python
training-loop hooks; nothing here touches the train step."""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "VisualDL", "config_callbacks"]


class Callback:
    """Base class; subclass and override the hooks you need."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train
    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    # eval
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    # predict
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Step/epoch console logging (the reference's ProgBarLogger): the
    values printed are host scalars ``fit`` already read, so logging
    adds no wait for the card."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _fmt(self, logs):
        return " - ".join(f"{k}: {np.asarray(v).item():.4f}"
                          if isinstance(v, (int, float, np.number))
                          or np.ndim(v) == 0 else f"{k}: {v}"
                          for k, v in (logs or {}).items())

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            steps = self.params.get("steps")
            print(f"step {step}/{steps or '?'} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, verbose: int = 1, min_delta: float = 0,
                 baseline: Optional[float] = None,
                 save_best_model: bool = True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = (self.baseline if self.baseline is not None else
                     (-np.inf if self.mode == "max" else np.inf))

    def _better(self, cur):
        if self.mode == "max":
            return cur > self.best + self.min_delta
        return cur < self.best - self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save(
                    os.path.join(self.params["save_dir"], "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: no {self.monitor} improvement "
                          f"in {self.patience} evals")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step or by_epoch)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        assert by_step != by_epoch, "exactly one of by_step/by_epoch"
        self.by_step = by_step

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    # NOTE: CompiledTrainStep already steps the scheduler per call; this
    # callback only drives the by_epoch policy (per-step would
    # double-step).
    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and not self.by_step:
            s.step()


class VisualDL(Callback):
    """Scalar logging to the visualdl-shaped writer (paddle.callbacks
    .VisualDL over ``visualdl.LogWriter``)."""

    def __init__(self, log_dir: str = "./log"):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._step = 0

    def _w(self):
        if self._writer is None:
            from ..visualdl import LogWriter
            self._writer = LogWriter(self.log_dir)
        return self._writer

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            try:
                self._w().add_scalar(f"train/{k}",
                                     float(np.asarray(v).reshape(-1)[0]),
                                     self._step)
            except (TypeError, ValueError):
                pass

    def on_eval_end(self, logs=None):
        for k, v in (logs or {}).items():
            try:
                self._w().add_scalar(f"eval/{k}",
                                     float(np.asarray(v).reshape(-1)[0]),
                                     self._step)
            except (TypeError, ValueError):
                pass

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()


def config_callbacks(callbacks=None, model=None, batch_size=None,
                     epochs=None, steps=None, verbose=2, log_freq=10,
                     save_dir=None, save_freq=1, metrics=None
                     ) -> CallbackList:
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq=save_freq,
                                       save_dir=save_dir)]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"batch_size": batch_size, "epochs": epochs,
                    "steps": steps, "verbose": verbose,
                    "metrics": metrics or [], "save_dir": save_dir})
    return lst
