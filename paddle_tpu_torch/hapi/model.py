"""paddle.Model — the hapi high-level trainer (counterpart of
``paddle_tpu/hapi/model.py``).

``Model(network).prepare(optimizer, loss, metrics)`` then
``fit/evaluate/predict/save/load`` with the callbacks protocol, over a
``torch.nn.Module``.  ``fit`` drives the port's ``CompiledTrainStep``
(forward, backward, clip and update, the update through the fused
kernel where the optimizer has a fused kind) with the reference's
choices of ``has_aux``, ``fused_step`` and ``grad_norm_tap``; its
checkpoints go through ``distributed.CheckpointManager``.  ``evaluate``
and ``predict`` run the network under ``torch.no_grad()`` in eval mode.

Batches from a loader are CPU tensors: each is copied once to the
network's device (the device of its first parameter) before the step;
a network on the card is never moved.  What crosses back to the host
(``_to_host``: the loss, each metric's ``compute`` output, predictions)
is one device-to-host copy, a wait for the card, a call.  Metrics get
their inputs on the device and their ``update`` in numpy on the host,
as in the reference.
"""
from __future__ import annotations

import os
from typing import Callable, List

import numpy as np
import torch

from ..common.errors import enforce
from ..io.dataloader import DataLoader
from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_host(x):
    """``x`` as a numpy array: one device-to-host copy (and so a wait)
    for a tensor on the card; bfloat16, which numpy cannot hold here,
    comes back widened to float32 (exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _host_tree(tree):
    """Tensors of a nested dict as numpy arrays where numpy holds their
    dtype (the reference pickles its optimizer state's raw arrays);
    bfloat16 tensors stay tensors, which ``framework.io.save`` stores
    as raw bits."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype != torch.bfloat16:
        return tree.detach().cpu().numpy()
    return tree


@torch.no_grad()
def _set_opt_state(step, tree) -> None:
    """Copy an optimizer state (``{"slots": {name: {slot: array}},
    "step": ...}``, numpy arrays or tensors) into ``step.state["opt"]``
    in place, names and shapes checked."""

    def put(dst, src, where):
        if isinstance(dst, dict):
            enforce(isinstance(src, dict) and set(src) == set(dst),
                    f"optimizer state {where}: keys "
                    f"{sorted(src) if isinstance(src, dict) else src!r} "
                    f"vs {sorted(dst)}")
            for k in dst:
                dst[k] = put(dst[k], src[k], f"{where}.{k}")
            return dst
        if isinstance(dst, torch.Tensor):
            t = torch.as_tensor(src)
            enforce(tuple(t.shape) == tuple(dst.shape),
                    f"optimizer state {where}: shape {tuple(t.shape)} vs "
                    f"{tuple(dst.shape)}")
            dst.copy_(t)
            return dst
        return src

    put(step.state["opt"], tree, "opt")


class Model:
    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self._pending_opt_state = None
        self._accum_grads = None
        self._last_train_preds = None
        self._in_fit = False
        self.stop_training = False

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, fused_step: bool = True,
                grad_norm_tap: bool = False):
        # amp_configs: accepted and read by no one, as in the reference
        # (paddle_tpu/hapi/model.py:57); amp is amp.decorate / auto_cast.
        # fused_step: run the step's optimizer update through the fused
        # clip + update (jit/train.py; False keeps the per-leaf loop).
        self._fused_step = bool(fused_step)
        # grad_norm_tap: the step also keeps the f32 global grad norm,
        # which fit feeds to the AnomalySentinel beside the loss.
        self._grad_norm_tap = bool(grad_norm_tap)
        self._optimizer = optimizer
        if loss is not None:
            enforce(callable(loss), "loss must be callable (a Module or fn)")
        self._loss = loss
        # re-preparing drops the train step: optimizer, loss and metrics
        # (the has_aux choice) are built into it.  If the OPTIMIZER
        # object is unchanged, its state carries over into the rebuilt
        # step.
        if self._train_step is not None:
            self._train_step.sync_to_model()
            if optimizer is not None and optimizer is getattr(
                    self._train_step, "optimizer", None):
                self._pending_opt_state = self._train_step.state.get(
                    "opt")
            else:
                self._pending_opt_state = None
            self._train_step = None
        self._metrics = _as_list(metrics)
        for m in self._metrics:
            enforce(isinstance(m, Metric),
                    f"metrics must be paddle_tpu_torch.metric.Metric, got "
                    f"{type(m)}")
        return self

    def _device(self) -> torch.device:
        for t in self.network.parameters():
            return t.device
        for t in self.network.buffers():
            return t.device
        return torch.device("cpu")

    def _to_device(self, items):
        """Each tensor or array of ``items`` (a list) on the network's
        device: one host-to-device copy for each that is not there."""
        dev = self._device()
        out = []
        for x in items:
            if isinstance(x, torch.Tensor):
                x = x.to(dev)
            elif isinstance(x, (np.ndarray, np.generic, int, float)):
                x = torch.as_tensor(x, device=dev)
            out.append(x)
        return out

    def _batch(self, inputs, labels):
        return {"inputs": tuple(self._to_device(_as_list(inputs))),
                "labels": tuple(self._to_device(_as_list(labels)))}

    def _loss_fn(self, net, batch):
        ins, labs = batch["inputs"], batch["labels"]
        out = net(*ins)
        outs = _as_list(out)
        return self._loss(*(outs + list(labs)))

    def _loss_fn_aux(self, net, batch):
        """(loss, predictions) of one forward: with metrics configured,
        train metrics come from the same pre-update forward as the loss
        (paddle semantics), not from a second eval pass."""
        ins, labs = batch["inputs"], batch["labels"]
        out = net(*ins)
        outs = _as_list(out)
        return self._loss(*(outs + list(labs))), tuple(outs)

    def _ensure_train_step(self):
        if self._train_step is None:
            enforce(self._optimizer is not None and self._loss is not None,
                    "call prepare(optimizer=..., loss=...) before training")
            from ..jit.train import CompiledTrainStep
            self.network.train()
            fused = getattr(self, "_fused_step", True)
            tap = getattr(self, "_grad_norm_tap", False)
            if self._metrics:
                self._train_step = CompiledTrainStep(
                    self.network, self._loss_fn_aux, self._optimizer,
                    has_aux=True, fused_step=fused, grad_norm_tap=tap)
            else:
                self._train_step = CompiledTrainStep(
                    self.network, self._loss_fn, self._optimizer,
                    fused_step=fused, grad_norm_tap=tap)
            if self._pending_opt_state is not None:
                _set_opt_state(self._train_step, self._pending_opt_state)
                self._pending_opt_state = None
        return self._train_step

    def _run_eval(self, fn: Callable, batch):
        """``fn(network, batch)`` under ``torch.no_grad()`` in eval mode
        (dropout off), independent of the train step: predict and
        evaluate work with no optimizer and never allocate its state.
        The previous mode is restored."""
        was_training = self.network.training
        self.network.eval()
        try:
            with torch.no_grad():
                return fn(self.network, batch)
        finally:
            if was_training:
                self.network.train()

    # -- batch-level API ------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        step = self._ensure_train_step()
        batch = self._batch(inputs, labels)
        if update and self._accum_grads is None:
            out = step(batch)                  # the fused fast path
            if step._has_aux:
                loss, preds = out
                # kept for fit's metrics only: direct train_batch
                # callers must not pin a logits buffer
                self._last_train_preds = preds if self._in_fit else None
                return [_to_host(loss)]
            self._last_train_preds = None
            return [_to_host(out)]
        # paddle update=False semantics: accumulate grads, defer update
        self._last_train_preds = None
        loss, grads = step.grad_step(batch)
        if self._accum_grads is None:
            self._accum_grads = grads
        else:
            self._accum_grads = {n: a + grads[n]
                                 for n, a in self._accum_grads.items()}
        if update:
            step.apply_grads(self._accum_grads)
            self._accum_grads = None
        return [_to_host(loss)]

    def _eval_fn(self, net, batch):
        ins, labs = batch["inputs"], batch["labels"]
        out = net(*ins)
        outs = _as_list(out)
        res = {"preds": outs}
        if self._loss is not None and labs:
            res["loss"] = self._loss(*(outs + list(labs)))
        return res

    def _predict_fn(self, net, batch):
        return _as_list(net(*batch["inputs"]))

    def eval_batch(self, inputs, labels=None):
        return self._run_eval(self._eval_fn, self._batch(inputs, labels))

    def predict_batch(self, inputs):
        batch = self._batch(inputs, None)
        return [_to_host(p) for p in self._run_eval(self._predict_fn, batch)]

    # -- loops ---------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, num_workers,
                drop_last=False):
        from ..io.dataloader import CheckpointableLoader
        if data is None or isinstance(data, (DataLoader,
                                             CheckpointableLoader)):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    @staticmethod
    def _split_batch(batch):
        """DataLoader batches arrive as [x] or [x, y] (or a longer list:
        the LAST item is the label, paddle's single-label convention)."""
        items = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if len(items) == 1:
            return items, []
        return items[:-1], items[-1:]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, checkpoint_dir=None, save_steps=None,
            auto_resume=True):
        """Train.  Crash-safe checkpointing: with ``checkpoint_dir`` set
        (a path, or a configured ``distributed.CheckpointManager`` for
        async saves / custom retention), the FULL training state
        (params, optimizer state, the dropout generator, the LR
        scheduler's and the loader's position) is checkpointed every
        ``save_steps`` optimizer steps (an atomic commit: a kill
        mid-save never leaves a torn checkpoint) and at the end;
        ``auto_resume=True`` restores the latest valid checkpoint before
        the first step and continues where the interrupted run stopped.
        Pass the data as a ``CheckpointableLoader`` for mid-epoch
        exactness (the loader position rides in the checkpoint and the
        resumed loss trajectory is bit-identical to an uninterrupted
        run); with a plain loader, resume restarts the interrupted epoch
        from its first batch.  If ``manager.install_preemption_hook()``
        was armed, a SIGTERM saves and stops cleanly after the step in
        flight."""
        loader = self._loader(train_data, batch_size, shuffle, num_workers,
                              drop_last=drop_last)
        enforce(loader is not None, "fit needs train_data")
        step = self._ensure_train_step()

        manager = None
        start_epoch = 0
        global_step = 0
        last_saved = -1
        loader_ckptable = hasattr(loader, "state_dict") and \
            hasattr(loader, "set_state_dict")
        # goodput accounting: one window per fit() call; a resumed run
        # books its checkpoint restore as restart_replay
        from ..observability import health as _health
        _health.get_health().goodput.start()
        if checkpoint_dir is not None:
            from ..distributed.ckpt_manager import CheckpointManager
            manager = checkpoint_dir if isinstance(
                checkpoint_dir, CheckpointManager) else \
                CheckpointManager(str(checkpoint_dir))
            if auto_resume:
                import time as _time
                _t0 = _time.monotonic()
                restored = manager.restore(step)
                if restored is not None:
                    rstep, extra = restored
                    extra = extra or {}
                    global_step = int(extra.get("global_step", rstep))
                    start_epoch = int(extra.get("epoch", 0))
                    lstate = extra.get("loader")
                    if lstate is not None and loader_ckptable:
                        loader.set_state_dict(lstate)
                    _health.get_health().goodput.add(
                        "restart_replay", _time.monotonic() - _t0)

        def ckpt_extra(epoch):
            lstate = loader.state_dict() if loader_ckptable else None
            # the epoch to RESUME INTO: the loader's cursor epoch when
            # it is checkpointable (it already advanced past an epoch
            # boundary), else the current one (replayed from batch 0)
            return {"global_step": global_step,
                    "epoch": int(lstate["epoch"]) if lstate is not None
                    else epoch,
                    "loader": lstate}
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, batch_size=batch_size,
                                verbose=verbose, log_freq=log_freq,
                                save_dir=save_dir,
                                save_freq=save_freq,
                                metrics=[n for m in self._metrics
                                         for n in _as_list(m.name())])
        # per-step telemetry: wall time (stream-synchronised), tokens/s,
        # MFU, into the metrics registry and the VisualDL callback's
        # writer when one is configured
        from .callbacks import VisualDL
        from ..observability import StepTimer
        from ..observability import tracing as _tracing
        vdl = next((c for c in cbks.callbacks
                    if isinstance(c, VisualDL)), None)
        timer = StepTimer(prefix="train",
                          writer=vdl._w() if vdl is not None else None)
        step.attach_timer(timer)

        def traced_batches(ldr):
            # one "train.data_load" span per batch FETCH (the host input
            # pipeline's time, apart from the train step's own span)
            it = iter(ldr)
            while True:
                with _tracing.span("train.data_load"), \
                        _health.goodput_region("data_stall"):
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                yield batch
        self.stop_training = False
        cbks.on_train_begin()
        logs = {}
        self._in_fit = True
        cur_epoch = start_epoch
        for epoch in range(start_epoch, epochs):
            cur_epoch = epoch
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            for step_i, batch in enumerate(traced_batches(loader)):
                cbks.on_train_batch_begin(step_i)
                ins, labs = self._split_batch(batch)
                # on the device once: the step and the metrics share it
                ins, labs = self._to_device(ins), self._to_device(labs)
                if ins:
                    # tokens/s convention: elements of the first input
                    timer.tokens_per_step = int(
                        np.prod(np.shape(ins[0]))) or None
                logs = {"loss": self.train_batch(ins, labs)[0]}
                # anomaly sentinel: NaN/Inf or an EWMA spike in the
                # step loss (and, with grad_norm_tap, the grad norm)
                # trips the configured policy (warn / skip_step / halt)
                _sentinel_vals = {
                    "loss": float(np.asarray(logs["loss"]).ravel()[0])}
                _gn = getattr(self._train_step, "last_grad_norm", None)
                if _gn is not None:
                    _sentinel_vals["grad_norm"] = float(
                        _to_host(_gn).ravel()[0])
                _act = _health.get_health().sentinel_check(
                    step=global_step, **_sentinel_vals)
                if _act == "halt":
                    self.stop_training = True
                _skip_metrics = _act == "skip_step"
                if timer.flops_per_step is None and \
                        timer.peak_flops is not None:
                    # priced once, after the first step, for the MFU
                    # gauge (skipped where the card's peak is unknown:
                    # the CPU)
                    timer.flops_per_step = step.step_flops(
                        {"inputs": tuple(ins), "labels": tuple(labs)})
                    if timer.flops_per_step is None:
                        timer.peak_flops = None   # don't retry per step
                if self._metrics and not _skip_metrics:
                    preds = self._last_train_preds
                    self._last_train_preds = None  # consume: don't pin
                    if preds is not None:
                        # pre-update predictions from the SAME forward
                        # as the loss
                        mlogs = self._update_metrics(
                            {"preds": list(preds)}, labs)
                    else:
                        # grad-accumulation path: an eval forward
                        # (post-update, documented drift)
                        ev = self.eval_batch(ins, labs)
                        mlogs = self._update_metrics(ev, labs)
                    mlogs.pop("loss", None)
                    logs.update(mlogs)
                cbks.on_train_batch_end(step_i, logs)
                global_step += 1
                if manager is not None:
                    preempted = getattr(manager, "preempted", False)
                    if preempted or (save_steps and
                                     global_step % save_steps == 0):
                        manager.save(step, global_step,
                                     extra_state=ckpt_extra(epoch))
                        last_saved = global_step
                    if preempted:
                        # SIGTERM landed: state is on disk, leave the
                        # loop cleanly
                        self.stop_training = True
                if self.stop_training:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size,
                              verbose=verbose, num_workers=num_workers,
                              callbacks=cbks)
        if manager is not None:
            # final checkpoint (unless the last save covers this step),
            # then drain the async queue so a writer's failure surfaces
            # here
            if global_step > 0 and last_saved != global_step:
                # a stopped run resumes INTO the interrupted epoch; a
                # completed one records `epochs` so resume is a no-op
                manager.save(step, global_step, extra_state=ckpt_extra(
                    cur_epoch if self.stop_training else epochs))
            manager.wait()
        cbks.on_train_end(logs)
        _health.get_health().goodput.stop()
        # the VisualDL callback closed its writer above: detach the
        # timer so later direct train_batch calls can't write into it
        step.attach_timer(None)
        self._in_fit = False
        self._last_train_preds = None
        return self

    def _update_metrics(self, ev, labs):
        out = {}
        if "loss" in ev:
            out["loss"] = _to_host(ev["loss"])
        preds = ev["preds"]
        for m in self._metrics:
            r = m.compute(*(list(preds) + list(labs)))
            # default compute() passes through an args tuple; update
            # takes them positionally (paddle Metric protocol)
            vals = _as_list(m.update(*[_to_host(x) for x in _as_list(r)]))
            out.update(dict(zip(_as_list(m.name()), vals)))
        return out

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = self._loader(eval_data, batch_size, False, num_workers)
        from .callbacks import CallbackList
        cbks = callbacks if isinstance(callbacks, CallbackList) else \
            config_callbacks(callbacks, model=self, verbose=verbose,
                             log_freq=log_freq,
                             metrics=[n for m in self._metrics
                                      for n in _as_list(m.name())])
        cbks.on_eval_begin()
        for m in self._metrics:
            m.reset()
        losses = []
        for step_i, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step_i)
            ins, labs = self._split_batch(batch)
            ins, labs = self._to_device(ins), self._to_device(labs)
            ev = self.eval_batch(ins, labs)
            logs = self._update_metrics(ev, labs)
            if "loss" in logs:
                losses.append(float(np.asarray(logs["loss"])))
            cbks.on_eval_batch_end(step_i, logs)
        result = {}
        if losses:
            result["loss"] = float(np.mean(losses))
        for m in self._metrics:
            vals = _as_list(m.accumulate())
            result.update(dict(zip(_as_list(m.name()), vals)))
        cbks.on_eval_end(result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=0)
        cbks.on_predict_begin()
        outs: List[List[np.ndarray]] = []
        for step_i, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step_i)
            ins, _ = self._split_batch(batch)
            preds = self.predict_batch(ins)
            outs.append(preds)
            cbks.on_predict_batch_end(step_i)
        cbks.on_predict_end()
        n_out = len(outs[0]) if outs else 0
        grouped = [[b[i] for b in outs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    # -- persistence ----------------------------------------------------------
    def save(self, path: str, training: bool = True):
        """path.pdparams (+ path.pdopt when training=True), the
        reference's layout and names: the network's ``state_dict``
        (parameters, then persistent buffers) and the optimizer state's
        arrays."""
        from ..framework.io import save
        self._sync_from_step()
        save(self.network.state_dict(keep_vars=True), path + ".pdparams")
        if training and self._train_step is not None:
            save(_host_tree(self._train_step.state["opt"]), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer=False):
        from ..framework.io import load
        state = load(path + ".pdparams")
        skipped = False
        if skip_mismatch:
            cur = self.network.state_dict()
            kept = {k: v for k, v in state.items()
                    if k in cur and tuple(np.shape(v)) ==
                    tuple(cur[k].shape)}
            skipped = len(kept) != len(state)
            state = kept
        # the reference's set_state_dict: names this network holds are
        # set (shapes must agree), others are left as they are
        self.network.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()}, strict=False)
        opt_state = None
        # a checkpoint whose params were partially skipped has optimizer
        # slots shaped for the OLD params
        if not reset_optimizer and not skipped and \
                os.path.exists(path + ".pdopt"):
            opt_state = load(path + ".pdopt")
        if self._train_step is not None:
            self._train_step.sync_from_model()
            if opt_state is not None:
                _set_opt_state(self._train_step, opt_state)
        else:
            # the train step is built lazily: applied when it is
            self._pending_opt_state = opt_state
        return self

    def _sync_from_step(self):
        if self._train_step is not None:
            self._train_step.sync_to_model()

    def parameters(self, *a, **k):
        return self.network.parameters(*a, **k)

    def summary(self, input_size=None, dtype=None):
        total = 0
        lines = []
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape)) if p.shape else 1
            total += n
            lines.append(f"  {name:50s} {str(tuple(p.shape)):20s} {n}")
        out = "\n".join(["-" * 80] + lines +
                        ["-" * 80, f"Total params: {total}"])
        print(out)
        return {"total_params": total}
