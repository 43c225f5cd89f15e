"""The port's ``hapi.Model`` against the reference's, f32 on the CPU.

- ``fit`` (two epochs, shuffled, an eval each epoch, ``VisualDL``),
  ``evaluate`` and ``predict`` on ``bert_tiny_config()`` (dropout 0) as
  a 4-way classifier over ids and an attention mask, the reference's
  weights carried in by ``load_raw_state_dict``: losses, parameters,
  evaluation and predictions within 1e-5 of the reference's, the train
  metrics (``Accuracy`` top-1 and top-2) and the VisualDL tags equal.
  The port's loader runs two worker processes, the reference's none.
- ``EarlyStopping``, ``ModelCheckpoint`` (through ``save_dir``) and the
  ``LRScheduler`` callback on a small MLP: the same stop, the same file
  names, the same scheduler position.
- ``train_batch(update=False)`` accumulation equals the reference's.
- ``.pdparams`` / ``.pdopt`` are read across packages both ways (f32);
  a reference ``.pdopt`` (pickled ``jax.Array``s) loads with JAX
  blocked; bf16 round-trips in the port.
- ``fit(checkpoint_dir=..., auto_resume=True)`` over a
  ``CheckpointableLoader`` resumes with a bit-identical loss trajectory.
- The reference's own hapi cases: eval mode, no optimizer, summary,
  ``skip_mismatch``, a callback list for ``evaluate``, train metrics
  from the training forward.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hapi as ref_hapi
from paddle_tpu.metric import Accuracy as RefAccuracy
from paddle_tpu.models import bert as ref_bert

import paddle_tpu_torch as port
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.hapi import (Callback, EarlyStopping, LRScheduler,
                                   Model, VisualDL)
from paddle_tpu_torch.io import CheckpointableLoader
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from torch_io_data import ArrDataset, TokenClsDataset

REPO = Path(__file__).resolve().parent.parent


def _no_dropout(cfg):
    return dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)


class RefBertCls(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.net = ref_bert.BertForSequenceClassification(
            _no_dropout(ref_bert.bert_tiny_config()), num_classes=4)

    def forward(self, ids, mask):
        return self.net(ids, attention_mask=mask)


class BertCls(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = bert.BertForSequenceClassification(
            _no_dropout(bert.bert_tiny_config()), num_classes=4,
            device="cpu")

    def forward(self, ids, mask):
        return self.net(ids, attention_mask=mask)


class RefMLP(paddle.nn.Layer):
    def __init__(self, out=5):
        super().__init__()
        self.fc1 = paddle.nn.Linear(3, 16)
        self.fc2 = paddle.nn.Linear(16, out)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


class MLP(torch.nn.Module):
    def __init__(self, out=5, p=0.0, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc1 = pnn.Linear(3, 16, device="cpu", generator=g)
        self.drop = pnn.Dropout(p)
        self.fc2 = pnn.Linear(16, out, device="cpu", generator=g)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


def _pair(ref_cls, port_cls):
    """A reference network after ``paddle.seed(0)`` and the port's with
    its weights (biases made nonzero first)."""
    paddle.seed(0)
    ref = ref_cls()
    state = {k: np.asarray(v) for k, v in ref.raw_state_dict().items()}
    rng = np.random.default_rng(5)
    for k in state:
        if k.endswith("bias"):
            state[k] = (0.05 * rng.standard_normal(state[k].shape)
                        ).astype(np.float32)
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    net = port_cls()
    load_raw_state_dict(net, state)
    return ref, net


def _hist(base):
    """A callback of either package (``base``) recording each step's
    logs, the epochs ended and each eval's logs."""

    class Hist(base):
        def __init__(self):
            super().__init__()
            self.logs, self.epochs, self.evals = [], [], []

        def on_train_batch_end(self, step, logs=None):
            self.logs.append({k: np.asarray(v).astype(np.float64)
                              for k, v in (logs or {}).items()})

        def on_epoch_end(self, epoch, logs=None):
            self.epochs.append(epoch)

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs or {}))
    return Hist()


def _tags(log_dir):
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [json.loads(line)["tag"] for line in f]


def _fit_bert(pkg, tmp):
    ref = pkg == "ref"
    rnet, pnet = _pair(RefBertCls, BertCls)
    net = rnet if ref else pnet
    hapi = ref_hapi if ref else port.hapi
    opt = (paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=net.parameters()) if ref
           else optim.AdamW(learning_rate=1e-3, parameters=net.parameters()))
    model = hapi.Model(net)
    model.prepare(opt, (paddle.nn if ref else pnn).CrossEntropyLoss(),
                  (RefAccuracy if ref else Accuracy)(topk=(1, 2)))
    hist = _hist(hapi.Callback)
    log_dir = os.path.join(tmp, pkg)
    np.random.seed(3)
    model.fit(TokenClsDataset(), eval_data=TokenClsDataset(n=16, seed=1),
              batch_size=8, epochs=2, verbose=0,
              num_workers=0 if ref else 2,
              callbacks=[hist, hapi.VisualDL(log_dir)])
    ev = model.evaluate(TokenClsDataset(n=16, seed=1), batch_size=8,
                        verbose=0)
    pred = model.predict(TokenClsDataset(n=12, seed=2), batch_size=8,
                         stack_outputs=True)
    params = {k: np.asarray(v) for k, v in model._params().items()} \
        if ref else {k: v.detach().numpy()
                     for k, v in net.state_dict().items()}
    return {"hist": hist, "eval": ev, "pred": pred, "params": params,
            "tags": _tags(log_dir)}


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hapi_fit"))
    # the writers import TensorBoard where it is installed, and its first
    # import draws from the global numpy stream: done before either seed
    for hapi in (ref_hapi, port.hapi):
        hapi.VisualDL(os.path.join(tmp, "warm"))._w().close()
    return _fit_bert("ref", tmp), _fit_bert("port", tmp)


def test_fit_losses_and_train_metrics_match_reference(fitted):
    want, got = fitted
    assert len(got["hist"].logs) == len(want["hist"].logs) == 8
    for g, w in zip(got["hist"].logs, want["hist"].logs):
        assert set(g) == set(w) == {"loss", "acc_top1", "acc_top2"}
        assert abs(float(g["loss"]) - float(w["loss"])) <= \
            1e-5 * abs(float(w["loss"]))
        assert float(g["acc_top1"]) == float(w["acc_top1"])
        assert float(g["acc_top2"]) == float(w["acc_top2"])
    assert got["hist"].epochs == want["hist"].epochs == [0, 1]
    # fit's eval after each epoch
    assert len(got["hist"].evals) == len(want["hist"].evals) == 2


def test_fit_parameters_match_reference(fitted):
    want, got = fitted
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        if k.endswith("k_proj.bias"):
            # a key bias's gradient is zero in exact arithmetic: both
            # sides step on rounding noise, which AdamW scales to steps
            # of up to lr each (8 steps of 1e-3)
            assert np.abs(got["params"][k] - w).max() <= 2 * 8 * 1e-3
            continue
        np.testing.assert_allclose(got["params"][k], w, atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_evaluate_and_predict_match_reference(fitted):
    want, got = fitted
    assert set(got["eval"]) == set(want["eval"]) == {"loss", "acc_top1",
                                                     "acc_top2"}
    assert abs(got["eval"]["loss"] - want["eval"]["loss"]) <= 1e-5
    assert got["eval"]["acc_top1"] == want["eval"]["acc_top1"]
    assert got["eval"]["acc_top2"] == want["eval"]["acc_top2"]
    for g, w in zip(got["hist"].evals, want["hist"].evals):
        assert abs(g["loss"] - w["loss"]) <= 1e-5
    assert len(got["pred"]) == 1 and got["pred"][0].shape == (12, 4)
    np.testing.assert_allclose(got["pred"][0], want["pred"][0], atol=1e-5)


def test_visualdl_writes_the_same_tags(fitted):
    want, got = fitted
    assert got["tags"] == want["tags"]
    assert "train/loss" in got["tags"] and "eval/acc_top2" in got["tags"]


# -- callbacks, accumulation, persistence on a small MLP ------------------

def _mlp_model(pkg, net, lr=0.05, sched=False, metrics=True):
    ref = pkg == "ref"
    lr_mod = paddle.optimizer.lr if ref else optim.lr
    rate = lr_mod.StepDecay(learning_rate=lr, step_size=3, gamma=0.5) \
        if sched else lr
    opt = (paddle.optimizer.AdamW if ref else optim.AdamW)(
        learning_rate=rate, parameters=net.parameters())
    model = (ref_hapi if ref else port.hapi).Model(net)
    model.prepare(opt, (paddle.nn if ref else pnn).CrossEntropyLoss(),
                  (RefAccuracy if ref else Accuracy)() if metrics else None)
    return model


@pytest.fixture(scope="module")
def callbacks_run(tmp_path_factory):
    out = {}
    for pkg, net in zip(("ref", "port"), _pair(RefMLP, MLP)):
        hapi = ref_hapi if pkg == "ref" else port.hapi
        model = _mlp_model(pkg, net, sched=True)
        save_dir = str(tmp_path_factory.mktemp(f"cb_{pkg}"))
        hist = _hist(hapi.Callback)
        stopper = hapi.EarlyStopping(monitor="acc", patience=1, verbose=0)
        np.random.seed(9)
        model.fit(ArrDataset(64), eval_data=ArrDataset(32, seed=4),
                  batch_size=16, epochs=8, verbose=0, save_dir=save_dir,
                  callbacks=[hist, stopper,
                             hapi.LRScheduler(by_step=False, by_epoch=True)])
        sched = model._optimizer._lr_scheduler
        out[pkg] = {"model": model, "net": net, "hist": hist,
                    "stop": model.stop_training, "best": stopper.best,
                    "files": sorted(os.listdir(save_dir)),
                    "sched": (sched.last_epoch, sched()),
                    "save_dir": save_dir}
    return out


def test_early_stopping_stops_at_the_reference_epoch(callbacks_run):
    want, got = callbacks_run["ref"], callbacks_run["port"]
    assert got["hist"].epochs == want["hist"].epochs
    assert got["stop"] == want["stop"]
    assert got["best"] == want["best"]
    assert [e["acc"] for e in got["hist"].evals] == \
        [e["acc"] for e in want["hist"].evals]


def test_model_checkpoint_writes_the_reference_files(callbacks_run):
    want, got = callbacks_run["ref"], callbacks_run["port"]
    assert got["files"] == want["files"]
    assert "final.pdparams" in got["files"] and "0.pdopt" in got["files"]


def test_lr_scheduler_callback_steps_as_the_reference(callbacks_run):
    want, got = callbacks_run["ref"], callbacks_run["port"]
    # the step steps the schedule every optimizer step; the callback
    # once an epoch (by_epoch)
    epochs = len(got["hist"].epochs)
    assert got["sched"][0] == want["sched"][0] >= 4 * epochs + epochs
    assert abs(got["sched"][1] - want["sched"][1]) <= 1e-12


def test_gradient_accumulation_matches_reference():
    rng = np.random.default_rng(0)
    x1, x2 = (rng.standard_normal((8, 3)).astype(np.float32)
              for _ in range(2))
    y1, y2 = (rng.integers(0, 5, 8) for _ in range(2))
    rnet, net = _pair(RefMLP, MLP)
    got = {}
    for pkg, n in (("ref", rnet), ("port", net)):
        opt = (paddle.optimizer.SGD if pkg == "ref" else optim.SGD)(
            learning_rate=0.1, parameters=n.parameters())
        m = (ref_hapi if pkg == "ref" else port.hapi).Model(n)
        m.prepare(opt, (paddle.nn if pkg == "ref" else pnn)
                  .CrossEntropyLoss())
        l1 = m.train_batch([x1], [y1], update=False)[0]
        l2 = m.train_batch([x2], [y2], update=True)[0]
        assert m._accum_grads is None
        got[pkg] = ([float(l1), float(l2)],
                    {k: np.asarray(v) if pkg == "ref" else v.detach().numpy()
                     for k, v in m._train_step.state["params"].items()})
    np.testing.assert_allclose(got["port"][0], got["ref"][0], rtol=1e-6)
    for k, w in got["ref"][1].items():
        np.testing.assert_allclose(got["port"][1][k], w, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # the deferred update is one step on the summed gradient
    _, net2 = _pair(RefMLP, MLP)
    m = Model(net2)
    m.prepare(optim.SGD(learning_rate=0.1, parameters=net2.parameters()),
              pnn.CrossEntropyLoss())
    step = m._ensure_train_step()
    _, g1 = step.grad_step({"inputs": (x1,), "labels": (y1,)})
    _, g2 = step.grad_step({"inputs": (x2,), "labels": (y2,)})
    step.apply_grads({k: g1[k] + g2[k] for k in g1})
    for k, p in step.state["params"].items():
        torch.testing.assert_close(p, torch.from_numpy(got["port"][1][k]),
                                   rtol=1e-6, atol=1e-7)


def _opt_arrays(model, pkg):
    opt = model._train_step.state["opt"]
    to_np = (lambda a: np.asarray(a)) if pkg == "ref" else \
        (lambda a: a.detach().numpy())
    return {"step": int(to_np(opt["step"])),
            "slots": {n: {k: to_np(v) for k, v in s.items()}
                      for n, s in opt["slots"].items()}}


def test_pdparams_and_pdopt_cross_packages(callbacks_run, tmp_path):
    ref_m, port_m = callbacks_run["ref"]["model"], \
        callbacks_run["port"]["model"]
    x = ArrDataset(16, seed=7)
    batch = (x.x, x.y)
    for src, dst in (("ref", "port"), ("port", "ref")):
        path = str(tmp_path / src / "model")
        (ref_m if src == "ref" else port_m).save(path)
        fresh_net = _pair(RefMLP, MLP)[0 if dst == "ref" else 1]
        fresh = _mlp_model(dst, fresh_net, sched=True)
        fresh.load(path)
        source = ref_m if src == "ref" else port_m
        want = source.predict_batch([batch[0]])[0]
        got = fresh.predict_batch([batch[0]])[0]
        np.testing.assert_allclose(got, want, atol=1e-6)
        # the optimizer state came over too: the next step agrees
        fresh._ensure_train_step()
        w_opt, g_opt = _opt_arrays(source, src), _opt_arrays(fresh, dst)
        assert g_opt["step"] == w_opt["step"] > 0
        for n, slots in w_opt["slots"].items():
            for k, v in slots.items():
                np.testing.assert_array_equal(g_opt["slots"][n][k], v)
    from paddle_tpu.framework.io import load as ref_load
    from paddle_tpu_torch.framework.io import load
    assert sorted(ref_load(str(tmp_path / "port" / "model.pdparams"))) == \
        sorted(load(str(tmp_path / "ref" / "model.pdparams")))


_LOAD_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["paddle_tpu"] = None
from paddle_tpu_torch.framework.io import load
opt = load(sys.argv[1])
leaves = [v for s in opt["slots"].values() for v in s.values()]
print(len(leaves), type(leaves[0]).__name__, float(sum(abs(a).sum()
                                                    for a in leaves)))
"""


def test_reference_pdopt_loads_without_jax(callbacks_run, tmp_path):
    path = str(tmp_path / "ref")
    callbacks_run["ref"]["model"].save(path)
    res = subprocess.run([sys.executable, "-c", _LOAD_WITHOUT_JAX,
                          path + ".pdopt"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, kind, total = res.stdout.split()
    want = _opt_arrays(callbacks_run["ref"]["model"], "ref")["slots"]
    assert int(n) == sum(len(s) for s in want.values())
    assert kind == "ndarray"
    np.testing.assert_allclose(float(total), sum(
        np.abs(v).sum() for s in want.values() for v in s.values()),
        rtol=1e-6)


def test_save_load_bfloat16_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(1)
    obj = {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
           "nested": [torch.randn(4, generator=g).half(),
                      torch.arange(6, dtype=torch.int32)],
           "arr": np.arange(3.0), "n": 7}
    port.save(obj, str(tmp_path / "x.pdparams"))
    back = port.load(str(tmp_path / "x.pdparams"))
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), obj["w"].view(torch.int16))
    assert torch.equal(back["nested"][0], obj["nested"][0])
    assert torch.equal(back["nested"][1], obj["nested"][1])
    np.testing.assert_array_equal(back["arr"], obj["arr"])
    assert back["n"] == 7
    # a bf16 network through Model.save / load
    net = MLP().to(torch.bfloat16)
    m = Model(net)
    m.prepare(optim.AdamW(learning_rate=1e-2, parameters=net.parameters()),
              lambda out, y: torch.nn.functional.cross_entropy(
                  out.float(), y))
    d = ArrDataset(16)
    m.train_batch([torch.from_numpy(d.x).bfloat16()], [d.y])
    m.save(str(tmp_path / "bf16"))
    m2 = Model(MLP(seed=3).to(torch.bfloat16))
    m2.prepare(optim.AdamW(learning_rate=1e-2,
                           parameters=m2.network.parameters()),
               m._loss)
    m2.load(str(tmp_path / "bf16"))
    for (k, a), b in zip(net.state_dict().items(),
                         m2.network.state_dict().values()):
        assert torch.equal(a, b), k
    m2._ensure_train_step()
    for n, s in m._train_step.state["opt"]["slots"].items():
        for k, v in s.items():
            assert torch.equal(m2._train_step.state["opt"]["slots"][n][k],
                               v), (n, k)


# -- crash-safe fit ----------------------------------------------------------

class _StopAfter(Callback):
    def __init__(self, n):
        super().__init__()
        self.n, self.seen = n, 0

    def on_train_batch_end(self, step, logs=None):
        self.seen += 1
        if self.seen >= self.n:
            self.model.stop_training = True


def _resume_model(seed):
    net = MLP(out=3, p=0.2, seed=seed)        # dropout: the stream resumes
    model = Model(net)
    model.prepare(optim.AdamW(learning_rate=5e-3), pnn.MSELoss())
    return model


class _RegDataset(ArrDataset):
    def __getitem__(self, i):
        return self.x[i], np.tile(self.x[i] * 0.5, 1)


def _resume_loader():
    return CheckpointableLoader(_RegDataset(32), batch_size=4, shuffle=True,
                                seed=7)


def test_fit_resumes_bit_identically(tmp_path):
    ref = _hist(Callback)
    _resume_model(1).fit(_resume_loader(), epochs=2, verbose=0,
                         callbacks=[ref])
    ref_losses = [float(l["loss"]) for l in ref.logs]
    assert len(ref_losses) == 16
    first = _hist(Callback)
    _resume_model(1).fit(_resume_loader(), epochs=2, verbose=0,
                         callbacks=[first, _StopAfter(5)],
                         checkpoint_dir=str(tmp_path / "ck"), save_steps=3)
    assert [float(l["loss"]) for l in first.logs] == ref_losses[:5]
    second = _hist(Callback)
    _resume_model(9).fit(_resume_loader(), epochs=2, verbose=0,
                         callbacks=[second],
                         checkpoint_dir=str(tmp_path / "ck"), save_steps=3,
                         auto_resume=True)
    assert [float(l["loss"]) for l in second.logs] == ref_losses[5:]
    # resuming a finished run is a no-op
    third = _hist(Callback)
    _resume_model(9).fit(_resume_loader(), epochs=2, verbose=0,
                         callbacks=[third],
                         checkpoint_dir=str(tmp_path / "ck"), save_steps=3)
    assert third.logs == []


# -- the reference's own hapi cases -----------------------------------------

def test_eval_runs_in_eval_mode_and_needs_no_optimizer():
    net = MLP(p=0.5)
    m = Model(net)
    m.prepare()
    x = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    assert net.training
    p1, p2 = m.predict_batch([x])[0], m.predict_batch([x])[0]
    np.testing.assert_array_equal(p1, p2)
    assert p1.shape == (8, 5) and not np.all(p1 == 0)
    assert net.training                        # the mode is restored
    assert m._train_step is None
    net.eval()
    m.predict_batch([x])
    assert not net.training


def test_summary_and_skip_mismatch(tmp_path, capsys):
    m = _mlp_model("port", MLP())
    assert m.summary()["total_params"] == 3 * 16 + 16 + 16 * 5 + 5
    m.fit(ArrDataset(32), batch_size=16, epochs=1, verbose=0)
    m.save(str(tmp_path / "m"))
    other = MLP(out=2, seed=4)
    m2 = Model(other)
    m2.prepare()
    m2.load(str(tmp_path / "m"), skip_mismatch=True)
    assert m2._pending_opt_state is None       # slots of other shapes
    assert torch.equal(other.fc1.weight, m.network.fc1.weight)
    assert not torch.equal(other.fc2.bias[:2], m.network.fc2.bias[:2])
    m3 = _mlp_model("port", MLP(seed=5))
    m3.load(str(tmp_path / "m"))
    assert m3._pending_opt_state is not None
    m3._ensure_train_step()
    assert m3._pending_opt_state is None
    assert any(bool(v.abs().sum() > 0) for s in
               m3._train_step.state["opt"]["slots"].values()
               for v in s.values())


def test_evaluate_accepts_callbacks_and_fit_reuses_the_forward():
    hits = []

    class Probe(Callback):
        def on_eval_end(self, logs=None):
            hits.append(logs)

    m = _mlp_model("port", MLP())
    m.evaluate(ArrDataset(32), batch_size=16, verbose=0, callbacks=[Probe()])
    assert hits and "acc" in hits[0]
    calls = []
    orig = m.eval_batch
    m.eval_batch = lambda *a, **k: calls.append(1) or orig(*a, **k)
    m.fit(ArrDataset(32), batch_size=8, epochs=1, verbose=0)
    assert calls == [] and m._train_step._has_aux
