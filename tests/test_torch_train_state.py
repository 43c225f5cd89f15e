"""The training loop's state on the port's ``CompiledTrainStep``: a
schedule, a clip and the grad-norm tap against the reference's trainer,
exact resume from a checkpoint, ``has_aux``, ``eval_step``,
``donate=False``, ``step_flops`` and ``StepTimer``.

At dropout 0 the reference ``GPTForCausalLM(gpt2_tiny_config())`` (built
after ``paddle.seed(0)``, weights carried into the port through
``load_raw_state_dict``) and the port train 4 steps with
``LinearWarmup(CosineAnnealingDecay)``, ``ClipGradByGlobalNorm(1.0)`` and
``grad_norm_tap=True``: losses and taps within 1e-5 relative (f32 sums
in another order).  At dropout 0.1 the port is held to itself: a
trainer saved after step 3 and loaded into a fresh one built from other
seeds runs on with the uninterrupted run's losses, bit for bit (the
reference's masks come from ``jax.random``, so no cross-package bit
parity exists there).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import CompiledTrainStep as RefStep
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCriterion
from paddle_tpu.models.gpt import gpt2_tiny_config as ref_tiny_config
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as RefClip
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.observability.steptimer import StepTimer as RefTimer
from paddle_tpu.optimizer import lr as ref_lr

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         gpt2_tiny_config)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.observability.steptimer import StepTimer

LR = 1e-3


def _batch(seed=0, b=2, s=64, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"x": ids[:, :-1], "y": ids[:, 1:].astype(np.int64)}


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(LR, T_max=8),
                            warmup_steps=2, start_lr=0.0, end_lr=LR)


@pytest.fixture(scope="module")
def ref_run():
    """The reference trainer, compiled once for the file: 4 steps with the
    schedule, the clip and the tap on 2 x 64 batches (lr, loss and tap of
    each), then its ``step_flops``; and the initial weights."""
    paddle.seed(0)
    ref = RefGPT(ref_tiny_config())
    weights = {k: np.asarray(v) for k, v in ref.raw_state_dict().items()}
    crit = RefCriterion()
    sched = _sched(ref_lr)
    step = RefStep(ref, lambda m, b: crit(m(b["x"]), b["y"]),
                   paddle.optimizer.AdamW(learning_rate=sched,
                                          parameters=ref.parameters(),
                                          grad_clip=RefClip(1.0)),
                   grad_norm_tap=True)
    rows = []
    for i in range(4):
        lr = sched()
        loss = float(step(_batch(i)))
        rows.append((lr, loss, float(step.last_grad_norm)))
    return {"weights": weights, "rows": rows,
            "last_epoch": sched.last_epoch,
            "flops": step.step_flops(_batch(0))}


def _port_trainer(weights=None, cfg=None, seed=0, model_seed=0, **kw):
    cfg = cfg or gpt2_tiny_config()
    model = GPTForCausalLM(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(model_seed))
    if weights is not None:
        load_raw_state_dict(model, weights)
    crit = GPTPretrainingCriterion()
    opt_kw = kw.pop("opt", {})
    opt = optim.AdamW(learning_rate=opt_kw.pop("learning_rate",
                                               _sched(optim.lr)),
                      parameters=model.parameters(),
                      grad_clip=ClipGradByGlobalNorm(1.0), **opt_kw)
    loss_fn = kw.pop("loss_fn", lambda m, b: crit(m(b["x"]), b["y"]))
    return model, CompiledTrainStep(model, loss_fn, opt, seed=seed, **kw)


def test_schedule_clip_and_tap_match_reference(ref_run):
    _, pstep = _port_trainer(ref_run["weights"], grad_norm_tap=True)
    psched = pstep.optimizer._lr_scheduler
    for i, (rlr, want, rt) in enumerate(ref_run["rows"]):
        lr = psched()
        assert lr == rlr
        got = float(pstep(_batch(i)))
        # the update read this step's lr from the optimizer's persistent
        # f32 scalar, filled in place
        lr_t = pstep.optimizer._lr_dev[torch.device("cpu")]
        assert lr_t.dtype == torch.float32
        assert float(lr_t) == float(np.float32(lr))
        assert abs(got - want) <= 1e-5 * abs(want), (i, got, want)
        pt = float(pstep.last_grad_norm)
        assert abs(pt - rt) <= 1e-5 * abs(rt), (i, pt, rt)
        assert pstep.last_grad_norm.dtype == torch.float32
    assert pstep.step_count == 4
    assert psched.last_epoch == ref_run["last_epoch"]


def _dropout_cfg():
    return dataclasses.replace(gpt2_tiny_config(), hidden_dropout_prob=0.1,
                               attention_probs_dropout_prob=0.1)


@pytest.mark.parametrize("how", ["direct", "manager_async_unfused_copy"])
def test_exact_resume_at_dropout(tmp_path, how):
    """Save after step 3, load into a trainer built from other model and
    dropout seeds, run 3 more steps: the losses equal the uninterrupted
    run's exactly.  The second case goes through ``CheckpointManager``
    with an async save, the per-leaf update and ``donate=False``."""
    kw = {} if how == "direct" else {"fused_step": False, "donate": False}
    batches = [_batch(10 + i) for i in range(6)]
    _, whole = _port_trainer(cfg=_dropout_cfg(), seed=5, **kw)
    want = [float(whole(b)) for b in batches]

    _, first = _port_trainer(cfg=_dropout_cfg(), seed=5, **kw)
    head = [float(first(b)) for b in batches[:3]]
    assert head == want[:3]
    _, second = _port_trainer(cfg=_dropout_cfg(), seed=9, model_seed=3,
                              **kw)
    if how == "direct":
        first.save_checkpoint(str(tmp_path / "ck"),
                              extra_state={"epoch": 1})
        extra = second.load_checkpoint(str(tmp_path / "ck"))
    else:
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(first, 3, extra_state={"epoch": 1})
        float(first(batches[3]))       # the state moves on at once
        mgr.wait()
        step, extra = mgr.restore(second)
        assert step == 3
    assert extra == {"epoch": 1}
    assert second.step_count == 3
    assert second.optimizer._lr_scheduler.last_epoch == 3
    assert int(second.state["opt"]["step"]) == 3
    assert [float(second(b)) for b in batches[3:]] == want[3:]


def test_has_aux_and_eval_step():
    """aux rides along from the same (pre-update) forward; ``eval_step``
    runs with no grad and changes nothing."""
    crit = GPTPretrainingCriterion()

    def loss_aux(m, b):
        logits = m(b["x"])
        return crit(logits, b["y"]), {"logit_mean": logits.mean()}

    model, step = _port_trainer(has_aux=True, loss_fn=loss_aux,
                                opt={"learning_rate": LR})
    batch = _batch(1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mean = step.eval_step(lambda m, b: m(b["x"]).mean(), batch)
    assert not mean.requires_grad
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n])
    loss, aux = step(batch)
    assert torch.equal(aux["logit_mean"], mean)
    assert not aux["logit_mean"].requires_grad
    loss2, grads = step.grad_step(batch)
    assert float(loss2) < float(loss) and set(grads) == set(before)


def test_donate_false_leaves_the_held_state_alone():
    _, donated = _port_trainer(opt={"learning_rate": LR})
    model, kept = _port_trainer(donate=False, opt={"learning_rate": LR})
    old = kept.state
    snap = {n: t.clone() for n, t in old["params"].items()}
    slots = {n: {k: v.clone() for k, v in s.items()}
             for n, s in old["opt"]["slots"].items()}
    for i in range(2):
        assert float(kept(_batch(i))) == float(donated(_batch(i)))
    for n, t in old["params"].items():
        assert torch.equal(t, snap[n])
        for k, v in old["opt"]["slots"][n].items():
            assert torch.equal(v, slots[n][k])
    assert kept.state is not old
    for n, p in model.named_parameters():
        assert torch.equal(p, donated.state["params"][n])
        assert p.data_ptr() == kept.state["params"][n].data_ptr()
        assert not torch.equal(p, snap[n])
    kept.sync_to_model()
    kept.sync_from_model()
    assert float(kept(_batch(2))) == float(donated(_batch(2)))


def test_step_flops_near_reference_and_generator_untouched(ref_run):
    """FlopCounterMode's count plus the kernels' and the update's, within
    10 % of the reference's XLA cost model at batch 2 x 64; the dropout
    stream is left as it was."""
    want = ref_run["flops"]
    _, pstep = _port_trainer(ref_run["weights"], cfg=_dropout_cfg())
    rng = pstep.generator.get_state()
    got = pstep.step_flops(_batch(0))
    assert torch.equal(pstep.generator.get_state(), rng)
    assert abs(got - want) <= 0.1 * want, (got, want)
    assert pstep.step_flops(_batch(0)) == got and pstep.step_count == 0


def test_step_timer_series_and_summary_match_reference():
    regs = {"ref": ref_metrics.MetricRegistry(),
            "port": port_metrics.MetricRegistry()}
    rt = RefTimer(registry=regs["ref"], tokens_per_step=64,
                  flops_per_step=1e9, peak_flops=1e12)
    pt = StepTimer(registry=regs["port"], tokens_per_step=64,
                   flops_per_step=1e9, peak_flops=1e12)
    rt.start()
    rt.stop(fence=jnp.ones(3))
    pt.start()
    pt.stop(fence={"a": [torch.ones(3)]})
    snaps = {k: r.snapshot() for k, r in regs.items()}
    assert set(snaps["ref"]) == set(snaps["port"]) == {
        "train_step_seconds", "train_steps_total", "train_tokens_per_sec",
        "train_mfu"}
    for name in snaps["ref"]:
        assert snaps["ref"][name]["kind"] == snaps["port"][name]["kind"]
    rs, ps = rt.summary(), pt.summary()
    assert set(rs) == set(ps) and ps["steps"] == rs["steps"] == 1
    assert ps["mfu"] > 0 and ps["tokens_per_sec"] > 0
    # attached to a trainer, every step is timed
    _, step = _port_trainer(opt={"learning_rate": LR})
    timer = StepTimer(registry=port_metrics.MetricRegistry(),
                      prefix="t", flops_per_step=step.step_flops(_batch()),
                      peak_flops=1e12)
    step.attach_timer(timer)
    for i in range(2):
        step(_batch(i))
    assert timer.summary()["steps"] == 2 and timer.summary()["mfu"] > 0
