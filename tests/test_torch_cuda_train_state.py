"""The training loop's state on the card: the per-leaf optimizers on CUDA
tensors, async-save snapshots of device state, and exact resume.

Marked ``cuda``; every test skips on a machine without a CUDA device.
This file imports neither JAX nor the reference package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_train_state.py

Tolerances: a per-leaf update on the card against the same on the CPU
within 1e-6 of the largest element (f32 elementwise ops, the card's
division and square root rounded on its own); the fused AdamW (#8)
against its per-leaf update the same.  A resumed run's losses equal the
uninterrupted run's exactly when the card repeats a step bit for bit,
and otherwise differ by no more than twice a repeat's spread.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                     save_state_dict)
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         gpt2_tiny_config)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fused_train as ft

pytestmark = pytest.mark.cuda

SHAPES = {"a": (64, 48), "b": (300,), "c": (4, 8, 16)}

PER_LEAF = [("Adagrad", {}), ("Adamax", {}), ("RMSProp", {"momentum": 0.5}),
            ("Lamb", {}), ("Adadelta", {"learning_rate": 1.0}),
            ("ASGD", {"batch_num": 2}), ("Rprop", {}), ("NAdam", {}),
            ("RAdam", {})]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy((scale * rng.standard_normal(s)).astype(
        np.float32)) for n, s in SHAPES.items()}


def _close(got, want):
    got, want = got.cpu(), want.cpu()
    assert ((got - want).abs().max()
            <= 1e-6 * max(want.abs().max().item(), 1e-30)), (got, want)


@pytest.mark.parametrize("name,kw", PER_LEAF, ids=[c[0] for c in PER_LEAF])
def test_per_leaf_update_on_the_card_equals_the_cpu(dev, name, kw):
    """Two steps of the fused-path entry point: the optimizer has no
    fused kind, so the per-leaf update runs on the card and #8 never
    launches."""
    opt = getattr(optim, name)(**{"learning_rate": 0.01, **kw})
    assert not opt.uses_fused_kernel()
    cpu = _leaves(0)
    card = {n: v.to(dev) for n, v in cpu.items()}
    sc, sg = opt.init_state(cpu), opt.init_state(card)
    ft.fused_update_flat.launches = 0
    for i in range(2):
        g = _leaves(10 + i, 0.5)
        cpu, sc = opt.apply_gradients(cpu, g, sc)
        card, sg = opt.apply_gradients_fused(
            card, {n: v.to(dev) for n, v in g.items()}, sg)
    assert ft.fused_update_flat.launches == 0
    for n in SHAPES:
        _close(card[n], cpu[n])
        for k, v in sg["slots"][n].items():
            _close(v, sc["slots"][n][k])


@pytest.mark.parametrize("clip", [None, ClipGradByGlobalNorm(1.0)],
                         ids=["no_clip", "global_norm"])
def test_adamw_fused_against_per_leaf_on_the_card(dev, clip):
    opt = optim.AdamW(learning_rate=0.01, weight_decay=0.1, grad_clip=clip)
    base = {n: v.to(dev) for n, v in _leaves(1).items()}
    g = {n: v.to(dev) for n, v in _leaves(2, 3.0).items()}
    plain, st_p = opt.apply_gradients(base, g, opt.init_state(base))
    fused = {n: v.clone() for n, v in base.items()}
    ft.fused_update_flat.launches = 0
    fused, st_f = opt.apply_gradients_fused(fused, g, opt.init_state(fused))
    assert ft.fused_update_flat.launches > 0
    for n in SHAPES:
        _close(fused[n], plain[n])


def test_lbfgs_on_the_card(dev):
    w = torch.nn.Parameter(torch.zeros(3, device=dev))
    tgt = torch.tensor([3.0, -1.0, 0.5], device=dev)
    scale = torch.tensor([1.0, 10.0, 3.0], device=dev)
    opt = optim.LBFGS(learning_rate=1.0, max_iter=25,
                      line_search_fn="strong_wolfe", parameters=[w])

    def closure():
        loss = (scale * (w - tgt) ** 2).sum()
        loss.backward()
        return loss

    assert float(opt.step(closure)) < 1e-6
    torch.testing.assert_close(w.detach().cpu(), tgt.cpu(), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_async_save_snapshots_device_state(dev, tmp_path, dtype):
    state = {"p": torch.randn(1 << 16, device=dev).to(dtype),
             "slots": {"m": torch.randn(256, 256, device=dev)},
             "step": torch.tensor(5, dtype=torch.int32, device=dev)}
    want = {"p": state["p"].cpu(), "m": state["slots"]["m"].cpu()}
    h = save_state_dict(state, str(tmp_path / "ck"), async_save=True)
    state["p"].mul_(-3)
    state["slots"]["m"].add_(1)
    state["step"].add_(1)
    h.wait(timeout=120)
    tmpl = {"p": torch.zeros(1 << 16, device=dev, dtype=dtype),
            "slots": {"m": torch.zeros(256, 256, device=dev)},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
    load_state_dict(tmpl, str(tmp_path / "ck"))
    assert torch.equal(tmpl["p"].cpu(), want["p"])
    assert torch.equal(tmpl["slots"]["m"].cpu(), want["m"])
    assert int(tmpl["step"]) == 5 and tmpl["p"].device == dev


def _trainer(dev, seed, model_seed):
    # head_dim 64: the flash kernels' width
    cfg = dataclasses.replace(gpt2_tiny_config(), hidden_size=128,
                              num_attention_heads=2, intermediate_size=256,
                              hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    model = GPTForCausalLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(model_seed))
    crit = GPTPretrainingCriterion()
    sched = optim.lr.LinearWarmup(optim.lr.CosineAnnealingDecay(
        1e-3, T_max=8), warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    opt = optim.AdamW(learning_rate=sched, parameters=model.parameters(),
                      grad_clip=ClipGradByGlobalNorm(1.0))
    return CompiledTrainStep(model, lambda m, b: crit(m(b["x"]), b["y"]),
                             opt, seed=seed, grad_norm_tap=True)


def _batches(dev, n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 256, (2, 129))
        out.append({"x": torch.tensor(ids[:, :-1], dtype=torch.int32,
                                      device=dev),
                    "y": torch.tensor(ids[:, 1:], device=dev)})
    return out


def test_exact_resume_on_the_card(dev, tmp_path):
    batches = _batches(dev, 6)
    first = _trainer(dev, 5, 0)
    [float(first(b)) for b in batches[:3]]
    first.save_checkpoint(str(tmp_path / "ck"))
    # the card's own repeat spread: the same 3 steps twice from one state
    runs = []
    for _ in range(2):
        again = _trainer(dev, 7, 1)
        again.load_checkpoint(str(tmp_path / "ck"))
        runs.append([float(again(b)) for b in batches[3:]])
    want = [float(first(b)) for b in batches[3:]]
    spread = max(abs(a - b) for a, b in zip(*runs))
    for got in runs:
        if spread == 0:
            assert got == want
        else:
            assert max(abs(a - b) for a, b in zip(got, want)) <= 2 * spread
    assert all(np.isfinite(want))
