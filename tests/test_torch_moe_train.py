"""The port's Qwen2-MoE training against the reference trainer.

The reference ``Qwen2MoeForCausalLM(qwen2_moe_tiny_config())`` with
``moe_dispatch_mode="grouped"`` (the dropless grouped dispatch: its
Pallas grouped matmuls run in interpret mode on the CPU) is built after
``paddle.seed(0)`` and its ``raw_state_dict()`` carried into the port;
both ``CompiledTrainStep``s take the same 2 x 16 batch in f32 with
AdamW and a global-norm clip of 0.5, with and without ``recompute``.
Tolerances: the loss within 1e-5 relative and every gradient within
1e-4 relative L2 (f32 sums in another order; the router's top-k picks
the same experts, so the sums differ only in rounding), and with
recompute the losses of three AdamW steps within 1e-5; the router's
gate values within 1e-5 and its aux loss within 1e-6 relative.  On the port alone, a two-output recompute region gives the
gradients of the same region without recompute bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import CompiledTrainStep as RefStep
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as RefQwen
from paddle_tpu.models.qwen2_moe import \
    qwen2_moe_tiny_config as ref_tiny_config

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.jit.recompute import recompute
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.from_jax import (load_optimizer_state,
                                              load_raw_state_dict)
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeConfig,
                                               Qwen2MoeForCausalLM,
                                               qwen2_moe_tiny_config)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.moe import MoELayer

LR, CLIP = 1e-2, 0.5


def _loss(m, b):
    return m(b["input_ids"], labels=b["labels"])


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    return {"input_ids": ids, "labels": labels}


@pytest.fixture(scope="module")
def ref_state():
    paddle.seed(0)
    ref = RefQwen(ref_tiny_config())
    return {k: np.asarray(v) for k, v in ref.raw_state_dict().items()}


def _pair(state, recompute_on):
    rc = ref_tiny_config()
    rc.moe_dispatch_mode, rc.recompute = "grouped", recompute_on
    paddle.seed(1)
    ref = RefQwen(rc)
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    pc = qwen2_moe_tiny_config()
    pc.recompute = recompute_on
    port = Qwen2MoeForCausalLM(pc, device="cpu")
    load_raw_state_dict(port, state)
    ropt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=ref.parameters(),
        grad_clip=paddle.ClipGradByGlobalNorm(CLIP))
    popt = optim.AdamW(learning_rate=LR, parameters=port.parameters(),
                       grad_clip=ClipGradByGlobalNorm(CLIP))
    return RefStep(ref, _loss, ropt), CompiledTrainStep(port, _loss, popt)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.mark.parametrize("recompute_on", [False, True],
                         ids=["no_recompute", "recompute"])
def test_grad_step_matches_reference(ref_state, recompute_on):
    """The first step's loss and gradients; under recompute, then three
    AdamW steps (each trainer's ``grad_step`` and ``apply_grads``)."""
    ref_step, port_step = _pair(ref_state, recompute_on)
    for i in range(3 if recompute_on else 1):
        loss, grads = ref_step.grad_step(_batch())
        ploss, pgrads = port_step.grad_step(_batch())
        assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
        if i == 0:
            assert set(pgrads) == set(grads)
            for n, g in pgrads.items():
                assert _rel_l2(np.asarray(grads[n]), g.numpy()) <= 1e-4, n
            # the experts, the router and the shared expert's gate learn
            for n in ("layers.0.mlp.experts.down_w",
                      "layers.1.mlp.gate.weight",
                      "layers.0.mlp.shared_expert_gate.weight",
                      "layers.0.self_attn.q_proj.bias"):
                assert pgrads[n].abs().max() > 0, n
        ref_step.apply_grads(grads)
        port_step.apply_grads(pgrads)
    if recompute_on:
        # the optimizer state carries over by name
        load_optimizer_state(port_step, {
            "slots": {n: {k: np.asarray(a) for k, a in s.items()}
                      for n, s in ref_step.state["opt"]["slots"].items()},
            "step": np.asarray(ref_step.state["opt"]["step"])})
        assert port_step.step_count == 3


@pytest.mark.parametrize("norm_topk,z_coef", [(False, 0.0), (True, 1e-3)])
def test_router_and_aux_loss_equal_the_reference(norm_topk, z_coef):
    """The router of both dispatches: equal expert choices, gate values
    within 1e-5 relative (f32 logits summed in another order, through
    the softmax) and the aux loss (load balance plus z-loss) within 1e-6
    relative."""
    from paddle_tpu.nn.moe import _router_topk as ref_router

    from paddle_tpu_torch.nn.moe import _router_topk
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    wg = (0.3 * rng.standard_normal((32, 8))).astype(np.float32)
    kw = dict(k=2, balance_coef=1.0, z_coef=z_coef, norm_topk=norm_topk)
    gv, idx, aux = ref_router(x, wg, **kw)
    pgv, pidx, paux = _router_topk(torch.tensor(x), torch.tensor(wg), **kw)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(pgv.numpy(), np.asarray(gv), rtol=1e-5)
    assert abs(float(paux) - float(aux)) <= 1e-6 * abs(float(aux))


def test_two_output_recompute_region_is_bit_equal():
    """A decoder layer returns ``(x, aux)``; under recompute both carry
    their gradients, equal bit for bit to the region run plainly."""
    cfg = qwen2_moe_tiny_config()
    model = Qwen2MoeForCausalLM(cfg, device="cpu")
    layer = model.layers[0]
    x0 = torch.randn(2, 16, cfg.hidden_size,
                     generator=torch.Generator().manual_seed(3))
    cos_sin = (model.rope_cos[:16], model.rope_sin[:16])
    params = list(layer.parameters())
    outs = []
    for run in (lambda x: layer(x, cos_sin),
                lambda x: recompute(layer, x, cos_sin)):
        x = x0.clone().requires_grad_()
        y, aux = run(x)
        loss = (y * y).sum() + 10.0 * aux
        outs.append((y.detach(), aux.detach(),
                     torch.autograd.grad(loss, [x] + params)))
    (y0, a0, g0), (y1, a1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_recompute_passes_through_outputs_without_grad():
    def region(x):
        return x * 2, (x * 3).detach()
    x = torch.ones(3, requires_grad=True)
    y, z = recompute(region, x)
    assert torch.equal(z, torch.full((3,), 3.0))
    (g,) = torch.autograd.grad(y.sum() + z.sum(), [x])
    assert torch.equal(g, torch.full((3,), 2.0))


@pytest.mark.parametrize("mode", ["dense", "grouped_ep"])
def test_dispatches_outside_the_slice_raise(mode):
    layer = MoELayer(16, 4, 8, k=2, dispatch_mode=mode, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layer(torch.zeros(1, 4, 16))


def test_sequence_parallel_raises():
    cfg = Qwen2MoeConfig(**{**vars(qwen2_moe_tiny_config()),
                            "sequence_parallel": True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Qwen2MoeForCausalLM(cfg, device="cpu")
