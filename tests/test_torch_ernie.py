"""The port's ERNIE-4.5 against the reference.

``Ernie45ForCausalLM(ernie45_tiny_config(moe))`` of each package, dense
and heterogeneous MoE (layer 0 dense, layer 1 eight experts top-2 and a
shared expert), f32 on the CPU: the reference is built after
``paddle.seed(0)`` and its ``raw_state_dict()`` carried into the port.
The reference's MoE layers are set to ``dispatch_mode = "grouped"``
(their grouped matmuls then run in interpret mode; on the CPU "auto"
would pick the capacity einsums, which the port does not take).
Tolerances: logits within 1e-5 relative L2 (f32 sums in another order),
the training loss (cross-entropy plus the aux loss) within 1e-5
relative, every gradient within 1e-4 relative L2.  Interleaved rope on
raw weights gives the logits of contiguous rope on the weights that
``_deinterleave_heads`` permuted, within 1e-5.  The flop counts that
the flash kernels report hold at head_dim 64 and 128 and GQA groups 3
and 5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import CompiledTrainStep as RefStep
from paddle_tpu.models.convert import _deinterleave_heads
from paddle_tpu.models.ernie import Ernie45ForCausalLM as RefErnie
from paddle_tpu.models.ernie import ernie45_tiny_config as ref_tiny

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.ernie import (Ernie45ForCausalLM,
                                           Ernie45ForCausalLMPipe,
                                           ernie45_a3b_config,
                                           ernie45_tiny_config)
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.nn.moe import MoELayer
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flops as _flops
from paddle_tpu_torch.ops import fused_train as ft


def _loss(m, b):
    return m(b["input_ids"], labels=b["labels"])


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    return {"input_ids": ids, "labels": labels}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _reference(moe, **over):
    cfg = ref_tiny(moe=moe)
    for k, v in over.items():
        setattr(cfg, k, v)
    paddle.seed(0)
    ref = RefErnie(cfg)
    for layer in ref.layers:
        if layer.is_moe:
            layer.mlp.dispatch_mode = "grouped"
    return ref


def _port(moe, state, **over):
    cfg = ernie45_tiny_config(moe=moe)
    for k, v in over.items():
        setattr(cfg, k, v)
    port = Ernie45ForCausalLM(cfg, device="cpu")
    load_raw_state_dict(port, state)
    return port


def _state(ref):
    return {k: np.asarray(v) for k, v in ref.raw_state_dict().items()}


def _logits(m, b):
    return m(b["input_ids"])


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "moe"])
def runs(request):
    """Each package's logits, loss and gradients on one batch (the
    reference's through its jitted ``eval_step`` and ``grad_step``)."""
    moe = request.param
    ref = _reference(moe)
    port = _port(moe, _state(ref))
    rstep = RefStep(ref, _loss, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=ref.parameters()))
    pstep = CompiledTrainStep(port, _loss, optim.AdamW(
        learning_rate=1e-3, parameters=port.parameters()))
    b = _batch()
    want = (np.asarray(rstep.eval_step(_logits, b)),) + rstep.grad_step(b)
    with torch.no_grad():
        logits = port(torch.tensor(b["input_ids"])).numpy()
    got = (logits,) + pstep.grad_step(b)
    return moe, port, want, got


def test_logits_match_reference(runs):
    _, _, (want, _, _), (got, _, _) = runs
    assert got.shape == (2, 16, 256)
    assert _rel_l2(want, got) <= 1e-5


def test_loss_and_gradients_match_reference(runs):
    moe, port, (_, loss, grads), (_, ploss, pgrads) = runs
    assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert set(pgrads) == set(grads)
    for n, g in pgrads.items():
        assert _rel_l2(np.asarray(grads[n]), g.numpy()) <= 1e-4, n
    if moe:
        # the MoE layer's experts, router and shared expert learn, and
        # its aux loss is part of the loss
        for n in ("layers.1.mlp.experts.down_w", "layers.1.mlp.gate.weight",
                  "layers.1.mlp.shared_up.weight"):
            assert pgrads[n].abs().max() > 0, n
        assert isinstance(port.layers[1].mlp, MoELayer)
        assert float(port.layers[1].mlp.aux_loss.detach()) > 0


def test_interleaved_rope_equals_deinterleaved_weights():
    """The reference's claim (``paddle_tpu/models/ernie.py:52-54``):
    interleaved rope on raw q/k weights gives the logits of contiguous
    rope on the lane-permuted weights, on the reference and on the
    port."""
    ref = _reference(False, rope_interleaved=True)
    raw = _state(ref)
    hd = 64 // 4
    perm = {k: (_deinterleave_heads(v, hd, axis=1)
                if k.endswith(("q_proj.weight", "k_proj.weight")) else v)
            for k, v in raw.items()}
    ids = _batch()["input_ids"]
    rstep = RefStep(ref, _loss, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=ref.parameters()))
    want = np.asarray(rstep.eval_step(_logits, {"input_ids": ids}))
    with torch.no_grad():
        inter = _port(False, raw, rope_interleaved=True)(
            torch.tensor(ids)).numpy()
        plain = _port(False, perm)(torch.tensor(ids)).numpy()
    assert _rel_l2(want, inter) <= 1e-5
    assert _rel_l2(inter, plain) <= 1e-5
    assert not np.allclose(raw["layers.0.self_attn.q_proj.weight"],
                           perm["layers.0.self_attn.q_proj.weight"])


def test_interleaved_rope_takes_the_plain_rope(monkeypatch):
    """The choice is made on the knob, as the reference's
    ``_mmr_eligible``: an interleaved projection never reaches the
    kernel's autograd Function (on the card: no launch), a contiguous
    one always does."""
    def kernel(*args):
        raise AssertionError("the kernel path was taken")
    monkeypatch.setattr(ft._MatmulRope, "apply", kernel)
    port = Ernie45ForCausalLM(ernie45_tiny_config(), device="cpu")
    port.config.rope_interleaved = True
    for layer in port.layers:
        layer.self_attn.rope_interleaved = True
    with torch.no_grad():
        port(torch.zeros(1, 8, dtype=torch.long))
    x, w = torch.zeros(1, 8, 64), torch.zeros(64, 64)
    cos, sin = port.rope_cos[:8], port.rope_sin[:8]
    with pytest.raises(AssertionError, match="kernel path"):
        ft.matmul_rope_raw(x, w, cos, sin, n_heads=4, head_dim=16)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_recompute_gives_the_gradients_of_the_plain_step(moe):
    """Full recompute over every layer (a dense layer's region returns
    ``(x, None)``): the loss and gradients equal the step without it bit
    for bit."""
    out = []
    for recompute_on in (False, True):
        cfg = ernie45_tiny_config(moe=moe)
        cfg.recompute = recompute_on
        port = Ernie45ForCausalLM(cfg, device="cpu")
        step = CompiledTrainStep(port, _loss, optim.AdamW(
            learning_rate=1e-3, parameters=port.parameters()))
        out.append(step.grad_step(_batch()))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1) and set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_step_flops_under_recompute():
    """``step_flops`` runs under full recompute (the recompute's inner
    ``autograd.grad`` beside the operator count) and counts the
    recomputed forward: more than without recompute, less than twice;
    ``OperatorFlops`` equals ``FlopCounterMode`` where both run."""
    from torch.utils.flop_counter import FlopCounterMode
    got = {}
    for recompute_on in (False, True):
        cfg = ernie45_tiny_config(moe=True)
        cfg.recompute = recompute_on
        port = Ernie45ForCausalLM(cfg, device="cpu")
        step = CompiledTrainStep(port, _loss, optim.AdamW(
            learning_rate=1e-3, parameters=port.parameters()))
        got[recompute_on] = step.step_flops(_batch())
    assert got[False] < got[True] < 2 * got[False]
    a, b = torch.randn(8, 16, requires_grad=True), torch.randn(16, 4)
    with FlopCounterMode(display=False) as ref, _flops.OperatorFlops() as op:
        (a @ b).sum().backward()
    assert op.total == ref.get_total_flops() == 2 * (2 * 8 * 16 * 4)


def test_a3b_config_and_pipe():
    c = ernie45_a3b_config()
    assert (c.moe_num_experts, c.moe_k, c.moe_num_shared_experts,
            c.moe_layer_start_index) == (64, 6, 2, 1)
    assert c.num_attention_heads // c.num_key_value_heads == 5
    with pytest.raises(NotImplementedError, match="Multi-device"):
        Ernie45ForCausalLMPipe(ernie45_tiny_config())


@pytest.mark.parametrize("h,hk,d", [(12, 4, 128), (20, 4, 128), (12, 4, 64),
                                    (16, 16, 64)],
                         ids=["g3_d128", "g5_d128", "g3_d64", "g1_d64"])
def test_flash_flop_count_matches_the_plain_operators(h, hk, d):
    """The flash forward's reported operations (4 d h a visited pair)
    equal what ``FlopCounterMode`` counts in its plain version's
    products, unmasked (every pair visited), at the new groups and head
    dims; the causal count is the visited pairs' share of it."""
    from torch.utils.flop_counter import FlopCounterMode
    b, s = 2, 32
    q = torch.zeros(b, s, h, d)
    k = torch.zeros(b, s, hk, d)
    with FlopCounterMode(display=False) as mode:
        fa.flash_attention_fwd_reference(q, k, k, causal=False)
    want = mode.get_total_flops()
    assert fa._attn_flops(4, b, h, d, s, s, False) == want
    causal = fa._attn_flops(4, b, h, d, s, s, True)
    assert causal == want * (s * (s + 1) // 2) // (s * s)
    with _flops.counting() as box:
        _flops.report(fa._attn_flops, 8, b, h, d, s, s, True)
    assert box[0] == 2 * causal
