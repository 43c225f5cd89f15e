"""Recompute and the fused chain against the reference trainer.

The reference ``LlamaForCausalLM(llama_tiny_config())`` keeps its
default ``fuse_norm_rope=True`` (the fused add+RMSNorm and matmul+rope
regions) and is built after ``paddle.seed(0)``; its ``raw_state_dict()``
is carried into the port.  For each recompute policy (off, "full",
"core_attn", "dots") both ``CompiledTrainStep``s take the same 2 x 16
batch on the CPU in f32 with AdamW and a global-norm clip of 0.5: the
loss within 1e-5 relative and every gradient within 1e-5 relative L2 of
the reference's, then (through each trainer's ``grad_step`` and
``apply_grads``) three steps with losses within 1e-5 and the states as
``test_torch_llama_train.py`` holds them (parameters 1e-4
absolute, moments 1e-4 relative).  These are f32 sums taken in another
order.  The bf16 (amp O2) recipe under "core_attn" has the wider
tolerances of that file's O2 test.

On the port alone: gradients under every policy equal those without
recompute (the recompute runs the same operations on the same inputs),
and the forward kernels' plain versions are counted to show what the
recomputed backward reruns: under "core_attn" it never calls the flash
forward.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import CompiledTrainStep as RefStep
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config

from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.jit.recompute import _resolve_policy, recompute
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_train as ft

LR, CLIP = 1e-2, 0.5
POLICIES = [None, "full", "core_attn", "dots"]


def _loss(m, b):
    return m(b["input_ids"], labels=b["labels"])


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    return {"input_ids": ids, "labels": labels}


def _set_policy(cfg, policy):
    cfg.recompute = policy is not None
    cfg.recompute_granularity = policy or "full"
    return cfg


def _port(policy, state):
    port = LlamaForCausalLM(_set_policy(llama_tiny_config(), policy),
                            device="cpu")
    load_raw_state_dict(port, state)
    return port


def _pair(policy, o2=False):
    paddle.seed(0)
    ref = RefLlama(_set_policy(ref_tiny_config(), policy))
    port = _port(policy, {k: np.asarray(v)
                          for k, v in ref.raw_state_dict().items()})
    if o2:
        ref = paddle.amp.decorate(ref, level="O2", dtype="bfloat16")
        port = amp.decorate(port, level="O2", dtype="bfloat16")
    ropt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=ref.parameters(),
        grad_clip=paddle.ClipGradByGlobalNorm(CLIP))
    popt = optim.AdamW(learning_rate=LR, parameters=port.parameters(),
                       grad_clip=ClipGradByGlobalNorm(CLIP))
    return RefStep(ref, _loss, ropt), CompiledTrainStep(port, _loss, popt)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_fused_chain_trains_like_the_reference(policy):
    ref_step, port_step = _pair(policy)
    assert port_step.model.config.fuse_norm_rope
    for i in range(3):
        loss, grads = ref_step.grad_step(_batch())
        ploss, pgrads = port_step.grad_step(_batch())
        assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
        if i == 0:
            assert set(pgrads) == set(grads)
            for n, g in pgrads.items():
                assert _rel_l2(np.asarray(grads[n]), g.numpy()) <= 1e-5, n
        ref_step.apply_grads(grads)
        port_step.apply_grads(pgrads)
    for n, p in port_step.state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(ref_step.state["params"][n]),
                                   rtol=0, atol=1e-4, err_msg=n)
    for n, slots in port_step.state["opt"]["slots"].items():
        for k, t in slots.items():
            want = np.asarray(ref_step.state["opt"]["slots"][n][k])
            assert np.abs(t.numpy() - want).max() \
                <= 1e-4 * np.abs(want).max(), (n, k)


def _grads(policy, state, dtype=torch.float32, loss=_loss):
    model = _port(policy, state).to(dtype)
    step = CompiledTrainStep(model, loss, optim.AdamW(
        learning_rate=LR, parameters=model.parameters()))
    return step.grad_step(_batch())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_every_policy_gives_the_gradients_without_recompute(dtype):
    state = LlamaForCausalLM(llama_tiny_config(), device="cpu").state_dict()
    state = {k: v.numpy() for k, v in state.items()}
    loss, want = _grads(None, state, dtype)
    for policy in POLICIES[1:]:
        got_loss, got = _grads(policy, state, dtype)
        assert float(got_loss) == float(loss), policy
        for n, g in got.items():
            torch.testing.assert_close(g, want[n], rtol=0, atol=0,
                                       msg=f"{policy} {n}")


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_o1_gradients_equal_those_without_recompute(amp_dtype):
    """amp O1 is active while the loss function runs; the backward, where
    the recompute replays each layer, runs after it has exited.  The
    replay takes the forward's amp state, so its products run in the
    same dtypes and every gradient is the one without recompute."""
    def o1_loss(m, b):
        with amp.auto_cast(level="O1", dtype=amp_dtype):
            return _loss(m, b)

    state = LlamaForCausalLM(llama_tiny_config(), device="cpu").state_dict()
    state = {k: v.numpy() for k, v in state.items()}
    loss, want = _grads(None, state, loss=o1_loss)
    for policy in POLICIES[1:]:
        got_loss, got = _grads(policy, state, loss=o1_loss)
        assert float(got_loss) == float(loss), policy
        for n, g in got.items():
            torch.testing.assert_close(g, want[n], rtol=0, atol=0,
                                       msg=f"{policy} {n}")


@pytest.mark.parametrize("policy,flash,mmr", [
    (None, 1, 2), ("full", 2, 4), ("core_attn", 1, 4), ("dots", 2, 4)],
    ids=str)
def test_what_the_recomputed_backward_reruns(monkeypatch, policy, flash,
                                             mmr):
    """Calls per layer in one grad step.  Under "core_attn" the recompute
    takes the kept (out, lse) and never calls the flash forward; the
    matmul+rope kernel (q and k) reruns under every policy, since its
    output is a kernel output and not a dot."""
    calls = {"flash": 0, "mmr": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_fwd",
                        counted("flash", fa.flash_attention_fwd))
    monkeypatch.setattr(ft, "matmul_rope_reference",
                        counted("mmr", ft.matmul_rope_reference))
    state = {k: v.numpy() for k, v in LlamaForCausalLM(
        llama_tiny_config(), device="cpu").state_dict().items()}
    _grads(policy, state)
    layers = llama_tiny_config().num_hidden_layers
    assert calls == {"flash": flash * layers, "mmr": mmr * layers}


def test_o2_bf16_core_attn_matches_reference():
    """amp O2 with "core_attn" on both sides, at the tolerances of the
    O2 test of ``test_torch_llama_train.py``: gradients within 2e-2
    relative L2 (bf16 activations rounded at other points), losses over
    three steps within 2^-8 relative."""
    ref_step, port_step = _pair("core_attn", o2=True)
    for i in range(3):
        loss, grads = ref_step.grad_step(_batch())
        ploss, pgrads = port_step.grad_step(_batch())
        assert abs(float(ploss) - float(loss)) <= 2.0 ** -8 * abs(float(loss))
        if i == 0:
            for n, g in pgrads.items():
                assert g.dtype == torch.bfloat16
                want = np.asarray(grads[n]).astype(np.float32)
                assert _rel_l2(want, g.float().numpy()) <= 2e-2, n
        ref_step.apply_grads(grads)
        port_step.apply_grads(pgrads)


def test_recompute_of_a_plain_function():
    """Tensors nested in the arguments get their gradients; without
    grad the function just runs; a region is differentiated once."""
    torch.manual_seed(0)
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)

    def f(a, pair, scale=1.0):
        return (torch.tanh(a @ pair[0]) * pair[1] * scale).sum()

    want = torch.autograd.grad(f(x, (w, 2.0), scale=3.0), (x, w))
    out = recompute(f, x, (w, 2.0), scale=3.0, policy="dots")
    got = torch.autograd.grad(out, (x, w), retain_graph=True)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="differentiated once"):
        torch.autograd.grad(out, (x, w))
    with torch.no_grad():
        assert recompute(f, x, (w, 2.0), policy="full") == f(x, (w, 2.0))


@pytest.mark.parametrize("policy", ["selective", "FULL", ["core_attn"],
                                    lambda *a: True],
                         ids=["selective", "FULL", "list", "callable"])
def test_unknown_policies_raise(policy):
    with pytest.raises(ValueError, match="unknown recompute policy"):
        _resolve_policy(policy)
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(torch.sin, torch.zeros(2, requires_grad=True),
                  policy=policy)
