"""The port's training slice against the reference trainer, end to end.

The reference ``LlamaForCausalLM(llama_tiny_config())`` (with
``fuse_norm_rope=False``, which the reference documents as bit-identical
to its fused chain) is built after ``paddle.seed(0)`` and its
``raw_state_dict()`` carried into the port; both ``CompiledTrainStep``s
then train on the same 2 x 16 batch (one -100 label per row) on the CPU
in f32 with AdamW (weight decay 0.01) and a global-norm clip of 0.5,
which clips every step here.  The reference runs its jnp paths, the
port its kernels' plain versions.

Tolerances, all from f32 sums taken in another order (XLA's fused
reductions against PyTorch's): losses 1e-5 relative; gradients 1e-5
relative L2 per leaf; after three steps moments within 1e-4 relative
(max-abs over max-abs) and parameters within 1e-4 absolute — Adam
divides each moment by its root second moment, so a gradient element
near zero whose sum cancels (rounding of order 1e-9) can move its
parameter by up to lr times a fraction, against lr = 1e-2.  The bf16
(amp O2) recipe has wider tolerances, stated in its test.
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
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.from_jax import (load_optimizer_state,
                                              load_raw_state_dict)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

LR, CLIP = 1e-2, 0.5


def _loss(m, b):
    return m(b["input_ids"], labels=b["labels"])


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    return {"input_ids": ids, "labels": labels}


def _pair(fused_ce=True, o2=False):
    paddle.seed(0)
    rc = ref_tiny_config()
    rc.fuse_norm_rope = False
    rc.fuse_linear_cross_entropy = fused_ce
    ref = RefLlama(rc)
    pc = llama_tiny_config()
    pc.fuse_norm_rope = False
    pc.fuse_linear_cross_entropy = fused_ce
    port = LlamaForCausalLM(pc, device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
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


def _assert_states_close(ref_step, port_step):
    for n, p in port_step.state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(ref_step.state["params"][n]),
                                   rtol=0, atol=1e-4, err_msg=n)
    for n, slots in port_step.state["opt"]["slots"].items():
        for k, t in slots.items():
            want = np.asarray(ref_step.state["opt"]["slots"][n][k])
            err = np.abs(t.numpy() - want).max() / np.abs(want).max()
            assert err <= 1e-4, (n, k, err)
    assert int(port_step.state["opt"]["step"]) == \
        int(ref_step.state["opt"]["step"])


@pytest.mark.parametrize("fused_ce", [True, False], ids=["fused_ce", "ce"])
def test_grad_step_matches_reference(fused_ce):
    ref_step, port_step = _pair(fused_ce)
    loss, grads = ref_step.grad_step(_batch())
    ploss, pgrads = port_step.grad_step(_batch())
    assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert set(pgrads) == set(grads)
    for n, g in pgrads.items():
        assert g.dtype == torch.float32
        assert _rel_l2(np.asarray(grads[n]), g.numpy()) <= 1e-5, n
    # the clip engages: the global norm is above CLIP
    gnorm = ClipGradByGlobalNorm(CLIP).global_norm(list(pgrads.values()))
    assert float(gnorm) > CLIP


@pytest.mark.parametrize("pack_small", [None, True, False])
def test_three_steps_match_reference(pack_small):
    ref_step, port_step = _pair()
    port_step._fused_pack_small = pack_small
    for _ in range(3):
        want = float(ref_step(_batch()))
        got = port_step(_batch())
        assert got.dim() == 0
        assert abs(float(got) - want) <= 1e-5 * abs(want)
    assert port_step.step_count == 3
    _assert_states_close(ref_step, port_step)


def test_resume_from_carried_optimizer_state():
    """Both frameworks continue from the reference's state after two
    steps: its parameters and its optimizer state (slots and step count)
    carried across as numpy."""
    ref_step, port_step = _pair()
    for _ in range(2):
        ref_step(_batch())
    load_raw_state_dict(port_step.model, {
        k: np.asarray(v) for k, v in ref_step.state["params"].items()})
    load_optimizer_state(port_step, {
        "slots": {n: {k: np.asarray(a) for k, a in s.items()}
                  for n, s in ref_step.state["opt"]["slots"].items()},
        "step": np.asarray(ref_step.state["opt"]["step"])})
    assert port_step.step_count == 2
    for seed in (1, 2):
        want = float(ref_step(_batch(seed)))
        got = float(port_step(_batch(seed)))
        assert abs(got - want) <= 1e-5 * abs(want)
    _assert_states_close(ref_step, port_step)


def test_unfused_update_path_matches_fused():
    """``fused_step=False`` (the per-leaf apply_gradients) gives the
    fused path's trajectory."""
    _, fused = _pair()
    _, plain = _pair()
    plain._fused_step = False
    for _ in range(2):
        a, b = fused(_batch()), plain(_batch())
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(a))
    for n, p in fused.state["params"].items():
        torch.testing.assert_close(p, plain.state["params"][n], rtol=0,
                                   atol=1e-6)


def test_o2_decorate_casts_params_and_rope_tables():
    pc = llama_tiny_config()
    pc.fuse_norm_rope = False
    m = amp.decorate(LlamaForCausalLM(pc, device="cpu"), level="O2",
                     dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    assert m.llama.rope_cos.dtype == torch.bfloat16
    step = CompiledTrainStep(m, _loss, optim.AdamW(
        learning_rate=LR, parameters=m.parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    losses = [float(step(_batch())) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    slots = step.state["opt"]["slots"]["lm_head.weight"]
    assert slots["moment1"].dtype == torch.float32


def test_o2_bf16_recipe_matches_reference():
    """The recipe ``chip_smoke.py`` times -- ``amp.decorate`` O2 (bf16
    params, f32 moments), AdamW with the clip -- on both sides from the
    same weights.  Gradients within 2e-2 relative L2 per leaf: five bf16
    roundings (2^-8 each), as the two frameworks round bf16 activations
    and their gradients at different points (the reference's attention
    casts its probabilities to bf16 before the value product; the port's
    plain flash version keeps them f32).  Losses over three steps within
    2^-8 relative: after a step, a parameter whose gradient sign was
    decided by rounding noise moves by lr the other way."""
    ref_step, port_step = _pair(o2=True)
    loss, grads = ref_step.grad_step(_batch())
    ploss, pgrads = port_step.grad_step(_batch())
    assert abs(float(ploss) - float(loss)) <= 2.0 ** -8 * abs(float(loss))
    for n, g in pgrads.items():
        assert g.dtype == torch.bfloat16
        want = np.asarray(grads[n]).astype(np.float32)
        assert _rel_l2(want, g.float().numpy()) <= 2e-2, n
    for _ in range(3):
        want = float(ref_step(_batch()))
        got = float(port_step(_batch()))
        assert abs(got - want) <= 2.0 ** -8 * abs(want)


def test_plain_paths_refuse_tensors_off_the_cpu():
    """``use_flash_attention=False`` runs plain PyTorch attention, so it
    takes CPU tensors only (on the card the flash kernels run).  The
    per-leaf update is the reference's own path for
    ``fused_step=False`` and for optimizers the kernel does not hold, so
    it runs on any device; ``meta`` tensors stand in for the card's."""
    cfg = llama_tiny_config()
    cfg.fuse_norm_rope = False
    cfg.use_flash_attention = False
    m = LlamaForCausalLM(cfg, device="cpu").to("meta")
    with pytest.raises(NotImplementedError, match="flash kernels"):
        m(torch.zeros(1, 4, dtype=torch.long, device="meta"))
    opt = optim.AdamW(learning_rate=LR, parameters=m.parameters())
    params = dict(m.named_parameters())
    new_p, st = opt.apply_gradients(params, params, opt.init_state(params))
    assert all(new_p[n].device.type == "meta"
               and new_p[n].shape == p.shape for n, p in params.items())
    assert st["step"].device.type == "meta"


@pytest.mark.parametrize("setting,item", [
    ({"sequence_parallel": True}, "remaining modules"),
    ({"sequence_parallel": True, "recompute": True,
      "recompute_granularity": "core_attn"}, "remaining modules"),
    ({"fuse_norm_rope": False, "sequence_parallel": True},
     "remaining modules"),
])
def test_forward_settings_outside_the_slice_raise(setting, item):
    cfg = llama_tiny_config()
    for k, v in setting.items():
        setattr(cfg, k, v)
    m = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        m(torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("gran", ["selective", "core-attn", ""])
def test_unknown_recompute_granularity_raises(gran):
    """As in the reference, an unknown policy is a ValueError, raised
    when the forward reaches the first layer."""
    cfg = llama_tiny_config()
    cfg.recompute, cfg.recompute_granularity = True, gran
    m = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        m(torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("setting", ["attention_bias", "rope_interleaved",
                                     "fuse_qkv"])
def test_model_settings_outside_the_slice_raise(setting):
    """The three attention knobs are ported (their parity with the
    reference: ``test_torch_llama_options.py``); the one model knob left
    outside the port, ``sequence_parallel``, raises in the forward."""
    cfg = LlamaConfig(**{**vars(llama_tiny_config()), setting: True})
    m = LlamaForCausalLM(cfg, device="cpu")
    assert m(torch.zeros(1, 4, dtype=torch.long)).shape == (1, 4, 256)
    cfg.sequence_parallel = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m(torch.zeros(1, 4, dtype=torch.long))


def test_trainer_and_optimizer_knobs_outside_the_slice_raise():
    """Every trainer knob is ported now: ``state_sharding_fn`` (a sharded
    train state, ``distributed.ShardedTrainStep``'s) is applied to the
    state at construction, as the reference's is; ``donate=False``,
    ``has_aux``, ``grad_norm_tap``, checkpoints and LR schedulers
    (``test_torch_train_state``, ``test_torch_lr``) and amp O1
    (``test_torch_amp.py``: its ``decorate`` casts no parameter) run.  A
    learning rate that is neither a float nor a scheduler is refused."""
    m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    opt = optim.AdamW(learning_rate=LR, parameters=m.parameters())
    seen = []
    step = CompiledTrainStep(
        m, _loss, opt, state_sharding_fn=lambda s: seen.append(s) or
        {**s, "tag": 1})
    assert len(seen) == 1 and step.state["tag"] == 1
    assert set(seen[0]) == {"params", "opt"}
    for knob in ({"donate": False}, {"has_aux": True},
                 {"grad_norm_tap": True}):
        CompiledTrainStep(m, _loss, opt, **knob)
    with pytest.raises(ValueError, match="LRScheduler"):
        optim.AdamW(learning_rate=object())
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    assert amp.decorate(m, level="O1") is m
    for n, p in m.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[n]), n
