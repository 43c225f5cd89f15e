"""The port's DiT, its diffusion objective and ``AutoencoderKL`` against
the reference, with the layers under them (``Conv2D``, ``GroupNorm``,
nearest upsampling) and the random draws they make.

Models in f32 on the CPU: ``dit_tiny_config()`` (2 blocks of 64, 4 heads
of 16, 16 patches) and an ``AutoencoderKL(base=16, groups=4)`` on 2 x 3
x 16 x 16 images.  The reference is built after ``paddle.seed(0)``;
every parameter is then replaced by seeded normal draws (std 0.05; the
adaLN-Zero gates and the final layer start at zero, which would leave
the blocks untested) and loaded into both.  The objective is compared at
the same timesteps, noise and labels (the two frameworks' generators
differ), with the labels kept (``class_dropout_prob`` 0).  Tolerances:
outputs and losses within 1e-5 relative (L2 for tensors; f32 sums in
another order), every gradient within 1e-4 relative L2.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as P
from paddle_tpu.jit.train import CompiledTrainStep as RefStep
from paddle_tpu.models import dit as ref_dit
from paddle_tpu.nn import functional as RF
from paddle_tpu.ops import _nn as ref_nn

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models import dit
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.conv import Conv2D
from paddle_tpu_torch.nn.norm import GroupNorm
from paddle_tpu_torch.ops import random as prandom


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _randomize(ref, seed):
    rng = np.random.default_rng(seed)
    state = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in ref.raw_state_dict().items()}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return state


def _sgd(params):
    return dict(learning_rate=1e-3, parameters=params)


def _grads_match(rstep, pstep, batch):
    loss, grads = rstep.grad_step(batch)
    ploss, pgrads = pstep.grad_step(batch)
    assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert set(pgrads) == set(grads)
    for n, g in pgrads.items():
        assert _rel_l2(np.asarray(grads[n]), g.numpy()) <= 1e-4, n
    return pgrads


@pytest.fixture(scope="module")
def dit_pair():
    cfg = dataclasses.replace(ref_dit.dit_tiny_config(),
                              class_dropout_prob=0.0)
    paddle.seed(0)
    ref = ref_dit.DiTWithDiffusion(cfg)
    state = _randomize(ref, 6)
    pcfg = dataclasses.replace(dit.dit_tiny_config(), class_dropout_prob=0.0)
    port = dit.DiTWithDiffusion(pcfg, device="cpu")
    load_raw_state_dict(port, state)
    rng = np.random.default_rng(7)
    batch = {"x": rng.standard_normal((2, 4, 8, 8)).astype(np.float32),
             "y": np.array([3, 9], np.int32),
             "t": np.array([5, 77], np.int32),
             "eps": rng.standard_normal((2, 4, 8, 8)).astype(np.float32)}
    return ref, port, batch


def _ref_objective(m, b):
    """The reference's ``DiTWithDiffusion.forward`` after its draws."""
    n = b["x"].shape[0]
    sa = P.reshape(P.index_select(m.sqrt_abar, b["t"]), [n, 1, 1, 1])
    s1 = P.reshape(P.index_select(m.sqrt_1m_abar, b["t"]), [n, 1, 1, 1])
    pred = m.dit(b["x"] * sa + b["eps"] * s1, b["t"], b["y"],
                 train=m.training)
    return RF.mse_loss(pred, b["eps"])


def _port_objective(m, b):
    return m.diffusion_loss(b["x"], b["y"], b["t"], b["eps"])


def test_dit_forward_matches_reference(dit_pair):
    ref, port, b = dit_pair
    rstep = RefStep(ref, _ref_objective, paddle.optimizer.AdamW(
        **_sgd(ref.parameters())))
    want = rstep.eval_step(
        lambda m, bb: m.dit(bb["x"], bb["t"], bb["y"], train=False), b)
    with torch.no_grad():
        got = port.dit(*(torch.tensor(b[k]) for k in ("x", "t", "y")),
                       train=False)
    assert got.shape == (2, 4, 8, 8)
    assert _rel_l2(np.asarray(want), got.numpy()) <= 1e-5


def test_diffusion_objective_and_gradients_match_reference(dit_pair):
    ref, port, b = dit_pair
    rstep = RefStep(ref, _ref_objective, paddle.optimizer.AdamW(
        **_sgd(ref.parameters())))
    pstep = CompiledTrainStep(port, _port_objective, optim.AdamW(
        **_sgd(port.parameters())))
    pgrads = _grads_match(rstep, pstep, b)
    for n in ("dit.blocks.0.adaLN.weight", "dit.blocks.1.qkv.weight",
              "dit.x_embed.weight", "dit.pos_embed",
              "dit.t_embed.mlp.0.weight", "dit.y_embed.table.weight"):
        assert pgrads[n].abs().max() > 0, n


def test_diffusion_forward_draws_from_the_guarded_generator(dit_pair):
    """One call draws t and the noise (and, with class dropout, the
    label drop) from the generator the trainer guards: equal seeds give
    equal losses, other seeds others."""
    _, port, b = dit_pair
    port.dit.y_embed.dropout_prob = 0.5
    x, y = torch.tensor(b["x"]), torch.tensor(b["y"])
    losses = []
    with torch.no_grad():
        for seed in (1, 1, 2):
            with prandom.rng_guard(torch.Generator().manual_seed(seed)):
                losses.append(float(port(x, y)))
    port.dit.y_embed.dropout_prob = 0.0
    assert losses[0] == losses[1] != losses[2]


@pytest.fixture(scope="module")
def vae_pair():
    paddle.seed(0)
    ref = ref_dit.AutoencoderKL(base=16, groups=4)
    state = _randomize(ref, 8)
    port = dit.AutoencoderKL(base=16, groups=4, device="cpu")
    load_raw_state_dict(port, state)
    x = np.random.default_rng(9).standard_normal((2, 3, 16, 16)).astype(
        np.float32)
    return ref, port, x


def _encode_decode(m, b):
    mean, logvar = m.encode(b["x"])
    return mean, logvar, m.decode(mean)


def test_vae_encode_and_decode_match_reference(vae_pair):
    ref, port, x = vae_pair
    rstep = RefStep(ref, lambda m, b: _encode_decode(m, b)[2].mean(),
                    paddle.optimizer.AdamW(**_sgd(ref.parameters())))
    want = rstep.eval_step(_encode_decode, {"x": x})
    with torch.no_grad():
        got = _encode_decode(port, {"x": torch.tensor(x)})
    assert got[0].shape == (2, 4, 8, 8) and got[2].shape == (2, 3, 16, 16)
    for w, g in zip(want, got):
        assert _rel_l2(np.asarray(w), g.numpy()) <= 1e-5


def test_vae_gradients_match_reference(vae_pair):
    """The reconstruction + KL loss at the latent mean (no noise draw)."""
    ref, port, x = vae_pair

    def loss(m, b, mse, exp, mean_of):
        mean, logvar = m.encode(b["x"])
        kl = 0.5 * mean_of(exp(logvar) + mean * mean - 1.0 - logvar)
        return mse(m.decode(mean), b["x"]) + 1e-4 * kl

    rstep = RefStep(ref, lambda m, b: loss(m, b, RF.mse_loss, P.exp,
                                           P.mean),
                    paddle.optimizer.AdamW(**_sgd(ref.parameters())))
    pstep = CompiledTrainStep(
        port, lambda m, b: loss(m, b, F.mse_loss, torch.exp, torch.mean),
        optim.AdamW(**_sgd(port.parameters())))
    _grads_match(rstep, pstep, {"x": x})


@pytest.mark.parametrize("stride,padding,groups", [(1, 1, 1), (2, 1, 1),
                                                   (2, 0, 2)])
def test_conv2d_and_group_norm_match_reference(stride, padding, groups):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 4, 9, 9)).astype(np.float32)
    w = rng.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    want = ref_nn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                         stride, padding, 1, groups)
    got = F.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(bias),
                   stride, padding, 1, groups)
    assert _rel_l2(np.asarray(want), got.numpy()) <= 1e-5
    gw, gb = rng.standard_normal((2, 6)).astype(np.float32)
    want = ref_nn.group_norm(want, 3, jnp.asarray(gw), jnp.asarray(gb), 1e-6)
    got = F.group_norm(got, 3, torch.tensor(gw), torch.tensor(gb), 1e-6)
    assert _rel_l2(np.asarray(want), got.numpy()) <= 1e-5
    up = ref_nn.interpolate(want, scale_factor=2.0, mode="nearest")
    assert _rel_l2(np.asarray(up), F.interpolate(
        got, scale_factor=2.0).numpy()) <= 1e-5


def test_amp_o2_keeps_the_reference_promotions(monkeypatch):
    """Under amp O2 the buffers turn bf16 (``sqrt_abar``, as the
    reference's ``Layer.to``), the timestep features stay f32, so the
    blocks' attention and the loss run in f32, as the reference's do."""
    from paddle_tpu_torch import amp
    seen = []
    attend = F.scaled_dot_product_attention

    def spy(q, k, v, **kw):
        seen.append(q.dtype)
        return attend(q, k, v, **kw)

    monkeypatch.setattr(F, "scaled_dot_product_attention", spy)
    model = amp.decorate(dit.DiTWithDiffusion(dit.dit_tiny_config(),
                                              device="cpu"),
                         level="O2", dtype="bfloat16")
    assert model.sqrt_abar.dtype == torch.bfloat16
    assert model.dit.blocks[0].qkv.weight.dtype == torch.bfloat16
    with torch.no_grad():
        loss = model(torch.randn(2, 4, 8, 8), torch.tensor([1, 2]))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert seen == [torch.float32] * 2


def test_layers_and_draws():
    """``Conv2D``'s weight is ``[out, in / groups, kh, kw]`` and its bias
    zeros; ``GroupNorm`` drops its affine parameters on request; the
    draws have the reference's shapes, dtypes and ranges."""
    conv = Conv2D(4, 8, 3, padding=1, groups=2, device="cpu")
    assert conv.weight.shape == (8, 2, 3, 3)
    assert torch.equal(conv.bias, torch.zeros(8))
    assert Conv2D(4, 8, 1, bias_attr=False, device="cpu").bias is None
    gn = GroupNorm(2, 4, weight_attr=False, bias_attr=False, device="cpu")
    assert gn.weight is None and gn.bias is None
    assert not list(gn.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Conv2D(4, 8, 3, padding_mode="reflect", device="cpu")
    with prandom.rng_guard(torch.Generator().manual_seed(3)):
        t = prandom.randint(0, 10, [64], device="cpu")
        u = prandom.rand([64], device="cpu")
        n = prandom.randn([2, 3], dtype=torch.bfloat16, device="cpu")
        hi = prandom.randint(5, shape=[64], device="cpu")
    assert t.dtype == torch.int32 and 0 <= int(t.min()) <= int(t.max()) < 10
    assert u.dtype == torch.float32 and 0.0 <= float(u.min()) < 1.0
    assert n.dtype == torch.bfloat16 and n.shape == (2, 3)
    assert int(hi.max()) < 5
