"""The port's fused optimizer update (plain version, CPU) against the
reference's.

``fused_update_reference`` against the reference's for SGD, Momentum
(plain and Nesterov), Adam with L2 decay and AdamW, with and without a
clip scale, on f32 and bf16 parameters (bf16 gradients with bf16
parameters, so the clip fold rounds through bf16).  Both compute op for
op in f32; XLA may contract a multiply-add into one rounding where
PyTorch rounds twice, so values agree within 2 f32 ulps (rtol 2.4e-7)
and new bf16 parameters within one bf16 ulp (the f32 value may sit on a
rounding boundary).

``Optimizer.apply_gradients_fused`` (packed and per leaf) and
``fused_update_flat`` (in place) against the reference's
``apply_gradients_fused`` over a small tree of mixed-size leaves: f32
parameters within rtol 1e-6 and slots within 1e-5 over two steps, since
the global norm is summed in another order and its clip scale may move
by an ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import fused_train as ref_ft

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, global_norm_sq_f32
from paddle_tpu_torch.ops import fused_train as ft

HYPER = {
    "sgd": {"weight_decay": 0.01, "decoupled": False},
    "momentum": {"weight_decay": 0.0, "decoupled": False, "momentum": 0.9,
                 "nesterov": False},
    "nesterov": {"weight_decay": 0.01, "decoupled": False,
                 "momentum": 0.9, "nesterov": True},
    "adam_l2": {"weight_decay": 0.01, "decoupled": False, "beta1": 0.9,
                "beta2": 0.999, "epsilon": 1e-8},
    "adamw": {"weight_decay": 0.01, "decoupled": True, "beta1": 0.9,
              "beta2": 0.95, "epsilon": 1e-8},
}
KIND = {"sgd": "sgd", "momentum": "momentum", "nesterov": "momentum",
        "adam_l2": "adam", "adamw": "adam"}
F32_RTOL = 2.4e-7


def _case(kind, dtype, seed=0, n=(33, 40)):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 0.1).astype(np.float32)
    if dtype == "bfloat16":      # values a bf16 holds exactly
        p = np.array(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
        g = np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    slots = {k: (rng.standard_normal(n) ** 2 * 0.01).astype(np.float32)
             for k in ft.SLOT_KEYS[kind]}
    return p, g, slots


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 0.37], ids=["noclip", "clip"])
@pytest.mark.parametrize("opt", list(HYPER))
def test_update_reference_matches_reference(opt, clip, dtype):
    kind, hyper = KIND[opt], HYPER[opt]
    p, g, slots = _case(kind, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want_p, want_s = ref_ft.fused_update_reference(
        kind, jnp.asarray(p, jdt), jnp.asarray(g, jdt),
        {k: jnp.asarray(v) for k, v in slots.items()},
        lr=jnp.float32(1e-2), step_f=jnp.float32(3.0),
        clip_scale=None if clip is None else jnp.float32(clip),
        hyper=hyper)
    f32 = torch.float32
    got_p, got_s = ft.fused_update_reference(
        kind, torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt),
        {k: torch.from_numpy(v) for k, v in slots.items()},
        lr=torch.tensor(1e-2, dtype=f32), step_f=torch.tensor(3.0, dtype=f32),
        clip_scale=None if clip is None else torch.tensor(clip, dtype=f32),
        hyper=hyper)
    assert got_p.dtype == tdt
    want_p = np.asarray(want_p.astype(jnp.float32))
    if dtype == "bfloat16":
        assert np.all(np.abs(got_p.float().numpy() - want_p)
                      <= _bf16_ulp(want_p))
    else:
        np.testing.assert_allclose(got_p.numpy(), want_p, rtol=F32_RTOL,
                                   atol=0)
    assert set(got_s) == set(want_s)
    for k in got_s:
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]),
                                   rtol=F32_RTOL, atol=1e-30)


def test_update_flat_is_in_place_and_refuses_bad_slots():
    p, g, slots = _case("adam", "float32")
    tp, tg = torch.from_numpy(p.copy()), torch.from_numpy(g)
    ts = {k: torch.from_numpy(v.copy()) for k, v in slots.items()}
    scal = torch.tensor([1e-2, 3.0, 0.5])
    want_p, want_s = ft.fused_update_reference(
        "adam", tp, tg, ts, lr=scal[0], step_f=scal[1], clip_scale=scal[2],
        hyper=HYPER["adamw"])
    ptr = tp.data_ptr()
    ft.fused_update_flat("adam", tp, tg, ts, scalars=scal, has_clip=True,
                         hyper=HYPER["adamw"])
    assert tp.data_ptr() == ptr
    assert torch.equal(tp, want_p)
    assert all(torch.equal(ts[k], want_s[k]) for k in ts)
    with pytest.raises(ValueError, match="slots"):
        ft.fused_update_flat("momentum", tp, tg, ts, scalars=scal,
                             has_clip=False, hyper=HYPER["momentum"])


def _tree(seed=0):
    """Leaves above and below the 1 MiB packing threshold, in two
    dtypes."""
    rng = np.random.default_rng(seed)
    shapes = {"big.w": (520, 512), "a.norm": (64,), "b.norm": (64,),
              "c.w": (16, 32), "d.bf16": (48,), "e.bf16": (40,)}
    params, grads = {}, {}
    for n, s in shapes.items():
        dt = jnp.bfloat16 if "bf16" in n else jnp.float32
        params[n] = jnp.asarray(rng.standard_normal(s), dt)
        grads[n] = jnp.asarray(rng.standard_normal(s) * 0.5, dt)
    return params, grads


def _to_torch(tree):
    return {n: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        for n, a in tree.items()}


@pytest.mark.parametrize("pack_small", [True, False])
def test_apply_gradients_fused_matches_reference(pack_small):
    params, grads = _tree()
    ref_opt = paddle.optimizer.AdamW(
        learning_rate=1e-2, grad_clip=paddle.ClipGradByGlobalNorm(1.0))
    state = ref_opt.init_state(params)
    for _ in range(2):
        params, state = ref_opt.apply_gradients_fused(
            params, grads, state, pack_small=pack_small)
    tparams, tgrads = _to_torch(_tree()[0]), _to_torch(grads)
    opt = optim.AdamW(learning_rate=1e-2,
                      grad_clip=ClipGradByGlobalNorm(1.0))
    tstate = opt.init_state(tparams)
    for _ in range(2):
        out, tstate = opt.apply_gradients_fused(tparams, tgrads, tstate,
                                                pack_small=pack_small)
        assert out is tparams                       # updated in place
    assert int(tstate["step"]) == int(state["step"]) == 2
    for n, p in tparams.items():
        want = np.asarray(params[n].astype(jnp.float32))
        got = p.float().numpy()
        if p.dtype == torch.bfloat16:
            assert np.all(np.abs(got - want) <= _bf16_ulp(want)), n
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=n)
        for k, t in tstate["slots"][n].items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(state["slots"][n][k]), rtol=1e-5,
                atol=1e-9, err_msg=f"{n}.{k}")


def test_global_norm_sums_bf16_in_f32():
    """A bf16 running sum would saturate near 256; the f32 one does not
    (the reference's regression case)."""
    leaves = [torch.ones(4096, dtype=torch.bfloat16) for _ in range(4)]
    assert float(global_norm_sq_f32(leaves)) == 4 * 4096.0
    scale = float(ClipGradByGlobalNorm(64.0).transform(leaves)[0][0])
    assert scale == pytest.approx(0.5, rel=1e-2)


def test_update_flop_estimate_matches_reference():
    for kind in ("sgd", "momentum", "adam"):
        for clip in (False, True):
            assert ft.update_flop_estimate(kind, 1000, clip) == \
                ref_ft.update_flop_estimate(kind, 1000, clip)
