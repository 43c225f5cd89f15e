"""The port's 14 optimizers, the eager API, the regularizers and the
clips against the reference's, on the CPU.

Inputs are numpy-seeded f32 leaves handed to both packages.  The
per-leaf update (``init_state`` / ``apply_gradients``) of every
optimizer but LBFGS runs 3 steps on both sides: parameters and slots
within rtol 1e-6 (f32 arithmetic in the same order; the tolerance
absorbs XLA's and PyTorch's differently fused transcendental ops).  The
eager ``step`` / ``minimize`` run on ``nn.Parameter``s against the
reference's ``Parameter``s with the same gradients; LBFGS through its
closure; ``state_dict`` round trips.  The fused and unfused AdamW of the
port are bit-equal on the CPU, as the reference promises of its own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as ref_opt
from paddle_tpu import regularizer as ref_reg
from paddle_tpu.nn import clip as ref_clip
from paddle_tpu.tensor import Parameter as RefParameter
from paddle_tpu.tensor import Tensor as RefTensor

from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import regularizer as port_reg
from paddle_tpu_torch.nn import clip as port_clip

RTOL = 1e-6
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}


# (name, kwargs for both packages); the clips and regularizers are made
# per package by the factories below
CASES = [
    ("SGD", {"learning_rate": 0.1}),
    ("SGD_l2", {"learning_rate": 0.1, "weight_decay": "L2"}),
    ("Momentum", {"learning_rate": 0.1, "momentum": 0.9}),
    ("Momentum_nesterov", {"learning_rate": 0.1, "momentum": 0.8,
                           "use_nesterov": True, "weight_decay": 0.01}),
    ("Adam", {"learning_rate": 0.01, "grad_clip": "global"}),
    ("AdamW", {"learning_rate": 0.01, "weight_decay": 0.05}),
    ("Adagrad", {"learning_rate": 0.1, "initial_accumulator_value": 0.1}),
    ("Adamax", {"learning_rate": 0.02}),
    ("RMSProp", {"learning_rate": 0.01, "momentum": 0.5}),
    ("RMSProp_centered", {"learning_rate": 0.01, "centered": True,
                          "grad_clip": "norm"}),
    ("Lamb", {"learning_rate": 0.01, "lamb_weight_decay": 0.02}),
    ("Adadelta", {"learning_rate": 1.0, "grad_clip": "value"}),
    ("ASGD", {"learning_rate": 0.1, "batch_num": 2}),
    ("Rprop", {"learning_rate": 0.01}),
    ("NAdam", {"learning_rate": 0.01}),
    ("RAdam", {"learning_rate": 0.01}),
]


def _make(pkg, name, kw, parameters=None):
    opt_mod, clip_mod, reg_mod = pkg
    kw = dict(kw)
    clip = kw.pop("grad_clip", None)
    if clip is not None:
        kw["grad_clip"] = {"global": lambda: clip_mod.ClipGradByGlobalNorm(
                               0.5),
                           "norm": lambda: clip_mod.ClipGradByNorm(0.3),
                           "value": lambda: clip_mod.ClipGradByValue(
                               0.2)}[clip]()
    if kw.get("weight_decay") == "L2":
        kw["weight_decay"] = reg_mod.L2Decay(0.05)
    elif kw.get("weight_decay") == "L1":
        kw["weight_decay"] = reg_mod.L1Decay(0.05)
    cls = getattr(opt_mod, name.split("_")[0])
    return cls(parameters=parameters, **kw)


REF = (ref_opt, ref_clip, ref_reg)
PORT = (port_opt, port_clip, port_reg)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


def test_every_optimizer_has_a_case():
    names = {c[0].split("_")[0] for c in CASES} | {"LBFGS"}
    assert names == set(port_opt.optimizer.__all__) - {"Optimizer"}
    assert len(names) == 14


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_per_leaf_update_matches_reference(name, kw):
    ref, port = _make(REF, name, kw), _make(PORT, name, kw)
    params = _leaves(0)
    rp = {n: jnp.asarray(v) for n, v in params.items()}
    pp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    rs, ps = ref.init_state(rp), port.init_state(pp)
    for i in range(3):
        grads = _leaves(10 + i, scale=0.5)
        rp, rs = ref.apply_gradients(
            rp, {n: jnp.asarray(g) for n, g in grads.items()}, rs)
        pp, ps = port.apply_gradients(
            pp, {n: torch.from_numpy(g) for n, g in grads.items()}, ps)
        for n in SHAPES:
            _close(pp[n].numpy(), rp[n])
            assert set(ps["slots"][n]) == set(rs["slots"][n])
            for k, v in ps["slots"][n].items():
                _close(v.numpy(), rs["slots"][n][k])
        assert int(ps["step"]) == int(rs["step"]) == i + 1


def _ref_params(arrays):
    return [RefParameter(jnp.asarray(v)) for v in arrays.values()]


def _port_params(arrays):
    return [torch.nn.Parameter(torch.from_numpy(v.copy()))
            for v in arrays.values()]


@pytest.mark.parametrize("name,kw", CASES + [
    ("SGD_l1", {"learning_rate": 0.1, "weight_decay": "L1"}),
    ("Adagrad_l1", {"learning_rate": 0.1, "weight_decay": "L1"})],
    ids=[c[0] for c in CASES] + ["SGD_l1", "Adagrad_l1"])
def test_eager_step_matches_reference(name, kw):
    """``step()`` over the parameters the optimizer holds, 3 times with
    fresh gradients; L1Decay takes its sign form here."""
    start = _leaves(1)
    rps, pps = _ref_params(start), _port_params(start)
    ref = _make(REF, name, kw, parameters=rps)
    port = _make(PORT, name, kw, parameters=pps)
    for i in range(3):
        for rp, pp, g in zip(rps, pps, _leaves(20 + i, 0.5).values()):
            rp._grad = jnp.asarray(g)
            pp.grad = torch.from_numpy(g)
        ref.step()
        port.step()
        for rp, pp in zip(rps, pps):
            _close(pp.detach().numpy(), rp.value)
    port.clear_grad()
    assert all(p.grad is None for p in pps)
    assert port._step_count == ref._step_count == 3


def test_l1_and_l2_decay_differ_on_the_eager_path_only():
    """L1Decay is sign(param) on the eager step and the L2 form on the
    train step's update, as in the reference."""
    start, g = _leaves(2), _leaves(3)
    out = {}
    for reg in ("L1", "L2"):
        pps = _port_params(start)
        opt = _make(PORT, "SGD", {"learning_rate": 0.1, "weight_decay": reg},
                    parameters=pps)
        for p, gg in zip(pps, g.values()):
            p.grad = torch.from_numpy(gg)
        opt.step()
        params = {n: torch.from_numpy(v) for n, v in start.items()}
        new_p, _ = opt.apply_gradients(
            params, {n: torch.from_numpy(v) for n, v in g.items()},
            opt.init_state(params))
        out[reg] = ([p.detach().clone() for p in pps], new_p)
    assert not all(torch.equal(a, b) for a, b in zip(out["L1"][0],
                                                       out["L2"][0]))
    for n in SHAPES:
        assert torch.equal(out["L1"][1][n], out["L2"][1][n])


def test_minimize_matches_reference():
    """``minimize(loss)``: backward, step, clear_grad, on a quadratic."""
    start = _leaves(4)
    target = _leaves(5)
    rps, pps = _ref_params(start), _port_params(start)
    ref = ref_opt.AdamW(learning_rate=0.05, parameters=rps,
                        weight_decay=0.01)
    port = port_opt.AdamW(learning_rate=0.05, parameters=pps,
                          weight_decay=0.01)
    for _ in range(3):
        rloss = sum(((p - RefTensor(jnp.asarray(t))) ** 2).sum()
                    for p, t in zip(rps, target.values()))
        ploss = sum(((p - torch.from_numpy(t)) ** 2).sum()
                    for p, t in zip(pps, target.values()))
        _close(ploss.detach().numpy(), rloss.numpy())
        ref.minimize(rloss)
        port.minimize(ploss)
        assert all(p.grad is None for p in pps)
        for rp, pp in zip(rps, pps):
            _close(pp.detach().numpy(), rp.value)


def test_adamw_apply_decay_param_fun_on_the_eager_step():
    start, g = _leaves(6), _leaves(7)
    rps, pps = _ref_params(start), _port_params(start)
    names = ["norm.bias", "w1", "w2"]
    for rp, n in zip(rps, names):
        rp.name = n
    kw = dict(learning_rate=0.1, weight_decay=0.2, lr_ratio=None,
              apply_decay_param_fun=lambda n: "bias" not in n)
    ref = ref_opt.AdamW(parameters=rps, **kw)
    port = port_opt.AdamW(parameters=list(zip(names, pps)), **kw)
    assert set(port.state_dict()) == {"@step"}
    for rp, pp, gg in zip(rps, pps, g.values()):
        rp._grad, pp.grad = jnp.asarray(gg), torch.from_numpy(gg)
    ref.step()
    port.step()
    for rp, pp in zip(rps, pps):
        _close(pp.detach().numpy(), rp.value)


def _quadratic_lbfgs(pkg, **kw):
    if pkg == "ref":
        w = RefParameter(jnp.zeros(3, jnp.float32))
        tgt = RefTensor(jnp.asarray([3.0, -1.0, 0.5], jnp.float32))
        scale = RefTensor(jnp.asarray([1.0, 10.0, 3.0], jnp.float32))
        opt = ref_opt.LBFGS(parameters=[w], **kw)
    else:
        w = torch.nn.Parameter(torch.zeros(3))
        tgt = torch.tensor([3.0, -1.0, 0.5])
        scale = torch.tensor([1.0, 10.0, 3.0])
        opt = port_opt.LBFGS(parameters=[w], **kw)

    def closure():
        loss = (scale * (w - tgt) * (w - tgt)).sum()
        loss.backward()
        return loss

    loss = opt.step(closure)
    value = np.asarray(w.value) if pkg == "ref" else w.detach().numpy()
    return float(np.asarray(loss.numpy())), value


@pytest.mark.parametrize("kw", [
    {"learning_rate": 1.0, "max_iter": 25, "line_search_fn": "strong_wolfe"},
    {"learning_rate": 0.1, "max_iter": 4, "history_size": 2,
     "weight_decay": 0.1}], ids=["strong_wolfe", "armijo_decay"])
def test_lbfgs_closure_matches_reference(kw):
    rloss, rw = _quadratic_lbfgs("ref", **kw)
    ploss, pw = _quadratic_lbfgs("port", **kw)
    np.testing.assert_allclose(pw, rw, rtol=1e-5, atol=1e-6)
    assert abs(ploss - rloss) <= 1e-5 * max(abs(rloss), 1e-6)


@pytest.mark.parametrize("name", ["AdamW", "NAdam", "ASGD"])
def test_state_dict_round_trip(name):
    """The eager optimizer's ``state_dict`` has the reference's keys and
    values; loaded into a fresh optimizer it continues as the first."""
    kw = dict(next(k for n, k in CASES if n == name))
    start = _leaves(8)
    rps, pps = _ref_params(start), _port_params(start)
    ref = _make(REF, name, kw, parameters=rps)
    port = _make(PORT, name, kw, parameters=pps)
    for i in range(2):
        for rp, pp, g in zip(rps, pps, _leaves(30 + i, 0.5).values()):
            rp._grad, pp.grad = jnp.asarray(g), torch.from_numpy(g)
        ref.step()
        port.step()
    sd, rsd = port.state_dict(), ref.state_dict()
    assert set(sd) == set(rsd) and sd["@step"] == rsd["@step"] == 2
    for k, v in sd.items():
        if k != "@step":
            _close(v.numpy(), rsd[k].numpy())
    copies = _port_params({n: p.detach().numpy() for n, p
                           in zip(SHAPES, pps)})
    again = _make(PORT, name, kw, parameters=copies)
    again.set_state_dict(sd)
    g = _leaves(40, 0.5)
    for ps in (pps, copies):
        for p, gg in zip(ps, g.values()):
            p.grad = torch.from_numpy(gg)
    port.step()
    again.step()
    for a, b in zip(pps, copies):
        assert torch.equal(a, b)


def test_scheduler_state_rides_in_state_dict():
    sched = port_opt.lr.MultiStepDecay(0.1, milestones=[1, 3])
    w = torch.nn.Parameter(torch.ones(2))
    opt = port_opt.SGD(learning_rate=sched, parameters=[w])
    sched.step()
    sched.step()
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 2
    fresh = port_opt.lr.MultiStepDecay(0.1, milestones=[1, 3])
    port_opt.SGD(learning_rate=fresh, parameters=[w]).set_state_dict(sd)
    assert fresh() == sched() and fresh.last_epoch == 2


@pytest.mark.parametrize("clip", [None, "global"])
def test_fused_and_unfused_adamw_bit_equal(clip):
    kw = {"learning_rate": 0.01, "weight_decay": 0.05}
    if clip:
        kw["grad_clip"] = clip
    opt = _make(PORT, "AdamW", kw)
    params = {n: torch.from_numpy(v) for n, v in _leaves(9).items()}
    fused = {n: v.clone() for n, v in params.items()}
    st_u, st_f = opt.init_state(params), opt.init_state(fused)
    for i in range(3):
        grads = {n: torch.from_numpy(v) for n, v in
                 _leaves(50 + i, 2.0).items()}
        params, st_u = opt.apply_gradients(params, grads, st_u)
        fused, st_f = opt.apply_gradients_fused(fused, grads, st_f)
        for n in SHAPES:
            assert torch.equal(params[n], fused[n])
            for k in ("moment1", "moment2"):
                assert torch.equal(st_u["slots"][n][k], st_f["slots"][n][k])


def test_non_fused_kinds_take_the_per_leaf_update():
    """An optimizer or clip the kernel does not hold updates through
    ``apply_gradients`` inside ``apply_gradients_fused`` (in place)."""
    for name, kw in [("Lamb", {"learning_rate": 0.01}),
                     ("AdamW", {"learning_rate": 0.01, "grad_clip": "value"})]:
        opt = _make(PORT, name, kw)
        assert not opt.uses_fused_kernel()
        params = {n: torch.from_numpy(v) for n, v in _leaves(11).items()}
        grads = {n: torch.from_numpy(v) for n, v in _leaves(12).items()}
        want, _ = opt.apply_gradients(params, grads, opt.init_state(params))
        live = {n: v.clone() for n, v in params.items()}
        opt.apply_gradients_fused(live, grads, opt.init_state(live))
        for n in SHAPES:
            assert torch.equal(live[n], want[n])
    assert _make(PORT, "AdamW", {"grad_clip": "global"}).uses_fused_kernel()


@pytest.mark.parametrize("clip", ["global", "norm", "value"])
def test_clip_transforms_match_reference(clip):
    g = _leaves(13, 3.0)
    ref = _make(REF, "SGD", {"grad_clip": clip})._grad_clip
    port = _make(PORT, "SGD", {"grad_clip": clip})._grad_clip
    want = ref.transform([jnp.asarray(v) for v in g.values()])
    got = port.transform([torch.from_numpy(v) for v in g.values()])
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    pairs = port([(None, torch.from_numpy(v)) for v in g.values()])
    for (_, a), b in zip(pairs, got):
        assert torch.equal(a, b)


def test_clip_grad_value_and_norm_match_reference():
    g = _leaves(14, 3.0)
    for fn, arg in (("clip_grad_value_", 0.4), ("clip_grad_norm_", 1.5)):
        rps, pps = _ref_params(_leaves(15)), _port_params(_leaves(15))
        for rp, pp, gg in zip(rps, pps, g.values()):
            rp._grad, pp.grad = jnp.asarray(gg), torch.from_numpy(gg.copy())
        rnorm = getattr(ref_clip, fn)(rps, arg)
        pnorm = getattr(port_clip, fn)(pps, arg)
        if fn == "clip_grad_norm_":
            _close(pnorm.numpy(), rnorm.numpy())
        for rp, pp in zip(rps, pps):
            _close(pp.grad.numpy(), rp._grad)
