"""The port's fused step regions (plain versions, CPU) against the
reference's.

``add_rms_norm``, ``add_layer_norm`` (with and without bias),
``matmul_rope`` and ``qkv_rope`` of ``paddle_tpu_torch.nn.functional``
against ``paddle_tpu``'s on the same numpy inputs, forward and VJP, in
f32 and bf16 (bf16 inputs, weights and cotangents; the matmul+rope
tables in bf16 too, as amp O2 leaves them).  The reference runs its jnp
composition on the CPU (its kernels engage on a TPU only); one case per
kernel runs the reference's Pallas kernel itself in interpret mode.

Tolerances, as max |error| over max |reference|, forward and VJP: f32
1e-6 (the same operations; XLA and PyTorch sum the row statistics and
the products in another order, a few f32 ulps: 2.1e-7 measured); bf16
2^-7, one bf16 step at the largest element's binade (an f32 sum in
another order can cross a bf16 rounding edge: 6.9e-3 measured).
``h = residual + x`` is exact in both frameworks and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops import _nn as ref_nn
from paddle_tpu.ops.pallas import fused_train as ref_ft

from paddle_tpu_torch.models.llama import _rope_cos_sin
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.norm import LayerNorm, RMSNorm
from paddle_tpu_torch.ops import _nn
from paddle_tpu_torch.ops import fused_train as ft

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 1e-6, "bf16": 2.0 ** -7}
EPS = 1e-5


def _arrays(dt, shapes, seed=0, scale=1.0):
    """numpy f32 arrays holding values the dtype represents exactly."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        out.append(np.asarray(jnp.asarray(a, DTYPES[dt][1]).astype(
            jnp.float32)))
    return out


def _t(a, dt):
    return torch.from_numpy(a.copy()).to(DTYPES[dt][0])


def _j(a, dt):
    return jnp.asarray(a, DTYPES[dt][1])


def _err(got, want):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _vjp_port(fn, ins, cts):
    leaves = [t.clone().requires_grad_() for t in ins]
    outs = fn(*leaves)
    return outs, torch.autograd.grad(outs, leaves, cts)


def _vjp_ref(fn, ins, cts):
    outs, vjp = jax.vjp(fn, *ins)
    return outs, vjp(cts)


def _check(port_outs, ref_outs, dt):
    for i, (p, r) in enumerate(zip(port_outs, ref_outs)):
        assert p.dtype == DTYPES[dt][0], (i, p.dtype)
        assert _err(p, r) <= TOL[dt], (i, _err(p, r))


def _norm_case(dt, bias):
    x, r, dh, dy = _arrays(dt, [(2, 8, 64)] * 4)
    w, b = _arrays(dt, [(64,), (64,)], seed=1, scale=0.3)
    w = w + 1.0                  # near the ones a norm starts from
    w = np.asarray(jnp.asarray(w, DTYPES[dt][1]).astype(jnp.float32))
    return [x, r, w] + ([b] if bias else []), [dh, dy]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_add_rms_norm_matches_reference(dt):
    ins, cts = _norm_case(dt, bias=False)
    (ph, py), pg = _vjp_port(
        lambda x, r, w: F.add_rms_norm(x, r, w, EPS),
        [_t(a, dt) for a in ins], tuple(_t(a, dt) for a in cts))
    (rh, ry), rg = _vjp_ref(
        lambda x, r, w: ref_ft.add_rms_norm_raw(x, r, w, EPS),
        [_j(a, dt) for a in ins], tuple(_j(a, dt) for a in cts))
    assert _err(ph, rh) == 0.0
    _check([py], [ry], dt)
    _check(pg, rg, dt)
    assert ft.add_rms_norm_raw.launches == 0      # the plain version ran


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_add_layer_norm_matches_reference(dt, bias):
    ins, cts = _norm_case(dt, bias)

    def port(x, r, w, b=None):
        return F.add_layer_norm(x, r, w, b, EPS)

    def ref(x, r, w, b=None):
        return ref_ft.add_layer_norm_raw(x, r, w, b, EPS)

    (ph, py), pg = _vjp_port(port, [_t(a, dt) for a in ins],
                             tuple(_t(a, dt) for a in cts))
    (rh, ry), rg = _vjp_ref(ref, [_j(a, dt) for a in ins],
                            tuple(_j(a, dt) for a in cts))
    assert _err(ph, rh) == 0.0
    _check([py], [ry], dt)
    _check(pg, rg, dt)
    assert ft.add_layer_norm_raw.launches == 0


def _rope_tables(s, d, dt):
    ang = _rope_cos_sin(s, d, 10000.0)
    return [np.asarray(jnp.asarray(f(ang), DTYPES[dt][1]).astype(
        jnp.float32)) for f in (np.cos, np.sin)]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_matmul_rope_matches_reference(dt):
    b, s, k, nh, hd = 2, 8, 64, 4, 16
    x, w, ct = _arrays(dt, [(b, s, k), (k, nh * hd), (b, s, nh, hd)])
    cos, sin = _rope_tables(s, hd, dt)
    kw = dict(n_heads=nh, head_dim=hd)
    out, pg = _vjp_port(
        lambda x, w: ft.matmul_rope_raw(x, w, _t(cos, dt), _t(sin, dt),
                                        **kw), [_t(x, dt), _t(w, dt)],
        _t(ct, dt))
    want, rg = _vjp_ref(
        lambda x, w: ref_ft.matmul_rope_raw(x, w, _j(cos, dt), _j(sin, dt),
                                            **kw), [_j(x, dt), _j(w, dt)],
        _j(ct, dt))
    _check([out], [want], dt)
    _check(pg, rg, dt)
    assert ft.matmul_rope_raw.launches == 0


@pytest.mark.parametrize("dt", list(DTYPES))
def test_qkv_rope_matches_reference(dt):
    b, s, k, nh, nkv, hd = 2, 8, 64, 4, 2, 16
    x, wq, wk, wv = _arrays(dt, [(b, s, k), (k, nh * hd), (k, nkv * hd),
                                 (k, nkv * hd)], scale=0.5)
    cts = _arrays(dt, [(b, s, nh, hd), (b, s, nkv, hd), (b, s, nkv, hd)],
                  seed=2)
    cos, sin = _rope_tables(s, hd, dt)
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=hd)
    outs, pg = _vjp_port(
        lambda *a: F.qkv_rope(*a, _t(cos, dt), _t(sin, dt), **kw),
        [_t(a, dt) for a in (x, wq, wk, wv)],
        tuple(_t(c, dt) for c in cts))
    want, rg = _vjp_ref(
        lambda *a: ref_ft.qkv_rope_raw(*a, _j(cos, dt), _j(sin, dt), **kw),
        [_j(a, dt) for a in (x, wq, wk, wv)], tuple(_j(c, dt) for c in cts))
    _check(outs, want, dt)
    _check(pg, rg, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_plain_versions_match_reference_pallas_kernels(dt):
    """The reference's kernels #9 (RMS and LN bodies) and #10, run in
    Pallas interpret mode at shapes they take (H 128, rows a multiple of
    the row tile; head_dim 128), against the port's plain versions."""
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("this jax has no pltpu.force_tpu_interpret_mode")
    x, r, xm, wq = _arrays(dt, [(2, 16, 128), (2, 16, 128), (2, 32, 128),
                                (128, 256)])
    w, bias = _arrays(dt, [(128,), (128,)], seed=1, scale=0.3)
    cos, sin = _rope_tables(32, 128, dt)
    with pltpu.force_tpu_interpret_mode():
        rms = ref_ft._add_rms_norm_k(_j(x, dt), _j(r, dt), _j(w, dt), EPS)
        ln = ref_ft._add_ln_k(_j(x, dt), _j(r, dt), _j(w, dt),
                              _j(bias, dt), EPS)
        mmr = ref_ft._matmul_rope_k(_j(xm, dt), _j(wq, dt), _j(cos, dt),
                                    _j(sin, dt), 2, 128, False)
    got_rms = ft.add_rms_norm_reference(_t(x, dt), _t(r, dt), _t(w, dt),
                                        EPS)
    got_ln = ft.add_layer_norm_reference(_t(x, dt), _t(r, dt), _t(w, dt),
                                         _t(bias, dt), EPS)
    got_mmr = ft.matmul_rope_reference(_t(xm, dt), _t(wq, dt), _t(cos, dt),
                                       _t(sin, dt), 2, 128)
    for got, want in ((got_rms, rms), (got_ln, ln)):
        assert _err(got[0], want[0]) == 0.0
        _check([got[1]], [want[1]], dt)
    _check([got_mmr], [mmr], dt)


def test_norm_modules_route_through_the_fused_regions():
    x, r = (torch.randn(2, 5, 32) for _ in range(2))
    rms = RMSNorm(32, 1e-5, device="cpu")
    h, y = rms.forward_residual(x, r)
    torch.testing.assert_close(h, r + x, rtol=0, atol=0)
    torch.testing.assert_close(y, rms(r + x), rtol=0, atol=0)
    ln = LayerNorm(32, 1e-5, device="cpu")
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5)
        ln.bias.uniform_(-0.5, 0.5)
    h, y = ln.forward_residual(x, r)
    torch.testing.assert_close(y, ln(r + x), rtol=0, atol=0)
    # the plain forward against the reference's layer_norm
    want = ref_nn.layer_norm(jnp.asarray((r + x).numpy()), [32],
                             jnp.asarray(ln.weight.detach().numpy()),
                             jnp.asarray(ln.bias.detach().numpy()), 1e-5)
    assert _err(ln(r + x), want) <= TOL["f32"]
    # a 2-D normalized shape takes the unfused chain
    ln2 = LayerNorm([5, 32], device="cpu", bias_attr=False)
    assert ln2.bias is None
    h, y = ln2.forward_residual(x, r)
    torch.testing.assert_close(y, _nn.layer_norm(r + x, [5, 32],
                                                 ln2.weight), rtol=0, atol=0)


def test_fused_regions_refuse_tensors_off_the_cpu():
    """Off the CPU the wrappers launch their kernel or raise; ``meta``
    tensors stand in for the card's here and reach the kernels' checks."""
    m = {"device": "meta"}
    x = torch.zeros(2, 8, 64, **m)
    w = torch.zeros(64, **m)
    with pytest.raises(NotImplementedError, match="needs a weight"):
        F.add_rms_norm(x, x, None)
    # float16 and a 16-bit x over an f32 residual are kernel modes; two
    # 16-bit dtypes, or a weight in the other 16-bit dtype, are not
    with pytest.raises(NotImplementedError, match="one 16-bit over float32"):
        F.add_rms_norm(x.half(), x.bfloat16(), w)
    with pytest.raises(NotImplementedError, match="one 16-bit over float32"):
        F.add_rms_norm(x.bfloat16(), x.bfloat16(), w.half())
    big = torch.zeros(2, 8192 + 128, **m)
    with pytest.raises(NotImplementedError, match="up to 8192"):
        F.add_layer_norm(big, big, torch.zeros(8192 + 128, **m), None)
    with pytest.raises(ValueError, match="CUDA device"):
        F.add_rms_norm(x, x, w)
    cos = torch.zeros(8, 16, **m)
    with pytest.raises(NotImplementedError, match="head_dim 64 and 128"):
        ft.matmul_rope_raw(x, torch.zeros(64, 64, **m), cos, cos,
                           n_heads=4, head_dim=16)
    cos = torch.zeros(8, 64, **m)
    # interleaved rope is the reference's own plain route on any device
    # (its kernel declines it), chosen on the knob: no launch, no raise
    before = ft.matmul_rope_raw.launches
    out = ft.matmul_rope_raw(x, torch.zeros(64, 128, **m), cos, cos,
                             n_heads=2, head_dim=64, interleaved=True)
    assert out.shape == (2, 8, 2, 64) and out.device.type == "meta"
    out = ft.matmul_rope_raw(torch.zeros(2, 8, 64), torch.zeros(64, 128),
                             torch.zeros(8, 64), torch.zeros(8, 64),
                             n_heads=2, head_dim=64, interleaved=True)
    assert out.shape == (2, 8, 2, 64)
    assert ft.matmul_rope_raw.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        ft.matmul_rope_raw(x, torch.zeros(64, 128, **m), cos, cos,
                           n_heads=2, head_dim=64)
    with pytest.raises(ValueError, match=r"cos/sin \[S, 64\]"):
        ft.matmul_rope_raw(x, torch.zeros(64, 128, **m), cos[:4], cos[:4],
                           n_heads=2, head_dim=64)
