"""The add+norm backward's plain version (CPU) against autograd of the
plain forward and against the reference's VJP rules.

``add_rms_norm_backward_reference`` / ``add_layer_norm_backward_reference``
(the formula the backward kernel of ``csrc/add_norm.cu`` is held to on
the card) on the same numpy inputs as autograd through the port's plain
forward and as ``paddle_tpu``'s ``_add_rms_bwd`` / ``_add_ln_bwd``: RMS,
LN and LN with a bias, every dtype pair of f32 and bf16, with and
without h's own gradient (the reference gets zeros for it).

Tolerances, as max |error| over max |reference|: f32 1e-6 (the closed
form sums in another order than autograd's chain: a few f32 ulps); bf16
and the mixed pairs 2^-7, one bf16 step at the largest element's binade
(an f32 sum in another order can cross a bf16 rounding edge before the
gradient is rounded to h's dtype).  ``dw`` and ``db`` are the row sums
in the weight's dtype; against the reference they are held relative to
the largest column sum of |terms| instead (the same 1e-6 / 2^-7): XLA
sums the reference's 16-bit cotangents over the two leading axes in
stages, each rounded to bf16 (its db differed from the f32 sum rounded
once by 0.125 at a largest element of 9.25), and a rounding of a
partial sum is bounded by the sum of the magnitudes, not of the values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_train as ref_ft

from paddle_tpu_torch.ops import fused_train as ft

PAIRS = {"f32": (torch.float32, torch.float32),
         "bf16": (torch.bfloat16, torch.bfloat16),
         "bf16_f32w": (torch.bfloat16, torch.float32),
         "f32_bf16w": (torch.float32, torch.bfloat16)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
EPS = 1e-5


def _tol(xdt, wdt):
    return 1e-6 if xdt == wdt == torch.float32 else 2.0 ** -7


def _err(got, want):
    g = got.detach().float().numpy()
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _case(body, pair, seed=0):
    """numpy f32 inputs holding values of their dtypes: x, r, w, b (or
    None), dh, dy; and the dtypes."""
    xdt, wdt = PAIRS[pair]
    odt = torch.promote_types(xdt, wdt)
    rng = np.random.default_rng(seed)

    def arr(shape, dt, scale=1.0, shift=0.0):
        a = torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                             .astype(np.float32))
        return a.to(dt).float().numpy()

    shape = (2, 8, 64)
    x, r, dh = (arr(shape, xdt) for _ in range(3))
    w = arr((64,), wdt, 0.3, 1.0)
    b = arr((64,), wdt, 0.3) if body == "ln_bias" else None
    return (x, r, w, b, dh, arr(shape, odt)), (xdt, wdt, odt)


def _t(a, dt):
    return None if a is None else torch.from_numpy(a.copy()).to(dt)


def _plain(body, h, w, b, dh, dy):
    if body == "rms":
        return ft.add_rms_norm_backward_reference(h, w, dh, dy, EPS)
    return ft.add_layer_norm_backward_reference(h, w, b, dh, dy, EPS)


def _forward(body, x, r, w, b):
    if body == "rms":
        return ft.add_rms_norm_reference(x, r, w, EPS)
    return ft.add_layer_norm_reference(x, r, w, b, EPS)


BODIES = ["rms", "ln", "ln_bias"]


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh", "no_dh"])
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("body", BODIES)
def test_plain_backward_matches_autograd(body, pair, with_dh):
    (x, r, w, b, dh, dy), (xdt, wdt, odt) = _case(body, pair)
    leaves = [_t(x, xdt), _t(r, xdt), _t(w, wdt), _t(b, wdt)]
    for t in leaves:
        if t is not None:
            t.requires_grad_()
    h, y = _forward(body, *leaves)
    outs, cts = [y], [_t(dy, odt)]
    if with_dh:
        outs.append(h)
        cts.append(_t(dh, xdt))
    wrt = [t for t in leaves if t is not None]
    grads = torch.autograd.grad(outs, wrt, cts)
    dx, dw, db = _plain(body, h.detach(), _t(w, wdt), _t(b, wdt),
                        _t(dh, xdt) if with_dh else None, _t(dy, odt))
    assert dx.dtype == xdt and dw.dtype == wdt
    tol = _tol(xdt, wdt)
    for got, want in zip([dx, dx, dw] + ([db] if b is not None else []),
                         grads):
        assert _err(got, want.float().numpy()) <= tol
    assert db is None if b is None else db.dtype == wdt


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh", "no_dh"])
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("body", BODIES)
def test_plain_backward_matches_reference_vjp(body, pair, with_dh):
    (x, r, w, b, dh, dy), (xdt, wdt, odt) = _case(body, pair, seed=1)
    jx, jr = jnp.asarray(x, JNP[xdt]), jnp.asarray(r, JNP[xdt])
    jw = jnp.asarray(w, JNP[wdt])
    jdh = jnp.asarray(dh if with_dh else np.zeros_like(dh), JNP[xdt])
    cts = (jdh, jnp.asarray(dy, JNP[odt]))
    if body == "rms":
        want = ref_ft._add_rms_bwd(EPS, (jx, jr, jw), cts)
    else:
        jb = None if b is None else jnp.asarray(b, JNP[wdt])
        want = ref_ft._add_ln_bwd(EPS, (jx, jr, jw, jb), cts)
    h = _t(r, xdt) + _t(x, xdt)
    tdy = _t(dy, odt)
    dx, dw, db = _plain(body, h, _t(w, wdt), _t(b, wdt),
                        _t(dh, xdt) if with_dh else None, tdy)
    tol = _tol(xdt, wdt)
    want = [np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in want
            if a is not None]
    for g in (dx, dx):
        assert _err(g, want.pop(0)) <= tol
    # dw's terms dy * round(n), db's dy: each sum held against the
    # largest column sum of its terms' magnitudes
    n = _forward(body, torch.zeros_like(h), h, torch.ones(64, dtype=xdt),
                 None)[1].float()
    for g, terms in zip([dw] + ([db] if b is not None else []),
                        [tdy.float() * n, tdy.float()]):
        scale = terms.abs().sum((0, 1)).max().item()
        err = np.abs(g.float().numpy() - want.pop(0)).max() / scale
        assert err <= tol, err


@pytest.mark.parametrize("body", BODIES)
def test_leaves_get_equal_unaliased_grads_from_h(body):
    """x and residual are both leaves: each gets dx, equal and in its own
    storage; the Function saves h (its output) with the weight and bias,
    never x or the residual; h unused reaches the backward as None."""
    (x, r, w, b, dh, dy), (xdt, wdt, odt) = _case(body, "bf16", seed=2)
    tx, tr = _t(x, xdt).requires_grad_(), _t(r, xdt).requires_grad_()
    tw, tb = _t(w, wdt).requires_grad_(), _t(b, wdt)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        if body == "rms":
            h, y = ft.add_rms_norm_raw(tx, tr, tw, EPS)
        else:
            h, y = ft.add_layer_norm_raw(tx, tr, tw, tb, EPS)
    ptrs = {t.data_ptr() for t in saved}
    assert h.data_ptr() in ptrs and tw.data_ptr() in ptrs
    assert tx.data_ptr() not in ptrs and tr.data_ptr() not in ptrs
    seen = []
    plain = ft._norm_backward_plain

    def spy(*args):
        seen.append(args[3])
        return plain(*args)

    ft._norm_backward_plain = spy
    try:
        (y.float() * _t(dy, odt).float()).sum().backward()
    finally:
        ft._norm_backward_plain = plain
    assert seen == [None]                  # h's gradient was never made
    assert torch.equal(tx.grad, tr.grad)
    assert tx.grad.data_ptr() != tr.grad.data_ptr()
    want, _, _ = _plain(body, h.detach(), _t(w, wdt), _t(b, wdt), None,
                        _t(dy, odt))
    assert torch.equal(tx.grad, want)


def test_backward_raw_runs_the_plain_version_on_the_cpu():
    (x, r, w, b, dh, dy), (xdt, wdt, odt) = _case("ln_bias", "f32")
    h = _t(r, xdt) + _t(x, xdt)
    before = (ft.add_rms_norm_backward_raw.launches,
              ft.add_layer_norm_backward_raw.launches)
    got = ft.add_layer_norm_backward_raw(h, _t(w, wdt), _t(b, wdt),
                                         _t(dh, xdt), _t(dy, odt), EPS)
    want = ft.add_layer_norm_backward_reference(
        h, _t(w, wdt), _t(b, wdt), _t(dh, xdt), _t(dy, odt), EPS)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    dx, dw, db = ft.add_rms_norm_backward_raw(h, _t(w, wdt), None,
                                              _t(dy, odt), EPS)
    assert db is None and dx.shape == h.shape and dw.shape == (64,)
    assert (ft.add_rms_norm_backward_raw.launches,
            ft.add_layer_norm_backward_raw.launches) == before == (0, 0)
