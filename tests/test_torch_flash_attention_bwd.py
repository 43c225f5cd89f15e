"""The port's flash-attention backward (plain version, CPU) against the
reference.

``flash_attention_bwd_reference`` and the gradients that flow through
``_FlashAttention`` (via ``nn.functional.scaled_dot_product_attention``)
against ``jax.vjp`` of the reference's jnp ``scaled_dot_product_attention``
on the same numpy inputs and output cotangent.  Cases: causal square,
causal with Sq < Sk, GQA with G = 4, and an additive mask (with -1e30
entries).  One more case runs the reference's Pallas backward
``_bwd_impl`` in interpret mode and feeds the port the reference
forward's own output and lse.  Tolerance 2e-5 absolute on gradients of
order 1: f32 sums in another order, and the lse-based softmax against
the oracle's direct one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops import _nn as ref_nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as port

CASES = {
    # name: (B, Sq, Sk, H, KVH, causal, mask shape or None)
    "causal_square": (2, 16, 16, 4, 4, True, None),
    "causal_sq_lt_sk": (1, 8, 24, 4, 2, True, None),
    "gqa4": (1, 16, 16, 8, 2, False, None),
    "masked": (2, 8, 24, 4, 4, False, (2, 1, 8, 24)),
    "gqa4_causal_masked_bcast": (1, 8, 16, 8, 2, True, (1, 8, 1, 16)),
}
TOL = 2e-5


def _inputs(b, sq, sk, h, kvh, mask_shape, d=16, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.standard_normal((b, sq, h, d)).astype(f)
    k = rng.standard_normal((b, sk, kvh, d)).astype(f)
    v = rng.standard_normal((b, sk, kvh, d)).astype(f)
    do = rng.standard_normal((b, sq, h, d)).astype(f)
    mask = None
    if mask_shape is not None:
        mask = rng.standard_normal(mask_shape).astype(f)
        mask[..., : mask_shape[-1] // 3] = -1e30
    return q, k, v, do, mask


def _ref_grads(q, k, v, do, mask, causal):
    def f(q, k, v):
        return ref_nn.scaled_dot_product_attention(
            q, k, v, attn_mask=None if mask is None else jnp.asarray(mask),
            is_causal=causal)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_reference_vjp(case):
    b, sq, sk, h, kvh, causal, mshape = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, h, kvh, mshape)
    want = _ref_grads(q, k, v, do, mask, causal)
    t = torch.from_numpy
    tmask = None if mask is None else t(mask)

    out, lse = port.flash_attention_fwd(t(q), t(k), t(v), causal=causal,
                                        mask=tmask)
    got = port.flash_attention_bwd(t(q), t(k), t(v), out, lse, t(do),
                                   causal=causal, mask=tmask)
    assert got[1].shape == (b, sk, kvh, 16)      # kv-head granular
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)

    # the same gradients through the autograd Function
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    F.scaled_dot_product_attention(qt, kt, vt, attn_mask=tmask,
                                   is_causal=causal).backward(t(do))
    for x, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=0, atol=TOL)


def test_backward_matches_reference_pallas_bwd_impl():
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("this jax has no pltpu.force_tpu_interpret_mode "
                    "(kernel-vs-reference parity needs TPU-capable jax)")
    from paddle_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd
    b, s, h, kvh, d = 1, 64, 8, 2, 64
    q, k, v, do, _ = _inputs(b, s, s, h, kvh, None, d=d, seed=3)
    tr = [jnp.asarray(np.swapaxes(x, 1, 2)) for x in (q, k, v, do)]
    with pltpu.force_tpu_interpret_mode():
        out, lse = _fwd(*tr[:3], causal=True, bq=32, bk=32)
        want = _bwd_impl(*tr[:3], out, lse, tr[3], causal=True, bq=32,
                         bk=32)
    t = torch.from_numpy
    got = port.flash_attention_bwd_reference(
        t(q), t(k), t(v), t(np.swapaxes(np.asarray(out), 1, 2).copy()),
        t(np.asarray(lse)[..., 0].copy()), t(do), causal=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(w), 1, 2),
                                   rtol=0, atol=TOL)


def test_backward_outside_the_slice_raises():
    """What the kernels still refuse: a trained bias that broadcasts over
    the query rows off the CPU (``meta`` tensors stand for the card's:
    the refusal comes before any launch), and dropout_p of 1 or more."""
    q, k, v, do, _ = _inputs(1, 8, 8, 4, 4, None)
    meta = [torch.from_numpy(x).to("meta").requires_grad_()
            for x in (q, k, v)]
    bias = torch.zeros(1, 4, 1, 8, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="remaining kernels"):
        F.scaled_dot_product_attention(*meta, attn_mask=bias)
    t = torch.from_numpy
    qt = t(q).requires_grad_()
    for p in (1.0, 1.5):
        with pytest.raises(ValueError, match="dropout_p"):
            F.scaled_dot_product_attention(qt, t(k), t(v), dropout_p=p)


def test_reference_attention_matches_flash_gradients():
    """``use_flash_attention=False``'s plain attention is differentiable
    by autograd and agrees with the flash path in f32."""
    b, sq, sk, h, kvh, causal, _ = CASES["causal_sq_lt_sk"]
    q, k, v, do, _ = _inputs(b, sq, sk, h, kvh, None)
    grads = []
    for fn in (F.scaled_dot_product_attention,
               F.scaled_dot_product_attention_ref):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        fn(*xs, is_causal=causal).backward(torch.from_numpy(do))
        grads.append([x.grad for x in xs])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=0, atol=TOL)
