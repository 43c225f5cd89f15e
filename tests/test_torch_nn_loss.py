"""The port's training losses (``ops/_nn.py``) against the reference's.

``fused_linear_cross_entropy`` (chunked LM-head product + softmax
cross-entropy, logits recomputed in the backward) and ``cross_entropy``
on the same numpy inputs as ``paddle_tpu.ops._nn``'s, values and, through
``jax.vjp``, gradients.  N = 40 tokens in chunks of 16 (the last one
partial), one label in five ignored (-100).

Tolerances.  f32: 1e-5 relative (f32 sums in another order).  bf16: the
logits are f32 on both sides (exact products of bf16 operands summed in
f32), so the loss also agrees to 1e-5 relative; logits rounded to bf16
would miss that by far at these magnitudes (logits of order 10, whose
bf16 spacing is 0.06).  bf16 gradients: 2^-7 relative L2, two bf16
roundings -- the port rounds the f32 softmax gradient to bf16 before its
product, the reference keeps it f32, and both round the result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import _nn as ref_nn

from paddle_tpu_torch.ops import _nn

N, H, V, CHUNK = 40, 32, 96, 16
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}


def _inputs(transpose_weight, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, N // 2, H)).astype(np.float32)
    w = rng.standard_normal((V, H) if transpose_weight else (H, V)).astype(
        np.float32) * (3.0 / np.sqrt(H))            # logits of order 3
    lab = rng.integers(0, V, (2, N // 2)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.2] = -100
    return x, w, lab


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _as(a, dt):
    """numpy f32 -> (jax array, torch tensor) of one dtype, holding the
    same values (bf16 rounded once, by torch)."""
    t = torch.from_numpy(a).to(DTYPES[dt][2])
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dt][1]), t


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("transpose_weight", [False, True],
                         ids=["w_hv", "w_vh_tied"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_fused_linear_cross_entropy_matches_reference(dt, transpose_weight,
                                                      reduction):
    x, w, lab = _inputs(transpose_weight)
    (jx, tx), (jw, tw) = _as(x, dt), _as(w, dt)
    if dt == "bf16":      # logits of order 10: their bf16 spacing is 0.06
        jw, tw = jw * 4, tw * 4

    def ref(x_, w_):
        return ref_nn.fused_linear_cross_entropy(
            x_, w_, jnp.asarray(lab), reduction=reduction,
            transpose_weight=transpose_weight, chunk_size=CHUNK)

    want, vjp = jax.vjp(ref, jx, jw)
    tx.requires_grad_()
    tw.requires_grad_()
    got = _nn.fused_linear_cross_entropy(
        tx, tw, torch.from_numpy(lab), reduction=reduction,
        transpose_weight=transpose_weight, chunk_size=CHUNK)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.detach().numpy(), want) <= 1e-5
    cot = np.random.default_rng(1).random(want.shape).astype(np.float32)
    want_dx, want_dw = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
    assert _rel(tx.grad.float().numpy(), want_dx) <= GRAD_TOL[dt]
    assert _rel(tw.grad.float().numpy(), want_dw) <= GRAD_TOL[dt]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_reference(reduction):
    x, w, lab = _inputs(False)
    logits = (x @ w).reshape(N, V)
    want = ref_nn.cross_entropy(jnp.asarray(logits), jnp.asarray(
        lab.reshape(N)), reduction=reduction)
    got = _nn.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(lab.reshape(N)),
                            reduction=reduction)
    assert _rel(got.numpy(), want) <= 1e-5


def test_losses_refuse_what_they_do_not_take():
    """A bias of another length than the vocabulary, and an unknown
    reduction (a bias of the right length is ported:
    ``test_torch_losses.py``)."""
    x, w, lab = _inputs(False)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="bias"):
        _nn.fused_linear_cross_entropy(t(x), t(w), t(lab),
                                       bias=torch.zeros(V + 1))
    with pytest.raises(ValueError, match="reduction"):
        _nn.fused_linear_cross_entropy(t(x), t(w), t(lab), reduction="max")
