"""The port's flash-attention forward (plain version, CPU) against the
reference's jnp ``scaled_dot_product_attention``.

Cases: an additive mask (with -1e30 entries, as the engine's prefill
uses), causal with Sq < Sk, and GQA — each alone and combined.  Outputs
agree within 1e-5 (f32 sums in another order); the log-sum-exp is
checked against numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import _nn as ref_nn

from paddle_tpu_torch.ops import flash_attention as port

CASES = {
    # name: (B, Sq, Sk, H, KVH, causal, mask shape or None)
    "masked": (2, 8, 24, 4, 4, False, (2, 1, 8, 24)),
    "causal_sq_lt_sk": (1, 8, 16, 4, 4, True, None),
    "gqa": (2, 16, 16, 8, 2, False, None),
    "gqa_causal_masked_bcast": (1, 8, 16, 8, 2, True, (1, 8, 1, 16)),
}


def _inputs(b, sq, sk, h, kvh, mask_shape, d=16, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.standard_normal((b, sq, h, d)).astype(f)
    k = rng.standard_normal((b, sk, kvh, d)).astype(f)
    v = rng.standard_normal((b, sk, kvh, d)).astype(f)
    mask = None
    if mask_shape is not None:
        mask = rng.standard_normal(mask_shape).astype(f)
        # hide a stripe of keys, with the engine's -1e30
        mask[..., : mask_shape[-1] // 3] = -1e30
    return q, k, v, mask


@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_matches_reference(case):
    b, sq, sk, h, kvh, causal, mshape = CASES[case]
    q, k, v, mask = _inputs(b, sq, sk, h, kvh, mshape)
    want = ref_nn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=None if mask is None else jnp.asarray(mask),
        is_causal=causal)
    t = torch.from_numpy
    out, lse = port.flash_attention_fwd(
        t(q), t(k), t(v), causal=causal,
        mask=None if mask is None else t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # log-sum-exp of the scaled, masked scores, per (b, h, row)
    g = h // kvh
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k, g, axis=2).astype(np.float64)) / np.sqrt(16)
    if mask is not None:
        s = s + mask
    if causal:
        vis = np.arange(sq)[:, None] + (sk - sq) >= np.arange(sk)[None]
        s = np.where(vis, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(port.flash_attention_raw(
        t(q), t(k), t(v), causal=causal,
        mask=None if mask is None else t(mask)), out)


def test_flash_forward_outside_the_slice_raises():
    q, k, v, _ = _inputs(1, 16, 8, 4, 4, None)
    t = torch.from_numpy
    with pytest.raises(NotImplementedError, match="training"):
        port.flash_attention_fwd(t(q), t(k), t(v), dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="sq <= sk"):
        port.flash_attention_fwd(t(q), t(k), t(v), causal=True)
    with pytest.raises(NotImplementedError, match="mask shape"):
        port.flash_attention_fwd(t(q), t(k), t(v),
                                 mask=torch.zeros(1, 1, 16, 9))
