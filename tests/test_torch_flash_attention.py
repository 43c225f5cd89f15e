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
    with pytest.raises(ValueError, match="dropout_p"):
        port.flash_attention_fwd(t(q), t(k), t(v), dropout_p=1.0,
                                 seed=torch.tensor(0))
    with pytest.raises(ValueError, match="seed"):
        port.flash_attention_fwd(t(q), t(k), t(v), dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="sq <= sk"):
        port.flash_attention_fwd(t(q), t(k), t(v), causal=True)
    with pytest.raises(NotImplementedError, match="mask shape"):
        port.flash_attention_fwd(t(q), t(k), t(v),
                                 mask=torch.zeros(1, 1, 16, 9))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_matches_reference_at_the_prefill_geometry(d):
    """The split path's prefill attention as the engine calls it, cut in
    size: GQA 4, Sq 40 < Sk 96, no causal flag, an additive [1, 1, Sq,
    Sk] position mask with -1e30 stripes (the keys past each row's
    position and every fifth key)."""
    b, sq, sk, h, kvh = 1, 40, 96, 8, 2
    q, k, v, _ = _inputs(b, sq, sk, h, kvh, None, d=d, seed=d)
    pos = np.arange(sq)[:, None] + (sk - sq)
    mask = np.where(np.arange(sk)[None, :] <= pos, 0.0, -1e30)
    mask[:, ::5] = -1e30
    mask = mask.astype(np.float32)[None, None]
    want = ref_nn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=jnp.asarray(mask))
    t = torch.from_numpy
    out, _ = port.flash_attention_fwd(t(q), t(k), t(v), mask=t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


SPLIT_CASES = {
    # name: (B, Sq, Sk, H, KVH, D, causal, mask kind)
    "prefill_striped": (1, 40, 96, 8, 2, 64, False, "striped"),
    "prefill_hidden_rows": (1, 40, 96, 8, 2, 128, False, "rows"),
    # rows 0-63 see keys 0-63 only: the splits past key 64 see no key
    "causal_empty_split": (1, 130, 130, 4, 2, 64, True, None),
    "causal_sq_lt_sk_hidden_rows": (2, 70, 200, 4, 1, 64, True, "rows"),
}


@pytest.mark.parametrize("nsplit", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_merged_key_splits_equal_the_forward(case, nsplit):
    """The f32 kernel's key splits, plain: the merge of 1-4 splits'
    partial (acc, m, l) equals the one-pass forward (1e-5 relative L2,
    lse 1e-5), a split with no key has m = -inf and l = 0, and a row
    whose every key is hidden still gets the mean of V.  The first split
    ends at key 64, the others share the rest."""
    b, sq, sk, h, kvh, d, causal, kind = SPLIT_CASES[case]
    cuts = [0, sk] if nsplit == 1 else \
        [0] + [64 + i * (sk - 64) // (nsplit - 1) for i in range(nsplit)]
    q, k, v, _ = _inputs(b, sq, sk, h, kvh, None, d=d, seed=nsplit)
    mask = None
    if kind is not None:
        rng = np.random.default_rng(7)
        mask = rng.standard_normal((1, 1, sq, sk)).astype(np.float32)
        mask[..., ::5] = -1e30
        if kind == "rows":
            mask[..., -1, :] = -1e30          # in the last row tile
    t = torch.from_numpy
    tm = None if mask is None else t(mask)
    acc, m, l = port.key_split_partials_reference(
        t(q), t(k), t(v), cuts, causal=causal, mask=tm)
    assert bool(((m == -np.inf) == (l == 0)).all())
    if case == "causal_empty_split":
        # rows 0-63 see no key past 63: every split but the first empty
        assert bool(((m[..., :64] == -np.inf).sum(0) == nsplit - 1).all())
    out, lse = port.merge_key_splits_reference(acc, m, l)
    want, want_lse = port.flash_attention_fwd_reference(
        t(q), t(k), t(v), causal=causal, mask=tm)
    rel = ((out - want).norm() / want.norm()).item()
    assert rel <= 1e-5, rel
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    if kind == "rows":
        g = h // kvh
        mean_v = np.repeat(v, g, axis=2).mean(axis=1)      # [B, H, D]
        np.testing.assert_allclose(out[:, -1].numpy(), mean_v, rtol=0,
                                   atol=1e-5)
