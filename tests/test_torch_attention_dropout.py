"""In-kernel attention dropout (the dropout mode of #2-#4): the keep bit,
and the plain versions of the forward and both backward kernels.

The reference seeds the TPU's hardware PRNG per (b, h, q tile, k tile),
and in interpret mode that PRNG is stubbed to zeros, so no bit parity
with it exists.  The port's keep bit is a hash of (seed, b, h, row,
col): the tests pin its bits with literals (and a pure-Python twin),
check the keep rate against the binomial, show that the mask depends on
no tiling, and hold the plain forward and backward at p > 0 against a
dense oracle fed the extracted mask (the identity-V trick of
``tests/test_pallas_flash.py``).  At p = 0 the path equals the
reference's ``flash_attention_raw`` run in interpret mode.  Tolerances
1e-5 absolute (f32 sums in another order, values of order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops.pallas.flash_attention import flash_attention_raw

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa

_M32 = 0xFFFFFFFF


def _mix(x, v):
    """One round of the kernels' hash on Python ints: fmix32((x ^ v) *
    0x9E3779B1)."""
    x = ((x ^ v) * 0x9E3779B1) & _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def test_hash_bits_are_fixed():
    seed = torch.tensor(12345)
    idx = [torch.tensor(v) for v in ([0, 3], [1, 11], [0, 1023],
                                     [0, 7, 1023])]
    got = fa.dropout_bits(seed, *idx).flatten().tolist()
    assert got[:6] == [3911972188, 4049573129, 4080642095, 474404578,
                       2310186910, 1301664456]
    assert got[22] == 3431374524                   # b 3, h 11, row 1023, col 7
    want = [_mix(_mix(_mix(_mix(_mix(12345, 0), b), h), r), c)
            for b in (0, 3) for h in (1, 11) for r in (0, 1023)
            for c in (0, 7, 1023)]
    assert got == want
    # a seed above 2^32 folds its high word in
    big = fa.dropout_bits(torch.tensor(2 ** 40 + 5), 1, 1, 1, 1).item()
    assert big == _mix(_mix(_mix(_mix(_mix(5, 2 ** 8), 0), 0), 0), 0)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_is_binomial(p):
    keep = fa.dropout_keep(torch.tensor(7), p, 2, 4, 128, 128)
    n = keep.numel()
    rate = keep.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5
    # rows and heads are not copies of one another
    assert not torch.equal(keep[0, 0, 0], keep[0, 0, 1])
    assert not torch.equal(keep[0, 0], keep[0, 1])


def test_mask_does_not_depend_on_the_tiling():
    seed = torch.tensor(2024)
    whole = fa.dropout_keep(seed, 0.3, 2, 3, 96, 80)
    blocks = torch.cat([fa.dropout_keep(seed, 0.3, 2, 3,
                                        torch.arange(r, r + 32), 80)
                        for r in range(0, 96, 32)], dim=2)
    assert torch.equal(whole, blocks)
    cols = torch.cat([fa.dropout_keep(seed, 0.3, 2, 3, 96,
                                      torch.arange(c, c + 16))
                      for c in range(0, 80, 16)], dim=3)
    assert torch.equal(whole, cols)


def _inputs(b=2, s=24, h=4, kvh=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [torch.from_numpy(rng.standard_normal(shape).astype(f))
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                          (b, s, h, d))]


def _oracle(q, k, v, keep, p, causal):
    """Dense attention with the given keep mask, in autograd ops."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1)
    sc = qt @ kt.transpose(-1, -2) / d ** 0.5
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            float("-inf"))
    probs = torch.softmax(sc, -1) * keep / (1 - p)
    return (probs @ vt).transpose(1, 2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_forward_and_backward_equal_the_dense_oracle(causal, p):
    q, k, v, do = _inputs()
    b, s, h, _ = q.shape
    seed = torch.tensor(11)
    # the forward's own mask, read through V = I (D = Sk, one kv head per
    # query head: each output row is that row's dropped probabilities);
    # the bits do not depend on q and k
    qe, ke = _inputs(h=h, kvh=h, d=s, seed=5)[:2]
    eye = torch.eye(s)[None, :, None, :].expand(b, s, h, s)
    out_eye, _ = fa.flash_attention_fwd(qe, ke, eye, causal=causal,
                                        dropout_p=p, seed=seed)
    keep = out_eye.transpose(1, 2) > 0
    want_keep = fa.dropout_keep(seed, p, b, h, s, s)
    if causal:
        want_keep &= torch.ones(s, s, dtype=torch.bool).tril()
    assert torch.equal(keep, want_keep)

    keep = fa.dropout_keep(seed, p, b, h, s, s)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, dropout_p=p,
                                      seed=seed)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = _oracle(*leaves, keep, p, causal)
    torch.testing.assert_close(out, want.detach(), rtol=0, atol=1e-5)
    grads = torch.autograd.grad(want, leaves, do)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 dropout_p=p, seed=seed)
    for g, w in zip(got, grads):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    # and through the entry point: the same seed, the same gradients
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention_raw(*leaves, causal=causal, dropout_p=p,
                           seed=seed).backward(do)
    for x, w in zip(leaves, grads):
        torch.testing.assert_close(x.grad, w, rtol=0, atol=1e-5)


@pytest.mark.skipif(not hasattr(pltpu, "force_tpu_interpret_mode"),
                    reason="this jax has no pltpu.force_tpu_interpret_mode")
def test_at_p0_the_path_equals_the_reference_kernels():
    """``F.scaled_dot_product_attention`` at dropout 0 (training) against
    the reference's ``flash_attention_raw`` in interpret mode: output and
    dq, dk, dv (causal, GQA group 2, D 64)."""
    q, k, v, do = _inputs(b=1, s=16, h=4, kvh=2, d=64, seed=1)

    @jax.jit            # one program: the three kernels lowered once
    def reference(q_, k_, v_, do_):
        out_, vjp = jax.vjp(lambda *a: flash_attention_raw(
            *a, causal=True, dropout_p=0.0), q_, k_, v_)
        return out_, vjp(do_)

    with pltpu.force_tpu_interpret_mode():
        out, want = reference(*(jnp.asarray(x.numpy())
                                for x in (q, k, v, do)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = F.scaled_dot_product_attention(*leaves, dropout_p=0.0,
                                         is_causal=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    got.backward(do)
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_dropout_of_one_raises():
    q, k, v, _ = _inputs()
    with pytest.raises(ValueError, match="dropout_p"):
        F.scaled_dot_product_attention(q, k, v, dropout_p=1.0)
    with pytest.raises(ValueError, match="dropout_p"):
        fa.flash_attention_fwd(q, k, v, dropout_p=1.0,
                               seed=torch.tensor(0))
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention_fwd(q, k, v, dropout_p=0.1)


@pytest.mark.parametrize("policy", ["full", "core_attn"])
def test_recompute_replays_the_dropout_draws(policy):
    """A recomputed region that draws hidden-dropout masks and an
    attention seed gets the gradients of the region run once: the
    recompute sets the generator back to where the region started, and
    the attention seed comes back through ``kept``."""
    from paddle_tpu_torch.jit.recompute import recompute
    from paddle_tpu_torch.ops.random import rng_guard
    q, k, v, do = _inputs()

    def region(q_, k_, v_):
        x = F.scaled_dot_product_attention(F.dropout(q_, 0.3), k_, v_,
                                           dropout_p=0.2, is_causal=True)
        return F.dropout(x, 0.3)

    grads = []
    for remat in (False, True):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        gen = torch.Generator().manual_seed(9)
        with rng_guard(gen):
            out = recompute(region, *leaves, policy=policy) if remat \
                else region(*leaves)
            after = gen.get_state()
        out.backward(do)            # outside the guard, as a user's would
        assert torch.equal(gen.get_state(), after)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
