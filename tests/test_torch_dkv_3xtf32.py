"""#4's f32 route on the tensor cores (``flash_bwd_dkv_3xtf32``): its
products emulated on the CPU and held against the reference's Pallas
backward.

Each operand of the kernel's four products (S^T = K Q^T, dP^T = V dO^T,
dV += P^T dO, dK += dS^T Q) is split as x = hi + lo, hi its TF32
rounding (``cvt.rna``: 10 mantissa bits, to nearest, ties away from 0,
done here on the bits) and lo the TF32 rounding of x - hi, and each
product is taken as hi hi' + hi lo' + lo hi' with f32 sums, q scaled
first as the kernel and the plain version scale it.  The emulation is
held within 1e-5 (of the largest element) of the reference's
``_bwd_impl`` run in interpret mode at a small GPT-2-like shape (causal,
D 64): without dropout, and with dropout 0.1, where interpret mode's
stubbed PRNG keeps no element (so the emulation is given no kept
element either: dV is 0 and dK comes from dS = -P delta alone); and
within 1e-5 of the port's plain backward with the port's keep bits.  A
single TF32 product (hi hi' alone) misses 1e-5 on the same inputs: the
reason the route takes three.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.ops import flash_attention as fa

B, S, H, D = 1, 128, 2, 64
TOL = 1e-5


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: add half a unit of
    the 13 dropped bits to the magnitude, then drop them."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a, b, terms):
    """a @ b with f32 operands split into TF32 parts: ``terms`` 3 is
    3xTF32 (hi hi' + hi lo' + lo hi'), 1 a single TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    out = ah.double() @ bh.double()
    if terms == 3:
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def emulated_dkv(q, k, v, do, out, lse, keep, p, terms=3):
    """The kernel's dK/dV on [B, S, H, D] f32 inputs (causal, no mask,
    GQA group 1), ``keep`` [B, H, Sq, Sk] the kept elements (None: no
    dropout), each product by ``mm``."""
    qs = q * (1.0 / math.sqrt(q.shape[-1]))
    delta = (out * do).sum(-1).transpose(1, 2)             # [B, H, Sq]
    sq, sk = q.shape[1], k.shape[1]
    hidden = torch.ones(sq, sk, dtype=torch.bool).triu(1 + sk - sq)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            st = mm(k[b, :, h], qs[b, :, h].T, terms)        # [Sk, Sq]
            st = st.masked_fill(hidden.T, -1e30)
            pt = torch.exp(st - lse[b, h][None, :])
            dpt = mm(v[b, :, h], do[b, :, h].T, terms)
            pd = pt
            if keep is not None:
                kt = keep[b, h].T
                dpt = torch.where(kt, dpt / (1 - p), 0.0)
                pd = torch.where(kt, pt / (1 - p), 0.0)
            dst = pt * (dpt - delta[b, h][None, :])
            dv[b, :, h] = mm(pd, do[b, :, h], terms)
            dk[b, :, h] = mm(dst, qs[b, :, h], terms)
    return dk, dv


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((B, S, H, D)),
                         dtype=torch.float32) for _ in range(4)]


def _close(got, want, tol=TOL):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() <= tol * scale


@pytest.mark.skipif(not hasattr(pltpu, "force_tpu_interpret_mode"),
                    reason="this jax has no pltpu.force_tpu_interpret_mode")
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_3xtf32_dkv_matches_reference_bwd_impl(p):
    from paddle_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd
    q, k, v, do = _inputs(5)
    tr = [jnp.asarray(np.swapaxes(x.numpy(), 1, 2)) for x in (q, k, v, do)]
    kw = {} if p == 0 else dict(dropout_p=p,
                                seed=jnp.asarray([7], jnp.int32))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _fwd(*tr[:3], causal=True, bq=32, bk=32)
        want = _bwd_impl(*tr[:3], out, lse, tr[3], causal=True, bq=32,
                         bk=32, **kw)
    out_t = torch.tensor(np.swapaxes(np.asarray(out), 1, 2))
    lse_t = torch.tensor(np.asarray(lse)[..., 0])
    keep = None if p == 0 else torch.zeros(B, H, S, S, dtype=torch.bool)
    got = emulated_dkv(q, k, v, do, out_t, lse_t, keep, p)
    for g, w in zip(got, want[1:]):
        w = torch.tensor(np.swapaxes(np.asarray(w), 1, 2))
        assert _close(g, w), (g - w).abs().max()
    if p:
        assert not got[1].any() and got[0].abs().max() > 0


def test_3xtf32_dkv_matches_the_plain_backward_with_dropout():
    """The port's keep bits (``dropout_keep``), p 0.1: the emulation
    within 1e-5 of ``flash_attention_bwd_reference``; one TF32 product
    on the same inputs is off by more than 1e-5."""
    q, k, v, do = _inputs(6)
    p, seed = 0.1, torch.tensor(99, dtype=torch.int64)
    kw = dict(causal=True, dropout_p=p, seed=seed)
    out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)[1:]
    keep = fa.dropout_keep(seed, p, B, H, S, S)
    got = emulated_dkv(q, k, v, do, out, lse, keep, p)
    for g, w in zip(got, want):
        assert _close(g, w), (g - w).abs().max() / w.abs().max()
    one = emulated_dkv(q, k, v, do, out, lse, keep, p, terms=1)
    assert not all(_close(g, w) for g, w in zip(one, want))


def test_tf32_rounding_is_cvt_rna():
    """Ties go away from zero; 10 mantissa bits survive."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0])
    assert torch.equal(tf32(x), want)
    hi, lo = split(torch.tensor([math.pi], dtype=torch.float32))
    assert abs((hi + lo).item() - math.pi) < 2.0 ** -21
