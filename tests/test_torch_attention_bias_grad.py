"""The gradient of a trained attention bias (#5, the reference's
``_bwd_dmask``) and the trained-bias routes of the entry points.

The plain ``flash_attention_dbias_reference`` is held against the
reference's ``_bwd_dmask`` kernel (the one ``flash_attention_raw_ext(...,
mask_grad=True)`` runs for the bias), in interpret mode, on the same
q, k, v, dO, output and lse, at p = 0: the four bias shapes ``(1, H, S,
S)``, ``(B, 1, S, S)``, ``(1, 1, S, S)`` and ``(B, H, S, S)``, causal and
not, GQA group 2, within 1e-4 (the reference's own test's tolerance).
At p > 0 it is held against dense autograd with the kernels' keep mask.
``F.scaled_dot_product_attention`` with a trained bias (the §C 1 case
among them: q, k and v needing no gradient) is held against the
reference's jnp path (``ops/_nn.py`` ``scaled_dot_product_attention``
under ``jax.vjp``) within 1e-5: f32 sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops import _nn as ref_nn
from paddle_tpu.ops.pallas.flash_attention import _bwd_dmask

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa

B, S, H, KVH, D = 2, 16, 2, 1, 64
SHAPES = [(1, H, S, S), (B, 1, S, S), (1, 1, S, S), (B, H, S, S)]


def _arrays(seed=0, b=B, s=S, h=H, kvh=KVH, d=D, bias_shape=None):
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.standard_normal(shape).astype(f)
           for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                         (b, s, h, d))]
    if bias_shape is not None:
        out.append((rng.standard_normal(bias_shape) * 0.5).astype(f))
    return out


def _bhsd(x):
    return jnp.asarray(np.swapaxes(x, 1, 2))


CASES = [(shape, causal) for causal in (False, True) for shape in SHAPES]


@pytest.fixture(scope="module")
def dmask_cases():
    """For every (bias shape, causal) case: the inputs, the plain
    version's dbias, and the reference kernel's -- all eight reference
    calls traced into one jitted program, which lowers the interpret-mode
    kernels once rather than eight times over."""
    t = torch.from_numpy
    cases, args = {}, []
    for shape, causal in CASES:
        q, k, v, do, bias = _arrays(bias_shape=shape)
        out, lse = fa.flash_attention_fwd_reference(
            t(q), t(k), t(v), causal=causal, mask=t(bias))
        got = fa.flash_attention_dbias_reference(
            t(q), t(k), t(v), out, lse, t(do), t(bias), causal=causal)
        lse8 = np.broadcast_to(lse.numpy()[..., None], (B, H, S, 8))
        args.append([_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(out.numpy()),
                     jnp.asarray(lse8), _bhsd(do), jnp.asarray(bias)])
        cases[(shape, causal)] = got

    @jax.jit
    def reference(args):
        return [_bwd_dmask(*a, causal=causal, bq=S, bk=S)
                for a, (_, causal) in zip(args, CASES)]

    with pltpu.force_tpu_interpret_mode():
        wants = reference(args)
    return {c: (cases[c], np.asarray(w)) for c, w in zip(CASES, wants)}


@pytest.mark.skipif(not hasattr(pltpu, "force_tpu_interpret_mode"),
                    reason="this jax has no pltpu.force_tpu_interpret_mode")
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_dbias_matches_the_reference_kernel(dmask_cases, shape,
                                                  causal):
    got, want = dmask_cases[(shape, causal)]
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, H, S, S), (B, 1, S, S)], ids=str)
def test_plain_dbias_with_dropout_matches_dense_autograd(shape, causal):
    q, k, v, do, bias = (torch.from_numpy(a) for a in
                         _arrays(1, bias_shape=shape))
    p, seed = 0.2, torch.tensor(31)
    keep = fa.dropout_keep(seed, p, B, H, S, S)
    bias_l = bias.clone().requires_grad_()
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // KVH, 1)
              for x in (k, v))
    sc = qt @ kt.transpose(-1, -2) / D ** 0.5 + bias_l
    if causal:
        sc = sc.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                            float("-inf"))
    probs = torch.softmax(sc, -1) * keep / (1 - p)
    dense = (probs @ vt).transpose(1, 2)
    want, = torch.autograd.grad(dense, [bias_l], do)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, mask=bias,
                                      dropout_p=p, seed=seed)
    got = fa.flash_attention_dbias(q, k, v, out, lse, do, bias,
                                   causal=causal, dropout_p=p, seed=seed)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _ref_vjp(q, k, v, do, bias, causal=False):
    """The reference's jnp attention and its vjp in (q, k, v, bias)."""
    def f(q_, k_, v_, b_):
        return ref_nn.scaled_dot_product_attention(q_, k_, v_, attn_mask=b_,
                                                   is_causal=causal)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v, bias)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("need_qkv", [False, True], ids=["bias_only", "all"])
def test_trained_bias_gets_the_reference_gradient(need_qkv):
    """ROADMAP §C 1: q, k and v [1, 8, 2, 16] needing no gradient and a
    zero bias [1, 2, 8, 8] that needs one; then the same with every
    input needing one."""
    q, k, v, do = _arrays(2, b=1, s=8, h=2, kvh=2, d=16)
    bias = np.zeros((1, 2, 8, 8), np.float32)
    leaves = [torch.from_numpy(x).requires_grad_(need_qkv)
              for x in (q, k, v)]
    bt = torch.from_numpy(bias).requires_grad_()
    out = F.scaled_dot_product_attention(*leaves, attn_mask=bt)
    out.backward(torch.from_numpy(do))
    want_out, want = _ref_vjp(q, k, v, do, bias)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), want[3], rtol=0, atol=1e-5)
    for x, w in zip(leaves, want[:3]):
        if need_qkv:
            np.testing.assert_allclose(x.grad.numpy(), w, rtol=0, atol=1e-5)
        else:
            assert x.grad is None


@pytest.mark.parametrize("shape", [(1, 2, 8, 8), (1, 2, 1, 8)],
                         ids=["full_sq", "query_broadcast"])
def test_sdpa_with_trained_bias_matches_the_jnp_path(shape):
    """A causal attention with a trained bias, and with one that
    broadcasts over the query rows (on the CPU it runs the plain version
    under autograd), every input needing a gradient."""
    q, k, v, do, bias = _arrays(3, b=1, s=8, h=2, kvh=2, d=16,
                                bias_shape=shape)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                         is_causal=True)
    out.backward(torch.from_numpy(do))
    want_out, want = _ref_vjp(q, k, v, do, bias, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-5)
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=0, atol=1e-5)


def test_boolean_trainable_mask_is_a_constant():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(4))
    allow = torch.ones(S, S, dtype=torch.bool).tril()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = fa.flash_attention_raw(*leaves, mask=allow, mask_grad=True)
    want = fa.flash_attention_raw(q, k, v, causal=True)
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=1e-6)
    got.backward(do)
    assert all(x.grad is not None for x in leaves)
