"""#3's and #5's f32 routes on the tensor cores (``flash_bwd_dq_3xtf32``,
``flash_dbias_3xtf32``): their products emulated on the CPU and held
against the reference's Pallas kernels.

Both kernels rebuild S = Q K^T (q scaled first, as the plain version
scales it) and dP = dO V^T; the dQ kernel then takes dQ = dS K / sqrt(D),
the bias gradient sums dS = P (dP' - delta) over the bias's broadcast
batch and head dims.  Each product is emulated as the kernels take it
(``mm`` of ``test_torch_dkv_3xtf32``: each operand split as x = hi + lo
by ``cvt.rna`` on the bits, hi hi' + hi lo' + lo hi' with f32 sums) at a
small GPT-2-like shape (causal, D 64).  The emulation is held within
1e-5 (of the largest element) of the reference's ``_bwd_impl`` and
``_bwd_dmask`` in interpret mode, without dropout and with dropout 0.1,
where interpret mode's stubbed PRNG keeps no element (so the emulation
is given no kept element either: dS = -P delta); the bias gradient over
biases [1, H], [B, 1] and [1, 1]; and within 1e-5 of the port's plain
versions with the port's keep bits.  A single TF32 product (hi hi'
alone) misses 1e-5 on the same inputs: the reason the routes take
three.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.ops import flash_attention as fa
from test_torch_dkv_3xtf32 import mm

B, S, H, D = 2, 128, 2, 64
TOL = 1e-5
P = 0.1
BIAS_SHAPES = [(1, H, S, S), (B, 1, S, S), (1, 1, S, S)]

needs_interpret = pytest.mark.skipif(
    not hasattr(pltpu, "force_tpu_interpret_mode"),
    reason="this jax has no pltpu.force_tpu_interpret_mode")


def emulated_ds(q, k, v, do, out, lse, bias, keep, p, terms):
    """dS = P (dP' - delta) [B, H, Sq, Sk] of the kernels' S / dP stage
    on [B, S, H, D] f32 inputs (causal, GQA group 1), the bias [MB, MH,
    Sq, Sk] added to the scaled score (None: none), ``keep`` the kept
    elements (None: no dropout), each product by ``mm``."""
    qs = q * (1.0 / math.sqrt(q.shape[-1]))
    delta = (out * do).sum(-1).transpose(1, 2)             # [B, H, Sq]
    sq, sk = q.shape[1], k.shape[1]
    hidden = torch.ones(sq, sk, dtype=torch.bool).triu(1 + sk - sq)
    ds = torch.empty(q.shape[0], q.shape[2], sq, sk)
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            s = mm(qs[b, :, h], k[b, :, h].T, terms)
            if bias is not None:
                s = s + bias[b % bias.shape[0], h % bias.shape[1]]
            s = s.masked_fill(hidden, -1e30)
            pr = torch.exp(s - lse[b, h][:, None])
            dp = mm(do[b, :, h], v[b, :, h].T, terms)
            if keep is not None:
                dp = torch.where(keep[b, h], dp / (1 - p), 0.0)
            ds[b, h] = pr * (dp - delta[b, h][:, None])
    return ds


def emulated_dq(q, k, v, do, out, lse, keep, p, terms=3):
    """The dQ kernel's dQ [B, Sq, H, D]: dS K (by ``mm``) scaled."""
    ds = emulated_ds(q, k, v, do, out, lse, None, keep, p, terms)
    dq = torch.empty_like(q)
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            dq[b, :, h] = mm(ds[b, h], k[b, :, h], terms) * (
                1.0 / math.sqrt(q.shape[-1]))
    return dq


def emulated_dbias(q, k, v, do, out, lse, bias, keep, p, terms=3):
    """The bias-gradient kernel's dbias in the bias's shape: dS summed
    over the dims the bias broadcasts."""
    ds = emulated_ds(q, k, v, do, out, lse, bias, keep, p, terms)
    dims = [i for i in (0, 1) if bias.shape[i] == 1]
    return ds.sum(dims, keepdim=True) if dims else ds


def _close(got, want, tol=TOL):
    return (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.fixture(scope="module")
def inputs():
    """q, k, v, dO [B, S, H, D] and the biases, from one numpy seed."""
    rng = np.random.default_rng(21)
    qkvd = [torch.tensor(rng.standard_normal((B, S, H, D)),
                         dtype=torch.float32) for _ in range(4)]
    biases = {sh: torch.tensor(0.5 * rng.standard_normal(sh),
                               dtype=torch.float32) for sh in BIAS_SHAPES}
    return qkvd, biases


def _bhsd(x):
    return jnp.asarray(np.swapaxes(x.numpy(), 1, 2))


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference kernels in interpret mode, traced into one jitted
    program: the forward (undropped: interpret mode keeps no element)
    without a bias and with each bias, ``_bwd_impl``'s dQ and
    ``_bwd_dmask``'s dbias at p 0 and 0.1.  Returns {case: (out, lse,
    want)} as torch tensors on [B, S, H, D] / [B, H, S]."""
    from paddle_tpu.ops.pallas.flash_attention import (_bwd_dmask,
                                                       _bwd_impl, _fwd)
    (q, k, v, do), biases = inputs
    tr = [_bhsd(x) for x in (q, k, v, do)]
    masks = [None] + [jnp.asarray(biases[sh].numpy()) for sh in BIAS_SHAPES]
    seed = jnp.asarray([7], jnp.int32)
    blk = dict(causal=True, bq=64, bk=64)

    @jax.jit
    def run(tr, masks):
        res = []
        for mask in masks:
            out, lse = _fwd(*tr[:3], mask=mask, **blk)
            for p in (0.0, P):
                kw = {} if p == 0 else dict(dropout_p=p, seed=seed)
                if mask is None:
                    want = _bwd_impl(*tr[:3], out, lse, tr[3], **blk,
                                     **kw)[0]
                else:
                    want = _bwd_dmask(*tr[:3], out, lse, tr[3], mask,
                                      **blk, **kw)
                res.append((out, lse, want))
        return res

    with pltpu.force_tpu_interpret_mode():
        res = run(tr, masks)
    cases = [("dq", p) for p in (0.0, P)] + [
        (sh, p) for sh in BIAS_SHAPES for p in (0.0, P)]
    got = {}
    for case, (out, lse, want) in zip(cases, res):
        want = np.asarray(want)
        if case[0] == "dq":
            want = np.swapaxes(want, 1, 2)
        got[case] = (torch.tensor(np.swapaxes(np.asarray(out), 1, 2)),
                     torch.tensor(np.asarray(lse)[..., 0]),
                     torch.tensor(want))
    return got


@needs_interpret
@pytest.mark.parametrize("p", [0.0, P])
def test_3xtf32_dq_matches_reference_bwd_impl(inputs, reference, p):
    (q, k, v, do), _ = inputs
    out, lse, want = reference[("dq", p)]
    keep = None if p == 0 else torch.zeros(B, H, S, S, dtype=torch.bool)
    got = emulated_dq(q, k, v, do, out, lse, keep, p)
    assert _close(got, want), (got - want).abs().max()


@needs_interpret
@pytest.mark.parametrize("p", [0.0, P])
@pytest.mark.parametrize("shape", BIAS_SHAPES, ids=str)
def test_3xtf32_dbias_matches_reference_bwd_dmask(inputs, reference, shape,
                                                   p):
    (q, k, v, do), biases = inputs
    out, lse, want = reference[(shape, p)]
    keep = None if p == 0 else torch.zeros(B, H, S, S, dtype=torch.bool)
    got = emulated_dbias(q, k, v, do, out, lse, biases[shape], keep, p)
    assert got.shape == want.shape == shape
    assert _close(got, want), (got - want).abs().max()


@pytest.fixture(scope="module")
def plain(inputs):
    """The port's plain versions with the port's keep bits at p 0.1:
    (out, lse, keep, dQ) without a bias and (out, lse, dbias) with
    each."""
    (q, k, v, do), biases = inputs
    seed = torch.tensor(99, dtype=torch.int64)
    kw = dict(causal=True, dropout_p=P, seed=seed)
    keep = fa.dropout_keep(seed, P, B, H, S, S)
    out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    res = {"dq": (out, lse,
                  fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                   **kw)[0])}
    for sh, bias in biases.items():
        out, lse = fa.flash_attention_fwd_reference(q, k, v, mask=bias,
                                                    **kw)
        res[sh] = (out, lse, fa.flash_attention_dbias_reference(
            q, k, v, out, lse, do, bias, **kw))
    return keep, res


@pytest.mark.parametrize("case", ["dq"] + BIAS_SHAPES, ids=str)
def test_3xtf32_matches_the_plain_versions_with_dropout(inputs, plain,
                                                        case):
    """p 0.1 with the port's keep bits (``dropout_keep``): the emulation
    within 1e-5 of ``flash_attention_bwd_reference``'s dQ and of
    ``flash_attention_dbias_reference``; one TF32 product on the same
    inputs is off by more than 1e-5."""
    (q, k, v, do), biases = inputs
    keep, res = plain
    out, lse, want = res[case]

    def emulated(terms):
        if case == "dq":
            return emulated_dq(q, k, v, do, out, lse, keep, P, terms)
        return emulated_dbias(q, k, v, do, out, lse, biases[case], keep, P,
                              terms)
    got = emulated(3)
    assert _close(got, want), (got - want).abs().max() / want.abs().max()
    assert not _close(emulated(1), want)
