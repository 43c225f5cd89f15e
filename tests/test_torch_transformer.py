"""The port's ``nn/transformer.py`` against the reference's layers.

One module holds a ``MultiHeadAttention`` and two
``TransformerEncoderLayer``s (pre-norm with relu, post-norm with gelu:
the post-norm form runs the fused add+LayerNorm), all at dropout 0, and
a trained additive attention bias ``[1, H, S, S]`` that every one of
them takes as its mask.  The reference module is built after
``paddle.seed(0)`` and its ``raw_state_dict()`` carried into the port;
the reference's outputs and gradients come from one jitted ``jax.vjp``
through its trainer's ``traced_forward`` (the jnp paths), the port's
from autograd over its kernels' plain versions.  Tolerance 1e-5 relative L2
per output and per gradient, the bias's included: f32 sums in another
order.  The key projections' biases are the exception: their gradient is
zero in exact arithmetic (a shift shared by every key leaves the softmax
as it is), so both sides hold rounding noise, and each must be below
1e-5 of the largest gradient's norm.  The incremental ``Cache`` path is
checked on the port: a token at a time it reproduces the whole
sequence's attention.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import traced_forward
from paddle_tpu.nn.initializer import Normal as RefNormal
from paddle_tpu.nn.transformer import MultiHeadAttention as RefMHA
from paddle_tpu.nn.transformer import \
    TransformerEncoderLayer as RefEncoderLayer

from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.nn.transformer import (MultiHeadAttention,
                                             TransformerEncoder,
                                             TransformerEncoderLayer)

E, H, F, S, B = 32, 2, 64, 8, 2


class _RefTrio(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.mha = RefMHA(E, H)
        self.pre = RefEncoderLayer(E, H, F, dropout=0.0,
                                   normalize_before=True)
        self.post = RefEncoderLayer(E, H, F, dropout=0.0,
                                    activation="gelu")
        self.bias = self.create_parameter(
            [1, H, S, S], default_initializer=RefNormal(0.0, 0.5))

    def forward(self, x):
        return (self.mha(x, attn_mask=self.bias), self.pre(x, self.bias),
                self.post(x, self.bias))


class _Trio(torch.nn.Module):
    def __init__(self):
        super().__init__()
        kw = dict(device="cpu")
        self.mha = MultiHeadAttention(E, H, **kw)
        self.pre = TransformerEncoderLayer(E, H, F, dropout=0.0,
                                           normalize_before=True, **kw)
        self.post = TransformerEncoderLayer(E, H, F, dropout=0.0,
                                            activation="gelu", **kw)
        self.bias = torch.nn.Parameter(torch.zeros(1, H, S, S))

    def forward(self, x):
        return (self.mha(x, attn_mask=self.bias), self.pre(x, self.bias),
                self.post(x, self.bias))


def _rel_l2(want, got):
    want = np.asarray(want)
    return float(np.linalg.norm(want - got) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def case():
    paddle.seed(0)
    ref = _RefTrio()
    port = _Trio()
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((B, S, E)).astype(np.float32),
             "ct": [rng.standard_normal((B, S, E)).astype(np.float32)
                    for _ in range(3)]}

    @jax.jit
    def outs_and_grads(params, x, cts):
        outs, vjp = jax.vjp(lambda p: traced_forward(
            ref, lambda m, b: m(b["x"]), p, {"x": x}, jax.random.key(0)),
            params)
        return outs, vjp(tuple(cts))[0]

    want = outs_and_grads(ref.raw_state_dict(), batch["x"], batch["ct"])
    return port, batch, want


def test_outputs_match_reference(case):
    port, batch, (want, _) = case
    with torch.no_grad():
        got = port(torch.from_numpy(batch["x"]))
    for w, g in zip(want, got):
        assert _rel_l2(w, g.numpy()) <= 1e-5


def test_gradients_match_reference_bias_included(case):
    port, batch, (_, want) = case
    outs = port(torch.from_numpy(batch["x"]))
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(outs, batch["ct"]))
    params = dict(port.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(params) == set(want)
    scale = max(np.linalg.norm(np.asarray(w)) for w in want.values())
    for (n, _), g in zip(params.items(), grads):
        if n.endswith("k_proj.bias"):
            assert max(np.linalg.norm(np.asarray(want[n])),
                       g.norm().item()) <= 1e-5 * scale, n
        else:
            assert _rel_l2(want[n], g.numpy()) <= 1e-5, n


def test_cache_decodes_a_token_at_a_time():
    torch.manual_seed(0)
    mha = MultiHeadAttention(E, H, device="cpu")
    x = torch.randn(B, S, E)
    causal = torch.zeros(S, S).masked_fill_(
        ~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    with torch.no_grad():
        whole = mha(x, attn_mask=causal)
        cache = mha.gen_cache(x)
        steps = []
        for t in range(S):
            out, cache = mha(x[:, t:t + 1], cache=cache)
            steps.append(out)
        static = mha.gen_cache(x, x, type=MultiHeadAttention.StaticCache)
        cross = mha(x, cache=static)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=0,
                               atol=1e-5)
    assert cache.k.shape == (B, S, H, E // H)
    torch.testing.assert_close(cross, mha(x).detach(), rtol=0, atol=1e-6)


def test_encoder_stacks_copies_of_its_layer():
    layer = TransformerEncoderLayer(E, H, F, dropout=0.0, device="cpu")
    enc = TransformerEncoder(layer, 2)
    assert enc.layers[0] is layer
    assert torch.equal(enc.layers[1].linear1.weight, layer.linear1.weight)
    x = torch.randn(B, S, E)
    with torch.no_grad():
        torch.testing.assert_close(enc(x), layer(layer(x)))
