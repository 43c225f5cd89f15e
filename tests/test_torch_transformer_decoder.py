"""The port's decoder stack (``nn/transformer.py``) against the
reference's: ``TransformerDecoderLayer``, ``TransformerDecoder`` and the
encoder-decoder ``Transformer``.

One tiny ``Transformer`` a form (E 32, 2 heads, d_ff 64, 2 + 2 layers,
dropout 0): post-norm with relu and pre-norm with gelu.  The reference
is built after ``paddle.seed(0)`` and its ``raw_state_dict()`` carried
into the port.  Masks are the reference's own kinds: the target's
additive -inf causal mask from ``generate_square_subsequent_mask`` plus
key padding, ``[B, 1, T, T]``; the source's and the memory's key padding
``[B, 1, 1, S]`` (-inf), a trailing share of each row padded.  The
reference's outputs and parameter gradients come from one jitted
``jax.vjp`` through ``traced_forward`` (its jnp paths), the port's from
autograd over its kernels' plain versions: 1e-5 relative L2 (f32 sums in
another order), the key projections' biases excepted as in
``test_torch_transformer.py`` (their gradient is zero in exact
arithmetic: both sides must be below 1e-5 of the largest gradient).

Incremental decoding (``gen_cache``: a ``Cache`` for the self attention,
a ``StaticCache`` of the memory) runs a token at a time on both sides,
the reference's steps in one jitted ``traced_forward``: each step's
output within 1e-5, and the port's
steps equal its whole-sequence forward under the causal mask.  Under
amp O2 (bf16 weights) the cache starts as f32 zeros, so queries are
bf16 and keys f32: the output dtype must be the reference's (f32, by
promotion) and the values within 2e-2 relative L2 (bf16 roundings in
other places over 2 layers).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import traced_forward
from paddle_tpu.nn.transformer import Transformer as RefTransformer

from paddle_tpu_torch import amp
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.nn.transformer import (MultiHeadAttention,
                                             Transformer,
                                             TransformerDecoderLayer)

E, H, F, B, S, T = 32, 2, 64, 2, 7, 6
FORMS = {"post_relu": dict(normalize_before=False, activation="relu"),
         "pre_gelu": dict(normalize_before=True, activation="gelu")}


def _rel_l2(want, got):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.linalg.norm(want - got) / np.linalg.norm(want))


def _masks(rng):
    """(src_mask [B,1,1,S], tgt_mask [B,1,T,T], memory_mask [B,1,1,S])
    as additive f32 arrays: -inf on padded keys (the last 0-2 of a row)
    and above the target's diagonal."""
    causal = np.asarray(
        RefTransformer.generate_square_subsequent_mask(T).value)
    src_pad = np.zeros((B, 1, 1, S), np.float32)
    tgt_pad = np.zeros((B, 1, 1, T), np.float32)
    for b in range(B):
        src_pad[b, ..., S - rng.integers(1, 3):] = -np.inf
        tgt_pad[b, ..., T - rng.integers(0, 2):] = -np.inf
    return src_pad, causal[None, None] + tgt_pad, src_pad


def _pair(form):
    paddle.seed(0)
    ref = RefTransformer(E, H, 2, 2, F, dropout=0.0, **FORMS[form])
    port = Transformer(E, H, 2, 2, F, dropout=0.0, device="cpu",
                       **FORMS[form])
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


def _run(m, b):
    return m(b["src"], b["tgt"], b["src_mask"], b["tgt_mask"],
             b["mem_mask"])


@pytest.fixture(scope="module", params=list(FORMS))
def case(request):
    ref, port = _pair(request.param)
    rng = np.random.default_rng(0)
    src_mask, tgt_mask, mem_mask = _masks(rng)
    batch = {"src": rng.standard_normal((B, S, E)).astype(np.float32),
             "tgt": rng.standard_normal((B, T, E)).astype(np.float32),
             "src_mask": src_mask, "tgt_mask": tgt_mask,
             "mem_mask": mem_mask}
    ct = rng.standard_normal((B, T, E)).astype(np.float32)

    @jax.jit
    def outs_and_grads(params, b, cot):
        out, vjp = jax.vjp(lambda p: traced_forward(
            ref, _run, p, b, jax.random.key(0)), params)
        return out, vjp(cot)[0]

    want = outs_and_grads(ref.raw_state_dict(), batch, ct)
    return ref, port, batch, ct, want


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_outputs_match_reference(case):
    _, port, batch, _, (want, _) = case
    with torch.no_grad():
        got = _run(port, _torch_batch(batch))
    assert np.isfinite(got.numpy()).all()
    assert _rel_l2(want, got.numpy()) <= 1e-5


def test_gradients_match_reference(case):
    _, port, batch, ct, (_, want) = case
    out = _run(port, _torch_batch(batch))
    params = dict(port.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                list(params.values()))
    assert set(params) == set(want)
    scale = max(np.linalg.norm(np.asarray(w)) for w in want.values())
    for (n, _), g in zip(params.items(), grads):
        if n.endswith("k_proj.bias"):
            assert max(np.linalg.norm(np.asarray(want[n])),
                       g.norm().item()) <= 1e-5 * scale, n
        else:
            assert _rel_l2(want[n], g.numpy()) <= 1e-5, n


def _decode(decoder, memory, tgt, cache, to_out):
    """Feed ``tgt`` a token at a time through ``decoder`` with ``cache``;
    the steps' outputs, each through ``to_out``."""
    outs = []
    for t in range(tgt.shape[1]):
        out, cache = decoder(tgt[:, t:t + 1], memory, None, None, cache)
        outs.append(to_out(out))
    return outs, cache


def _ref_decode(m, b):
    mem = m.encoder(b["src"])
    outs, cache = _decode(m.decoder, mem, b["tgt"], m.decoder.gen_cache(mem),
                          lambda o: o)
    return outs, cache[0][0].k


def test_cached_decoding_matches_reference_and_whole_sequence(case):
    ref, port, batch, _, _ = case
    src, tgt = batch["src"], batch["tgt"]
    want, ref_k = jax.jit(lambda p, b: traced_forward(
        ref, _ref_decode, p, b, jax.random.key(0)))(
            ref.raw_state_dict(), {"src": src, "tgt": tgt})
    with torch.no_grad():
        mem = port.encoder(torch.from_numpy(src))
        got, cache = _decode(port.decoder, mem, torch.from_numpy(tgt),
                             port.decoder.gen_cache(mem),
                             lambda o: o.numpy())
        whole = port.decoder(torch.from_numpy(tgt), mem,
                             Transformer.generate_square_subsequent_mask(
                                 T, device="cpu"))
    for w, g in zip(want, got):
        assert _rel_l2(w, g) <= 1e-5
    inc, static = cache[0]
    assert isinstance(inc, MultiHeadAttention.Cache)
    assert isinstance(static, MultiHeadAttention.StaticCache)
    assert inc.k.shape == (B, T, H, E // H) and static.k.shape[1] == S
    np.testing.assert_allclose(np.asarray(ref_k), inc.k.numpy(), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(torch.from_numpy(np.concatenate(got, 1)),
                               whole, rtol=0, atol=1e-5)


def test_o2_bf16_cached_decoding_promotes_as_the_reference():
    """amp O2: bf16 weights, the cache's f32 zeros -> bf16 queries
    against f32 keys in the first self attention; the reference's jnp
    attention promotes (f32 logits, f32 output), and so does the port."""
    ref, port = _pair("post_relu")
    ref = paddle.amp.decorate(ref, level="O2", dtype="bfloat16")
    port = amp.decorate(port, level="O2", dtype="bfloat16")
    rng = np.random.default_rng(1)
    src = rng.standard_normal((B, S, E)).astype(np.float32)
    tgt = rng.standard_normal((B, 3, E)).astype(np.float32)
    outs, _ = jax.jit(lambda p, b: traced_forward(
        ref, _ref_decode, p, b, jax.random.key(0)))(
            ref.raw_state_dict(), {"src": src.astype(jax.numpy.bfloat16),
                                   "tgt": tgt.astype(jax.numpy.bfloat16)})
    want = [(str(o.dtype), np.asarray(o, np.float32)) for o in outs]
    with torch.no_grad():
        mem = port.encoder(torch.from_numpy(src).bfloat16())
        layer = port.decoder.layers[0]
        cache = layer.gen_cache(mem)
        q = layer.self_attn._shape(layer.self_attn.q_proj(
            torch.from_numpy(tgt[:, :1]).bfloat16()))
        assert q.dtype == torch.bfloat16 and cache[0].k.dtype == \
            torch.float32
        got, _ = _decode(port.decoder, mem,
                         torch.from_numpy(tgt).bfloat16(),
                         port.decoder.gen_cache(mem),
                         lambda o: (str(o.dtype), o.float().numpy()))
    for (wd, w), (gd, g) in zip(want, got):
        assert wd.endswith("float32") and gd == "torch.float32"
        assert _rel_l2(w, g) <= 2e-2


def test_decoder_layer_refuses_nothing_the_reference_takes():
    """A decoder layer alone (no cache) with a [T, T] causal mask and no
    memory mask, and the subsequent mask equal to the reference's."""
    torch.manual_seed(0)
    layer = TransformerDecoderLayer(E, H, F, dropout=0.0, device="cpu")
    x, mem = torch.randn(B, T, E), torch.randn(B, S, E)
    mask = Transformer.generate_square_subsequent_mask(T, device="cpu")
    np.testing.assert_array_equal(
        mask.numpy(),
        np.asarray(RefTransformer.generate_square_subsequent_mask(T).value))
    with torch.no_grad():
        out = layer(x, mem, tgt_mask=mask)
        first = layer(x[:, :1], mem)
    assert out.shape == (B, T, E) and torch.isfinite(out).all()
    torch.testing.assert_close(out[:, :1], first, rtol=0, atol=1e-5)
