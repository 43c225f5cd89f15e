"""The port's int8 quantization against the reference's, on the CPU.

``paddle_tpu_torch/quantization`` against ``paddle_tpu/quantization``:
the absmax primitives must give the same int8 codes and f32 scales bit
for bit on the same numpy inputs (f32 and bf16, exact .5 ties that
round half to even, all-zero rows), and ``quantized_matmul`` the same
values (integer-valued inputs make the product exact in both, so what
is compared is the fold of the scale, cast to the product's dtype
first).  ``quantize_model``: the reference's tiny Llama, converted and
carried across with ``from_jax`` (parameters and the ``qweight`` /
``weight_scale`` buffers), serves the same greedy tokens through the
port's ``LLMEngine`` as the reference's ``generate`` gives (top-1
margins above 1e-4, as in the engine tests).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.quantization import quantize_model as ref_quantize_model
from paddle_tpu.quantization import ops as R

from paddle_tpu_torch.inference import engine as E
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.quantization import (QuantizedLinear,
                                           dequantize_absmax,
                                           quantize_absmax, quantize_model,
                                           quantize_rows, quantized_matmul)

BF16 = {"jax": jnp.bfloat16, "torch": torch.bfloat16}


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 40)).astype(np.float32) * 3
    # exact ties: absmax 127 makes the scale 1, so x / scale = k + 0.5
    x[7, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    x[:8, 9] = [127.0, 4.5, -5.5, 0.5, -2.5, 3.5, 7.5, -127.0]
    x[20] = 0.0                                   # an all-zero row
    x[:, 30] = 0.0                                # and an all-zero column
    return x


def _ref(fn, *a, **kw):
    return [np.asarray(o) for o in fn(*a, **kw)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantize_absmax_bit_equal(dtype, axis):
    x = _inputs()
    xj = jnp.asarray(x, BF16["jax"] if dtype == "bfloat16" else jnp.float32)
    xt = torch.tensor(x).to(BF16["torch"] if dtype == "bfloat16"
                            else torch.float32)
    want_q, want_s = _ref(R.quantize_absmax_raw, xj, axis=axis)
    got_q, got_s = quantize_absmax(xt, axis=axis)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # the ties rounded half to even, the zero row to scale EPS / 127
    if axis == 1 and dtype == "float32":
        assert got_q[7, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
        assert got_s[20].item() == np.float32(np.float32(1e-8) / 127)
    np.testing.assert_array_equal(
        dequantize_absmax(got_q, got_s, axis=axis).numpy(),
        np.asarray(R.dequantize_absmax_raw(jnp.asarray(want_q),
                                           jnp.asarray(want_s), axis=axis)))


def test_quantize_rows_bit_equal():
    x = _inputs().reshape(4, 6, 40)
    want = _ref(R.quantize_rows_raw, jnp.asarray(x))
    got = quantize_rows(torch.tensor(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_bit_equal(dtype):
    rng = np.random.default_rng(1)
    x = rng.integers(-4, 5, (6, 16)).astype(np.float32)
    qw = rng.integers(-7, 8, (16, 12)).astype(np.int8)
    sc = (rng.random(12) * 0.02 + 1e-3).astype(np.float32)
    jdt = BF16["jax"] if dtype == "bfloat16" else jnp.float32
    tdt = BF16["torch"] if dtype == "bfloat16" else torch.float32
    want = np.asarray(R.quantized_matmul_raw(
        jnp.asarray(x, jdt), jnp.asarray(qw), jnp.asarray(sc)),
        np.float32)
    got = quantized_matmul(torch.tensor(x).to(tdt), torch.tensor(qw),
                           torch.tensor(sc))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "bfloat16":
        # the scale is rounded to bf16 before the product, as there
        exact = (torch.tensor(x) @ torch.tensor(qw).float()) * \
            torch.tensor(sc)
        assert not torch.equal(got.float(), exact.to(tdt).float())


P = 8
GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
# one length: the reference's generate compiles once for the batch
PROMPTS = [list(range(1, 20)), [7] * 19, list(range(40, 59))]
MARGIN = 1e-4


@pytest.fixture(scope="module")
def quantized_models():
    """The reference's tiny Llama through its ``quantize_model``, and the
    port's through its own, carrying the reference's parameters and
    int8 buffers."""
    paddle.seed(0)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    ref_quantize_model(ref)
    port = quantize_model(LlamaForCausalLM(llama_tiny_config(),
                                           device="cpu"))
    load_raw_state_dict(
        port, {k: np.asarray(v) for k, v in ref.raw_state_dict().items()},
        buffers={k: np.asarray(b.value) for k, b in ref.named_buffers()
                 if k.rsplit(".", 1)[-1] in ("qweight", "weight_scale")})
    return ref, port


def test_quantize_model_swaps_every_linear(quantized_models):
    ref, port = quantized_models
    lin = [n for n, m in port.named_modules()
           if isinstance(m, QuantizedLinear)]
    assert len(lin) == 2 * 7 + 1                  # 7 a layer, and the head
    layer = port.llama.layers[0].self_attn.q_proj
    assert layer.qweight.dtype == torch.int8
    x = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    want = ref.llama.layers[0].self_attn.q_proj(paddle.to_tensor(x))
    np.testing.assert_allclose(layer(torch.tensor(x)).numpy(),
                               np.asarray(want.numpy()), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        layer.dequantized_weight().numpy(),
        np.asarray(ref.llama.layers[0].self_attn.q_proj
                   .dequantized_weight().numpy()), rtol=0, atol=0)


def test_quantize_model_generates_the_reference_tokens(quantized_models,
                                                       monkeypatch):
    """Greedy tokens of the quantized tiny Llama: the port's engine takes
    the model as it is and gives the reference ``generate``'s tokens."""
    ref, port = quantized_models
    seen = []
    chunk, mixed = E._paged_prefill_chunk, E._mixed_forward

    def chunk_rec(*a, **kw):
        logits = chunk(*a, **kw)
        top2 = logits.topk(2).values
        seen.append(float(top2[0] - top2[1]))
        return logits

    def mixed_rec(*a, **kw):
        logits = mixed(*a, **kw)
        rows = (a[9] + a[10] - 1)[a[10] > 0].long()
        top2 = logits[rows].topk(2, dim=-1).values
        seen.append(float((top2[:, 0] - top2[:, 1]).min()))
        return logits

    monkeypatch.setattr(E, "_paged_prefill_chunk", chunk_rec)
    monkeypatch.setattr(E, "_mixed_forward", mixed_rec)
    eng = LLMEngine(port, device="cpu", **GEOM)
    assert isinstance(eng._layers[0][1], tuple)
    for i, p in enumerate(PROMPTS):
        eng.add_request(i, p, max_new_tokens=6)
    while eng.has_work():
        eng.step()
    want, _ = ref.generate(np.asarray(PROMPTS), max_new_tokens=6)
    got = [eng.result(i) for i in range(len(PROMPTS))]
    assert got == np.asarray(want.numpy()).tolist()
    assert min(seen) >= MARGIN
