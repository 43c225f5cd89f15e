"""The Llama attention options against the reference: ``attention_bias``
(q/k/v biases), ``rope_interleaved`` (GPT-J pairing) and ``fuse_qkv``
(one product of the concatenated weights), and the public
``apply_rotary_pos_emb``.

Tiny Llama configs in f32 on the CPU, the reference built after
``paddle.seed(0)`` with nonzero biases carried into the port through
``raw_state_dict()``.  Tolerances: logits within 1e-5 relative L2 (f32
sums in another order); with all three knobs on, the loss within 1e-5
relative and every gradient within 1e-4 relative L2.  As in the
reference, a bias or ``fuse_qkv`` takes the unfused rope, and
interleaved rope inside the fused chain takes the plain rope: the
fused and unfused chains give equal logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import CompiledTrainStep as RefStep
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import apply_rotary_pos_emb as ref_rope
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           apply_rotary_pos_emb,
                                           llama_tiny_config)

KNOBS = ("attention_bias", "rope_interleaved", "fuse_qkv")


def _batch():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    return {"input_ids": ids, "labels": labels}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _models(knobs, **port_over):
    cfg = ref_tiny()
    for k in knobs:
        setattr(cfg, k, True)
    paddle.seed(0)
    ref = RefLlama(cfg)
    state = {k: np.asarray(v) for k, v in ref.raw_state_dict().items()}
    rng = np.random.default_rng(2)
    for k in state:
        if k.endswith(".bias"):          # zeros at init: make them count
            state[k] = (0.1 * rng.standard_normal(state[k].shape)
                        ).astype(np.float32)
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    pcfg = dataclasses.replace(llama_tiny_config(),
                               **{k: True for k in knobs}, **port_over)
    port = LlamaForCausalLM(pcfg, device="cpu")
    load_raw_state_dict(port, state)
    return ref, port


@pytest.mark.parametrize("knob", KNOBS)
def test_each_knob_logits_match_reference(knob):
    ref, port = _models((knob,))
    ids = _batch()["input_ids"]
    want = np.asarray(ref(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.tensor(ids)).numpy()
        # the unfused chain gives the same logits
        port.config.fuse_norm_rope = False
        for layer in port.llama.layers:
            layer.self_attn.fuse_norm_rope = False
            layer.fuse_chain = False
        unfused = port(torch.tensor(ids)).numpy()
    assert _rel_l2(want, got) <= 1e-5
    assert _rel_l2(got, unfused) <= 1e-5
    attn = port.llama.layers[0].self_attn
    # as the reference: only interleaved rope stays on the fused chain
    assert LlamaForCausalLM(dataclasses.replace(
        port.config, fuse_norm_rope=True), device="cpu").llama.layers[
            0].self_attn.fuse_norm_rope == (knob == "rope_interleaved")
    assert (attn.q_proj.bias is not None) == (knob == "attention_bias")


def test_all_knobs_loss_and_gradients_match_reference():
    ref, port = _models(KNOBS)

    def loss(m, b):
        return m(b["input_ids"], labels=b["labels"])

    rstep = RefStep(ref, loss, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=ref.parameters()))
    pstep = CompiledTrainStep(port, loss, optim.AdamW(
        learning_rate=1e-3, parameters=port.parameters()))
    want, grads = rstep.grad_step(_batch())
    got, pgrads = pstep.grad_step(_batch())
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert set(pgrads) == set(grads)
    for n, g in pgrads.items():
        assert _rel_l2(np.asarray(grads[n]), g.numpy()) <= 1e-4, n
    assert pgrads["llama.layers.0.self_attn.k_proj.bias"].abs().max() > 0


@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rotary_pos_emb_matches_reference(interleaved):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    ang = rng.uniform(0, 6, (8, 8)).astype(np.float32)
    ang = np.concatenate([ang, ang], axis=-1)
    cos, sin = np.cos(ang), np.sin(ang)
    rq, rk = ref_rope(*(paddle.to_tensor(a) for a in (q, k, cos, sin)),
                      interleaved=interleaved)
    pq, pk = apply_rotary_pos_emb(*(torch.tensor(a) for a in (q, k, cos,
                                                               sin)),
                                  interleaved=interleaved)
    np.testing.assert_allclose(pq.numpy(), np.asarray(rq.numpy()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk.numpy()),
                               rtol=1e-6, atol=1e-6)
