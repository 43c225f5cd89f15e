"""The port's GPT-2 training path against the reference, end to end.

The reference ``GPTForCausalLM(gpt2_tiny_config())`` (dropout 0) is built
after ``paddle.seed(0)`` and its ``raw_state_dict()`` carried into the
port through ``load_raw_state_dict``; both ``CompiledTrainStep``s then
train on one 2 x 32 batch with ``bench.py`` ``bench_gpt2``'s recipe
(``GPTPretrainingCriterion``, AdamW at lr 1e-4, f32) on the CPU.  The reference runs
its jnp paths, the port its kernels' plain versions.  Tolerances, from
f32 sums taken in another order: logits 1e-5 relative L2; losses 1e-5
relative; every gradient 1e-5 relative L2 per leaf.

At dropout 0.1 the port is checked on its own (the reference draws its
masks from ``jax.random``, so no bit parity exists): one ``seed``
reproduces its losses, another gives others.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import CompiledTrainStep as RefStep
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCriterion
from paddle_tpu.models.gpt import gpt2_tiny_config as ref_tiny_config

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         gpt2_tiny_config)

LR = 1e-4         # bench_gpt2's AdamW rate


def _batch(seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (2, 33)).astype(np.int32)
    return {"x": ids[:, :-1], "y": ids[:, 1:].astype(np.int64)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    ref = RefGPT(ref_tiny_config())
    port = GPTForCausalLM(gpt2_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


def test_state_dict_carries_across(pair):
    ref, port = pair
    names = list(ref.raw_state_dict())
    assert [n for n, _ in port.named_parameters()] == names
    for n, p in port.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(), np.asarray(ref.raw_state_dict()[n]))


@pytest.fixture(scope="module")
def ref_step(pair):
    """The reference trainer (one configuration for the whole file): it
    keeps its own copy of the parameters, so the model stays as built."""
    ref, _ = pair
    crit = RefCriterion()
    return RefStep(ref, lambda m, b: crit(m(b["x"]), b["y"]),
                   paddle.optimizer.AdamW(learning_rate=LR,
                                          parameters=ref.parameters()))


def test_logits_match_reference(pair, ref_step):
    _, port = pair
    batch = _batch()
    want = np.asarray(ref_step.eval_step(lambda m, b: m(b["x"]), batch))
    with torch.no_grad():
        got = port(torch.from_numpy(batch["x"])).numpy()
    assert got.shape == want.shape == (2, 32, 256)
    assert _rel_l2(want, got) <= 1e-5


def test_three_adamw_steps_match_reference(pair, ref_step):
    """Three steps of grad_step + apply_grads on both sides, from the
    same weights.  The port's trainer updates its model in place, so it
    trains a fresh copy and the module's pair stays untouched."""
    ref, _ = pair
    port = GPTForCausalLM(gpt2_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    pcrit = GPTPretrainingCriterion()
    port_step = CompiledTrainStep(
        port, lambda m, b: pcrit(m(b["x"]), b["y"]),
        optim.AdamW(learning_rate=LR, parameters=port.parameters()))
    for i in range(3):
        batch = _batch(i)
        loss, grads = ref_step.grad_step(batch)
        ploss, pgrads = port_step.grad_step(batch)
        assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
        assert set(pgrads) == set(grads)
        for n, g in pgrads.items():
            assert _rel_l2(np.asarray(grads[n]), g.numpy()) <= 1e-5, (i, n)
        ref_step.apply_grads(grads)
        port_step.apply_grads(pgrads)
    assert port_step.step_count == 3


def test_cached_decode_raises(pair):
    _, port = pair
    with pytest.raises(NotImplementedError, match="cached decode"):
        port.gen_caches(1)
    with pytest.raises(NotImplementedError, match="cached decode"):
        port(torch.zeros(1, 4, dtype=torch.long), caches=[None, None])


def _dropout_losses(seed):
    cfg = dataclasses.replace(gpt2_tiny_config(), hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    port = GPTForCausalLM(cfg, device="cpu")
    crit = GPTPretrainingCriterion()
    step = CompiledTrainStep(
        port, lambda m, b: crit(m(b["x"]), b["y"]),
        optim.AdamW(learning_rate=LR, parameters=port.parameters()),
        seed=seed)
    return [float(step(_batch(i))) for i in range(2)]


def test_dropout_is_reproducible_from_the_seed():
    first, again, other = (_dropout_losses(s) for s in (3, 3, 4))
    assert first == again
    assert first != other
    assert all(np.isfinite(first))
