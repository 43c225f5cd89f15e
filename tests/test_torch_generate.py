"""The model's own cached decode in the port against the reference, on
the CPU.

``LlamaForCausalLM.generate`` on the reference's tiny Llama carried into
the port (f32) must give the reference's tokens, equal, on the
reference's own cases (``tests/test_generation.py``): greedy against a
plain full-forward loop, one token, ``max_length``, EOS padding the
tail, sampling with top-k / temperature and with top-p (the same seed
gives the same tokens, another seed others; ``p`` away from ties of the
cumulative mass), ``top_k=1`` equal to greedy, beam search at a width
equal to the vocabulary (exhaustive over two tokens), with an EOS pool
that freezes a hypothesis, and batched with a length penalty.  Scores
within 1e-5 (f32 sums in another order).  The concat caches of Llama
(``gen_caches``) and GPT-2 (``gen_caches``, ``caches=``): a prompt then
three one-token calls, logits within 1e-5 of the reference's.  The
reference's refusals are the port's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.common.errors import EnforceError
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt2_tiny_config as ref_gpt_config
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config

from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_tiny_config
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn.generation import StaticCache

SCORE_TOL = 1e-5


def _carry(ref, port):
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def llama():
    paddle.seed(3)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    return _carry(ref, LlamaForCausalLM(llama_tiny_config(), device="cpu"))


@pytest.fixture(scope="module")
def gpt():
    paddle.seed(0)
    ref = RefGPT(ref_gpt_config())
    ref.eval()
    port = GPTForCausalLM(gpt2_tiny_config(), device="cpu")
    port.eval()
    return _carry(ref, port)


def _both(pair, ids, **kw):
    """The reference's and the port's (ids, scores) as numpy."""
    ref, port = pair
    a, sa = ref.generate(paddle.to_tensor(np.asarray(ids, np.int32)), **kw)
    b, sb = port.generate(torch.tensor(np.asarray(ids)), **kw)
    return (np.asarray(a.numpy()), np.asarray(sa.numpy())), \
        (b.numpy(), sb.numpy())


def _naive_greedy(port, ids, n_new):
    """Full forwards over the growing sequence, the arg max each time."""
    ids = torch.tensor(np.asarray(ids, np.int64))
    out = []
    for _ in range(n_new):
        nxt = port(ids)[:, -1].argmax(-1)
        out.append(nxt)
        ids = torch.cat([ids, nxt[:, None]], dim=1)
    return torch.stack(out, 1).numpy()


CASES = {
    "greedy": dict(max_new_tokens=8),
    "single_token": dict(max_new_tokens=1),
    "max_length": dict(max_length=10),
    "sampling_top_k": dict(max_new_tokens=6, decode_strategy="sampling",
                           top_k=8, temperature=0.7, seed=11),
    "sampling_other_seed": dict(max_new_tokens=6,
                                decode_strategy="sampling", top_k=8,
                                temperature=0.7, seed=12),
    "sampling_top_p": dict(max_new_tokens=4, decode_strategy="sampling",
                           top_p=0.8, seed=0),
    "beam_length_penalty": dict(max_new_tokens=4,
                                decode_strategy="beam_search", num_beams=3,
                                length_penalty=1.0),
    "beam_exhaustive": dict(max_new_tokens=2, decode_strategy="beam_search",
                            num_beams=256),
}
IDS = np.random.default_rng(3).integers(0, 256, (2, 7)).astype(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_generate_equals_the_reference(llama, case):
    ids = IDS[:1, :4] if case in ("max_length", "beam_exhaustive") else IDS
    (want, wsc), (got, gsc) = _both(llama, ids, **CASES[case])
    np.testing.assert_array_equal(got, want)
    assert np.abs(gsc - wsc).max() <= SCORE_TOL
    n = CASES[case].get("max_new_tokens", 10 - ids.shape[1])
    assert got.shape == (ids.shape[0], n) and got.dtype == np.int32
    if case in ("greedy", "single_token"):
        np.testing.assert_array_equal(got, _naive_greedy(llama[1], ids, n))
        assert (gsc <= 0).all()


def test_sampling_is_seeded_and_top_k1_is_greedy(llama):
    _, port = llama
    ids = torch.tensor(IDS)
    kw = CASES["sampling_top_k"]
    a, _ = port.generate(ids, **kw)
    b, _ = port.generate(ids, **kw)
    c, _ = port.generate(ids, **CASES["sampling_other_seed"])
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy, _ = port.generate(ids, max_new_tokens=5)
    k1, _ = port.generate(ids, max_new_tokens=5, decode_strategy="sampling",
                          top_k=1, seed=3)
    assert torch.equal(greedy, k1)


def test_eos_pads_tail(llama):
    _, port = llama
    ids = [[5, 9, 2]]
    first = int(_naive_greedy(port, ids, 1)[0, 0])
    (want, wsc), (got, gsc) = _both(llama, ids, max_new_tokens=6,
                                    eos_token_id=first, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == first and (got[0, 1:] == 0).all()
    assert np.abs(gsc - wsc).max() <= SCORE_TOL


def test_beam_eos_pool_freezes_hypothesis(llama):
    _, port = llama
    prompt = [[5, 9, 2, 14]]
    out_g, _ = port.generate(torch.tensor(prompt), max_new_tokens=6)
    eos = int(out_g[0, 2])
    (want, wsc), (got, gsc) = _both(
        llama, prompt, max_new_tokens=6, decode_strategy="beam_search",
        num_beams=4, eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    assert np.abs(gsc - wsc).max() <= SCORE_TOL
    seq = got[0].tolist()
    if eos in seq:
        assert all(t == 0 for t in seq[seq.index(eos) + 1:])


def test_beam_batched_length_penalty_with_eos(llama):
    (want, wsc), (got, gsc) = _both(
        llama, [[5, 9, 2], [7, 1, 3]], max_new_tokens=5,
        decode_strategy="beam_search", num_beams=3, length_penalty=1.0,
        eos_token_id=17, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    assert np.abs(gsc - wsc).max() <= SCORE_TOL and np.isfinite(gsc).all()


def test_static_cache_forward_equals_full_forward(llama):
    """The static-cache protocol by hand: a prefill at 0, then one token
    a call at its position, logits equal to the full forward's."""
    _, port = llama
    ids = torch.tensor(IDS[:, :6], dtype=torch.long)
    caches = port.gen_static_caches(2, 8)
    assert isinstance(caches[0], StaticCache)
    with torch.no_grad():
        full = port(ids)
        a, caches = port(ids[:, :4], caches=caches, pos=0, prefill=True)
        b, caches = port(ids[:, 4:5], caches=caches, pos=4)
        c, caches = port(ids[:, 5:6], caches=caches, pos=5)
    got = torch.cat([a, b, c], dim=1)
    assert (got - full).abs().max() <= 1e-5


@pytest.mark.parametrize("model", ["llama", "gpt"])
def test_concat_cache_logits_within_1e5(llama, gpt, model):
    ref, port = llama if model == "llama" else gpt
    ids = IDS[:, :5]
    rc, pc = ref.gen_caches(2), port.gen_caches(2)
    with torch.no_grad():
        for lo, hi in ((0, 2), (2, 3), (3, 4), (4, 5)):
            rl, rc = ref(paddle.to_tensor(ids[:, lo:hi]), caches=rc)
            pl, pc = port(torch.tensor(ids[:, lo:hi], dtype=torch.long),
                          caches=pc)
            assert np.abs(pl.numpy() - np.asarray(rl.numpy())).max() <= 1e-5
    assert pc[0][0].shape[1] == 5


def test_generate_refusals_match(llama):
    ref, port = llama
    ids = [[1, 2]]
    for kw, match in ((dict(decode_strategy="contrastive"),
                       "unsupported decode_strategy"),
                      (dict(decode_strategy="beam_search", num_beams=1),
                       "num_beams >= 2"),
                      (dict(max_length=2), "nothing to generate"),
                      (dict(max_new_tokens=200), "max_position_embeddings")):
        with pytest.raises(EnforceError, match=match):
            ref.generate(paddle.to_tensor(np.asarray(ids, np.int32)), **kw)
        with pytest.raises(ValueError, match=match):
            port.generate(torch.tensor(ids), **kw)
