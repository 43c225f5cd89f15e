"""Sampling in the port against the reference, on the CPU.

``paddle_tpu_torch/common/prng.py`` replays ``jax.random``'s threefry2x32
stream (``jax_threefry_partitionable`` on), so the words of
``PRNGKey``, ``split``, ``fold_in`` and the raw bits must be equal, and
so must the uniforms, bit for bit.  The Gumbel noise is ``-log(-log
u)``: each library rounds ``log`` on its own (each within an ulp of the
exact value), so the noise is held within 4 ulp of ``max(|g|, 1)`` (an
ulp of the inner log carries into an outer log near 0).
``filtered_probs`` is held within 1e-6 (softmax sums in another order).
Tokens must be equal: ``sample_logits`` with and without ``row_ids``,
and the engine's sampled tokens on the reference's tiny Llama carried
into the port (f32), on the unified step with ``begin_request`` under a
prefill budget of 8 and with ``add_request`` in windows of
``steps_per_sync`` 4, on the split path in windows of 4, and across a
preemption script with a recompute resume; the engine keys after
serving are equal too.  Top-p
keeps the entries whose preceding cumulative mass is below ``p``; a
mass within an ulp of ``p`` may keep one entry more or less on either
side, so the ``p`` values here sit away from such ties (the test checks
the gap).  ``top_k=1`` gives the greedy tokens.

The reference engines run with ``scan_decode=False`` (the port's host
chain); the file builds two reference engine configurations, the
unified and the split one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import sampling as RS
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.nn import generation as RG

from paddle_tpu_torch.common import prng
from paddle_tpu_torch.inference import sampling as S
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn import generation as G

SEEDS = [0, 1, 1234, -1, 2 ** 31 + 7]
SHAPES = [(7,), (3, 256), (1, 128256)]
GEOM = dict(max_seqs=8, max_len=64, page_size=8, n_pages=64)
PROMPTS = [[5, 9, 2, 14], list(range(1, 20)), [7] * 33,
           [3, 1, 4, 1, 5, 9, 2, 6], list(range(40, 51))]
KNOBS = dict(decode_strategy="sampling", top_k=20, top_p=0.9,
             temperature=0.8, seed=1234)
FILTERS = [dict(), dict(top_k=8), dict(top_p=0.8), dict(temperature=0.7),
           dict(top_k=50, top_p=0.9, temperature=0.8)]
# the two reference engine configurations of this file
UNIFIED = dict(steps_per_sync=4, prefill_token_budget=8)
SPLIT = dict(unified_step=False, steps_per_sync=4)


def _words(key):
    return np.asarray(key).astype(np.int64).tolist()


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    port = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def logits():
    return (np.random.default_rng(0).standard_normal((6, 256)) * 3
            ).astype(np.float32)


# -- the threefry stream ------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_words_equal(seed):
    key, pkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert pkey.tolist() == _words(key)
    for num in (2, 5):
        assert prng.split(pkey, num).tolist() == _words(
            jax.random.split(key, num))
    for data in (0, 1, 77, 2 ** 31 + 5, 0x5bec0d02):
        assert prng.fold_in(pkey, data).tolist() == _words(
            jax.random.fold_in(key, data))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 1234])
def test_random_bits_equal(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = prng.random_bits(prng.prng_key(seed), shape).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_bits_equal_and_gumbel_within_4_ulp(shape):
    key, pkey = jax.random.PRNGKey(5), prng.prng_key(5)
    tiny = float(np.finfo(np.float32).tiny)
    for lo in (0.0, tiny):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo))
        got = prng.uniform(pkey, shape, minval=lo).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    want = np.asarray(jax.random.gumbel(key, shape))
    got = prng.gumbel(pkey, shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 4 * ulp).all()


def test_sampling_keys_equal():
    key, pkey = jax.random.PRNGKey(9), prng.prng_key(9)
    subs, last = RS.window_keys(key, 3)
    psubs, plast = S.window_keys(pkey, 3)
    assert [_words(k) for k in subs] == [p.tolist() for p in psubs]
    assert _words(last) == plast.tolist()
    for a, b in zip(RS.spec_window_keys(key), S.spec_window_keys(pkey)):
        assert _words(a) == b.tolist()
    assert _words(RS.spec_draw_key(key, 2, 5)) == \
        S.spec_draw_key(pkey, 2, 5).tolist()
    assert _words(RS.fold_row(key, 3)) == S.fold_row(pkey, 3).tolist()
    fp = S.key_fingerprint(pkey)
    assert fp == RS.key_fingerprint(key)
    assert S.key_from_fingerprint(fp).tolist() == pkey.tolist()


# -- filters and draws --------------------------------------------------------
def _top_p_gap(logits, p):
    """The smallest distance of a prefix mass of the sorted softmax from
    ``p``, per row (f64)."""
    x = np.sort(logits.astype(np.float64), axis=-1)[:, ::-1]
    e = np.exp(x - x.max(-1, keepdims=True))
    cum = np.cumsum(e / e.sum(-1, keepdims=True), -1)
    return np.abs(cum - p).min()


@pytest.mark.parametrize("kw", FILTERS, ids=str)
def test_filtered_probs_within_1e6(logits, kw):
    if "top_p" in kw:
        assert _top_p_gap(logits / kw.get("temperature", 1.0),
                          kw["top_p"]) > 1e-5
    want = np.asarray(RG.filtered_probs(jnp.asarray(logits),
                                        strategy="sampling", **kw))
    got = G.filtered_probs(torch.tensor(logits), strategy="sampling",
                           **kw).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert ((got > 0) == (want > 0)).all()


@pytest.mark.parametrize("kw", FILTERS, ids=str)
@pytest.mark.parametrize("row_ids", [None, np.arange(3, 9)],
                         ids=["dense", "rows"])
def test_sample_logits_tokens_equal(logits, kw, row_ids):
    for seed in (0, 7, 99):
        t, lp = RG.sample_logits(jnp.asarray(logits),
                                 jax.random.PRNGKey(seed),
                                 strategy="sampling", row_ids=row_ids, **kw)
        pt, plp = G.sample_logits(torch.tensor(logits), prng.prng_key(seed),
                                  strategy="sampling", row_ids=row_ids,
                                  **kw)
        assert pt.tolist() == np.asarray(t).tolist()
        assert np.abs(plp.numpy() - np.asarray(lp)).max() <= 1e-5


def test_only_finite_entries_need_noise():
    """A filtered row draws its noise at its finite entries alone: the
    same token as the whole draw, ties to the first index."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((4, 4096)).astype(np.float32))
    x[:, 100:] = float("-inf")
    x[0, 7] = x[0, 3] = 50.0                       # a tie: index 3 wins
    rows = prng.fold_in_rows(prng.prng_key(2), torch.arange(4))
    got = prng.categorical(None, x, row_keys=rows)
    full = torch.argmax(x + prng._gumbel_from_bits(prng._bits_at(
        rows[:, 0:1], rows[:, 1:2], torch.arange(4096)[None])), dim=-1)
    assert got.tolist() == full.tolist() and int(got[0]) == 3


def test_top_k1_equals_greedy(logits):
    t, _ = G.sample_logits(torch.tensor(logits), prng.prng_key(4),
                           strategy="sampling", top_k=1, temperature=0.5)
    assert t.tolist() == np.argmax(logits, -1).tolist()


# -- the engine ---------------------------------------------------------------
def _serve(eng, admit, max_new=9):
    for i, p in enumerate(PROMPTS):
        getattr(eng, admit)(f"r{i}", p, max_new_tokens=max_new)
    while eng.has_work():
        eng.step()
    return [eng.result(f"r{i}") for i in range(len(PROMPTS))]


@pytest.fixture(scope="module")
def served(models):
    """Each reference configuration's sampled tokens and final key, for
    both admission paths the configuration takes."""
    ref, _ = models
    out = {}
    for name, cfg, admits in (("unified", UNIFIED,
                               ("begin_request", "add_request")),
                              ("split", SPLIT, ("add_request",))):
        for admit in admits:
            eng = RefEngine(ref, **GEOM, scan_decode=False, **KNOBS, **cfg)
            out[name, admit] = (_serve(eng, admit),
                                RS.key_fingerprint(eng._key))
    return out


@pytest.mark.parametrize("name,admit", [("unified", "begin_request"),
                                        ("unified", "add_request"),
                                        ("split", "add_request")])
def test_engine_sampled_tokens_equal(models, served, name, admit):
    _, port = models
    cfg = UNIFIED if name == "unified" else SPLIT
    eng = LLMEngine(port, device="cpu", **GEOM, **KNOBS, **cfg)
    got = _serve(eng, admit)
    want, key = served[name, admit]
    assert got == want
    assert S.key_fingerprint(eng._key) == key
    greedy = _serve(LLMEngine(port, device="cpu", **GEOM, **cfg), admit)
    assert got != greedy                  # the knobs took effect


def _preempted(eng):
    """Serve with r1 suspended for a step and resumed: with no swap pool
    its prompt and generated tokens are recomputed (1-token replay
    windows, the engine key untouched)."""
    for i, p in enumerate(PROMPTS):
        eng.add_request(f"r{i}", p, max_new_tokens=9)
    eng.step()
    assert not eng.suspend("r1")
    eng.step()
    assert eng.resume("r1") == "recompute"
    while eng.has_work():
        eng.step()
    return [eng.result(f"r{i}") for i in range(len(PROMPTS))]


def test_engine_sampled_recompute_resume_equal(models):
    """The same preemption script on both engines (the unified
    configuration without a swap pool) gives the same tokens.  They are
    not those of an unpreempted run: the suspended request misses a
    step and comes back in another batch row, and a row's draws follow
    the step key and its row."""
    ref, port = models
    want = _preempted(RefEngine(ref, **GEOM, scan_decode=False, **KNOBS,
                                **UNIFIED, swap_pool_pages=0))
    got = _preempted(LLMEngine(port, device="cpu", **GEOM, **KNOBS,
                               **UNIFIED, swap_pool_pages=0))
    assert got == want


@pytest.mark.parametrize("cfg", [UNIFIED, SPLIT], ids=["unified", "split"])
def test_engine_top_k1_equals_greedy(models, cfg):
    _, port = models
    greedy = _serve(LLMEngine(port, device="cpu", **GEOM, **cfg),
                    "add_request")
    k1 = _serve(LLMEngine(port, device="cpu", **GEOM, **cfg,
                          decode_strategy="sampling", top_k=1, seed=3,
                          temperature=0.7), "add_request")
    assert k1 == greedy
