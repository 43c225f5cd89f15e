"""Speculative decoding in the port against the reference, on the CPU.

The reference's tiny Llama (seed 0) is the target and another (seed 1)
the draft, both carried into the port (f32).  Greedy: the speculative
tokens equal the port's plain greedy tokens on every serving path the
reference's ``tests/test_speculative.py`` runs (f32 and int8 pools,
prefix-cache hits, ``begin_request`` with its plain prefill windows,
the split path, an EOS mid-window, preemption with both restore paths),
the target drafting for itself accepts everything, and tokens and
``spec_stats`` equal the reference's speculative engine.  Rejection
mode (sampling knobs): tokens and ``spec_stats`` equal the reference's
for the same seed, on the unified and the split path.  The acceptance
pieces equal the reference's: ``residual_dist`` (f64, within 1e-12),
``acceptance_uniforms`` (equal) and ``rejection_accept`` (equal tokens);
the delivered token's marginal is the target's distribution.  Both
caches are clean after a drain, and the reference's refusals (draft
vocabulary, rope length, ``spec_k``, an MoE draft) are the port's, with
the same messages.

Two reference engine configurations: greedy and sampled speculative.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.inference import speculative as RSP
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config

from paddle_tpu_torch.common import prng
from paddle_tpu_torch.inference import speculative as SP
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                               qwen2_moe_tiny_config)

P = 8
GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
PROMPTS = [[5, 9, 2, 14], list(range(1, 20)), [7] * 33,
           [3, 1, 4, 1, 5, 9, 2, 6]]
SAMPLED = dict(decode_strategy="sampling", temperature=0.9, top_k=40,
               seed=7)


def _pair(seed):
    paddle.seed(seed)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    port = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def models():
    """(reference target, port target, reference draft, port draft)."""
    return _pair(0) + _pair(1)


def _mk(model, draft=None, k=3, **kw):
    if draft is not None:
        kw.update(draft_model=draft, spec_k=k)
    return LLMEngine(model, device="cpu", **GEOM, **kw)


def _serve(eng, prompts=PROMPTS, max_new=9, admit="add_request", eos=None):
    for i, p in enumerate(prompts):
        getattr(eng, admit)(f"r{i}", p, max_new_tokens=max_new,
                            eos_token_id=eos)
    while eng.has_work():
        eng.step()
    return [eng.result(f"r{i}") for i in range(len(prompts))]


# -- greedy: the plain tokens -------------------------------------------------
@pytest.mark.parametrize("case", ["fp", "int8", "prefix", "begin", "split",
                                  "eos"])
def test_greedy_spec_equals_plain(models, case):
    _, port, _, draft = models
    kw, admit, eos, prompts = {}, "add_request", None, PROMPTS
    if case == "int8":
        kw = {"kv_dtype": "int8"}
    elif case == "prefix":
        prompts = [PROMPTS[2], PROMPTS[2], PROMPTS[1]]
    elif case == "begin":
        admit = "begin_request"
    elif case == "split":
        kw = {"unified_step": False}
    if case == "eos":
        eos = _serve(_mk(port))[0][3]            # retires r0 mid-window
    want = _serve(_mk(port, **kw), prompts, admit=admit, eos=eos)
    eng = _mk(port, draft, **kw)
    assert _serve(eng, prompts, admit=admit, eos=eos) == want
    st = eng.spec_stats
    assert st["proposed"] >= st["accepted"] >= 0 and st["windows"] > 0


def test_self_draft_accepts_everything(models):
    _, port, _, _ = models
    eng = _mk(port, port, k=3)
    got = _serve(eng)
    assert got == _serve(_mk(port))
    st = eng.spec_stats
    assert st["accepted"] == st["proposed"] and st["windows"] == 2
    assert st["delivered"] == sum(len(t) - 1 for t in got)


@pytest.mark.parametrize("pool,path", [(64, "swap_in"), (0, "recompute")])
def test_preempt_resume_equals_plain(models, pool, path):
    """Suspend releases the draft slot; resume attaches it again at the
    next window; the tokens stay the plain ones."""
    _, port, _, draft = models
    want = _serve(_mk(port), PROMPTS[:2])
    eng = _mk(port, draft, swap_pool_pages=pool)
    for i in range(2):
        eng.add_request(f"r{i}", PROMPTS[i], max_new_tokens=9)
    eng.step()
    eng.suspend("r0")
    assert eng.requests["r0"].draft_slot is None
    eng.step()
    assert eng.resume("r0") == path
    while eng.has_work():
        eng.step()
    assert [eng.result(f"r{i}") for i in range(2)] == want


def test_both_caches_clean_after_drain(models):
    _, port, _, draft = models
    eng = _mk(port, draft)
    free_t, free_d = eng.cache.free_pages(), eng._spec_cache.free_pages()
    _serve(eng)
    assert eng.cache.free_pages() == free_t
    assert eng._spec_cache.free_pages() == free_d


# -- against the reference's speculative engine -------------------------------
@pytest.mark.parametrize("mode", ["greedy", "rejection"])
def test_spec_engine_equals_the_reference(models, mode):
    ref, port, rdraft, draft = models
    kw = {} if mode == "greedy" else SAMPLED
    reng = RefEngine(ref, **GEOM, scan_decode=False, draft_model=rdraft,
                     spec_k=3, **kw)
    want = _serve(reng)
    eng = _mk(port, draft, **kw)
    assert _serve(eng) == want
    assert eng.spec_stats == reng.spec_stats
    assert eng._spec_mode == reng._spec_mode == mode
    if mode == "rejection":
        # the same engine configuration on the split path, and admitted
        # through begin_request
        for extra, admit in (({"unified_step": False}, "add_request"),
                             ({}, "begin_request")):
            reng = RefEngine(ref, **GEOM, scan_decode=False,
                             draft_model=rdraft, spec_k=3, **kw, **extra)
            eng = _mk(port, draft, **kw, **extra)
            assert _serve(eng, admit=admit) == _serve(reng, admit=admit)
            assert eng.spec_stats == reng.spec_stats


# -- the acceptance pieces ----------------------------------------------------
def _dists(rng, v=64):
    p = rng.dirichlet(np.ones(v) * 0.3)
    q = rng.dirichlet(np.ones(v) * 0.3)
    return p, q


def test_residual_dist_and_uniforms_equal():
    rng = np.random.default_rng(0)
    for _ in range(5):
        p, q = _dists(rng)
        assert np.abs(SP.residual_dist(p, q)
                      - RSP.residual_dist(p, q)).max() <= 1e-12
    assert np.array_equal(SP.residual_dist(p, p), RSP.residual_dist(p, p))
    for seed, row in ((0, 0), (3, 5), (11, 2)):
        want = RSP.acceptance_uniforms(jax.random.PRNGKey(seed), 4, row)
        got = SP.acceptance_uniforms(prng.prng_key(seed), 4, row)
        assert got == want


def test_rejection_accept_equals_the_reference():
    rng = np.random.default_rng(1)
    k, v = 3, 64
    for t in range(40):
        q = np.stack([_dists(rng, v)[1] for _ in range(k)])
        p = np.stack([_dists(rng, v)[0] for _ in range(k + 1)])
        d = np.array([rng.choice(v, p=q[j]) for j in range(k)])
        ra, rr = jax.random.split(jax.random.PRNGKey(100 + t))
        pa, pr = prng.split(prng.prng_key(100 + t))
        want = RSP.rejection_accept(d, q, p, ra, rr, row=t % 4)
        got = SP.rejection_accept(d, q, p, pa, pr, row=t % 4)
        assert got == want
    assert SP.greedy_accept([4, 5, 6], [4, 5, 7, 9]) == \
        RSP.greedy_accept([4, 5, 6], [4, 5, 7, 9]) == ([4, 5, 7], 2)


def test_rejection_accept_keeps_the_target_distribution():
    """Accept ``d ~ q`` with probability ``min(1, p(d) / q(d))``, resample
    rejects from the residual: the delivered token's marginal is p
    however bad q is."""
    rng = np.random.default_rng(0)
    p = np.array([0.55, 0.25, 0.15, 0.05])
    q = np.array([0.10, 0.20, 0.30, 0.40])
    counts = np.zeros(4)
    n = 800
    for t in range(n):
        a_root, r_root = prng.split(prng.prng_key(1000 + t))
        toks, _ = SP.rejection_accept(np.array([rng.choice(4, p=q)]),
                                      q[None], np.stack([p, p]), a_root,
                                      r_root, row=0)
        counts[toks[0]] += 1
    assert np.abs(counts / n - p).max() < 0.07


# -- refusals -----------------------------------------------------------------
def test_draft_refusals_match(models):
    ref, port, _, _ = models
    cfg = llama_tiny_config()
    rcfg = ref_tiny_config()
    cases = [({"vocab_size": 128}, "vocab"),
             ({"max_position_embeddings": 16}, "max_position")]
    for change, match in cases:
        rd = RefLlama(type(rcfg)(**{**vars(rcfg), **change}))
        with pytest.raises(Exception, match=match) as want:
            RefEngine(ref, **GEOM, scan_decode=False, draft_model=rd,
                      spec_k=2)
        pd = LlamaForCausalLM(LlamaConfig(**{**vars(cfg), **change}),
                              device="cpu")
        with pytest.raises(ValueError, match=match) as got:
            _mk(port, pd, k=2)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        _mk(port, port, k=0)
    moe = Qwen2MoeForCausalLM(qwen2_moe_tiny_config(), device="cpu")
    with pytest.raises(ValueError, match="dense backbone"):
        LLMEngine(moe, device="cpu", max_seqs=4, max_len=64, page_size=P,
                  n_pages=64, draft_model=moe, spec_k=2)
