"""The port's serving slice against the reference engine, end to end.

The reference ``LlamaForCausalLM(llama_tiny_config())`` is built after
``paddle.seed(0)`` and its ``raw_state_dict()`` carried into the port
with ``load_raw_state_dict``; both engines then serve the same prompts
on the CPU in f32 (the reference through its jnp paths, the port
through its kernels' plain versions).  Greedy tokens must be equal on
every admission path: deferred ``begin_request`` + ``step``,
synchronous ``add_request`` + ``step``, host-chained ``steps_per_sync``
windows, and a shared-prefix pair (whose ``prefix_stats`` must match
too).  Prefill logits must agree within 1e-4 (f32 sums in another
order).

Token equality is only meaningful where the top-1 choice is not a near
tie: every test records the port's top-1 margin on each row whose token
is used and requires it to stay above 1e-4.  Seed 0 satisfies this.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config

from paddle_tpu_torch.inference import engine as E
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config

P = 8
GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
PROMPTS = [[5, 9, 2, 14],                         # sub-page
           list(range(1, 20)),                    # 2.5 pages
           [7] * 33,                              # page-crossing
           [3, 1, 4, 1, 5, 9, 2, 6],              # exactly one page
           list(range(40, 51))]                   # 1.5 pages
SYSTEM = list(range(100, 117))                    # 2 pages + 1 token
PAIR = [SYSTEM + [1, 2, 3], SYSTEM + [9, 8]]
MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    port = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


def _margin(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.fixture
def margins(monkeypatch):
    """Record the port's smallest top-1 margin over the rows whose
    token is used: each live descriptor's last row in the mixed step,
    and every prefill chunk's logits."""
    seen = []
    mixed, chunk = E._mixed_forward, E._paged_prefill_chunk

    def mixed_rec(*args, **kw):
        logits = mixed(*args, **kw)
        q_start, q_len = args[9], args[10]
        rows = (q_start + q_len - 1)[q_len > 0].long()
        seen.append(_margin(logits[rows]))
        return logits

    def chunk_rec(*args, **kw):
        logits = chunk(*args, **kw)
        seen.append(_margin(logits))
        return logits

    monkeypatch.setattr(E, "_mixed_forward", mixed_rec)
    monkeypatch.setattr(E, "_paged_prefill_chunk", chunk_rec)
    yield seen
    assert seen and min(seen) >= MARGIN, \
        f"top-1 margin {min(seen)} below {MARGIN}: pick another seed"


def _engines(models, ref_kw=(), **kw):
    ref, port = models
    return (RefEngine(ref, **GEOM, **dict(ref_kw), **kw),
            LLMEngine(port, device="cpu", **GEOM, **kw))


def _serve(eng, prompts, admit, max_new):
    for i, p in enumerate(prompts):
        getattr(eng, admit)(f"r{i}", p, max_new_tokens=max_new)
    while eng.has_work():
        eng.step()
    return [eng.result(f"r{i}") for i in range(len(prompts))]


@pytest.mark.parametrize("admit,max_new,kw", [
    ("begin_request", 6, {}),
    ("add_request", 6, {}),
    ("add_request", 9, {"steps_per_sync": 4}),
    ("begin_request", 9, {"steps_per_sync": 4}),
], ids=["begin", "add", "add-window4", "begin-window4"])
def test_greedy_tokens_equal_reference(models, margins, admit, max_new,
                                       kw):
    # the reference's host-chained window (scan_decode=False) is its
    # on-device window's order, bit for bit
    ref_eng, port_eng = _engines(models, ref_kw={"scan_decode": False},
                                 **kw)
    want = _serve(ref_eng, PROMPTS, admit, max_new)
    got = _serve(port_eng, PROMPTS, admit, max_new)
    assert got == want
    assert all(len(t) == max_new for t in got)


@pytest.mark.parametrize("admit", ["begin_request", "add_request"])
def test_shared_prefix_pair_equal_reference(models, margins, admit):
    """The second request of the pair maps the first one's two full
    system-prompt pages and prefills only its tail."""
    outs = []
    for eng in _engines(models):
        toks = []
        for i, p in enumerate(PAIR):
            getattr(eng, admit)(f"p{i}", p, max_new_tokens=5)
            while eng.has_work():
                eng.step()
            toks.append(eng.result(f"p{i}"))
        outs.append((toks, dict(eng.prefix_stats)))
    (want, want_stats), (got, got_stats) = outs
    assert got == want
    assert got_stats == want_stats
    assert got_stats["hit_tokens"] == 2 * P and got_stats["shared_pages"] == 2


def test_first_token_logits_match_reference(models, margins):
    ref_eng, port_eng = _engines(models)
    for p in PROMPTS:
        rs = ref_eng.cache.allocate(len(p) + 1)
        ps = port_eng.cache.allocate(len(p) + 1)
        want = np.asarray(ref_eng._prefill_seq(rs, p, 0))
        got = port_eng._prefill_seq(ps, p, 0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        ref_eng.cache.release(rs)
        port_eng.cache.release(ps)


def test_abort_and_pop_result(models):
    _, port = models
    eng = LLMEngine(port, device="cpu", **GEOM)
    eng.begin_request("a", PROMPTS[1], max_new_tokens=4)
    eng.add_request("b", PROMPTS[0], max_new_tokens=4)
    free = eng.cache.free_pages()
    assert eng.abort("a") and eng.abort("b")
    assert not eng.abort("a")
    assert not eng.has_work()
    assert eng.cache.free_pages() == free + 3 + 1
    assert eng.requests["b"].cancelled
    assert len(eng.pop_result("b")) == 1         # its prefill token
    assert eng.result("a") == []
    with pytest.raises(ValueError, match="unknown request"):
        eng.result("b")


@pytest.mark.parametrize("knob", [
    {"moe_dropless": False}, {"swap_pool_pages": 16},
    {"moe_capacity_factor": 2.0}, {"decode_strategy": "sampling"},
    {"mesh": object()}, {"draft_model": object()},
    {"scan_decode": True}, {"top_k": 5}, {"top_p": 0.9},
    {"temperature": 0.5}, {"seed": 3}, {"enable_metrics": True},
    {"tp_axis": "mp"}, {"spec_k": 2},
])
def test_knobs_outside_the_slice_raise(models, knob):
    _, port = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMEngine(port, device="cpu", **GEOM, **knob)
    # the reference's keywords at the value the port runs are taken
    LLMEngine(port, device="cpu", **GEOM, scan_decode=False, top_k=0,
              top_p=1.0, temperature=1.0, seed=0, enable_metrics=False,
              tp_axis="tp", spec_k=4)


def test_weights_are_referenced_not_copied(models):
    _, port = models
    eng = LLMEngine(port, device="cpu", **GEOM)
    layer0 = port.llama.layers[0]
    assert eng._layers[0][1] is layer0.self_attn.q_proj.weight
    assert eng._head_w is port.lm_head.weight
    assert eng.cache.k_pages.shape == (2, 2, 64, P, 16)
    assert eng.cache.k_pages.dtype == torch.float32
