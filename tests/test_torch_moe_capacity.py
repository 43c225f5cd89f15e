"""Capacity-factor MoE serving against the reference engine.

The tiny Qwen2-MoE of ``test_torch_moe_serving.py`` (8 experts top-2,
the reference model after ``paddle.seed(0)``, its weights carried into
the port) serves with ``moe_dropless=False``: at page size 8 a capacity
factor of 0.5 caps each expert at ceil(2 x 8 x 0.5 / 8) = 1 slot a page
group (drops are certain) and 1.25 at 3.  On the unified step and on
the split path, greedy tokens and the ``moe`` plane of
``metrics_snapshot()`` (kept slots per expert, dropped slots, capacity)
must equal the reference's (``scan_decode=False``).  ``moe_ffn`` with
``group_start`` must equal the reference's ``moe_ffn`` (outputs within
1e-6, counts exactly).  Sampled serving and a swap-in resume under
capacity give the reference's tokens.  As in the other engine tests,
every row whose token is used must have a top-1 margin of at least 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.inference.moe_dispatch import MoEArch as RefArch
from paddle_tpu.inference.moe_dispatch import moe_ffn as ref_moe_ffn
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as RefQwen
from paddle_tpu.models.qwen2_moe import \
    qwen2_moe_tiny_config as ref_tiny_config

from paddle_tpu_torch.inference import engine as E
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.moe_dispatch import MoEArch, moe_ffn
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                               qwen2_moe_tiny_config)

P = 8
GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
PROMPTS = [[5, 9, 2, 14], list(range(1, 20)), [7] * 33,
           [3, 1, 4, 1, 5, 9, 2, 6], list(range(40, 51))]
MARGIN = 1e-4
CAPS = {0.5: 1, 1.25: 3}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefQwen(ref_tiny_config())
    ref.eval()
    port = Qwen2MoeForCausalLM(qwen2_moe_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


def _margin(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.fixture
def margins(monkeypatch):
    """The port's smallest top-1 margin over the rows whose token is
    used: each live descriptor's last row, every prefill chunk, and the
    live rows of every split-path forward."""
    seen = []
    mixed, chunk, dec = (E._mixed_forward, E._paged_prefill_chunk,
                         E._decode_forward)

    def mixed_rec(*args, **kw):
        logits, counts = mixed(*args, **kw)
        q_start, q_len = args[9], args[10]
        rows = (q_start + q_len - 1)[q_len > 0].long()
        seen.append(_margin(logits[rows]))
        return logits, counts

    def chunk_rec(*args, **kw):
        logits, counts = chunk(*args, **kw)
        seen.append(_margin(logits))
        return logits, counts

    def dec_rec(*args, **kw):
        logits, counts = dec(*args, **kw)
        live = kw["live"]
        if bool(live.any()):
            seen.append(_margin(logits[live]))
        return logits, counts

    monkeypatch.setattr(E, "_mixed_forward", mixed_rec)
    monkeypatch.setattr(E, "_paged_prefill_chunk", chunk_rec)
    monkeypatch.setattr(E, "_decode_forward", dec_rec)
    yield seen
    assert seen and min(seen) >= MARGIN, \
        f"top-1 margin {min(seen)} below {MARGIN}: pick another seed"


def _engines(models, cf, **kw):
    ref, port = models
    knobs = dict(GEOM, moe_dropless=False, moe_capacity_factor=cf, **kw)
    return (RefEngine(ref, scan_decode=False, **knobs),
            LLMEngine(port, device="cpu", **knobs))


def _serve(eng, admit, max_new=5):
    for i, p in enumerate(PROMPTS):
        getattr(eng, admit)(f"r{i}", p, max_new_tokens=max_new)
    dropped = []
    while eng.has_work():
        decode_only = not eng._prefilling
        eng.step()
        if decode_only:
            dropped.append(eng.metrics_snapshot()["moe"]["dropped_tokens"])
    return [eng.result(f"r{i}") for i in range(len(PROMPTS))], dropped


def _moe(snap):
    m = snap["moe"]
    return m["expert_tokens"], m["dropped_tokens"], m["capacity"]


@pytest.mark.parametrize("cf", sorted(CAPS))
@pytest.mark.parametrize("path", ["unified", "split"])
def test_greedy_tokens_and_moe_plane_equal_reference(models, margins, cf,
                                                     path):
    unified = path == "unified"
    ref_eng, port_eng = _engines(models, cf, unified_step=unified)
    admit = "begin_request" if unified else "add_request"
    want, _ = _serve(ref_eng, admit)
    got, dropped = _serve(port_eng, admit)
    assert got == want
    assert _moe(port_eng.metrics_snapshot()) == \
        _moe(ref_eng.metrics_snapshot())
    tokens, n_dropped, cap = _moe(port_eng.metrics_snapshot())
    assert cap == CAPS[cf]
    live = sum(len(p) for p in PROMPTS) + len(PROMPTS) * 4
    layers = port_eng._moe_counts.shape[0]
    assert sum(tokens) + n_dropped == live * 2 * layers
    if cf == 0.5:
        assert n_dropped > 0
    # pure-decode steps drop nothing: singleton groups
    assert dropped and len(set(dropped)) == 1 and dropped[0] == n_dropped


@pytest.mark.parametrize("cap", [1, 3])
def test_moe_ffn_group_ranks_equal_reference(models, cap):
    _, port = models
    mlp = port.layers[0].mlp
    ex = mlp.experts
    t, h = 24, port.config.hidden_size
    rng = np.random.default_rng(cap)
    hn = rng.standard_normal((t, h)).astype(np.float32)
    live = np.ones(t, bool)
    live[[5, 17, 23]] = False                  # padding rows
    # three page groups and four singleton rows
    group = np.array([0] * 8 + [8] * 8 + [16, 17, 18, 19] + [20] * 4,
                     np.int32)
    ws = [mlp.gate.weight, ex.gate_w, ex.up_w, ex.down_w,
          mlp.shared_gate.weight, mlp.shared_up.weight,
          mlp.shared_down.weight, mlp.shared_expert_gate.weight]
    kw = dict(num_experts=8, top_k=2, norm_topk=False, capacity=cap,
              shared=True, shared_gate=True, attn_bias=True,
              dispatch="grouped")
    got, gcnt = moe_ffn(torch.from_numpy(hn), tuple(w.detach() for w in ws),
                        MoEArch(**kw), torch.from_numpy(live),
                        torch.from_numpy(group))
    want, wcnt = ref_moe_ffn(
        jnp.asarray(hn), tuple(jnp.asarray(w.detach().numpy()) for w in ws),
        RefArch(**kw), jnp.asarray(live), jnp.asarray(group))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))
    assert int(gcnt.sum()) < 2 * int(live.sum())      # some slots dropped
    # the dense comparator keeps and drops the same slots
    dense, dcnt = moe_ffn(torch.from_numpy(hn),
                          tuple(w.detach() for w in ws),
                          MoEArch(**dict(kw, dispatch="dense")),
                          torch.from_numpy(live), torch.from_numpy(group))
    np.testing.assert_array_equal(dcnt.numpy(), gcnt.numpy())
    np.testing.assert_allclose(dense.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_budget_below_a_page_is_refused_alike(models):
    ref, port = models
    msgs = []
    for build in (lambda kw: RefEngine(ref, scan_decode=False, **kw),
                  lambda kw: LLMEngine(port, device="cpu", **kw)):
        with pytest.raises(ValueError) as err:
            build(dict(GEOM, moe_dropless=False, prefill_token_budget=4))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "prefill_token_budget >= page_size" \
        in msgs[0]
    # the split path packs no budget: taken
    LLMEngine(port, device="cpu", **GEOM, moe_dropless=False,
              prefill_token_budget=4, unified_step=False)


def _preempt_script(eng):
    eng.begin_request("x", PROMPTS[1], max_new_tokens=6)
    eng.begin_request("y", PROMPTS[2], max_new_tokens=6)
    eng.add_request("z", PROMPTS[4], max_new_tokens=6)
    while len(eng.requests["y"].out) < 2:     # y decodes, x and z too
        eng.step()
    assert eng.suspend("y")
    eng.step()
    assert eng.resume("y") == "swap_in"
    while eng.has_work():
        eng.step()
    return [eng.result(r) for r in "xyz"]


def test_sampled_serving_and_swap_in_under_capacity(models):
    samp = dict(decode_strategy="sampling", top_k=5, temperature=0.8,
                seed=7)
    ref_eng, port_eng = _engines(models, 0.5, **samp)
    want = _preempt_script(ref_eng)
    assert _preempt_script(port_eng) == want
    assert _moe(port_eng.metrics_snapshot()) == \
        _moe(ref_eng.metrics_snapshot())
