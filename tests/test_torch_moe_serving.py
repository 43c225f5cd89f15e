"""The port's MoE serving against the reference engine, end to end.

The reference ``Qwen2MoeForCausalLM(qwen2_moe_tiny_config())`` (8
experts top-2, a gated shared expert, q/k/v biases) is built after
``paddle.seed(0)`` and its ``raw_state_dict()`` carried into the port;
both ``LLMEngine``s serve ``tests/test_moe_serving.py``'s prompts on the
CPU in f32 with ``moe_dispatch="grouped"`` (the reference's grouped
dispatch runs its per-row oracle on the CPU, the port its kernel's
plain version).  Greedy tokens must be equal through ``add_request``
and through ``begin_request`` + the unified step, and so must the
per-(layer, expert) routed-slot counts.  Prefill logits agree within
1e-4 (f32 sums in another order).  As in the Llama engine test, every
row whose token is used must have a top-1 margin of at least 1e-4, so
that token equality means something.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as RefQwen
from paddle_tpu.models.qwen2_moe import \
    qwen2_moe_tiny_config as ref_tiny_config

from paddle_tpu_torch.inference import engine as E
from paddle_tpu_torch.inference.backbone import resolve_backbone
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.moe_dispatch import MoEArch, moe_ffn
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                               qwen2_moe_tiny_config)

P = 8
GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
PROMPTS = [[5, 9, 2, 14],                         # sub-page
           list(range(1, 20)),                    # 2.5 pages
           [7] * 33,                              # page-crossing
           [3, 1, 4, 1, 5, 9, 2, 6],              # exactly one page
           list(range(40, 51))]                   # 1.5 pages
MARGIN = 1e-4


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
    used (each live descriptor's last row; every prefill chunk)."""
    seen = []
    mixed, chunk = E._mixed_forward, E._paged_prefill_chunk

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

    monkeypatch.setattr(E, "_mixed_forward", mixed_rec)
    monkeypatch.setattr(E, "_paged_prefill_chunk", chunk_rec)
    yield seen
    assert seen and min(seen) >= MARGIN, \
        f"top-1 margin {min(seen)} below {MARGIN}: pick another seed"


def _serve(eng, admit, max_new=6):
    for i, p in enumerate(PROMPTS):
        getattr(eng, admit)(f"r{i}", p, max_new_tokens=max_new)
    while eng.has_work():
        eng.step()
    return [eng.result(f"r{i}") for i in range(len(PROMPTS))]


@pytest.mark.parametrize("admit", ["begin_request", "add_request"],
                         ids=["begin", "add"])
def test_greedy_tokens_and_counts_equal_reference(models, margins, admit):
    ref, port = models
    ref_eng = RefEngine(ref, **GEOM, moe_dispatch="grouped")
    port_eng = LLMEngine(port, device="cpu", **GEOM, moe_dispatch="grouped")
    want = _serve(ref_eng, admit)
    got = _serve(port_eng, admit)
    assert got == want
    assert all(len(t) == 6 for t in got)
    np.testing.assert_array_equal(port_eng._moe_counts.numpy(),
                                  ref_eng._moe_counts)
    # dropless: every routed slot is counted, k per real token per layer
    assert int(port_eng._moe_counts.sum(axis=1).min()) > 0


def test_first_token_logits_match_reference(models, margins):
    ref, port = models
    ref_eng = RefEngine(ref, **GEOM)
    port_eng = LLMEngine(port, device="cpu", **GEOM)
    for p in PROMPTS:
        rs = ref_eng.cache.allocate(len(p) + 1)
        ps = port_eng.cache.allocate(len(p) + 1)
        want = np.asarray(ref_eng._prefill_seq(rs, p, 0))
        got = port_eng._prefill_seq(ps, p, 0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        ref_eng.cache.release(rs)
        port_eng.cache.release(ps)


def test_dense_comparator_gives_the_grouped_tokens(models):
    """On the CPU the per-row comparator and the grouped dispatch run the
    same row-wise products: the same tokens and counts."""
    _, port = models
    outs = []
    for mode in ("grouped", "dense"):
        eng = LLMEngine(port, device="cpu", **GEOM, moe_dispatch=mode)
        outs.append((_serve(eng, "begin_request", 4),
                     eng._moe_counts.clone()))
    assert outs[0][0] == outs[1][0]
    assert torch.equal(outs[0][1], outs[1][1])


def test_backbone_spec_and_referenced_weights(models):
    _, port = models
    spec = resolve_backbone(port)
    assert spec.arch == "qwen2_moe" and spec.attn_bias
    assert spec.moe == {"num_experts": 8, "top_k": 2, "norm_topk": False,
                        "capacity_factor": 1.25, "shared": True,
                        "shared_gate": True}
    eng = LLMEngine(port, device="cpu", **GEOM)
    layer0 = port.layers[0]
    assert eng._layers[0][2] is layer0.self_attn.q_proj.bias
    assert eng._layers[0][10] is layer0.mlp.experts.gate_w
    assert eng._moe_counts.shape == (2, 8)


@pytest.mark.parametrize("knob", [{"moe_dropless": False},
                                  {"moe_capacity_factor": 2.0}])
def test_knobs_outside_the_slice_raise(models, knob):
    """Both capacity knobs are taken: ``moe_dropless=False`` sets the
    per-page-group cap from the config's capacity factor (1.25: ceil(2 x
    8 x 1.25 / 8) = 3 slots an expert); a capacity factor beside the
    default ``moe_dropless=True`` changes nothing, as in the reference."""
    _, port = models
    eng = LLMEngine(port, device="cpu", **GEOM, **knob)
    ref_cap = 3 if knob.get("moe_dropless") is False else 0
    assert eng._arch.capacity == ref_cap
    assert eng.metrics_snapshot()["moe"]["capacity"] == ref_cap


def test_dense_dispatch_refuses_tensors_off_the_cpu():
    """The per-row comparator is plain PyTorch: on the card the MoE FFN
    goes through the kernel (``meta`` tensors stand in for the card's)."""
    arch = MoEArch(num_experts=4, top_k=2, norm_topk=False, shared=False,
                   shared_gate=False, attn_bias=False, dispatch="dense")
    t, h, f = 4, 8, 8
    meta = dict(device="meta")
    mw = (torch.zeros(h, 4, **meta), torch.zeros(4, h, f, **meta),
          torch.zeros(4, h, f, **meta), torch.zeros(4, f, h, **meta),
          None, None, None, None)
    with pytest.raises(NotImplementedError, match="CPU tensors only"):
        moe_ffn(torch.zeros(t, h, **meta), mw, arch,
                torch.ones(t, dtype=torch.bool, **meta))
