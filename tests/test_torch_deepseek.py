"""DeepSeekMoE-16B's geometry served by the port against the reference.

``deepseek_moe_16b_config()`` of each package (64 experts top-6, shared
experts without a gate, no attention biases, top-k weights not
renormalised) cut to tiny widths (hidden 64, 2 layers, 4 heads, expert
width 32, shared 64, vocab 256), f32 on the CPU.  The reference is built
after ``paddle.seed(0)`` and its ``raw_state_dict()`` carried into the
port; both ``LLMEngine``s serve the same prompts with
``moe_dispatch="grouped"`` through the Qwen2-MoE backbone.  Greedy
tokens and the per-(layer, expert) routed-slot counts must be equal.
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as RefQwen
from paddle_tpu.models.qwen2_moe import \
    deepseek_moe_16b_config as ref_deepseek

from paddle_tpu_torch.inference.backbone import resolve_backbone
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                               deepseek_moe_16b_config)

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4,
            moe_intermediate_size=32, shared_expert_intermediate_size=64,
            max_position_embeddings=128)
GEOM = dict(max_seqs=4, max_len=64, page_size=8, n_pages=32)
PROMPTS = [[5, 9, 2, 14], list(range(1, 20)), [7] * 17]


def test_config_is_deepseek_moe_16b():
    c = deepseek_moe_16b_config()
    ref = ref_deepseek()
    assert dataclasses.asdict(c) == {
        k: v for k, v in dataclasses.asdict(ref).items()
        if k in dataclasses.asdict(c)}
    assert (c.num_experts, c.num_experts_per_tok, c.norm_topk_prob,
            c.attention_bias, c.use_shared_expert_gate) == (64, 6, False,
                                                            False, False)


@pytest.fixture(scope="module")
def served():
    paddle.seed(0)
    ref = RefQwen(dataclasses.replace(ref_deepseek(), **TINY))
    ref.eval()
    port = Qwen2MoeForCausalLM(dataclasses.replace(deepseek_moe_16b_config(),
                                                   **TINY), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    engines = (RefEngine(ref, **GEOM, moe_dispatch="grouped"),
               LLMEngine(port, device="cpu", **GEOM, moe_dispatch="grouped"))
    out = []
    for eng in engines:
        for i, p in enumerate(PROMPTS):
            eng.add_request(f"r{i}", p, max_new_tokens=6)
        while eng.has_work():
            eng.step()
        out.append([eng.result(f"r{i}") for i in range(len(PROMPTS))])
    return port, engines, out


def test_greedy_tokens_and_routing_equal_reference(served):
    port, (ref_eng, port_eng), (want, got) = served
    assert got == want and all(len(t) == 6 for t in got)
    np.testing.assert_array_equal(port_eng._moe_counts.numpy(),
                                  ref_eng._moe_counts)
    spec = resolve_backbone(port)
    assert spec.arch == "qwen2_moe" and not spec.attn_bias
    assert spec.moe["num_experts"] == 64 and spec.moe["top_k"] == 6
    assert spec.moe["shared"] and not spec.moe["shared_gate"]
    assert not spec.moe["norm_topk"]
