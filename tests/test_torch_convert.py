"""The port's checkpoint converters against the reference's.

No checkpoint can be fetched, so each test writes a Hugging Face-layout
state dict of seeded random arrays (the names and ``[out, in]`` layouts
of HF's Llama, BERT, GPT-2, ERNIE-4.5 and Qwen2-MoE, made here from the
port's tiny models by the inverse renames) with ``torch.save``.  Each
``convert_hf_*`` must give the reference's arrays bit for bit, and each
``load_hf_*`` must fill every parameter of the port's model with them,
leaving nothing missing or unexpected.  The ERNIE-4.5 conversion
permutes the q/k lanes: the converted model with contiguous rope gives
the logits of the raw weights under interleaved rope within 1e-5
relative L2.  ``export_hf_llama`` / ``save_hf_llama`` round-trip through
either package's ``load_hf_llama`` exactly.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from paddle_tpu.models import convert as ref_convert

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models.bert import BertModel, bert_tiny_config
from paddle_tpu_torch.models.ernie import (Ernie45ForCausalLM,
                                           ernie45_tiny_config)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_tiny_config
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                               qwen2_moe_tiny_config)

_LINEAR = re.compile(r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|"
                     r"down_proj|lm_head|mlp\.gate|shared_expert_gate|"
                     r"query|key|value|dense)\.weight$")


def _hf_llama(name):
    return name if name.startswith("lm_head") else \
        "model." + name[len("llama."):]


def _hf_top(name):                   # ERNIE and Qwen2-MoE: layers at top
    return name if name.startswith("lm_head") else "model." + name


_BERT = [(r"^embeddings\.layer_norm\.", "embeddings.LayerNorm."),
         (r"\.layers\.(\d+)\.self_attn\.q_proj\.",
          r".layer.\1.attention.self.query."),
         (r"\.layers\.(\d+)\.self_attn\.k_proj\.",
          r".layer.\1.attention.self.key."),
         (r"\.layers\.(\d+)\.self_attn\.v_proj\.",
          r".layer.\1.attention.self.value."),
         (r"\.layers\.(\d+)\.self_attn\.out_proj\.",
          r".layer.\1.attention.output.dense."),
         (r"\.layers\.(\d+)\.norm1\.",
          r".layer.\1.attention.output.LayerNorm."),
         (r"\.layers\.(\d+)\.linear1\.", r".layer.\1.intermediate.dense."),
         (r"\.layers\.(\d+)\.linear2\.", r".layer.\1.output.dense."),
         (r"\.layers\.(\d+)\.norm2\.", r".layer.\1.output.LayerNorm.")]


def _hf_bert(name):
    for pat, rep in _BERT:
        name = re.sub(pat, rep, name)
    return "bert." + name


_GPT2 = [(r"^gpt\.", "transformer."),
         (r"\.attn\.qkv_proj\.", ".attn.c_attn."),
         (r"\.attn\.out_proj\.", ".attn.c_proj."),
         (r"\.mlp\.fc_in\.", ".mlp.c_fc."),
         (r"\.mlp\.fc_out\.", ".mlp.c_proj.")]


def _hf_gpt2(name):
    for pat, rep in _GPT2:
        name = re.sub(pat, rep, name)
    return name


def _hf_dict(model, rename, transpose=True, seed=0):
    """Random arrays under the HF names of ``model``'s parameters, in
    torch's ``[out, in]`` Linear layout when ``transpose``; Qwen2-MoE's
    stacked experts split per expert."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        m = re.match(r"layers\.(\d+)\.mlp\.experts\.(gate|up|down)_w$", name)
        if m:
            for e in range(shape[0]):
                out[f"model.layers.{m.group(1)}.mlp.experts.{e}."
                    f"{m.group(2)}_proj.weight"] = rng.standard_normal(
                        shape[:0:-1]).astype(np.float32)
            continue
        hf = rename(name)
        hf = re.sub(r"\.mlp\.shared_(gate|up|down)\.",
                    r".mlp.shared_expert.\1_proj.", hf)
        if transpose and (_LINEAR.search(hf) or "shared_expert." in hf
                          or "classifier" in hf) and len(shape) == 2:
            shape = shape[::-1]
        out[hf] = rng.standard_normal(shape).astype(np.float32)
    return out


def _save(tmp_path, state, extra=()):
    path = str(tmp_path / "ckpt.bin")
    full = {k: torch.from_numpy(v) for k, v in state.items()}
    for k, v in extra:
        full[k] = v
    torch.save(full, path)
    return path


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], np.asarray(want[k])), k


def _assert_loaded(model, arrays, result):
    assert result == ([], [])
    for n, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), arrays[n]), n


FAMILIES = {
    "llama": (lambda: LlamaForCausalLM(llama_tiny_config(), device="cpu"),
              _hf_llama, True, "llama",
              [("model.layers.0.self_attn.rotary_emb.inv_freq",
                torch.ones(8))]),
    "bert": (lambda: BertModel(bert_tiny_config(), device="cpu"), _hf_bert,
             True, "bert", [("bert.embeddings.position_ids",
                             torch.arange(64)[None])]),
    "gpt2": (lambda: GPTForCausalLM(gpt2_tiny_config(), device="cpu"),
             _hf_gpt2, False, "gpt2",
             [("transformer.h.0.attn.bias", torch.ones(1, 1, 4, 4)),
              ("lm_head.weight", torch.zeros(256, 64))]),
    "ernie45": (lambda: Ernie45ForCausalLM(ernie45_tiny_config(),
                                           device="cpu"),
                _hf_top, True, "ernie45", []),
    "qwen2_moe": (lambda: Qwen2MoeForCausalLM(qwen2_moe_tiny_config(),
                                              device="cpu"),
                  _hf_top, True, "qwen2_moe", []),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converter_and_loader_match_reference(family, tmp_path):
    make, rename, transpose, fn, extra = FAMILIES[family]
    model = make()
    hf = _hf_dict(model, rename, transpose)
    kw = {"head_dim": 16} if family == "ernie45" else {}
    if family == "bert":
        kw = {"prefix": ""}
    want = getattr(ref_convert, f"convert_hf_{fn}")(dict(hf), **kw)
    got = getattr(convert, f"convert_hf_{fn}")(dict(hf), **kw)
    _assert_same(got, want)
    path = _save(tmp_path, hf, extra)
    loaded = convert.load_torch_checkpoint(path)
    _assert_same(loaded, {**hf, **{k: v.numpy() for k, v in extra}})
    _assert_loaded(model, {k: np.asarray(v) for k, v in want.items()},
                   getattr(convert, f"load_hf_{fn}")(model, path))


def test_ernie_conversion_keeps_the_logits(tmp_path):
    """HF ERNIE-4.5 weights run under interleaved rope as they are, and
    under contiguous rope once converted, with equal logits."""
    cfg = ernie45_tiny_config()
    converted = Ernie45ForCausalLM(cfg, device="cpu")
    hf = _hf_dict(converted, _hf_top, seed=1)
    for k in hf:
        hf[k] *= 0.1
    convert.load_hf_ernie45(converted, _save(tmp_path, hf))
    raw = Ernie45ForCausalLM(dataclasses.replace(cfg, rope_interleaved=True),
                             device="cpu")
    with torch.no_grad():
        for n, p in raw.named_parameters():
            v = hf[_hf_top(n)]
            p.copy_(torch.from_numpy(v.T if _LINEAR.search(n) else v))
        ids = torch.tensor(np.random.default_rng(2).integers(0, 256, (2, 12)))
        a, b = raw(ids).numpy(), converted(ids).numpy()
    assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(a)
    assert not np.array_equal(
        converted.layers[0].self_attn.q_proj.weight.detach().numpy(),
        raw.layers[0].self_attn.q_proj.weight.detach().numpy())


def test_convert_ernie_needs_head_dim():
    with pytest.raises(Exception, match="head_dim"):
        convert.convert_hf_ernie45({})


def test_export_round_trips_through_both_packages(tmp_path):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
    from paddle_tpu.models.llama import llama_tiny_config as ref_tiny
    port = LlamaForCausalLM(llama_tiny_config(), device="cpu",
                            generator=torch.Generator().manual_seed(3))
    exported = convert.export_hf_llama(port)
    assert "model.layers.0.self_attn.q_proj.weight" in exported
    assert exported["lm_head.weight"].shape == (256, 64)     # [out, in]
    path = str(tmp_path / "llama.bin")
    convert.save_hf_llama(port, path)
    again = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    assert convert.load_hf_llama(again, path) == ([], [])
    for (n, p), q in zip(port.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n
    paddle.seed(0)
    ref = RefLlama(ref_tiny())
    assert ref_convert.load_hf_llama(ref, path) == ([], [])
    ref_state = ref.raw_state_dict()
    for n, p in port.named_parameters():
        assert np.array_equal(np.asarray(ref_state[n]), p.detach().numpy())
