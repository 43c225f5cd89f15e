"""Checkpoint conversion: Hugging Face / torch weights into the port's
models, and the port's Llama back out (counterpart of
``paddle_tpu/models/convert.py``, whose mapping tables are copied here).

Torch-format checkpoints (``pytorch_model.bin`` / ``*.safetensors``)
are renamed and re-laid-out into the port's parameter names, which are
the reference's.  Two layout rules cover almost everything:

* torch ``nn.Linear`` stores ``[out, in]``; Paddle's Linear stores
  ``[in, out]``, so every ``*_proj/linear/dense`` weight is transposed.
* Embeddings and norms are layout-identical (and so are convolutions,
  ``nn/conv.py``).

Families: Llama, BERT, GPT-2, ERNIE-4.5 (dense; its q/k lanes permuted
so the model runs the contiguous rope, ``_deinterleave_heads``) and
Qwen2-MoE (per-expert weights stacked); and the export direction for
Llama.  The converters work on dicts of numpy arrays; ``load_hf_*``
reads a file and copies into a model's parameters in place, returning
(missing, unexpected) names.  ``safetensors`` is imported only to read
a ``.safetensors`` file.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.errors import enforce

__all__ = ["load_torch_checkpoint", "convert_hf_llama",
           "convert_hf_bert", "load_hf_llama", "load_hf_bert",
           "convert_hf_gpt2", "load_hf_gpt2", "convert_hf_ernie45",
           "load_hf_ernie45", "convert_hf_qwen2_moe",
           "load_hf_qwen2_moe", "export_hf_llama", "save_hf_llama"]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU copy as numpy; bfloat16 (which numpy lacks) widens to f32,
    as stock HF checkpoints are bf16."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a torch ``.bin`` / ``.pt`` (pickle, tensors only) or a
    ``.safetensors`` file into numpy."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return {k: _to_numpy(v) for k, v in load_file(path).items()}
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: _to_numpy(v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in state.items()}


@torch.no_grad()
def _apply(model, mapped: Dict[str, np.ndarray]
           ) -> Tuple[List[str], List[str]]:
    own = dict(model.named_parameters())
    missing = [k for k in own if k not in mapped]
    unexpected = [k for k in mapped if k not in own]
    for name, arr in mapped.items():
        p = own.get(name)
        if p is None:
            continue
        enforce(tuple(arr.shape) == tuple(p.shape),
                f"converted weight {name!r}: shape {arr.shape} vs model "
                f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(p.dtype))
    return missing, unexpected


# ---------------------------------------------------------------------------
# Llama (HF LlamaForCausalLM layout)
# ---------------------------------------------------------------------------

_LLAMA_TRANSPOSE = re.compile(
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj|lm_head)"
    r"\.weight$")


def convert_hf_llama(state: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
    """HF ``model.layers.N...`` names -> ``llama.layers.N...`` (this
    framework's LlamaForCausalLM), transposing linear weights."""
    out = {}
    for k, v in state.items():
        nk = k
        if nk.startswith("model."):
            nk = "llama." + nk[len("model."):]
        if _LLAMA_TRANSPOSE.search(nk):
            v = np.asarray(v).T
        if "rotary_emb" in nk:        # recomputed, not a parameter
            continue
        out[nk] = np.asarray(v)
    return out


def load_hf_llama(model, path: str) -> Tuple[List[str], List[str]]:
    """Load an HF Llama checkpoint file into ``model`` in place; returns
    (missing, unexpected) parameter names."""
    return _apply(model, convert_hf_llama(load_torch_checkpoint(path)))


# ---------------------------------------------------------------------------
# BERT (HF BertModel layout)
# ---------------------------------------------------------------------------

_BERT_RENAMES = [
    (r"^bert\.", ""),
    (r"embeddings\.LayerNorm\.", "embeddings.layer_norm."),
    (r"encoder\.layer\.(\d+)\.attention\.self\.query\.",
     r"encoder.layers.\1.self_attn.q_proj."),
    (r"encoder\.layer\.(\d+)\.attention\.self\.key\.",
     r"encoder.layers.\1.self_attn.k_proj."),
    (r"encoder\.layer\.(\d+)\.attention\.self\.value\.",
     r"encoder.layers.\1.self_attn.v_proj."),
    (r"encoder\.layer\.(\d+)\.attention\.output\.dense\.",
     r"encoder.layers.\1.self_attn.out_proj."),
    (r"encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\.",
     r"encoder.layers.\1.norm1."),
    (r"encoder\.layer\.(\d+)\.intermediate\.dense\.",
     r"encoder.layers.\1.linear1."),
    (r"encoder\.layer\.(\d+)\.output\.dense\.",
     r"encoder.layers.\1.linear2."),
    (r"encoder\.layer\.(\d+)\.output\.LayerNorm\.",
     r"encoder.layers.\1.norm2."),
]

_BERT_TRANSPOSE = re.compile(
    r"(q_proj|k_proj|v_proj|out_proj|linear1|linear2|pooler\.dense|"
    r"classifier)\.weight$")


def convert_hf_bert(state: Dict[str, np.ndarray], prefix: str = "bert."
                    ) -> Dict[str, np.ndarray]:
    """HF bert names -> the port's BertModel names (use
    ``prefix`` for where BertModel sits in the target, e.g. ``"bert."``
    inside BertForSequenceClassification or ``""`` standalone)."""
    out = {}
    for k, v in state.items():
        nk = k
        for pat, rep in _BERT_RENAMES:
            nk = re.sub(pat, rep, nk)
        if "position_ids" in nk:      # HF buffer, not a parameter
            continue
        if _BERT_TRANSPOSE.search(nk):
            v = np.asarray(v).T
        out[prefix + nk] = np.asarray(v)
    return out


def load_hf_bert(model, path: str, prefix: str = ""
                 ) -> Tuple[List[str], List[str]]:
    return _apply(model, convert_hf_bert(load_torch_checkpoint(path),
                                         prefix=prefix))


# ---------------------------------------------------------------------------
# GPT-2 (HF GPT2LMHeadModel layout)
# ---------------------------------------------------------------------------

_GPT2_RENAMES = [
    (r"^transformer\.", "gpt."),
    (r"\.h\.(\d+)\.attn\.c_attn\.", r".h.\1.attn.qkv_proj."),
    (r"\.h\.(\d+)\.attn\.c_proj\.", r".h.\1.attn.out_proj."),
    (r"\.h\.(\d+)\.mlp\.c_fc\.", r".h.\1.mlp.fc_in."),
    (r"\.h\.(\d+)\.mlp\.c_proj\.", r".h.\1.mlp.fc_out."),
]


def convert_hf_gpt2(state: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
    """HF GPT-2 names -> the port's GPTForCausalLM.  HF GPT-2
    uses Conv1D modules that ALREADY store [in, out] — no transposes,
    only renames; the tied lm_head is dropped (reused from wte)."""
    out = {}
    for k, v in state.items():
        if k.endswith(".attn.bias") or k.endswith(".attn.masked_bias"):
            continue                  # causal-mask buffers, not params
        if k == "lm_head.weight":
            continue                  # tied to wte
        nk = k
        for pat, rep in _GPT2_RENAMES:
            nk = re.sub(pat, rep, nk)
        out[nk] = np.asarray(v)
    return out


def load_hf_gpt2(model, path: str) -> Tuple[List[str], List[str]]:
    return _apply(model, convert_hf_gpt2(load_torch_checkpoint(path)))


# ---------------------------------------------------------------------------
# ERNIE-4.5 dense (HF Ernie4_5ForCausalLM layout — llama-shaped)
# ---------------------------------------------------------------------------

def _deinterleave_heads(v: np.ndarray, head_dim: int,
                        axis: int) -> np.ndarray:
    """Permute per-head lanes (0,2,4,..,1,3,5,..) along ``axis``.

    ERNIE-4.5's rope pairs lanes (2i, 2i+1) with angle θ_i (GPT-J
    style).  Attention scores are invariant under a joint permutation
    of q/k head lanes, so baking this permutation into the q/k
    projection weights makes the checkpoint numerically exact under
    the standard contiguous-half rope, which the port runs inside the
    matmul+rope kernel (interleaved rope takes the plain version)."""
    v = np.moveaxis(np.asarray(v), axis, -1)
    shp = v.shape
    heads = v.reshape(shp[:-1] + (shp[-1] // head_dim, head_dim))
    perm = np.concatenate([np.arange(0, head_dim, 2),
                           np.arange(1, head_dim, 2)])
    heads = heads[..., perm]
    return np.moveaxis(heads.reshape(shp), -1, axis)


_ERNIE_QK = re.compile(r"(q_proj|k_proj)\.(weight|bias)$")


def convert_hf_ernie45(state: Dict[str, np.ndarray],
                       head_dim: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """HF ``model.layers.N...`` -> the port's Ernie45ForCausalLM
    (which keeps the layer stack at the TOP level: ``layers.N...``).
    Same linear-transpose rule as Llama, plus the q/k lane permutation
    that converts ERNIE's interleaved rope into the fast contiguous
    layout (see _deinterleave_heads).  ``head_dim`` is required for the
    permutation (load_hf_ernie45 reads it off the target model)."""
    enforce(head_dim is not None and head_dim > 0,
            "convert_hf_ernie45 needs head_dim for the rope lane "
            "permutation (it is shape-preserving, so skipping it would "
            "load cleanly but attend with silently wrong numerics); "
            "use load_hf_ernie45(model, path) to infer it")
    out = {}
    for k, v in state.items():
        nk = k
        if nk.startswith("model."):
            nk = nk[len("model."):]
        if "rotary_emb" in nk:
            continue
        v = np.asarray(v)
        if _ERNIE_QK.search(nk):
            v = _deinterleave_heads(v, head_dim, axis=0)
        if _LLAMA_TRANSPOSE.search(nk):
            v = v.T
        out[nk] = np.asarray(v)
    return out


def load_hf_ernie45(model, path: str) -> Tuple[List[str], List[str]]:
    head_dim = model.layers[0].self_attn.head_dim
    return _apply(model, convert_hf_ernie45(load_torch_checkpoint(path),
                                            head_dim=head_dim))


# ---------------------------------------------------------------------------
# Qwen2-MoE (HF Qwen2MoeForCausalLM layout)
# ---------------------------------------------------------------------------

_QWEN_EXPERT = re.compile(
    r"^model\.layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate|up|down)_proj"
    r"\.weight$")
_QWEN_RENAMES = [
    (r"^model\.", ""),
    (r"\.mlp\.shared_expert\.gate_proj\.", ".mlp.shared_gate."),
    (r"\.mlp\.shared_expert\.up_proj\.", ".mlp.shared_up."),
    (r"\.mlp\.shared_expert\.down_proj\.", ".mlp.shared_down."),
]
_QWEN_TRANSPOSE = re.compile(
    r"(q_proj|k_proj|v_proj|o_proj|lm_head|mlp\.gate|shared_gate|"
    r"shared_up|shared_down|shared_expert_gate)\.weight$")


def convert_hf_qwen2_moe(state: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """HF Qwen2-MoE -> the port's Qwen2MoeForCausalLM: per-expert
    ``experts.N.{gate,up,down}_proj [F, H]`` stack into the batched
    ``experts.{gate,up,down}_w`` ([E, H, F] / [E, F, H]); the router and
    shared-expert linears transpose like every torch Linear."""
    out: Dict[str, np.ndarray] = {}
    experts: Dict[Tuple[int, str], Dict[int, np.ndarray]] = {}
    for k, v in state.items():
        m = _QWEN_EXPERT.match(k)
        if m:
            layer, eid, kind = int(m.group(1)), int(m.group(2)), m.group(3)
            experts.setdefault((layer, kind), {})[eid] = np.asarray(v)
            continue
        nk = k
        for pat, rep in _QWEN_RENAMES:
            nk = re.sub(pat, rep, nk)
        if "rotary_emb" in nk:
            continue
        if _QWEN_TRANSPOSE.search(nk):
            v = np.asarray(v).T
        out[nk] = np.asarray(v)
    for (layer, kind), by_id in experts.items():
        enforce(sorted(by_id) == list(range(len(by_id))),
                f"layer {layer} {kind}_proj: expert ids "
                f"{sorted(by_id)} are not contiguous from 0 — partial "
                "checkpoint shard? merge all shards before converting")
        stack = np.stack([by_id[i].T for i in range(len(by_id))])
        # gate/up: [E, H, F]; down: [E, F, H] — both from [out,in].T
        out[f"layers.{layer}.mlp.experts.{kind}_w"] = stack
    return out


def load_hf_qwen2_moe(model, path: str) -> Tuple[List[str], List[str]]:
    return _apply(model,
                  convert_hf_qwen2_moe(load_torch_checkpoint(path)))


# ---------------------------------------------------------------------------
# export: the port -> HF (the other migration direction)
# ---------------------------------------------------------------------------

def export_hf_llama(model) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_hf_llama``: a ``LlamaForCausalLM``'s
    parameters under HF ``LlamaForCausalLM`` names and layouts (numpy
    arrays, bf16 widened to f32)."""
    out = {}
    for name, p in model.named_parameters():
        v = _to_numpy(p)
        nk = name
        if nk.startswith("llama."):
            nk = "model." + nk[len("llama."):]
        if _LLAMA_TRANSPOSE.search(nk):
            v = v.T
        out[nk] = np.ascontiguousarray(v)
    return out


def save_hf_llama(model, path: str) -> None:
    """Write an HF-loadable torch checkpoint of a ``LlamaForCausalLM``."""
    torch.save({k: torch.from_numpy(v)
                for k, v in export_hf_llama(model).items()}, path)
