"""Model-backbone adapter seam for :class:`~.engine.LLMEngine`.

Counterpart of ``paddle_tpu/inference/backbone.py``: a
:class:`BackboneSpec` names everything the serving path reads off a
model — the decoder layer list, the final norm, the embedding and head
weights, the rope buffers — and a small predicate registry resolves a
model instance to its spec by duck typing, never by class identity.

Two backbones register here: ``llama`` (``LlamaForCausalLM``-shaped
models, ``model.llama.*``) and ``qwen2_moe`` (``Qwen2MoeForCausalLM``-
shaped: top-level ``layers`` whose ``mlp`` is a shared-expert MoE
layer), whose spec also carries the router geometry the engine freezes
into its MoE dispatch configuration (``inference/moe_dispatch.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from ..common.errors import enforce

__all__ = ["BackboneSpec", "register_backbone", "resolve_backbone"]


@dataclass
class BackboneSpec:
    """Everything LLMEngine reads off a model, named once.  ``moe`` is
    ``None`` for dense-FFN backbones; for MoE backbones the router
    geometry (num_experts, top_k, norm_topk, capacity_factor, shared,
    shared_gate)."""
    arch: str
    config: Any
    layers: List[Any]
    norm: Any
    embed_tokens: Any
    lm_head: Optional[Any]
    rope_cos: Any
    rope_sin: Any
    attn_bias: bool = False
    moe: Optional[dict] = None


# ordered (arch, predicate, builder) triples — first predicate match
# wins, so register more specific shapes before more general ones
_REGISTRY: List[tuple] = []


def register_backbone(arch: str, predicate: Callable[[Any], bool],
                      builder: Callable[[Any], "BackboneSpec"]):
    """Register a servable model family: ``predicate(model)`` decides
    membership by duck typing, ``builder(model)`` produces the spec.
    A later registration of the same ``arch`` replaces the earlier."""
    global _REGISTRY
    _REGISTRY = [(a, p, b) for (a, p, b) in _REGISTRY if a != arch]
    _REGISTRY.append((arch, predicate, builder))


def resolve_backbone(model) -> BackboneSpec:
    """Resolve ``model`` to its BackboneSpec, or raise one clear error
    naming the supported families."""
    for arch, pred, build in _REGISTRY:
        try:
            matched = bool(pred(model))
        except AttributeError:
            matched = False
        if matched:
            return build(model)
    supported = ", ".join(a for a, _, _ in _REGISTRY)
    raise ValueError(
        f"LLMEngine cannot serve {type(model).__name__}: no registered "
        f"backbone matches it (supported: {supported}).  A servable "
        f"model exposes either a ``.llama`` submodule (Llama family) or "
        f"top-level ``layers``/``norm``/``embed_tokens``/``rope_*`` with "
        f"a shared-expert MoE ``mlp`` (Qwen2-MoE family); register new "
        f"families with inference.backbone.register_backbone().")


# -- llama ------------------------------------------------------------------

def _is_llama(model) -> bool:
    return hasattr(model, "llama") and hasattr(model.llama, "layers")


def _build_llama(model) -> BackboneSpec:
    lm = model.llama
    layers = list(lm.layers)
    enforce(layers, "model.llama.layers is empty")
    # the serving path carries no qkv bias; a biased checkpoint would
    # silently drop its biases (wrong tokens), so refuse it loudly
    enforce(getattr(layers[0].self_attn.q_proj, "bias", None) is None,
            "Llama backbone with attention biases is not servable by "
            "the dense engine path")
    return BackboneSpec(
        arch="llama", config=model.config, layers=layers,
        norm=lm.norm, embed_tokens=lm.embed_tokens,
        lm_head=model.lm_head, rope_cos=lm.rope_cos,
        rope_sin=lm.rope_sin, attn_bias=False, moe=None)


# -- qwen2-moe ----------------------------------------------------------------

def _is_qwen2_moe(model) -> bool:
    if hasattr(model, "llama") or not hasattr(model, "layers"):
        return False
    layers = list(model.layers)
    if not layers:
        return False
    mlp = getattr(layers[0], "mlp", None)
    gate = getattr(mlp, "gate", None)
    return (hasattr(model, "norm") and hasattr(model, "embed_tokens")
            and hasattr(model, "rope_cos")
            and hasattr(mlp, "experts")
            and hasattr(gate, "num_experts") and hasattr(gate, "k"))


def _build_qwen2_moe(model) -> BackboneSpec:
    layers = list(model.layers)
    g0, m0 = layers[0].mlp.gate, layers[0].mlp
    for l in layers[1:]:
        g, m = l.mlp.gate, l.mlp
        enforce(g.num_experts == g0.num_experts and g.k == g0.k
                and g.norm_topk_prob == g0.norm_topk_prob
                and (m.shared_gate is None) == (m0.shared_gate is None)
                and (m.shared_expert_gate is None)
                == (m0.shared_expert_gate is None),
                "MoE serving needs one router/shared-expert geometry "
                "across all decoder layers")
    attn_bias = layers[0].self_attn.q_proj.bias is not None
    return BackboneSpec(
        arch="qwen2_moe", config=model.config, layers=layers,
        norm=model.norm, embed_tokens=model.embed_tokens,
        lm_head=model.lm_head, rope_cos=model.rope_cos,
        rope_sin=model.rope_sin, attn_bias=attn_bias,
        moe={"num_experts": int(g0.num_experts), "top_k": int(g0.k),
             "norm_topk": bool(g0.norm_topk_prob),
             "capacity_factor": float(g0.capacity_factor),
             "shared": m0.shared_gate is not None,
             "shared_gate": m0.shared_expert_gate is not None})


register_backbone("llama", _is_llama, _build_llama)
register_backbone("qwen2_moe", _is_qwen2_moe, _build_qwen2_moe)
