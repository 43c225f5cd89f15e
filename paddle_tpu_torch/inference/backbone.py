"""Model-backbone adapter seam for :class:`~.engine.LLMEngine`.

Counterpart of ``paddle_tpu/inference/backbone.py``: a
:class:`BackboneSpec` names everything the serving path reads off a
model — the decoder layer list, the final norm, the embedding and head
weights, the rope buffers — and a small predicate registry resolves a
model instance to its spec by duck typing, never by class identity.

Only the ``llama`` backbone is ported.  MoE families (Qwen2-MoE,
DeepSeekMoE) resolve to an error naming the ROADMAP item that ports
them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from ..common.errors import enforce

__all__ = ["BackboneSpec", "register_backbone", "resolve_backbone"]


@dataclass
class BackboneSpec:
    """Everything LLMEngine reads off a model, named once.  ``moe`` is
    ``None`` for dense-FFN backbones (the only kind served here)."""
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
    layers = list(getattr(model, "layers", None) or [])
    if layers and hasattr(getattr(layers[0], "mlp", None), "experts"):
        raise NotImplementedError(
            f"{type(model).__name__} is an MoE backbone; MoE serving is "
            f"not ported yet (ROADMAP 'Port: MoE and remaining kernels')")
    supported = ", ".join(a for a, _, _ in _REGISTRY)
    raise ValueError(
        f"LLMEngine cannot serve {type(model).__name__}: no registered "
        f"backbone matches it (supported: {supported}).  A servable "
        f"model exposes a ``.llama`` submodule with ``layers``; register "
        f"new families with inference.backbone.register_backbone().")


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


register_backbone("llama", _is_llama, _build_llama)
