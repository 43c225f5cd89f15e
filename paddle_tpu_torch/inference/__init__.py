"""The serving surface (counterpart of ``paddle_tpu/inference/__init__.py``)
under the reference's names.  ``Config``, ``Predictor``,
``PredictorTensor`` and ``create_predictor`` are not ported (ROADMAP
'Port: remaining modules')."""
from ..nn.generation import sample_logits
from .backbone import BackboneSpec, register_backbone, resolve_backbone
from .engine import GenRequest, LLMEngine
from .moe_dispatch import MoEArch, moe_ffn
from .paged_cache import PagedKVCache
from .sampling import split_step, window_keys

__all__ = ["PagedKVCache", "LLMEngine", "GenRequest", "BackboneSpec",
           "register_backbone", "resolve_backbone", "MoEArch", "moe_ffn",
           "sample_logits", "split_step", "window_keys"]
