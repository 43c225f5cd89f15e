"""The port's package surfaces: every name that ``paddle_tpu_torch.nn``,
``.nn.functional``, ``.inference`` and ``.amp`` export imports, is the
port's own object (defined in ``paddle_tpu_torch``, never the
reference's), and carries the reference's name; where the reference
exports a name the port has ported, the port exports it too."""
import importlib

import pytest

import paddle_tpu_torch

PACKAGES = ["paddle_tpu_torch.nn", "paddle_tpu_torch.nn.functional",
            "paddle_tpu_torch.inference", "paddle_tpu_torch.amp"]
# what the reference exports there that the port does not have yet
# (ROADMAP 'Port: remaining modules')
NOT_PORTED = {"Config", "Predictor", "PredictorTensor", "create_predictor",
              "Layer", "functional_state", "LayerDict", "LayerList",
              "ParameterList", "Sequential", "ParamAttr", "utils"}


def _exported(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    return names


@pytest.mark.parametrize("package", PACKAGES)
def test_exported_names_are_the_ports_own(package):
    mod = importlib.import_module(package)
    names = _exported(mod)
    assert names
    for name in names:
        obj = getattr(mod, name)
        home = getattr(obj, "__module__", None) or getattr(obj, "__name__",
                                                           "")
        assert home.startswith("paddle_tpu_torch"), (name, home)


@pytest.mark.parametrize("package,names", [
    ("paddle_tpu_torch.inference",
     ["PagedKVCache", "LLMEngine", "GenRequest", "BackboneSpec",
      "register_backbone", "resolve_backbone", "MoEArch", "moe_ffn",
      "sample_logits", "split_step", "window_keys"]),
    ("paddle_tpu_torch.amp",
     ["auto_cast", "amp_guard", "decorate", "white_list", "black_list",
      "GradScaler"]),
    ("paddle_tpu_torch.nn",
     ["Linear", "Embedding", "Dropout", "Conv2D", "LayerNorm", "RMSNorm",
      "GroupNorm", "MultiHeadAttention", "TransformerEncoderLayer",
      "TransformerEncoder", "TransformerDecoderLayer",
      "TransformerDecoder", "Transformer", "CrossEntropyLoss",
      "AdaptiveLogSoftmaxWithLoss", "functional", "initializer"]),
])
def test_reference_names_are_exported(package, names):
    mod = importlib.import_module(package)
    ref = importlib.import_module(package.replace("paddle_tpu_torch",
                                                  "paddle_tpu"))
    for name in names:
        assert hasattr(mod, name), name
        assert hasattr(ref, name), name
    ref_names = set(_exported(ref))
    if package != "paddle_tpu_torch.nn":
        assert ref_names - set(_exported(mod)) <= NOT_PORTED


def test_package_docstring_names_what_is_ported():
    doc = paddle_tpu_torch.__doc__
    assert "two paths so far" not in doc
    for word in ("Transformer", "auto_cast", "GradScaler", "losses"):
        assert word in doc
