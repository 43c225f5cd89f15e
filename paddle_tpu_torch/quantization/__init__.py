"""paddle_tpu_torch.quantization — weight-only int8 and the int8 KV
cache's row quantization (counterpart of ``paddle_tpu/quantization``).

- :mod:`.ops`: symmetric absmax quantize / dequantize primitives, the
  per-token row quantization the int8 page pools store, and the
  output-channel fold of a weight-only int8 matmul.
- :mod:`.layers`: ``QuantizedLinear`` and the in-place converter
  ``quantize_model``.

``LLMEngine(kv_dtype="int8", weight_dtype="int8")`` consumes both
(``inference/engine.py``).
"""
from .layers import QuantizedLinear, quantize_model
from .ops import (EPS, QMAX, dequantize_absmax, quantize_absmax,
                  quantize_rows, quantized_matmul)

__all__ = ["QuantizedLinear", "quantize_model", "quantize_absmax",
           "dequantize_absmax", "quantize_rows", "quantized_matmul",
           "QMAX", "EPS"]
