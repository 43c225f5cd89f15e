"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` beside it is the reference and stays as
it is.  This package mirrors its module paths (``models/llama.py``,
``inference/engine.py``, ``ops/paged_attention.py`` ...) so a reader
finds each counterpart, but imports only ``torch`` and ``numpy``:
nothing of JAX and nothing of ``paddle_tpu``.

What is ported.  Serving: ``LLMEngine``'s ragged unified step, its
split decode path and synchronous chunked prefill, float or int8 KV
pools and weights (``quantization/``), sampling, ``generate`` and
speculative decoding, preemption, the observability plane
(``observability/``, ``profiler/``) and the serving runtime
(``serving/``).  Training: the Llama, Qwen2-MoE, GPT-2, ERNIE-4.5, BERT
and DiT families (with ``AutoencoderKL``) through ``CompiledTrainStep``
with fused regions, remat and dropout; ``nn/transformer.py``'s encoder
and decoder layers and the encoder-decoder ``Transformer``; amp O1
(``amp.auto_cast``, by op name) and O2 (``amp.decorate``) with
``GradScaler``; the reference's losses and loss layers; the LR
schedulers, the 14 optimizers with the eager API, the clips and
regularizers, ``StepTimer`` and train-state checkpoints
(``distributed/``, the reference's on-disk format) with exact resume.
``nn`` and ``inference`` export the reference's names of what is
ported.  The 13 TPU kernels' counterparts (paged attention for the
unified and split steps, flash forward and backward with in-kernel
dropout, the trained bias's gradient, the fused clip + optimizer
update, add + norm with its backward, matmul + rope, the MoE grouped
matmuls) are written by hand in CUDA C++ for Hopper (``csrc/``).
Entry points run on the GPU unless the caller passes ``device="cpu"``.
The high-level trainer (``Model``, ``hapi.callbacks``), ``io`` (datasets,
samplers, ``DataLoader``, the native token reader), ``metric`` and
``save`` / ``load`` are exported here as ``paddle_tpu/__init__.py``
exports them.
"""
from . import io
from .framework.io import load, save
from . import metric
from . import visualdl
from . import hapi
from .hapi import Model
from .hapi import callbacks
