"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` beside it is the reference and stays as
it is.  This package mirrors its module paths (``models/llama.py``,
``inference/engine.py``, ``ops/paged_attention.py`` ...) so a reader
finds each counterpart, but imports only ``torch`` and ``numpy``:
nothing of JAX and nothing of ``paddle_tpu``.

It ports two paths so far.  Serving: ``LLMEngine``'s ragged unified
step, its split decode path and synchronous chunked prefill, with float
or int8 KV pools and float or int8 weights (``quantization/``), for the
Llama and Qwen2-MoE families.  Training: ``LlamaForCausalLM``'s and
``Qwen2MoeForCausalLM``'s forward with the chunked linear +
cross-entropy, ``GPTForCausalLM`` with hidden and attention dropout
(``ops/random.py``'s generator), ``amp.decorate``, AdamW with a
global-norm clip and ``CompiledTrainStep``; ``nn/transformer.py``'s
attention and encoder layers, with a trained attention bias.  Their
kernels (paged attention for the unified and split steps, flash forward
and backward with in-kernel dropout, the trained bias's gradient, the
fused clip + optimizer update, add + norm, matmul + rope, the MoE
grouped matmuls) are written by hand in CUDA C++ for Hopper
(``csrc/``).  The serving engine reports into ``observability/``
(metrics, tracing, health, memory, request capsules; the reference's
stdlib modules kept as copies) and ``profiler/`` (over
``torch.profiler``).  The training loop's state is ported too: LR
schedulers, the reference's 14 optimizers with the eager API, the clips
and regularizers, ``StepTimer`` and train-state checkpoints
(``distributed/``, the reference's on-disk format) with exact resume.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
