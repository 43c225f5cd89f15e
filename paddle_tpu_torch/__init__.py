"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` beside it is the reference and stays as
it is.  This package mirrors its module paths (``models/llama.py``,
``inference/engine.py``, ``ops/paged_attention.py`` ...) so a reader
finds each counterpart, but imports only ``torch`` and ``numpy``:
nothing of JAX and nothing of ``paddle_tpu``.

What it serves today is the Llama serving path of ``LLMEngine``: the
ragged unified step and the synchronous chunked prefill, each through a
kernel written by hand in CUDA C++ for Hopper (``csrc/``).  Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""
