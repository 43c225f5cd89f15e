#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA GPU, the
CUDA toolkit (nvcc) and PyTorch built for CUDA.  It builds the port's
kernels from ``paddle_tpu_torch/csrc`` (one nvcc per source, all
started together) and holds each against its plain PyTorch version at
the main paths' full-width shapes (the attention kernels also at GQA
group 1, with int8 pools, with pools of another float dtype than q and
with dropout, the grouped matmuls at the
MoE serving and training shapes, the bias gradient at GPT-2's
attention).
Then it drives the main paths through their user entry points, each
with the launch counts set to 0 just before and read just after:

- serving: Llama-3-8B (full width, 32 layers, bf16, random weights from
  a seeded generator) through ``LLMEngine``, checked against a dense
  plain forward;
- training: Llama-3-8B width cut to 8 layers, bf16 (amp O2), seq 8192,
  batch 1, AdamW with a global-norm clip, through ``CompiledTrainStep``
  for 5 steps, on the unfused chain without remat;
- training on the reference's headline recipe: the same at 16 layers
  with the fused add+RMSNorm and matmul+rope regions
  (``fuse_norm_rope=True``) and ``recompute_granularity="core_attn"``;
  then at f32, 2 layers, seq 1024, the loss and every gradient of the
  unfused chain and of the fused chain under each recompute policy
  against a composition of plain versions, and one fused update against
  its plain version;
- quantized and split-path serving: the same Llama-3-8B on the split
  path (``unified_step=False``, kernel #7), on the unified step with int8
  KV pools and int8 weights (#1's int8 mode) and on the split path with
  both; ``PagedKVCache.attend`` (#6) on the live caches; then at f32, 2
  layers, the three engines on the card against the same on the CPU;
- MoE serving: Qwen1.5-MoE-A2.7B (``Qwen2MoeConfig()``: 24 layers, 60
  experts top-4, bf16) through ``LLMEngine`` on the same request mix,
  the expert FFN through the grouped matmul kernel, checked against a
  plain forward with a per-expert loop; then on the split path with
  both int8 knobs (#7 at group 1, #11 on int8 expert stacks);
- MoE training: ``bench.py`` ``bench_moe``'s recipe at Qwen1.5-MoE width
  cut to 6 layers, bf16 (amp O2), batch 4 x seq 4096, full recompute,
  AdamW, 5 steps (the fused gate/up, grouped and per-expert dW kernels
  with the attention and update kernels); then at f32, 2 layers, seq
  256, the loss and every gradient against a plain composition, with
  and without recompute;
- GPT-2 training: ``bench.py`` ``bench_gpt2``'s recipe at GPT-2 124M
  (12 layers, full width, vocab 50,304), f32, batch 8 x 1024, AdamW,
  attention dropout 0.1 inside the flash kernels and hidden dropout 0.1,
  5 steps; then at f32, 2 layers, seq 256, the loss and every gradient
  against a plain composition at dropout 0 and 0.1 (the same masks from
  the same generator seed); and one post-norm ``TransformerEncoderLayer``
  at GPT-2 width with a trained attention bias (the add+norm kernel's
  LayerNorm body, the flash kernels and the bias gradient #5); then
  the training loop's state on the same recipe: a warm-up and cosine
  schedule with the global-norm clip, its norm tapped and a
  ``StepTimer`` fed by ``step_flops`` (the lr #8 read each step, the
  launches, the host copies and waits against a constant-lr step), a
  checkpoint saved asynchronously after 3 steps and loaded into a fresh
  trainer (params bit-equal, the losses of the uninterrupted run), and
  the 9 optimizers without a fused kind, LBFGS and AdamW's per-leaf
  update against #8;
- serving as the reference's serving benches configure it: the bf16
  Llama-3-8B over the engine's default f32 pools (#1 with bf16 q over
  f32 pools); Llama-3-8B at full depth with f32 weights over bf16 pools
  (``dtype=bfloat16``, ``steps_per_sync`` 16) on the unified step (#1
  with f32 q over bf16 pools) and on the split path (#7, and #6 through
  ``PagedKVCache.attend``), with a 2-layer check against a dense f32
  forward whose K and V are rounded to bf16; then preemption on that
  engine: requests suspended into the host swap pool, past a full pool
  (recomputed through #7), and migrated to a second engine, each
  request's tokens held against an unpreempted run;
- sampling and speculative decoding on the ``serve`` model and requests:
  ``LLMEngine`` with ``top_k`` 50, ``top_p`` 0.9, temperature 0.8 and a
  seed (unified and split), its threefry draws against the CPU's and
  against ``filtered_probs``; ``model.generate`` (batch 4 x 128 prompt
  ids, 32 new tokens: greedy, sampling, beam search) with its #2, #9 and
  #10 launches counted; ``LLMEngine(draft_model=..., spec_k=4)`` with a
  random draft at Llama-3.2-1B's widths, with the target drafting for
  itself and in rejection mode, #1, #2 and #7 counted; then the same
  paths at f32, 2 layers, against the engine's greedy tokens;
- the observability plane on the ``serve`` model and requests: serves
  with the engine's metrics off and on, alternated twice (tokens equal,
  the same count of host copies and waits a step in a traced serve each
  way), ``metrics_snapshot()``, the Prometheus text, the spans of one
  traced request with its Chrome trace, the memory plane's rows;
- capacity-factor MoE serving: Qwen1.5-MoE-A2.7B at full depth with
  ``moe_dropless=False`` (the config's factor 1.25: 11 slots an expert a
  page group) on the serve mix, unified and split, with kept + dropped
  routed slots held to the live rows and no drops in pure-decode steps;
  then at f32, 2 layers, factor 0.5, the prefill logits against a plain
  forward that ranks each page chunk's slots;
- the serving runtime (``paddle_tpu_torch.serving``) over the ``serve``
  model: the serve mix through ``Scheduler`` against a direct run of the
  same engine calls, an overload burst at two priorities (shedding,
  deadlines, preemption; no cache out-of-memory); two streams through
  ``start_http_frontend`` and its ``/metrics``, ``/healthz``,
  ``/statusz`` and ``/memz``; two replicas on the card under
  ``ReplicaRouter``, ``drain_replica`` migrating KV pages, then the
  same replicas as ``RemoteReplica``s over HTTP with a dropped reply
  resubmitted once and a drain over the wire;
- the rest of the model zoo: the attention kernels at ERNIE-4.5's GQA
  groups 3 and 5, BERT's 16-bit head_dim 64 with a padding bias and
  dropout and DiT's f32 head_dim 64, bf16 #9 at BERT's width, #10 at
  hidden 1536 and 2560 and the grouped matmuls at 64 experts, each
  against its plain version; ERNIE-4.5 trained on ``bench_ernie``'s
  recipe (16 layers, 2 x 8192, full recompute, bf16) and at
  ERNIE-A3B's widths (a dense layer and ERNIE_MOE_LAYERS MoE layers of
  64 experts, 2 x 4096), their f32 chain against a plain composition
  and interleaved rope against de-interleaved weights; DiT-L/2 on
  ``bench_dit``'s recipe, ``AutoencoderKL`` at its own widths, BERT-base
  as a masked LM over padded rows (bf16, dropout 0.1); DeepSeekMoE-16B
  served at full depth (bf16) with its f32 2-layer check;
- the encoder-decoder Transformer (Transformer-base: 512 wide, 8 heads,
  6 + 6 layers) composed from the port's layers with a shared
  37,000-token embedding tied to the output: the attention kernels at
  its shapes (bf16 and f16 under its -inf masks, cross attention,
  one-token decoding) and the add+norm kernel's mixed mode (a 16-bit
  block output over the f32 residual stream) against their plain
  versions; trained under amp O1 bf16 with label-smoothed cross entropy
  through ``CompiledTrainStep`` (AdamW, Noam), under O1 f16 on the eager
  API with ``GradScaler`` from an overflowing scale; its f32 chain at 2 +
  2 layers against a plain composition; greedy decoding with
  ``gen_cache`` against a full recompute;
- the high-level trainer (``hapi.Model``) over the ``io`` loaders:
  BERT-base as a 4-way classifier (bf16 O2, 16 x 512, a quarter of each
  row padded) through ``fit`` over a shuffled ``DataLoader`` with two
  worker processes, an eval each epoch, ``LRScheduler`` and ``VisualDL``
  callbacks, then ``evaluate``, ``predict``, ``save`` and ``load``:
  losses bit-equal to a direct ``CompiledTrainStep`` loop over the same
  batches, exact launches of #2-#4, #9 and #8 a step, train accuracies
  equal to numpy's, predictions equal to a ``no_grad`` forward and
  bit-equal after a reload; a stopped ``fit`` over a
  ``CheckpointableLoader`` resumed by a fresh model with bit-equal
  losses; GPT-2 124M fed from a token file through the native reader
  (``core/csrc/dataio.cpp``, built here with ``g++``) and through
  ``DataLoader(num_workers=2)`` into ``fit``.

Every 16-bit training step must trace only the tensor-core (``wgmma``)
kernels of the flash forward, dQ and dK/dV families, the fused step
only the tensor-core matmul+rope kernel, and the MoE step only the
tensor-core grouped matmul (#11), fused gate/up (#12) and dW (#13)
kernels; every bf16 #11-#13 check must trace its wgmma kernel; the
bf16 serves (Llama-3-8B and Qwen1.5-MoE) only #1's ``mma.sync``
attention (``ragged_attend_mma``), the f32-weight serve
over bf16 pools only its 3xTF32 attention (``ragged_attend_3xtf32``),
and every #1 row its route's kernels; the f32 attention of the
GPT-2 step and of the split int8 serve's prefill only the 3xTF32
forward (``flash_fwd_3xtf32``, at GPT-2's shape and at the prefill
chunk's in a kernel row too), and the f32-row #11 of MoE serving only
the streaming kernel (``gmm_rows_stream``, in rows at a mixed and a
pure decode step); every tensor-core and streaming kernel must build
without spills.

Each phase prints one JSON line; the last three lines are the kernel
table, the card's name and power limit as nvidia-smi reports them, and
``{"ok": true, ...}``.  Any failed phase exits non-zero before the
``ok`` line.  Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 tensor-core rate, for the least time the card could take
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # f32 inputs on the tensor cores (TF32)
F32_TC_NOTE = "3xTF32: 3 x operations at 495 TFLOP/s (bound_fma_ms: f32 " \
              "67 TFLOP/s)"
F32_FMA_NOTE = "f32 67 TFLOP/s (bound_3xtf32_ms: 3 x operations at 495)"
TOL = 2e-2          # bf16 outputs: one rounding of values of order 1
# bf16 gradients, relative to the largest element: one output rounding
# (2^-8) plus f32 sums in another order
GRAD_TOL = 2e-2
# relative L2 error of a bf16 output against its plain version: each
# side rounds once (at most 2^-9 of each element), so 2^-7 is four
# roundings
REL_L2_TOL = 2.0 ** -7
SEED = 0
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_STEPS = 8, 8192, 5
FUSED_LAYERS = 16          # the headline recipe with core_attn remat
VOCAB = 128256
# the serving mix: four begin_request prompts and one add_request
SERVE_LENS = {"b37": 37, "b128": 128, "b300": 300, "b1000": 1000,
              "a200": 200}
SERVE_NEW = 32
# Qwen1.5-MoE-A2.7B training cut: 6 of 24 layers, batch 4, seq 4096
MOE_LAYERS, MOE_BATCH, MOE_SEQ = 6, 4, 4096
# GPT-2 124M, bench.py bench_gpt2's recipe: batch 8 x seq 1024, f32,
# attention and hidden dropout 0.1; 12 heads of 64
GPT_BATCH, GPT_SEQ, GPT_WIDTH, GPT_HEADS, GPT_STEPS = 8, 1024, 768, 12, 5
GPT_DROP = 0.1
GPT_LAYERS_124M = 12
# relative L2 error of an f32 output against its plain version: f32 sums
# in another order
F32_REL_L2_TOL = 1e-5

class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_START = time.perf_counter()
# figures one phase hands to a later one
RESULTS = {}


def emit(obj):
    """One JSON line; a phase's line carries ``at_s``, the seconds since
    the script started (where the run's time goes)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def timed_ms(torch, fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, flops, peak=PEAK_BF16_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def f32_bounds(n_bytes, flops, tensor_cores):
    """``bound_ms`` and ``bound_by`` of an f32 kernel, with the bound of
    the other route beside them: an f32-accurate product on the tensor
    cores is three TF32 products (3 x flops at 495 TFLOP/s,
    ``tensor_cores``: ``bound_fma_ms`` beside), on the FMA pipe one f32
    product (67 TFLOP/s: ``bound_3xtf32_ms`` beside)."""
    tc = bound_ms(n_bytes, 3 * flops, peak=PEAK_TF32_FLOPS)
    fma = bound_ms(n_bytes, flops, peak=PEAK_F32_FLOPS)
    if tensor_cores:
        return {"bound_ms": tc[0], "bound_by": tc[1], "bound_fma_ms": fma[0]}
    return {"bound_ms": fma[0], "bound_by": fma[1], "bound_3xtf32_ms": tc[0]}


def design_of(name):
    """The design a kernel's (traced or mangled) name states: "3xtf32"
    (f32 on the tensor cores as three TF32 products: #2's f32 route, #4's
    f32 route at D 64, #1's f32, mixed and int8 modes), "wgmma" (16-bit
    on the tensor cores by warpgroup), "stream" (#11's f32 rows streaming
    their expert's weights), "mma" (16-bit on the tensor cores by warp,
    ``mma.sync``: #1's 16-bit mode), "split" (#6 and #7 spread over
    blocks by key span, ``paged_decode_split``) or "fma" (the FMA pipe,
    and the copy kernels)."""
    for key in ("3xtf32", "wgmma", "stream", "mma"):
        if key in name:
            return key
    if "paged_decode_split" in name:
        return "split"
    return "fma"


def ptxas_usage(report):
    """Registers and spill bytes of each kernel of a redesigned route
    (tensor-core and streaming kernels: every design but "fma") in a
    build report ({source: {"ptxas": assembler output}}), by mangled
    name."""
    usage, cur = {}, None
    for rep in report.values():
        for line in rep["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = m.group(1)
            elif cur and design_of(cur) != "fma":
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    usage.setdefault(cur, {})["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    usage.setdefault(cur, {})["spill_bytes"] = \
                        int(m.group(1)) + int(m.group(2))
    return usage


def rel_err(got, want):
    """Largest absolute error over the largest |want| element."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


# the unified step's live descriptors in ``ragged_case``: (kv_len, q_len)
RAGGED_LIVE = [(36, 1), (127, 1), (300, 1), (1031, 1), (256, 128), (126, 2),
               (128, 2)]


def ragged_bytes(el_q, el_p, H=32, KVH=8, int8=False):
    """Bytes #1 moves at ``ragged_case``'s shapes with q, the new rows and
    the output ``el_q`` bytes an element and pools ``el_p`` (int8 pools:
    an f32 scale a pool row besides): pages read once a kv head, q and
    new rows read, new rows appended, the whole output block written,
    descriptors and tables read."""
    T, P, D, maxp = 136, 128, 128, 16
    pages_read = sum(-(-(kl + ql) // P) for kl, ql in RAGGED_LIVE) * KVH
    rows = sum(ql for _, ql in RAGGED_LIVE)
    row_p = D * el_p + (4 if int8 else 0)       # bytes a pool row
    return (2 * pages_read * P * row_p + rows * H * D * el_q
            + 2 * rows * KVH * D * el_q + 2 * rows * KVH * row_p
            + T * P * H * D * el_q + 4 * (3 * T + T * maxp))


def ragged_case(torch, gen, dev, H=32, KVH=8):
    """The unified step's shapes: T = S = 136 rows (max_seqs 8 + prefill
    budget 128), P 128, D 128, H query and KVH KV heads (Llama-3-8B: 32
    and 8; Qwen1.5-MoE-A2.7B: 16 and 16): four decode rows at mixed
    lengths, one 128-row chunk, and one prompt split over two
    descriptors at a page boundary."""
    T, P, D, maxp = 136, 128, 128, 16
    n_pages = 8 * maxp + 1
    seqs = RAGGED_LIVE
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    q_start = torch.zeros(T, dtype=torch.int32)
    q_len = torch.zeros(T, dtype=torch.int32)
    kv_len = torch.zeros(T, dtype=torch.int32)
    tables = torch.zeros((T, maxp), dtype=torch.int32)
    row, used = 0, 0
    for d, (kl, ql) in enumerate(seqs):
        q_start[d], q_len[d], kv_len[d] = row, ql, kl
        if d == 6:                      # second half of the split prompt
            tables[d] = tables[5]
        else:                           # the split prompt's pages for both
            npg = -(-(kl + ql + (2 if d == 5 else 0)) // P)
            tables[d, :npg] = perm[used:used + npg].cpu()
            used += npg
        row += ql
    check(row == T, f"ragged case packs {row} rows, not {T}")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    args = dict(q=rnd(T, H, D), k_new=rnd(T, KVH, D), v_new=rnd(T, KVH, D),
                k_pages=rnd(KVH, n_pages, P, D),
                v_pages=rnd(KVH, n_pages, P, D), q_start=q_start.to(dev),
                q_len=q_len.to(dev), kv_len=kv_len.to(dev),
                page_tables=tables.to(dev))
    flops = sum(4 * H * D * (kl + r + 1) for kl, ql in seqs
                for r in range(ql))
    return args, ragged_bytes(2, 2, H, KVH), flops


def ragged_row(torch, name, kernel, plain, err, bound, design):
    """A row of #1's table: ``kernel()`` and ``plain()`` timed (CUDA
    events), the kernel traced (``RAGGED_FAMILIES``: its append and
    attention summed as ``device_ms``) and the design of its attention
    kernel held to ``design`` ("mma" for 16-bit q over pools of its type,
    "3xtf32" for every other mode)."""
    row = {"name": name, "route": "cuda",
           "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
           "replaces": "paddle_tpu/ops/pallas/paged_attention.py:912",
           "max_abs_err": err, "ms": timed_ms(torch, kernel, 20),
           "plain_ms": timed_ms(torch, plain, 5), "bound_ms": bound[0],
           "bound_by": bound[1], "library_ms": None,
           **traced_kernel(torch, kernel, RAGGED_FAMILIES)}
    check(row["design"] == design,
          f"{name} ran on {row['design']}, not {design}")
    return row


def flash_case(torch, gen, dev, H=32, KVH=8):
    """The synchronous prefill chunk: q [1, 128, H, 128] against the
    sequence's gathered pages [1, 2048, KVH, 128] (strided views, as the
    engine passes them) under the f32 position mask [1, 1, 128, 2048] of
    chunk 7 of a 1000-token prompt (Llama-3-8B: H 32, KVH 8)."""
    P, D, maxp, prev = 128, 128, 16, 896
    s_kv = maxp * P

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q = rnd(1, P, H, D)
    pages = rnd(2, KVH, maxp, P, D)
    k = pages[0].reshape(KVH, s_kv, D).transpose(0, 1)[None]
    v = pages[1].reshape(KVH, s_kv, D).transpose(0, 1)[None]
    allow = torch.arange(s_kv, device=dev)[None, :] <= \
        prev + torch.arange(P, device=dev)[:, None]
    mask = torch.zeros((1, 1, P, s_kv), device=dev).masked_fill_(
        ~allow, -1e30)
    n_bytes = (q.numel() + k.numel() + v.numel()) * 2 + mask.numel() * 4 \
        + q.numel() * 2 + H * P * 4
    flops = 4 * H * P * s_kv * D
    return dict(q=q, k=k, v=v, mask=mask), n_bytes, flops


def f32_prefill_kernel(torch, gen, dev, table):
    """#2's f32 route at the split path's prefill attention with int8 or
    other-dtype pools (the engine widens q and the gathered pages to f32):
    q [1, 128, 32, 128] against 1024 keys of 8 kv heads (strided views of
    [KVH, S, D] pages, as the engine passes them) under the f32 position
    mask [1, 1, 128, 1024] of a 1000-token prompt's last chunk (-1e30
    past each row's position), against its plain version (1e-5 relative
    L2, lse 1e-3), timed, with ``scaled_dot_product_attention`` in f32
    over the same mask with ``enable_gqa=True`` as the library call.  32
    blocks of 128 rows on 132 SMs: the keys split."""
    from paddle_tpu_torch.ops import flash_attention as fa
    H, KVH, P, D, s_kv, prev = 32, 8, 128, 128, 1024, 896
    q = torch.randn(1, P, H, D, generator=gen, device=dev)
    pages = torch.randn(2, KVH, s_kv, D, generator=gen, device=dev)
    k, v = pages[0].transpose(0, 1)[None], pages[1].transpose(0, 1)[None]
    allow = torch.arange(s_kv, device=dev)[None, :] <= \
        prev + torch.arange(P, device=dev)[:, None]
    mask = torch.zeros((1, 1, P, s_kv), device=dev).masked_fill_(
        ~allow, -1e30)
    kw = dict(causal=False, mask=mask)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err = rel_l2(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    check(err <= F32_REL_L2_TOL, f"f32 prefill flash off its plain version: "
                                 f"relative L2 {err}")
    check(lse_err <= 1e-3, f"f32 prefill flash lse off by {lse_err}")
    nsplit = ctypes.c_int()
    fa._kernel().flash_attention_fwd_workspace(1, H, P, s_kv, D, 0,
                                               ctypes.byref(nsplit))
    nsplit = nsplit.value
    check(nsplit > 1, f"the prefill chunk took {nsplit} key split(s)")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        def library():
            sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    except TypeError:                   # a PyTorch without enable_gqa
        kr, vr = (x.repeat_interleave(H // KVH, dim=1) for x in (kt, vt))

        def library():
            sdpa(qt, kr, vr, attn_mask=mask)
    n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel() + mask.numel()
                   + H * P)
    flops = 4 * H * P * s_kv * D
    row = {"name": "flash_attention_fwd_f32_prefill", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
           "replaces": "paddle_tpu/ops/pallas/flash_attention.py:164",
           "max_abs_err": (out - ref_out).abs().max().item(),
           "ms": timed_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                                **kw), 20),
           "plain_ms": timed_ms(
               torch, lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                               **kw), 5),
           **f32_bounds(n_bytes, flops, tensor_cores=True),
           "library_ms": timed_ms(torch, library, 20),
           **traced_kernel(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                                 **kw))}
    check(row["design"] == "3xtf32",
          f"f32 prefill ran on {row['design']}, not 3xtf32")
    table[row["name"]] = row
    emit({"phase": "kernel", **row, "rel_l2_err": err,
          "lse_max_abs_err": lse_err, "key_splits": nsplit,
          "shape": {"q": list(q.shape), "kv": list(k.shape),
                    "mask": list(mask.shape)}, "dtype": "float32",
          "bound_peak": F32_TC_NOTE,
          "tolerance": {"rel_l2_err": F32_REL_L2_TOL,
                        "lse_max_abs_err": 1e-3},
          "library_note": "scaled_dot_product_attention, f32, the same "
                          "mask, enable_gqa=True"})


def plain_hidden(torch, model, ids, kv_dtype=None):
    """Final-norm hidden states [B, S, H] of a plain causal forward over
    ids [B, S] (no pages, no kernels, no chunking: embedding, per layer
    RMSNorm, projections, f32 rope, the flash plain version, SwiGLU),
    differentiable by autograd.  ``kv_dtype``: K (after rope) and V are
    rounded to it before the attention, as pools of that dtype hold
    them."""
    from paddle_tpu_torch.models.llama import _rotate_half
    from paddle_tpu_torch.ops import _nn
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_fwd_reference
    c = model.config
    hd = c.hidden_size // c.num_attention_heads
    b, n = ids.shape
    lm = model.llama
    cos = lm.rope_cos[:n][None, :, None, :].float()
    sin = lm.rope_sin[:n][None, :, None, :].float()

    def rope(x):
        xf = x.float()
        return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)

    x = lm.embed_tokens.weight[ids.long()]
    for layer in lm.layers:
        a, m = layer.self_attn, layer.mlp
        hn = _nn.rms_norm(x, layer.input_layernorm.weight,
                          epsilon=c.rms_norm_eps)
        q = rope((hn @ a.q_proj.weight).view(b, n, -1, hd))
        k = rope((hn @ a.k_proj.weight).view(b, n, -1, hd))
        v = (hn @ a.v_proj.weight).view(b, n, -1, hd)
        if kv_dtype is not None:
            k, v = (t.to(kv_dtype).to(t.dtype) for t in (k, v))
        o = flash_attention_fwd_reference(q, k, v, causal=True)[0]
        x = x + o.reshape(b, n, -1) @ a.o_proj.weight
        hn = _nn.rms_norm(x, layer.post_attention_layernorm.weight,
                          epsilon=c.rms_norm_eps)
        x = x + (_nn.silu(hn @ m.gate_proj.weight)
                 * (hn @ m.up_proj.weight)) @ m.down_proj.weight
    return _nn.rms_norm(x, lm.norm.weight, epsilon=c.rms_norm_eps)


def dense_reference_logits(torch, model, ids, kv_dtype=None):
    """Last-position logits of a plain causal forward over one prompt
    (K and V rounded to ``kv_dtype`` when given)."""
    with torch.no_grad():
        return plain_hidden(torch, model, ids[None], kv_dtype)[0, -1] \
            @ model.lm_head.weight


def serve_reference(torch, dev, ids, cases, ref_logits):
    """What comes out agrees with a dense plain forward (no pages, no
    kernels).  For each (name, model, engine, tolerance) of ``cases``,
    the engine's prefill logits of prompt ``ids`` (the flash kernel)
    within the tolerance (relative L2) of ``ref_logits(model, ids)``; on
    the first case, f32 at full width with the depth cut to 2 layers,
    where kernels and plain versions agree to f32 rounding, the engine's
    4 greedy tokens (``begin_request``, the ragged kernel) equal the
    plain forward's.  At bf16 and full depth roundings compound over
    the random layers, so only a coarse bound (0.2) catches gross
    errors.  Returns the report."""
    rep = {"prompt_len": len(ids)}
    for name, m, e, tol in cases:
        slot = e.cache.allocate(len(ids) + 1)
        got = e._prefill_seq(slot, ids, 0).float()       # flash kernel
        e.cache.release(slot)
        want = ref_logits(m, torch.tensor(ids, device=dev)).float()
        check(bool(torch.isfinite(got).all()), f"{name}: logits not finite")
        rel = ((got - want).norm() / want.norm()).item()
        rep[name] = {"logits_rel_l2_err": rel, "tolerance": tol,
                     "argmax_equal": int(got.argmax()) == int(want.argmax())}
        check(rel <= tol, f"{name}: prefill logits off a dense forward "
                          f"by {rel} (relative L2)")
    name, m, e, _ = cases[0]
    want_toks, seq = [], list(ids)
    for _ in range(4):
        tok = int(ref_logits(m, torch.tensor(seq, device=dev)).argmax())
        want_toks.append(tok)
        seq.append(tok)
    e.begin_request("ref", ids, max_new_tokens=4)        # ragged kernel
    while e.has_work():
        e.step()
    got_toks = e.pop_result("ref")
    rep[name]["greedy_tokens_equal"] = got_toks == want_toks
    check(got_toks == want_toks,
          f"{name}: greedy tokens {got_toks} != dense {want_toks}")
    return rep


def kernel_family(name):
    for key, fam in (("ragged_attend", "ragged_attend"),
                     ("ragged_append", "ragged_append"),
                     ("paged_decode", "paged_decode"),
                     ("flash_fwd", "flash_fwd"),
                     ("flash_bwd_dq", "flash_bwd_dq"),
                     ("flash_bwd_dkv", "flash_bwd_dkv"),
                     ("flash_dbias", "flash_dbias"),
                     ("fused_update", "fused_update"),
                     # add_norm_bwd and add_norm_bwd_reduce before the
                     # forward's add_norm_fwd
                     ("add_norm_bwd", "add_norm_bwd"),
                     ("add_norm", "add_norm"),
                     ("matmul_rope", "matmul_rope"),
                     # grouped_matmul.cu, whatever the design: gmm_wgmma,
                     # gmm_rows_stream, gmm_t_f32; glu_wgmma, glu_f32;
                     # dw_wgmma, dw_f32
                     ("ptt::gmm_", "grouped_matmul"),
                     ("ptt::glu_", "grouped_matmul_glu"),
                     ("ptt::dw_", "grouped_matmul_dw")):
        if key in name:
            return fam
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "gemv", "sm90",
                              "nvjet")):
        return "matmul"
    return "other"


# the families whose kernels a trace names one by one (``routed_kernel_ms``,
# read by the route checks)
ROUTED_FAMILIES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_dbias",
                   "matmul_rope", "grouped_matmul", "grouped_matmul_glu",
                   "grouped_matmul_dw", "ragged_append", "ragged_attend",
                   "paged_decode")
# #1's kernels: the append (and the plan) and the attention, which merges
# its key splits (``ragged_attend_mma`` or ``ragged_attend_3xtf32``)
RAGGED_FAMILIES = ("ragged_append", "ragged_attend")


def profiled(torch, fn):
    """Run ``fn()`` under torch.profiler; return its result and the wall
    time, the summed kernel time by family, and the device's idle share
    of the wall time (one stream: kernels do not overlap).  Only the
    device is traced: recording every host op as well multiplied a
    host-bound serve's traced wall time and took seconds to summarise."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    fams, counts, top, routed = {}, {}, [], {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or \
                e.key.startswith("llm_engine."):
            # host ops (their kernels count), and the device spans of
            # ``record_function`` ranges (the engine's ``RecordEvent``s,
            # "llm_engine.*"), which cover kernels counted on their own
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            fam = kernel_family(e.key)
            fams[fam] = fams.get(fam, 0.0) + us / 1e3
            counts[fam] = counts.get(fam, 0) + e.count
            top.append((us / 1e3, e.key[:80], e.count))
            if fam in ROUTED_FAMILIES:
                routed[e.key.split("(")[0][:80]] = us / 1e3
    busy = sum(fams.values())
    check(busy <= 1.01 * wall_ms,
          f"traced device time {busy} ms exceeds the wall time {wall_ms} "
          f"ms: events counted twice ({sorted(fams.items())})")
    top.sort(reverse=True)
    return out, {"wall_ms": wall_ms,
                 "device_busy_ms": busy if busy else None,
                 "idle_share": 1 - busy / wall_ms if busy else None,
                 "kernel_ms_by_family": fams,
                 "kernel_count_by_family": counts,
                 "routed_kernel_ms": routed,
                 "top_kernels": [{"ms": ms, "name": n, "count": c}
                                 for ms, n, c in top[:8]]}


# traces of a kernel row taken again where the profiler dropped events
# (it dropped some from two traces in a row on the card)
TRACE_RETRIES = 3


def traced_kernel(torch, fn, family=None, calls=3):
    """The kernel that ``fn()`` launches, traced over ``calls`` calls:
    ``design`` read from its name (``design_of``), for the families of
    ``ROUTED_FAMILIES`` (flash, matmul+rope, the grouped matmuls #11-#13,
    #1; None for another ``family``), and ``device_ms``, its own device
    time a call (without the wrapper's host work).  ``family`` None: the
    one routed family traced; a tuple (#1's ``RAGGED_FAMILIES``):
    ``device_ms`` sums the kernels of those families (append and
    attention) and ``design`` is the last family's.  The profiler at
    times drops kernel events (a dK/dV row's trace held none, an f32
    forward row's one of its three; cause not found), so a trace whose
    count of a family's kernels is 0 or not a multiple of ``calls`` is
    taken again, up to ``TRACE_RETRIES`` times, ``trace_retries`` says
    how often, and the check fails if the last one is short too."""
    wanted = (family,) if isinstance(family, str) else family

    def lost(prof):
        fams = wanted or {kernel_family(n) for n in prof["routed_kernel_ms"]}
        n = [prof["kernel_count_by_family"].get(f, 0) for f in fams]
        return not n or any(c == 0 or c % calls for c in n)

    retries = 0
    _, prof = profiled(torch, lambda: [fn() for _ in range(calls)])
    while lost(prof) and retries < TRACE_RETRIES:
        retries += 1
        emit({"phase": "trace_retry", "family": family,
              "top_kernels": prof["top_kernels"]})
        _, prof = profiled(torch, lambda: [fn() for _ in range(calls)])
    check(not lost(prof), f"the trace of {family or 'a routed kernel'} "
                          f"lost events {retries + 1} times: "
                          f"{prof['kernel_count_by_family']}")
    names = [n for n in prof["routed_kernel_ms"]
             if wanted is None or kernel_family(n) == wanted[-1]]
    fams = {wanted[-1]} if wanted else {kernel_family(n) for n in names}
    designs = {design_of(n) for n in names}
    check(len(fams) == 1 and len(designs) <= 1 and (names or family),
          f"not one kernel traced ({family}): {names}")
    fam = fams.pop()
    ms = sum(prof["kernel_ms_by_family"].get(f, 0.0)
             for f in (wanted or (fam,)))
    check(ms, f"no {fam} kernel traced")
    return {"design": designs.pop() if designs else None,
            "device_ms": ms / calls, "trace_retries": retries}


# one rank's heads of a tensor-parallel mesh: (query heads, KV heads,
# what shards that way); each rank launches #1, #2, #6 and #7 once a
# layer a forward at these shapes
TP_RAGGED_SHARDS = ((16, 4, "llama3_8b tp 2"), (8, 2, "llama3_8b tp 4"),
                    (4, 4, "qwen1.5_moe_a2.7b tp 4"))
TP_SPLIT_SHARD = (8, 2, "llama3_8b tp 4")


def tp_shard_kernels(torch, gen, dev):
    """#1 at the unified step's shapes and #7, #6 and #2 at the split
    path's, at the heads one rank of a mesh holds (``TP_RAGGED_SHARDS``,
    ``TP_SPLIT_SHARD``), each against its plain version (outputs within
    ``TOL``, pools after an append equal), timed, traced and bounded.
    NCCL takes no two ranks on one card, so these rows are what holds
    the kernels at a tp > 1 rank's geometry on one card.  They run with
    the other kernel rows (traces taken after a traced serve lost kernel
    events); ``serve_tp_phase`` fills ``launches`` (a rank's count in its
    run of the serve mix, one a layer a forward at any tp; #6 and #7
    None, that run is unified) and prints them."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    t0 = time.perf_counter()
    rows = []
    for H, KVH, shard in TP_RAGGED_SHARDS:
        args, n_bytes, flops = ragged_case(torch, gen, dev, H, KVH)

        def ragged(fn, kp, vp):
            return fn(args["q"], kp, vp, args["k_new"], args["v_new"],
                      args["q_start"], args["q_len"], args["kv_len"],
                      args["page_tables"])
        kp_k, vp_k = (args[n].clone() for n in ("k_pages", "v_pages"))
        kp_p, vp_p = (args[n].clone() for n in ("k_pages", "v_pages"))
        got = ragged(pa.ragged_paged_append_attend, kp_k, vp_k)
        want = ragged(pa.ragged_paged_append_attend_reference, kp_p, vp_p)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        name = f"ragged_paged_append_attend_h{H}_kv{KVH}"
        check(torch.equal(kp_k, kp_p) and torch.equal(vp_k, vp_p),
              f"{name} appended other K/V than its plain version")
        check(err <= TOL, f"{name} off its plain version by {err}")
        rows.append(dict(ragged_row(
            torch, name,
            lambda: ragged(pa.ragged_paged_append_attend, kp_k, vp_k),
            lambda: ragged(pa.ragged_paged_append_attend_reference, kp_p,
                           vp_p), err, bound_ms(n_bytes, flops), "mma"),
            launches="ragged_paged_append_attend", shard=shard, heads=H,
            kv_heads=KVH))
        del args, kp_k, vp_k, kp_p, vp_p, got, want
    H, KVH, shard = TP_SPLIT_SHARD
    q, kn, vn, pools, tables, lens = decode_case(torch, gen, dev, H, KVH)
    for name, fn, plain, new in (
            ("paged_decode_append_attend", pa.paged_decode_append_attend,
             pa.paged_decode_append_attend_reference, (kn, vn)),
            ("paged_attention", pa.paged_attention,
             pa.paged_attention_reference, ())):
        mine = [None if p is None else p.clone() for p in pools]
        ref = [None if p is None else p.clone() for p in pools]

        def call(f, ps):
            return f(q, ps[0], ps[1], *new, tables, lens, ps[2], ps[3])
        got, want = call(fn, mine), call(plain, ref)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        name = f"{name}_h{H}_kv{KVH}"
        check(err <= TOL, f"{name} off its plain version by {err}")
        check(all(a is None or torch.equal(a, b)
                  for a, b in zip(mine, ref)),
              f"{name} wrote other pools than its plain version")
        bound, bound_by = bound_ms(*decode_cost(H, KVH, False, bool(new)))
        rows.append(dict(decode_row(
            torch, name, lambda: call(fn, mine), lambda: call(plain, ref),
            err, bound, bound_by), launches=None, shard=shard, heads=H,
            kv_heads=KVH))
        del mine, ref, got, want
    del q, kn, vn, pools
    args, n_bytes, flops = flash_case(torch, gen, dev, H, KVH)
    kw = dict(causal=False, mask=args["mask"])
    out, _ = fa.flash_attention_fwd(args["q"], args["k"], args["v"], **kw)
    ref_out, _ = fa.flash_attention_fwd_reference(args["q"], args["k"],
                                                  args["v"], **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref_out.float()).abs().max().item()
    name = f"flash_attention_fwd_h{H}_kv{KVH}"
    check(err <= TOL, f"{name} off its plain version by {err}")
    qt, kt, vt = (args[n].transpose(1, 2) for n in ("q", "k", "v"))
    mask_b = args["mask"].to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, bound_by = bound_ms(n_bytes, flops)
    rows.append({
        "name": name, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:164",
        "max_abs_err": err,
        "ms": timed_ms(torch, lambda: fa.flash_attention_fwd(
            args["q"], args["k"], args["v"], **kw), 20),
        "plain_ms": timed_ms(torch, lambda: fa.flash_attention_fwd_reference(
            args["q"], args["k"], args["v"], **kw), 5),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": timed_ms(torch, lambda: sdpa(
            qt, kt, vt, attn_mask=mask_b, enable_gqa=True), 20),
        **traced_kernel(torch, lambda: fa.flash_attention_fwd(
            args["q"], args["k"], args["v"], **kw)),
        "launches": "flash_attention_fwd", "shard": shard, "heads": H,
        "kv_heads": KVH})
    emit({"phase": "tp_shard_kernels", "seconds": time.perf_counter() - t0,
          "rows": [row["name"] for row in rows]})
    return rows


# one rank's part of Llama-3-8B under tensor-parallel training: (mp,
# query heads, KV heads); each rank launches #2-#4 once a layer a step
# and #10 on its q and k columns at these shapes
MP_SHARDS = ((4, 8, 2), (2, 16, 4))


def mp_shard_kernels(torch, np, gen, dev):
    """#2, #3 and #4 (causal, seq 8192) and #10 (x [1, 8192, 4096] @ the
    rank's q and k columns) at the heads one rank of an mp group holds
    (``MP_SHARDS``), each against its plain version, timed beside its
    library call, traced and bounded.  One card cannot hold an mp > 1
    gang, so these rows are what hold the kernels at an mp rank's
    geometry in this script (``tools/mp_train_rows.py`` runs the gangs
    on four cards).  They run with the other kernel rows;
    ``train_mp_phase`` fills ``launches`` (its run's count of the
    wrapper a row names, at mp 1) and prints them."""
    from paddle_tpu_torch.models.llama import _rope_cos_sin
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    t0 = time.perf_counter()
    s, hidden, hd = TRAIN_SEQ, 4096, 128
    ang = _rope_cos_sin(s, hd, 500000.0)
    cos, sin = (torch.from_numpy(f(ang)).to(dev, torch.bfloat16)
                for f in (np.cos, np.sin))
    x = torch.randn((1, s, hidden), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    rows = []
    for mp, h, hk in MP_SHARDS:
        shard = {"shard": f"llama3_8b mp {mp}", "mp": mp, "heads": h,
                 "kv_heads": hk}
        q, k, v, do = attention_case(torch, gen, dev, s, h=h, kvh=hk)
        errs = flash_check(torch, fa, s, q, k, v, do)
        torch.cuda.empty_cache()
        names = tuple(f"{n}_mp{mp}" for n in FLASH_TRAIN_ROWS)
        for (name, row), wrapper in zip(
                flash_train_rows(torch, fa, q, k, v, do, errs,
                                 names).items(),
                ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")):
            rows.append({**row, **shard, "launches": wrapper})
        del q, k, v, do
        torch.cuda.empty_cache()
        for proj, heads in (("q", h), ("k", hk)):
            w = (0.02 * torch.randn(hidden, heads * hd, generator=gen,
                                    device=dev)).to(torch.bfloat16)
            rows.append({**matmul_rope_row(
                torch, ft, x, w, cos, sin, heads, hd, proj,
                name=f"matmul_rope_{proj}_mp{mp}"), **shard,
                "launches": "matmul_rope"})
    emit({"phase": "mp_shard_kernels", "seconds": time.perf_counter() - t0,
          "rows": [row["name"] for row in rows]})
    return rows


# train_mp: Llama-3-8B width at MP_LAYERS layers on the headline recipe,
# a warm-up step and then MP_STEPS steps of each trainer
MP_LAYERS, MP_STEPS = 4, 3


def mp_collectives_a_step(layers, tokens, hidden, chunk=1024, el=2):
    """(mp collectives, their bytes) of one tensor-parallel Llama step:
    a layer's 2 forward all-reduces (o_proj, down_proj) and 2 backward
    ones (the gradient of the q/k/v and gate/up input, ``_c_identity``),
    each a [tokens, hidden] activation in the working dtype (``el``
    bytes); the embedding's forward all-reduce and the head input's
    gradient, the same size; 3 f32 all-reduces of a chunk's rows (max,
    sum of exponentials, label logit) for each cross-entropy chunk; the
    clip's f32 norm."""
    chunks = -(-tokens // chunk)
    n = 4 * layers + 2 + 3 * chunks + 1
    nbytes = (4 * layers + 2) * tokens * hidden * el + 3 * tokens * 4 + 4
    return n, nbytes


def train_mp_phase(torch, np, dev, table, shard_rows):
    """``train_mp``: Llama-3-8B width at MP_LAYERS layers on the headline
    recipe (bf16 amp O2, seq 8192, ``fuse_norm_rope``, ``core_attn``
    remat, the fused linear + cross-entropy, AdamW under a global-norm
    clip), first through ``CompiledTrainStep``, then through
    ``fleet.init`` (an NCCL world of one in this process, mp_degree 1),
    ``fleet.distributed_model`` and ``ShardedTrainStep``: the annotated
    Llama takes its tensor-parallel forward, so every mp collective goes
    through c10d.  Each trainer takes a warm-up step and MP_STEPS more on
    one batch, from one seed.  Checks: the losses equal
    ``CompiledTrainStep``'s within 1e-5 relative (bit-equal expected);
    #2-#4 launch once a layer a step, #10 four times (q and k, again in
    the recompute), #9 twice a layer and its backward once, #8 once a
    leaf; the mp collectives a step and their bytes follow
    ``mp_collectives_a_step``.  The process group stays up for
    ``serve_tp``.  Then the rows of ``mp_shard_kernels`` are printed
    with their launches from this run."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import ShardedTrainStep, fleet
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    t_phase = time.perf_counter()
    layers = MP_LAYERS
    cfg = dataclasses.replace(llama3_8b_config(), num_hidden_layers=layers,
                              fuse_norm_rope=True, recompute=True,
                              recompute_granularity="core_attn")
    ids, labels = train_batch(np, cfg.vocab_size, 1, TRAIN_SEQ)
    batch = {"input_ids": torch.tensor(ids, device=dev),
             "labels": torch.tensor(labels, device=dev)}
    counters = {"flash_attention_fwd": (fa.flash_attention_fwd, layers),
                "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq,
                                           layers),
                "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv,
                                            layers),
                "matmul_rope": (ft.matmul_rope_raw, 4 * layers),
                "add_norm": (ft.add_rms_norm_raw, 2 * layers),
                "add_norm_bwd": (ft.add_rms_norm_backward_raw, layers),
                "fused_update": (ft.fused_update_flat, None)}

    def trainer(sharded):
        model = LlamaForCausalLM(
            cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED + 6))
        if sharded:
            model = fleet.distributed_model(model)
        model = amp.decorate(model, level="O2", dtype="bfloat16")
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              grad_clip=ClipGradByGlobalNorm(1.0))
        loss = lambda m, b: m(b["input_ids"], labels=b["labels"])  # noqa
        if not sharded:
            return model, CompiledTrainStep(model, loss, opt)
        return model, ShardedTrainStep(
            model, loss, fleet.distributed_optimizer(opt), stage=1,
            device=dev)

    def run(step):
        losses = [step(batch)]                   # the warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn, _ in counters.values():
            fn.launches = 0
        times = []
        for _ in range(MP_STEPS):
            t = time.perf_counter()
            losses.append(step(batch))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return {"losses": [float(x) for x in losses], "step_s": times,
                "mean_step_s": sum(times) / len(times),
                "launches": {n: fn.launches
                             for n, (fn, _) in counters.items()},
                "peak_bytes": torch.cuda.max_memory_allocated()}

    model, step = trainer(sharded=False)
    plain = run(step)
    del model, step
    gc.collect()
    torch.cuda.empty_cache()

    strategy = dist.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "sharding_degree": 1}
    t0 = time.perf_counter()
    fleet.init(strategy=strategy)
    init_s = time.perf_counter() - t0
    model, step = trainer(sharded=True)
    n_params = sum(p.numel() for p in model.parameters())
    leaves = len(step.state["params"])
    mp = run(step)
    comm = dict(step.comm)
    backend = dist.get_backend()
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    want_n, want_bytes = mp_collectives_a_step(layers, TRAIN_SEQ,
                                               cfg.hidden_size)
    tok_s = TRAIN_SEQ / mp["mean_step_s"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(mp["losses"],
                                                  plain["losses"]))
    emit({"phase": "train_mp", "model": "llama3_8b width",
          "layers": layers, "mp": 1, "backend": backend,
          "recompute": "core_attn", "dtype": "bfloat16", "seq": TRAIN_SEQ,
          "batch": 1, "params": n_params, "leaves": leaves,
          "init_s": init_s, "sharded": mp, "compiled": plain,
          "losses_bit_equal": mp["losses"] == plain["losses"],
          "losses_max_rel_gap": rel, "tokens_per_s": tok_s,
          "mfu_6n": 6 * n_params * tok_s / PEAK_BF16_FLOPS,
          "peak_gb": mp["peak_bytes"] / 1e9,
          "comm": comm, "mp_collectives_formula": want_n,
          "mp_bytes_formula": want_bytes,
          "seconds": time.perf_counter() - t_phase})
    check(backend == "nccl", f"train_mp ran on {backend}")
    check(all(math.isfinite(x) for x in mp["losses"]),
          f"train_mp losses {mp['losses']}")
    check(rel <= 1e-5, f"train_mp losses {mp['losses']} off "
                       f"CompiledTrainStep's {plain['losses']} by {rel}")
    for name, (_, per_step) in counters.items():
        got = mp["launches"][name]
        k = leaves if per_step is None else per_step
        check(got == k * MP_STEPS,
              f"train_mp: {name} launched {got} times in {MP_STEPS} "
              f"steps, not {k} a step")
    check((comm["mp_collectives"], comm["mp_bytes"]) ==
          (want_n, want_bytes),
          f"train_mp made {comm['mp_collectives']} mp collectives of "
          f"{comm['mp_bytes']} bytes a step, not {want_n} of {want_bytes}")
    table["fused_update"]["train_mp_launches"] = \
        mp["launches"]["fused_update"]
    for row in shard_rows:
        row["launches"] = mp["launches"][row["launches"]]
        emit({"phase": "kernel_mp_shard", **row, "tolerance": TOL})
    return mp


@contextlib.contextmanager
def counted_forwards(collectives=False):
    """Counts the engine's forwards (``_mixed_forward``,
    ``_paged_prefill_chunk``, ``_decode_forward``) and, with
    ``collectives``, the ``torch.distributed`` collectives the process
    makes (``all_gather_into_tensor``, and every other under "other"),
    while the block runs; yields the counts."""
    import torch.distributed as tdist

    from paddle_tpu_torch.inference import engine as E
    counts = {"forwards": 0, "all_gather_into_tensor": 0, "other": 0}
    saved = [(E, n, getattr(E, n)) for n in (
        "_mixed_forward", "_paged_prefill_chunk", "_decode_forward")]
    if collectives:
        saved += [(tdist, n, getattr(tdist, n)) for n in (
            "all_gather_into_tensor", "all_reduce", "all_gather",
            "reduce_scatter_tensor", "broadcast", "all_to_all_single")]

    def wrap(mod, name, fn):
        key = "forwards" if mod is E else (
            name if name in counts else "other")

        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapped
    try:
        for mod, name, fn in saved:
            setattr(mod, name, wrap(mod, name, fn))
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve_tp_phase(torch, dev, prompts, greedy, greedy_stats, shard_rows):
    """``serve_tp``, the smoke's last phase: the serve mix through
    ``LLMEngine(mesh=serving_mesh(1))`` in an NCCL world of one in this
    process, on ``serve``'s model built again from its seed.  A mesh of
    one shards nothing and each gather copies the one rank's part, so
    the tokens must equal ``serve``'s bit for bit and #1's and #2's
    launches ``serve``'s; every forward makes 4 gathers a layer (128) and
    no other collective, and the engine holds the model's own weights
    (nothing copied).  The process group is torn down at the end.  Then
    the rows of ``tp_shard_kernels`` are printed with their launches
    from this run (the kernel names they carry in ``launches``)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    t_phase = time.perf_counter()
    dist.env.init_parallel_env()
    mesh = dist.topology.serving_mesh(1)
    init_s = time.perf_counter() - t_phase
    model = LlamaForCausalLM(
        llama3_8b_config(), device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    t0 = time.perf_counter()
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    q0 = model.llama.layers[0].self_attn.q_proj.weight
    check(eng._layers[0][1].data_ptr() == q0.data_ptr(),
          "serve_tp copied the weights at tp 1 on the model's card")
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd}
    with counted_forwards(collectives=True) as counts:
        stats, results = serve_run(torch, eng, prompts, counters)
    comm, rows, layers = eng.tp_comm(), eng.cache.memory_rows(), \
        len(eng._layers)
    n_fwd = counts["forwards"]
    calls = {k: v for k, v in counts.items() if k != "forwards"}
    backend = dist.get_backend()
    emit({"phase": "serve_tp", "model": "llama3_8b", "layers": layers,
          "tp": eng.tp, "backend": backend,
          "nccl_version": ".".join(str(v) for v in
                                   torch.cuda.nccl.version()),
          "init_s": init_s, "setup_s": setup_s, **stats,
          "serve_serve_s": greedy_stats["serve_s"],
          "serve_decode_tok_s": greedy_stats["decode_tok_s"],
          "forwards": n_fwd, "gathers": comm["gathers"],
          "gather_bytes": comm["bytes"],
          "gathers_per_forward": comm["gathers"] / max(n_fwd, 1),
          "collective_calls": calls,
          "kv_pool_bytes": rows["device_bytes"],
          "kv_pool_bytes_per_shard": rows["device_bytes_per_shard"]})
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    check(backend == "nccl", f"serve_tp ran on {backend}")
    check(results == greedy,
          "serve_tp's tokens differ from serve's at a mesh of one")
    check(stats["launches"] == greedy_stats["launches"],
          f"serve_tp launched {stats['launches']}, serve "
          f"{greedy_stats['launches']}")
    check(n_fwd > 0 and comm["gathers"] == 4 * layers * n_fwd,
          f"serve_tp gathered {comm['gathers']} times in {n_fwd} "
          f"forwards, not {4 * layers} a forward")
    check(calls == {"all_gather_into_tensor": comm["gathers"], "other": 0},
          f"serve_tp's collectives were {calls}, not its gathers alone")
    check(rows["tp"] == 1 and rows["device_bytes_per_shard"] ==
          rows["device_bytes"], f"serve_tp memory rows {rows}")
    for row in shard_rows:
        if row["launches"] is not None:
            row["launches"] = stats["launches"][row["launches"]]
        emit({"phase": "kernel_tp_shard", **row, "tolerance": TOL})
    emit({"phase": "serve_tp_done", "seconds":
          time.perf_counter() - t_phase,
          "shard_rows": [row["name"] for row in shard_rows]})
    return shard_rows


def serve_run(torch, eng, prompts, counters):
    """Serve ``prompts`` (``SERVE_LENS``' ids: the "b" ones through
    ``begin_request`` + ``step``, then "a200" through ``add_request``),
    SERVE_NEW tokens each, with the kernels' launch counts set to 0 just
    before and read just after.  Checks that every request returns its
    tokens and returns (stats, {rid: tokens})."""
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t_serve = time.perf_counter()
    submit, ttft, toks = {}, {}, {rid: [] for rid in prompts}
    for rid in ("b37", "b128", "b300", "b1000"):
        submit[rid] = time.perf_counter()
        eng.begin_request(rid, prompts[rid], max_new_tokens=SERVE_NEW)
    submit["a200"] = time.perf_counter()
    eng.add_request("a200", prompts["a200"], max_new_tokens=SERVE_NEW)
    ttft["a200"] = time.perf_counter() - submit["a200"]
    toks["a200"] = list(eng.requests["a200"].out)
    steps = decode_steps = decode_tokens = 0
    decode_s = 0.0
    while eng.has_work():
        pure_decode = not eng._prefilling
        t = time.perf_counter()
        new = eng.step()                    # returns host ints: synced
        dt = time.perf_counter() - t
        steps += 1
        now = time.perf_counter()
        for rid, ts in new.items():
            if not toks[rid]:
                ttft[rid] = now - submit[rid]
            toks[rid] += ts
        if pure_decode:
            decode_steps += 1
            decode_s += dt
            decode_tokens += sum(len(v) for v in new.values())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = {n: fn.launches for n, fn in counters.items()}
    results = {rid: eng.result(rid) for rid in prompts}
    for rid, out in results.items():
        check(len(out) == SERVE_NEW and out == toks[rid],
              f"request {rid} returned {len(out)} tokens, not {SERVE_NEW}")
    return {"serve_s": serve_s, "steps": steps, "prompt_lens": SERVE_LENS,
            "tokens": {rid: len(v) for rid, v in results.items()},
            "ttft_s": ttft, "decode_steps": decode_steps,
            "decode_tok_s": decode_tokens / decode_s if decode_s else None,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches}, results


def profile_serve(torch, eng, prompts, max_new):
    """Serve ``prompts`` (deferred admission) under torch.profiler."""
    def serve():
        for rid, ids in prompts.items():
            eng.begin_request(rid, ids, max_new_tokens=max_new)
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
        return steps
    steps, stats = profiled(torch, serve)
    return {"steps": steps, **stats}


def attention_case(torch, gen, dev, s, b=1, h=32, kvh=8):
    """The training path's attention: q [b, s, h, 128] against k/v [b, s,
    kvh, 128], bf16, and an output gradient (Llama-3-8B width: b 1, h 32,
    kvh 8)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    return rnd(b, s, h, 128), rnd(b, s, kvh, 128), rnd(b, s, kvh, 128), \
        rnd(b, s, h, 128)


def causal_pairs(s):
    """(query, key) pairs a causal square attention of length s visits."""
    return s * (s + 1) // 2


def train_batch(np, vocab, batch, seq):
    """``bench.py``'s ``_train_batch``: random ids and next-token labels
    with -100 on the last position."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    labels = np.concatenate(
        [ids[:, 1:], np.full((batch, 1), -100, np.int32)], axis=1)
    return ids, labels


def plain_loss(torch, model, ids, labels):
    """The training loss of ``plain_hidden``: the whole f32 logits and a
    log-softmax cross-entropy (mean over labels other than -100)."""
    x = plain_hidden(torch, model, ids)
    logp = torch.log_softmax((x @ model.lm_head.weight).float(), dim=-1)
    lab = labels.long()
    valid = lab != -100
    tok = -logp.gather(-1, torch.where(valid, lab, 0)[..., None])[..., 0]
    return (tok * valid).sum() / valid.sum()


def flash_check(torch, fa, s, q, k, v, do):
    """The causal flash forward, dQ and dK/dV kernels against their plain
    versions on one bf16 case (q [b, s, h, 128], k/v [b, s, kvh, 128]).  Each
    output is held relative to its values: at 8K an output row averages
    thousands of values and is of order 0.02, while row 0 copies one V
    row (order 1), so an absolute bound or one relative to the largest
    element says little about the long rows.  Returns the errors by
    output."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    got = {"out": out, "dq": fa.flash_attention_bwd_dq(*ops, True)}
    got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(*ops, True)
    del ops
    want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True)))
    want["out"], ref_lse = fa.flash_attention_fwd_reference(q, k, v,
                                                            causal=True)
    torch.cuda.synchronize()
    errs = {"lse_max_abs_err": (lse - ref_lse).abs().max().item()}
    for n, g in got.items():
        w = want[n]
        diff = (g.float() - w.float()).abs()
        errs[n] = {"max_abs_err": diff.max().item(),
                   "max_abs_want": w.float().abs().max().item(),
                   "rel_l2_err": ((g.float() - w.float()).norm()
                                  / w.float().norm()).item(),
                   "rel_to_largest": rel_err(g, w),
                   "elements_differing": int((g != w).sum()),
                   "elements": w.numel()}
    emit({"phase": "check", "what": "flash fwd + bwd, causal",
          "shape": list(q.shape), "kv_heads": k.shape[2], "errors": errs,
          "tolerance": {"lse_max_abs_err": 1e-3, "rel_l2_err": REL_L2_TOL,
                        "rel_to_largest": GRAD_TOL}})
    check(errs["lse_max_abs_err"] <= 1e-3,
          f"causal flash lse off its plain version at {s}: {errs}")
    for n in got:
        check(errs[n]["rel_l2_err"] <= REL_L2_TOL
              and errs[n]["rel_to_largest"] <= GRAD_TOL,
              f"flash {n} off its plain version at {s}: {errs[n]}")
    return errs


def flash_train_kernels(torch, gen, dev, table):
    """The flash forward, dQ and dK/dV kernels at the training path's
    attention: checked against their plain versions at [1, 2048, 32,
    128] and at the 8K training shape (causal, bf16, 8 KV heads), and
    timed at the 8K shape."""
    from paddle_tpu_torch.ops import flash_attention as fa
    flash_check(torch, fa, 2048, *attention_case(torch, gen, dev, 2048))
    torch.cuda.empty_cache()

    q, k, v, do = attention_case(torch, gen, dev, TRAIN_SEQ)
    errs = flash_check(torch, fa, TRAIN_SEQ, q, k, v, do)
    torch.cuda.empty_cache()
    for name, row in flash_train_rows(
            torch, fa, q, k, v, do, errs, FLASH_TRAIN_ROWS).items():
        emit({"phase": "kernel", **row})
        table[name] = row


# the names of the rows of #2, #3 and #4 at the 8K training shape
FLASH_TRAIN_ROWS = ("flash_attention_fwd_causal_8k", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")


def flash_train_rows(torch, fa, q, k, v, do, errs, names):
    """The causal flash forward, dQ and dK/dV kernels (#2-#4) on one bf16
    case (q [1, s, h, 128], k/v [1, s, kvh, 128]), rows named ``names``:
    each timed with CUDA events, beside its plain version, its library
    call and its bound, and traced (the tensor-core route checked);
    ``errs`` are ``flash_check``'s for the case.  Returns {name: row},
    each row with its shape notes."""
    _, s, h, d = q.shape
    hk = k.shape[2]
    pairs = causal_pairs(s)
    el = 2                                       # bf16 bytes
    qb, kb = s * h * d * el, s * hk * d * el      # one q-like, one k-like
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_library():
        sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    # one PyTorch call for the backward: aten's flash backward on K/V
    # repeated to the query heads (it takes no GQA; its dK/dV come per
    # query head, the group sum not included)
    bwd_library, bwd_note = None, None
    try:
        kr, vr = (x.repeat_interleave(h // hk, dim=1) for x in (kt, vt))
        res = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kr, vr, 0.0, True, False)
        lib_args = (dot, qt, kr, vr, res[0], res[1], res[2], res[3],
                    res[4], res[5], 0.0, True, res[6], res[7])

        def bwd_library():
            torch.ops.aten._scaled_dot_product_flash_attention_backward(
                *lib_args)
        bwd_library()
    except Exception as e:             # the yardstick only, never the port
        bwd_library, bwd_note = None, f"aten flash backward: {e}"[:200]
    rows = {}
    for name, src, line, fn, flops, n_bytes, plain, lib, outs in (
            (names[0], "flash_attention_fwd.cu", "flash_attention.py:164",
             lambda: fa.flash_attention_fwd(q, k, v, causal=True),
             4 * d * h * pairs, 2 * qb + 2 * kb + h * s * 4,
             lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True),
             fwd_library, ("out",)),
            (names[1], "flash_attention_bwd.cu", "flash_attention.py:390",
             lambda: fa.flash_attention_bwd_dq(*ops, True),
             6 * d * h * pairs, 3 * qb + 2 * kb + 2 * h * s * 4,
             lambda: fa.flash_attention_bwd_reference(
                 q, k, v, out, lse, do, causal=True), bwd_library, ("dq",)),
            (names[2], "flash_attention_bwd.cu", "flash_attention.py:431",
             lambda: fa.flash_attention_bwd_dkv(*ops, True),
             8 * d * h * pairs, 2 * qb + 4 * kb + 2 * h * s * 4,
             lambda: fa.flash_attention_bwd_reference(
                 q, k, v, out, lse, do, causal=True), bwd_library,
             ("dk", "dv"))):
        bound, bound_by = bound_ms(n_bytes, flops)
        ms = timed_ms(torch, fn, 3, warmup=1)
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": f"paddle_tpu/ops/pallas/{line}",
            "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
            "ms": ms,
            "plain_ms": timed_ms(torch, plain, 1, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None if lib is None else timed_ms(torch, lib, 3,
                                                            warmup=1),
            **traced_kernel(torch, fn),
            "shape": [1, s, h, d], "kv_heads": hk, "causal": True}
        check(rows[name]["design"] == "wgmma",
              f"{name}: the bf16 call did not reach the tensor cores")
        if name != names[0]:
            rows[name]["plain_note"] = "the whole plain backward (dq, dk, dv)"
            rows[name]["library_note"] = bwd_note or \
                f"aten flash backward on K/V repeated to {h} heads"
        torch.cuda.empty_cache()
    return rows


def update_kernel(torch, gen, dev, table):
    """The fused clip + AdamW update on the embedding leaf [128256,
    4096]: bf16 param and grad, f32 moments, lr 1e-4, step 3, clip 0.5."""
    from paddle_tpu_torch.ops import fused_train as ft
    shape = (VOCAB, 4096)
    p = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    g = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(
        torch.bfloat16)
    slots = {"moment1": torch.randn(shape, generator=gen, device=dev) * 1e-4,
             "moment2": torch.rand(shape, generator=gen, device=dev) * 1e-7}
    hyper = {"weight_decay": 0.01, "decoupled": True, "beta1": 0.9,
             "beta2": 0.999, "epsilon": 1e-8}
    scal = torch.tensor([1e-4, 3.0, 0.5], device=dev)

    def plain():
        return ft.fused_update_reference(
            "adam", p, g, slots, lr=scal[0], step_f=scal[1],
            clip_scale=scal[2], hyper=hyper)

    want_p, want_s = plain()
    ft.fused_update_flat("adam", p, g, slots, scalars=scal, has_clip=True,
                         hyper=hyper)
    torch.cuda.synchronize()
    slots_equal = all(torch.equal(slots[k], want_s[k]) for k in slots)
    err = (p.float() - want_p.float()).abs().max().item()
    ulp_ok = bool(((p.float() - want_p.float()).abs()
                   <= 2 ** -7 * want_p.float().abs()).all())
    del want_p, want_s
    check(slots_equal, "update kernel's moments differ from its plain "
                       "version")
    check(ulp_ok, f"update kernel's params off their plain version by "
                  f"more than one bf16 ulp (max abs {err})")
    n = p.numel()
    # 22 bytes an element: p 2 + 2, g 2, two f32 moments 4 + 4 each
    bound, bound_by = bound_ms(22 * n, ft.update_flop_estimate(
        "adam", n, has_clip=True), peak=PEAK_F32_FLOPS)
    row = {"name": "fused_update", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/fused_update.cu",
           "replaces": "paddle_tpu/ops/pallas/fused_train.py:168",
           "max_abs_err": err,
           "ms": timed_ms(torch, lambda: ft.fused_update_flat(
               "adam", p, g, slots, scalars=scal, has_clip=True,
               hyper=hyper), 10),
           "plain_ms": timed_ms(torch, plain, 2, warmup=1),
           "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    emit({"phase": "kernel", **row, "shape": list(shape),
          "slots_bitwise_equal": slots_equal,
          "library_note": "no PyTorch call folds a global-norm clip into "
                          "AdamW over bf16 params with f32 moments"})
    table["fused_update"] = row


def rel_l2(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def host_us(torch, fn, calls=1000):
    """Host microseconds a call of ``fn`` over ``calls`` calls, none
    synchronised (a CPU timer; at a shape whose device time is below the
    host's, so the launch queue never fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def add_norm_bwd_row(torch, table, name, fwd, h, w, b, dh, dy, eps, tol):
    """The add+norm backward kernel (``add_norm_bwd`` + its partials'
    ``add_norm_bwd_reduce``) on the forward kernel's h, held against the
    plain backward (dx, dw, db within ``tol`` relative L2; dw and db the
    same bits on a second call), timed, traced and bounded: h, dy, dh
    (when given) and the weight read, dx, dw (and db) written.  The
    library figure is ``native_layer_norm_backward`` for the LayerNorm
    body, from h with its statistics; RMSNorm's is
    ``_fused_rms_norm_backward`` where this PyTorch has it."""
    from paddle_tpu_torch.ops import fused_train as ft
    ln = fwd == "add_layer_norm"
    if ln:
        def run():
            return ft.add_layer_norm_backward_raw(h, w, b, dh, dy, eps)

        def plain():
            return ft.add_layer_norm_backward_reference(h, w, b, dh, dy, eps)
    else:
        def run():
            return ft.add_rms_norm_backward_raw(h, w, dh, dy, eps)

        def plain():
            return ft.add_rms_norm_backward_reference(h, w, dh, dy, eps)
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    errs = {k: rel_l2(g, wn) for k, g, wn in zip(("dx", "dw", "db"), got,
                                                 want) if wn is not None}
    same = all(torch.equal(g, a) for g, a in zip(got[1:], again[1:])
               if g is not None)
    check(all(e <= tol for e in errs.values()),
          f"{name} off its plain version: relative L2 {errs}")
    check(same, f"{name}: dw / db differ between two calls")
    n, hdim = h.numel(), h.shape[-1]
    el, ew = h.element_size(), w.element_size()
    n_bytes = (n * (2 * el + dy.element_size() + (el if dh is not None
                                                  else 0))
               + hdim * ew * (2 + (b is not None)))
    bound, bound_by = bound_ms(n_bytes, (16 if ln else 12) * n,
                               peak=PEAK_F32_FLOPS)
    library, note = None, None
    if ln:
        _, mean, rstd = torch.ops.aten.native_layer_norm(h, [hdim], w, b,
                                                         eps)
        dyl = dy.to(h.dtype)

        def lib_call():
            torch.ops.aten.native_layer_norm_backward(
                dyl, h, [hdim], mean, rstd, w, b, [True, True, b is not None])
        library = timed_ms(torch, lib_call, 20)
        note = ("torch.ops.aten.native_layer_norm_backward from h and its "
                "mean and rstd (dx, dw, db; no dh added)")
    else:
        rms_bwd = getattr(torch.ops.aten, "_fused_rms_norm_backward", None)
        try:
            _, rstd = torch.ops.aten._fused_rms_norm(h, [hdim], w, eps)
            dyl = dy.to(h.dtype)

            def lib_call():
                rms_bwd(dyl, h, [hdim], rstd, w, [True, True])
            lib_call()
            library = timed_ms(torch, lib_call, 20)
            note = ("torch.ops.aten._fused_rms_norm_backward from h and "
                    "its rstd (dx, dw; no dh added)")
        except (AttributeError, NotImplementedError, RuntimeError,
                TypeError) as e:
            note = (f"no PyTorch call computes RMSNorm's backward here "
                    f"({type(e).__name__})")
    row = {"name": name, "route": "cuda",
           "source": "paddle_tpu_torch/csrc/add_norm.cu",
           "replaces": "paddle_tpu/ops/pallas/fused_train.py:322",
           "launches": None,
           "max_abs_err": (got[0].float() - want[0].float()).abs().max()
           .item(),
           "ms": timed_ms(torch, run, 20),
           "device_ms": traced_kernel(torch, run, "add_norm_bwd")[
               "device_ms"],
           "plain_ms": timed_ms(torch, plain, 5),
           "bound_ms": bound, "bound_by": bound_by, "library_ms": library}
    emit({"phase": "kernel", **row, "body": fwd, "shape": list(h.shape),
          "dtype": str(h.dtype), "dh": dh is not None, "rel_l2_err": errs,
          "dw_db_bitwise_repeat": same, "tolerance": {"rel_l2_err": tol},
          "host_us": host_us(torch, lambda: (ft.add_layer_norm_backward_raw(
              h[:1, :8], w, b, None, dy[:1, :8], eps) if ln else
              ft.add_rms_norm_backward_raw(h[:1, :8], w, None, dy[:1, :8],
                                           eps))),
          "library_note": note})
    table[name] = row
    del got, again, want


def add_norm_kernel(torch, gen, dev, table):
    """The add+norm kernel (#9) at its paths' shapes, forward and
    backward: the RMS body at the Llama training path's post-attention
    residual add, x (the attention output) and r (the residual) [1, 8192,
    4096] bf16, w [4096] bf16 (h equal to its plain version, y within
    2^-7 relative L2; the backward with h's own gradient, as the residual
    stream carries it); the LayerNorm body with a bias at the post-norm
    encoder layer's shape (``encoder_bias``), [8, 1024, 768] f32 (h
    equal, y within 1e-5 relative L2; the backward without dh: the layer
    drops h).  ``host_us``: the wrapper's host time a call at a one-block
    shape."""
    from paddle_tpu_torch.ops import fused_train as ft
    for name, shape, dt, tol in (
            ("add_rms_norm", (1, TRAIN_SEQ, 4096), torch.bfloat16,
             REL_L2_TOL),
            ("add_layer_norm", (GPT_BATCH, GPT_SEQ, GPT_WIDTH),
             torch.float32, F32_REL_L2_TOL)):
        hdim = shape[-1]
        x, r = (torch.randn(shape, generator=gen, device=dev, dtype=dt)
                for _ in range(2))
        w = (1 + 0.1 * torch.randn(hdim, generator=gen, device=dev)).to(dt)
        b = (0.1 * torch.randn(hdim, generator=gen, device=dev)).to(dt)
        if name == "add_rms_norm":
            vectors, flops = 1, 5

            def run():
                return ft.add_rms_norm_raw(x, r, w, 1e-5)

            def plain():
                return ft.add_rms_norm_reference(x, r, w, 1e-5)

            def small():
                return ft.add_rms_norm_raw(x[:, :8], r[:, :8], w, 1e-5)
        else:
            vectors, flops = 2, 9

            def run():
                return ft.add_layer_norm_raw(x, r, w, b, 1e-5)

            def plain():
                return ft.add_layer_norm_reference(x, r, w, b, 1e-5)

            def small():
                return ft.add_layer_norm_raw(x[:1, :8], r[:1, :8], w, b,
                                             1e-5)
        n, el = x.numel(), x.element_size()
        (h, y), (want_h, want_y) = run(), plain()
        torch.cuda.synchronize()
        err = rel_l2(y, want_y)
        check(torch.equal(h, want_h), f"{name}: h differs from r + x")
        check(err <= tol, f"{name} kernel off its plain version: "
                          f"relative L2 {err}")
        # x and r read, h and y written, the weight (and bias)
        bound, bound_by = bound_ms(4 * n * el + vectors * hdim * el,
                                   flops * n, peak=PEAK_F32_FLOPS)
        row = {"name": "add_norm" if name == "add_rms_norm" else name,
               "route": "cuda", "source": "paddle_tpu_torch/csrc/add_norm.cu",
               "replaces": "paddle_tpu/ops/pallas/fused_train.py:322",
               "max_abs_err": (y.float() - want_y.float()).abs().max().item(),
               "ms": timed_ms(torch, run, 20),
               "device_ms": traced_kernel(torch, run, "add_norm")[
                   "device_ms"],
               "plain_ms": timed_ms(torch, plain, 5),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        emit({"phase": "kernel", **row, "body": name, "shape": list(shape),
              "dtype": str(dt), "rel_l2_err": err, "h_equal": True,
              "tolerance": {"rel_l2_err": tol},
              "host_us": host_us(torch, small),
              "library_note": "no single PyTorch call adds the residual "
                              "and normalises"})
        table[row["name"]] = row
        del x, r, want_h, want_y
        dy = torch.randn(shape, generator=gen, device=dev, dtype=y.dtype)
        rms = name == "add_rms_norm"
        dh = torch.randn(shape, generator=gen, device=dev, dtype=dt) \
            if rms else None
        add_norm_bwd_row(torch, table, row["name"] + "_bwd", name, h, w,
                         None if rms else b, dh, dy, 1e-5, tol)
        del h, y, dy, dh


def matmul_rope_kernel(torch, np, gen, dev, table):
    """The matmul+rope kernel (#10) at the training shape: x [1, 8192,
    4096] bf16 against Wq [4096, 4096] (32 heads) and Wk [4096, 1024] (8
    heads), head_dim 128, the rope tables [8192, 128] in bf16 as amp O2
    leaves them; each within 2^-7 relative L2 of its plain version.  The
    library figure is torch.matmul of the same product alone.  Then the
    f32 path (exact FMA products) at seq 1024 against its plain version
    (relative L2 1e-5: f32 sums in another order).  Each traced kernel
    must be the tensor-core one for bf16 and the FMA one for f32."""
    from paddle_tpu_torch.models.llama import _rope_cos_sin
    from paddle_tpu_torch.ops import fused_train as ft
    s, hidden, hd = TRAIN_SEQ, 4096, 128
    ang = _rope_cos_sin(s, hd, 500000.0)
    cos, sin = (torch.from_numpy(f(ang)).to(dev, torch.bfloat16)
                for f in (np.cos, np.sin))
    x = torch.randn((1, s, hidden), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    for proj, heads in (("q", 32), ("k", 8)):
        w = (0.02 * torch.randn(hidden, heads * hd, generator=gen,
                                device=dev)).to(torch.bfloat16)
        row = matmul_rope_row(torch, ft, x, w, cos, sin, heads, hd, proj)
        emit({"phase": "kernel", **row})
        if proj == "q":
            table["matmul_rope"] = row
    s32 = min(1024, s)
    x32 = torch.randn((1, s32, hidden), generator=gen, device=dev)
    w32 = 0.02 * torch.randn(hidden, 32 * hd, generator=gen, device=dev)
    c32, s32t = cos[:s32].float(), sin[:s32].float()
    got = ft.matmul_rope_raw(x32, w32, c32, s32t, n_heads=32, head_dim=hd)
    want = ft.matmul_rope_reference(x32, w32, c32, s32t, 32, hd)
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    def run32():
        return ft.matmul_rope_raw(x32, w32, c32, s32t, n_heads=32,
                                  head_dim=hd)

    traced = traced_kernel(torch, run32, "matmul_rope")
    bound, bound_by = bound_ms(
        (x32.numel() + w32.numel() + got.numel() + 2 * s32 * hd) * 4,
        2 * s32 * hidden * w32.shape[1], peak=PEAK_F32_FLOPS)
    # the library's yardstick, timed only: the same product alone in full
    # f32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "check", "what": "matmul_rope f32 (FMA path)",
          "shape": [1, s32, hidden], "heads": 32, "rel_l2_err": err,
          "tolerance": 1e-5, "ms": timed_ms(torch, run32, 5),
          "plain_ms": timed_ms(torch, lambda: ft.matmul_rope_reference(
              x32, w32, c32, s32t, 32, hd), 5),
          "bound_ms": bound, "bound_by": bound_by, "bound_peak": F32_FMA_NOTE,
          "library_ms": timed_ms(torch, lambda: torch.matmul(x32, w32), 10),
          "library_note": "torch.matmul of the product alone, f32 with "
                          "allow_tf32 False", **traced})
    check(err <= 1e-5, f"f32 matmul_rope off its plain version: {err}")
    check(traced["design"] == "fma",
          f"f32 matmul_rope left the FMA pipe: {traced}")


def matmul_rope_row(torch, ft, x, w, cos, sin, heads, hd, proj, name=None):
    """#10 on one bf16 projection (x [1, s, hidden] @ w [hidden, heads *
    hd], rope from the [s, hd] tables) within 2^-7 relative L2 of its
    plain version, timed beside it, its bound and torch.matmul of the
    product alone (the library figure), and traced (the tensor-core
    route checked).  Returns the row, with its shape notes."""
    s, hidden = x.shape[1], x.shape[2]

    def run():
        return ft.matmul_rope_raw(x, w, cos, sin, n_heads=heads, head_dim=hd)

    def plain():
        return ft.matmul_rope_reference(x, w, cos, sin, heads, hd)

    got, want = run(), plain()
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    check(got.shape == (1, s, heads, hd) and err <= REL_L2_TOL,
          f"matmul_rope ({proj}, {heads} heads) off its plain version: "
          f"relative L2 {err}")
    n_out = s * heads * hd
    bound, bound_by = bound_ms(
        (x.numel() + w.numel() + n_out + 2 * s * hd) * 2,
        2 * s * hidden * heads * hd)
    row = {"name": name or "matmul_rope", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/matmul_rope.cu",
           "replaces": "paddle_tpu/ops/pallas/fused_train.py:501",
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "ms": timed_ms(torch, run, 10),
           "plain_ms": timed_ms(torch, plain, 5),
           "bound_ms": bound, "bound_by": bound_by,
           "library_ms": timed_ms(torch, lambda: torch.matmul(x, w), 10),
           **traced_kernel(torch, run, "matmul_rope"),
           "projection": proj, "shape": [1, s, hidden], "heads": heads,
           "head_dim": hd, "rel_l2_err": err,
           "tolerance": {"rel_l2_err": REL_L2_TOL},
           "library_note": "torch.matmul of the product alone (no rope)"}
    check(row["design"] == "wgmma",
          f"matmul_rope ({proj}, {heads} heads): the bf16 call did not "
          f"reach the tensor cores")
    return row


def train_phase(torch, np, dev, table, *, phase, layers, fused):
    """Llama-3-8B width, ``layers`` layers, bf16 (amp O2), seq 8192,
    batch 1: the recipe's model -> decorate -> AdamW(clip) ->
    CompiledTrainStep, TRAIN_STEPS steps on one repeated batch, then one
    traced step.  ``fused``: the headline recipe's fused regions
    (``fuse_norm_rope=True``) with ``core_attn`` remat; else the unfused
    chain without remat.  Every kernel of the path must launch exactly
    as often as the model's structure says."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = dataclasses.replace(llama3_8b_config(), num_hidden_layers=layers,
                              fuse_norm_rope=fused, recompute=fused,
                              recompute_granularity="core_attn")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED + 2))
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=1e-4,
                          parameters=model.parameters(),
                          grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        model, lambda m, b: m(b["input_ids"], labels=b["labels"]), opt)
    ids, labels = train_batch(np, cfg.vocab_size, 1, TRAIN_SEQ)
    batch = {"input_ids": torch.tensor(ids, device=dev),
             "labels": torch.tensor(labels, device=dev)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = torch.cuda.memory_allocated()   # params and moments

    # kernel: (wrapper, launches a step).  The update runs once for each
    # of the 7 projections of a layer, the embedding and the head, and
    # once for the packed norm weights.  Under core_attn the recompute
    # reruns the add+norm and the q and k matmul+rope kernels of every
    # layer, but not the flash forward (its output is kept); the add+norm
    # backward runs once a layer.
    counters = {
        "flash_attention_fwd": (fa.flash_attention_fwd, layers),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, layers),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, layers),
        "fused_update": (ft.fused_update_flat, 7 * layers + 3)}
    if fused:
        counters["add_norm"] = (ft.add_rms_norm_raw, 2 * layers)
        counters["add_norm_bwd"] = (ft.add_rms_norm_backward_raw, layers)
        counters["matmul_rope"] = (ft.matmul_rope_raw, 4 * layers)
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {n: fn.launches for n, (fn, _) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = sum(times[1:]) / (len(times) - 1)    # the first one warms up
    tok_s = TRAIN_SEQ / step_s
    h = cfg.hidden_size
    # the loss at initialisation: the final RMSNorm gives every token a
    # hidden vector of norm sqrt(h), so its logits are N(0, sigma^2) with
    # sigma = initializer_range * sqrt(h) (1.28 here), and the mean
    # cross-entropy is ln V + sigma^2 / 2 (12.58), not ln V (11.76)
    sigma = cfg.initializer_range * math.sqrt(h)
    init_loss = math.log(cfg.vocab_size) + sigma ** 2 / 2
    f6n = 6 * n_params
    fattn = f6n + 6 * layers * TRAIN_SEQ * h
    emit({"phase": phase, "model": "llama3_8b width", "layers": layers,
          "fuse_norm_rope": fused,
          "recompute": "core_attn" if fused else None,
          "dtype": "bfloat16", "seq": TRAIN_SEQ, "batch": 1,
          "params": n_params, "setup_s": setup_s, "step_s": times,
          "mean_step_s": step_s, "tokens_per_s": tok_s,
          "mfu_6n": f6n * tok_s / PEAK_BF16_FLOPS,
          "mfu_6n_attn": fattn * tok_s / PEAK_BF16_FLOPS,
          "losses": losses, "ln_vocab": math.log(cfg.vocab_size),
          "expected_first_loss": init_loss,
          "state_bytes": state_bytes, "max_memory_allocated": peak,
          "launches": launches,
          "launches_per_step": {n: c / TRAIN_STEPS
                                for n, c in launches.items()}})
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - init_loss) <= 0.5,
          f"first loss {losses[0]} not within 0.5 of {init_loss}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(peak < 80e9, f"peak memory {peak} bytes, not under 80 GB")
    for n, (_, per_step) in counters.items():
        check(launches[n] == per_step * TRAIN_STEPS,
              f"{n} launched {launches[n]} times in {TRAIN_STEPS} steps, "
              f"not {per_step} a step")
    table["flash_attention_fwd_causal_8k"]["launches"] = \
        launches["flash_attention_fwd"]
    for n in launches:
        if n != "flash_attention_fwd":
            table[n]["launches"] = launches[n]

    _, prof = profiled(torch, lambda: step(batch))
    emit({"phase": f"{phase}_profile", **prof})
    check_tensor_core_route(prof, phase, FLASH_FAMILIES + (
        ("matmul_rope",) if fused else ()))
    check(not fused or prof["kernel_count_by_family"].get("add_norm_bwd"),
          f"{phase}: the add+norm backward kernel was not traced")


FLASH_FAMILIES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
GROUPED_FAMILIES = ("grouped_matmul", "grouped_matmul_glu",   # #11, #12,
                    "grouped_matmul_dw")                      # #13


def check_tensor_core_route(prof, phase, families=FLASH_FAMILIES,
                            design="wgmma"):
    """A traced run's launches of each family reached only the kernels
    of ``design`` (a bf16 step: the wgmma ones; f32 attention: the 3xTF32
    forward and dK/dV; f32 MoE serving: the streaming #11; the split
    decode path: the span-split #7): the family was traced, and every
    traced kernel of it has that design."""
    for fam in families:
        names = [n for n in prof["routed_kernel_ms"]
                 if kernel_family(n) == fam]
        check(names and all(design_of(n) == design for n in names),
              f"{phase}: {fam} kernels off the "
              f"{'tensor-core' if design == 'wgmma' else design} route: "
              f"{names}")


def train_reference_phase(torch, np, dev):
    """At f32 (full matmul precision), full width, 2 layers, seq 1024:
    the loss and every gradient of ``grad_step`` (the kernels) against
    ``plain_loss`` (plain versions, autograd) -- for the unfused chain,
    and for the fused chain (the add+norm and matmul+rope kernels) with
    recompute off and under each policy, from the same weights -- then
    one fused update against its plain version on the same gradients."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, clip_scale
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    layers = 2

    def build(fused):
        cfg = dataclasses.replace(llama3_8b_config(),
                                  num_hidden_layers=layers,
                                  fuse_norm_rope=fused)
        model = LlamaForCausalLM(
            cfg, device=dev, dtype=torch.float32,
            generator=torch.Generator(device=dev).manual_seed(SEED + 3))
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              grad_clip=ClipGradByGlobalNorm(1.0))
        return model, opt, CompiledTrainStep(
            model, lambda m, b: m(b["input_ids"], labels=b["labels"]), opt)

    model, opt, step = build(False)
    ids, labels = train_batch(np, model.config.vocab_size, 1, 1024)
    batch = {"input_ids": torch.tensor(ids, device=dev),
             "labels": torch.tensor(labels, device=dev)}
    loss, grads = step.grad_step(batch)
    params = step.state["params"]
    want_loss = plain_loss(torch, model, batch["input_ids"],
                           batch["labels"])
    want_grads = dict(zip(params, torch.autograd.grad(
        want_loss, list(params.values()))))
    wl = float(want_loss.detach())
    del want_loss

    def errors(loss, grads):
        rel = {n: ((grads[n] - w).norm() / w.norm()).item()
               for n, w in want_grads.items()}
        worst = max(rel, key=rel.get)
        return abs(float(loss) - wl) / abs(wl), rel, worst

    loss_rel, grad_rel, worst = errors(loss, grads)

    # the fused chain from the same weights, under each policy; the
    # recompute must not relaunch the flash forward under core_attn
    fmodel, _, fstep = build(True)
    fused = {}
    for policy, flash_per_layer in ((None, 1), ("full", 2),
                                    ("core_attn", 1), ("dots", 2)):
        fmodel.config.recompute = policy is not None
        fmodel.config.recompute_granularity = policy or "full"
        fa.flash_attention_fwd.launches = 0
        ft.matmul_rope_raw.launches = 0
        floss, fgrads = fstep.grad_step(batch)
        f_loss_rel, f_rel, f_worst = errors(floss, fgrads)
        fused[str(policy)] = {
            "loss_rel_err": f_loss_rel, "grad_rel_l2_max": f_rel[f_worst],
            "grad_rel_l2_worst": f_worst,
            "flash_fwd_launches": fa.flash_attention_fwd.launches,
            # the f32 matmul+rope (#10's FMA-pipe route) in one step
            "matmul_rope_launches": ft.matmul_rope_raw.launches}
        check(f_loss_rel <= 1e-5 and f_rel[f_worst] <= 1e-4,
              f"fused chain, recompute {policy}: loss off the plain "
              f"composition by {f_loss_rel}, gradient {f_worst} by "
              f"{f_rel[f_worst]}")
        check(fa.flash_attention_fwd.launches == flash_per_layer * layers,
              f"recompute {policy}: the flash forward launched "
              f"{fa.flash_attention_fwd.launches} times in one step")
        del fgrads
    del fmodel, fstep, want_grads

    # one fused update: every leaf against the plain version, from the
    # same grads, lr, step 1 and clip scale (the slots start at zero)
    names = sorted(params)
    old = {n: params[n].detach().clone() for n in names}
    scale = clip_scale([grads[n] for n in names], 1.0)
    lr, step_f = torch.tensor(1e-4, device=dev), torch.tensor(1.0,
                                                              device=dev)
    step.apply_grads(grads)
    upd_err, slots_equal = 0.0, True
    hyper = opt._fused_hyper()
    with torch.no_grad():
        for n in names:
            zeros = {k: torch.zeros_like(old[n]) for k in ("moment1",
                                                           "moment2")}
            want_p, want_s = ft.fused_update_reference(
                "adam", old[n], grads[n], zeros, lr=lr, step_f=step_f,
                clip_scale=scale, hyper=hyper)
            got_s = step.state["opt"]["slots"][n]
            slots_equal &= all(torch.equal(got_s[k], want_s[k])
                               for k in want_s)
            upd_err = max(upd_err, rel_err(params[n], want_p))
    emit({"phase": "train_reference", "dtype": "float32",
          "layers": layers, "seq": 1024, "loss": float(loss),
          "loss_rel_err": loss_rel, "grad_rel_l2_max": grad_rel[worst],
          "grad_rel_l2_worst": worst, "grad_rel_l2": grad_rel,
          "fused_chain_by_recompute": fused,
          "update_param_rel_err": upd_err,
          "update_slots_bitwise_equal": slots_equal,
          "tolerance": {"loss_rel": 1e-5, "grad_rel_l2": 1e-4,
                        "update_param_rel": 1e-6}})
    check(loss_rel <= 1e-5, f"f32 loss off the plain composition by "
                            f"{loss_rel} (relative)")
    check(grad_rel[worst] <= 1e-4, f"gradient {worst} off the plain "
                                   f"composition by {grad_rel[worst]}")
    check(slots_equal and upd_err <= 1e-6,
          f"fused update off its plain version: slots equal "
          f"{slots_equal}, params {upd_err}")


# ---------------------------------------------------------------------------
# Qwen1.5-MoE-A2.7B: the grouped matmul kernels, serving and training
# ---------------------------------------------------------------------------

MOE_E, MOE_K, MOE_H, MOE_F = 60, 4, 2048, 1408


def group1_kernels(torch, gen, dev, table):
    """The ragged kernel and the flash forward at GQA group 1 (16 query
    and 16 KV heads, D 128: Qwen1.5-MoE-A2.7B's attention), held against
    their plain versions and timed: the unified step's ragged shapes, the
    prefill chunk, and the causal forward, dQ and dK/dV at the MoE
    training shape [4, 4096, 16, 128] (rows of the kernel table, their
    launches from ``train_moe``)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    args, n_bytes, flops = ragged_case(torch, gen, dev, H=16, KVH=16)
    pools = (args["k_pages"], args["v_pages"])
    kp_k, vp_k = (p.clone() for p in pools)
    kp_p, vp_p = (p.clone() for p in pools)

    def ragged(fn, kp, vp):
        return fn(args["q"], kp, vp, args["k_new"], args["v_new"],
                  args["q_start"], args["q_len"], args["kv_len"],
                  args["page_tables"])

    got = ragged(pa.ragged_paged_append_attend, kp_k, vp_k)
    want = ragged(pa.ragged_paged_append_attend_reference, kp_p, vp_p)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(kp_k, kp_p) and torch.equal(vp_k, vp_p),
          "ragged kernel (group 1) appended other K/V than its plain "
          "version")
    check(err <= TOL, f"ragged kernel (group 1) off its plain version by "
                      f"{err}")
    key = "ragged_paged_append_attend_group1"
    table[key] = ragged_row(
        torch, key,
        lambda: ragged(pa.ragged_paged_append_attend, kp_k, vp_k),
        lambda: ragged(pa.ragged_paged_append_attend_reference, kp_p, vp_p),
        err, bound_ms(n_bytes, flops), "mma")
    emit({"phase": "kernel", **table[key], "group": 1, "heads": 16,
          "kv_heads": 16, "tolerance": TOL})
    del args, pools, kp_k, vp_k, kp_p, vp_p, got, want

    args, n_bytes, flops = flash_case(torch, gen, dev, H=16, KVH=16)
    kw = dict(causal=False, mask=args["mask"])
    out, lse = fa.flash_attention_fwd(args["q"], args["k"], args["v"], **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(
        args["q"], args["k"], args["v"], **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    check(err <= TOL and lse_err <= 1e-3,
          f"flash kernel (group 1) off its plain version by {err} (lse "
          f"{lse_err})")
    qt, kt, vt = (args[n].transpose(1, 2) for n in ("q", "k", "v"))
    mask_b = args["mask"].to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, bound_by = bound_ms(n_bytes, flops)
    emit({"phase": "kernel", "name": "flash_attention_fwd", "group": 1,
          "shape": list(args["q"].shape), "kv_len": args["k"].shape[1],
          "max_abs_err": err, "lse_max_abs_err": lse_err, "tolerance": TOL,
          "ms": timed_ms(torch, lambda: fa.flash_attention_fwd(
              args["q"], args["k"], args["v"], **kw), 20),
          "plain_ms": timed_ms(torch, lambda: fa.flash_attention_fwd_reference(
              args["q"], args["k"], args["v"], **kw), 5),
          "bound_ms": bound, "bound_by": bound_by,
          "library_ms": timed_ms(torch, lambda: sdpa(qt, kt, vt,
                                                     attn_mask=mask_b), 20),
          **traced_kernel(torch, lambda: fa.flash_attention_fwd(
              args["q"], args["k"], args["v"], **kw))})
    del args, out, lse, ref_out, ref_lse, qt, kt, vt, mask_b

    s, b, h, d = MOE_SEQ, MOE_BATCH, 16, 128
    q, k, v, do = attention_case(torch, gen, dev, s, b=b, h=h, kvh=h)
    errs = flash_check(torch, fa, s, q, k, v, do)
    torch.cuda.empty_cache()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    res = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False)
    lib_args = (dot, qt, kt, vt, res[0], res[1], res[2], res[3], res[4],
                res[5], 0.0, True, res[6], res[7])

    def plain_bwd():
        fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True)

    def bwd_library():
        torch.ops.aten._scaled_dot_product_flash_attention_backward(
            *lib_args)

    cost = attention_cost(b, s, h, h, d, 2)
    for name, key, line, fn, plain, lib, outs in (
            ("flash_attention_fwd_moe", "fwd", "flash_attention.py:164",
             lambda: fa.flash_attention_fwd(q, k, v, causal=True),
             lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True),
             lambda: sdpa(qt, kt, vt, is_causal=True), ("out",)),
            ("flash_attention_bwd_dq_moe", "dq", "flash_attention.py:390",
             lambda: fa.flash_attention_bwd_dq(*ops, True), plain_bwd,
             bwd_library, ("dq",)),
            ("flash_attention_bwd_dkv_moe", "dkv", "flash_attention.py:431",
             lambda: fa.flash_attention_bwd_dkv(*ops, True), plain_bwd,
             bwd_library, ("dk", "dv"))):
        flops, n_bytes = cost[key]
        bound, bound_by = bound_ms(n_bytes, flops)
        src = "flash_attention_fwd.cu" if key == "fwd" \
            else "flash_attention_bwd.cu"
        row = {"name": name, "route": "cuda",
               "source": f"paddle_tpu_torch/csrc/{src}",
               "replaces": f"paddle_tpu/ops/pallas/{line}",
               "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
               "ms": timed_ms(torch, fn, 3, warmup=1),
               "plain_ms": timed_ms(torch, plain, 1, warmup=1),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": timed_ms(torch, lib, 3, warmup=1),
               **traced_kernel(torch, fn)}
        check(row["design"] == "wgmma",
              f"{name}: the bf16 call did not reach the tensor cores")
        emit({"phase": "kernel", **row, "group": 1, "causal": True,
              "shape": [b, s, h, d],
              "library_note": "scaled_dot_product_attention" if key == "fwd"
              else "aten flash backward (dq, dk, dv)",
              "plain_note": None if key == "fwd"
              else "the whole plain backward (dq, dk, dv)"})
        table[name] = row
        torch.cuda.empty_cache()
    del q, k, v, do, qt, kt, vt, dot, ops, out, lse, res, lib_args
    torch.cuda.empty_cache()


def moe_plan_rows(torch, gen, dev, tokens, h, dtype, empty=None, e=MOE_E,
                  k=MOE_K):
    """Routes of ``tokens`` tokens to ``k`` distinct of ``e`` experts (4
    of 60 by default: the top k of random router scores; expert
    ``empty`` is never chosen), their dropless plan at the reference's
    row tile, and random rows scattered into the padded buffer (padding
    rows zero).  Returns (xs, tile_expert, counts, tm)."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    scores = torch.rand(tokens, e, generator=gen, device=dev)
    if empty is not None:
        scores[:, empty] = -1.0
    idx = scores.topk(k, dim=-1).indices
    tm = gm._auto_tm(e, tokens * k)
    _, dest, te, counts, m_pad = gm.make_dropless_plan(idx, e, tm)
    rows = torch.randn(tokens * k, h, generator=gen, device=dev)
    xs = torch.zeros(m_pad, h, device=dev, dtype=dtype).index_copy_(
        0, dest, rows.to(dtype))
    return xs, te, counts, tm


def grouped_mm_library(torch, counts, tm, a, b):
    """One ``torch._grouped_mm`` call over the padded expert groups of
    a (bf16) against b, for timing only; (fn, note) or (None, why)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "this PyTorch has no torch._grouped_mm"
    offs = torch.cumsum((counts + tm - 1) // tm * tm, 0).to(torch.int32)
    try:
        torch._grouped_mm(a, b, offs=offs)
        torch.cuda.synchronize()
    except Exception as e:              # the yardstick only, never the port
        return None, f"torch._grouped_mm: {e}"[:200]
    return (lambda: torch._grouped_mm(a, b, offs=offs)), \
        "torch._grouped_mm over the padded expert groups (timed only)"


def glu_composed(torch, counts, tm, xs, wg, wu):
    """#12's yardstick where no one PyTorch call computes it: two
    ``torch._grouped_mm`` calls (gate and up over the padded expert
    groups) and ``silu(g) * u``, for timing only; (fn, note) or (None,
    why)."""
    gate, note = grouped_mm_library(torch, counts, tm, xs, wg)
    if gate is None:
        return None, note
    up, _ = grouped_mm_library(torch, counts, tm, xs, wu)
    silu = torch.nn.functional.silu
    return (lambda: silu(gate()) * up()), \
        "two torch._grouped_mm calls and silu(g) * u (timed only)"


def moe_kernels(torch, gen, dev, table):
    """#11 (gmm), #12 (gmm_glu) and #13 (gmm_dw) at the MoE paths'
    shapes, each against its plain version and timed:

    - serving, one mixed step of 136 rows x top-4 (544 slots, tm 128,
      m_pad 8,320): #11 with f32 rows against the bf16 gate stack
      [60, 2048, 1408] and down stack [60, 1408, 2048], and one pure
      decode step of 8 rows (32 slots, m_pad 7,808) against the gate
      stack (``gmm_rows_stream``, relative L2 1e-5; padding rows and dead
      tiles exactly 0);
    - training, 4 x 4096 tokens x top-4 (65,536 slots, tm 256, m_pad
      80,896; expert 59 gets no rows, so #13's zero expert shows): #11
      forward (down), #11 transpose_w for the down and gate dX, #12 with
      and without save_pre, #13 for the gate and down weights (bf16, all
      on wgmma; relative L2 2^-7; #13's empty expert exactly zero).

    Each row carries ``design`` and ``device_ms`` from a trace of its
    call (wgmma for bf16, stream for the f32 rows), and fails on another
    design; #12's rows carry ``composed_ms``, two ``torch._grouped_mm``
    calls and ``silu(g) * u`` (``glu_composed``).

    bound_ms counts the FLOPs of the routed rows only and the bytes of
    the routed lhs rows, the weights of the experts with rows, and the
    output of the routed rows (for #13 the whole [E, K, N] output)."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    E, H, F = MOE_E, MOE_H, MOE_F
    bf = torch.bfloat16

    def stack(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(shape[1])).to(bf)

    wg, wu, wd = stack(E, H, F), stack(E, H, F), stack(E, F, H)

    def cost(counts, k, n, el_a, el_w, el_o, n_w=1, n_out=1):
        routed = int(counts.sum())
        live = int((counts > 0).sum())
        flops = 2 * n_w * routed * k * n
        n_bytes = routed * k * el_a + n_w * live * k * n * el_w \
            + n_out * routed * n * el_o
        return bound_ms(n_bytes, flops)

    def run_case(name, fn, plain, tol, bound, library, note, design=None,
                 composed=None, **extra):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [rel_l2(g, w) for g, w in zip(got, want)]
        abs_err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
        check(max(errs) <= tol, f"{name} ({note}) off its plain version: "
                                f"relative L2 {errs}")
        lib_fn, lib_note = library
        row = {"name": name, "route": "cuda",
               "source": "paddle_tpu_torch/csrc/grouped_matmul.cu",
               "replaces": {"grouped_matmul": "paddle_tpu/ops/pallas/"
                            "grouped_matmul.py:89",
                            "grouped_matmul_glu": "paddle_tpu/ops/pallas/"
                            "grouped_matmul.py:161",
                            "grouped_matmul_dw": "paddle_tpu/ops/pallas/"
                            "grouped_matmul.py:278"}[name],
               "max_abs_err": abs_err, "ms": timed_ms(torch, fn, 10),
               "plain_ms": timed_ms(torch, plain, 1, warmup=1),
               "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": None if lib_fn is None
               else timed_ms(torch, lib_fn, 10)}
        if composed is not None:     # #12: no one call; a composition
            row["composed_ms"] = None if composed[0] is None \
                else timed_ms(torch, composed[0], 10)
            extra["composed_note"] = composed[1]
        if design is not None:
            row.update(traced_kernel(torch, fn, name))
            check(row["design"] == design,
                  f"{name} ({note}) ran on {row['design']}, not {design}")
        emit({"phase": "kernel", **row, "case": note, "rel_l2_err": errs,
              "tolerance": {"rel_l2_err": tol}, "library_note": lib_note,
              **extra})
        return row

    # -- serving: f32 rows, bf16 stacks, tm 128: a mixed step (136 rows,
    # 544 slots; gate and down) and a pure decode step (8 rows, 32 slots)
    no_lib = (None, "torch._grouped_mm takes bf16 operands, not these f32 "
                    "rows")
    for tokens, proj, key in ((136, "gate", "grouped_matmul_f32_rows"),
                              (136, "down", "grouped_matmul_f32_rows_down"),
                              (8, "gate", "grouped_matmul_f32_rows_decode")):
        k, n, w = (H, F, wg) if proj == "gate" else (F, H, wd)
        xs, te, counts, tm = moe_plan_rows(torch, gen, dev, tokens, k,
                                           torch.float32)
        row = run_case(
            "grouped_matmul",
            lambda: gm.gmm_raw(xs, w, te, counts=counts),
            lambda: gm.gmm_reference(xs, w, te), 1e-5,
            cost(counts, k, n, 4, 2, 4), no_lib,
            f"serve {proj}, f32 rows, {tokens * MOE_K} slots",
            design="stream", shape=[list(xs.shape), [E, k, n]], tm=tm,
            routed_rows=int(counts.sum()))
        live = gm.routed_rows(te, counts, xs.shape[0])
        got = gm.gmm_raw(xs, w, te, counts=counts)
        torch.cuda.synchronize()
        check(not got[~live].any(), f"{key}: padding rows or dead tiles "
                                    f"not exactly 0")
        table[key] = dict(row, name=key)
        del xs, got, live

    # -- training: bf16, tm 256, expert 59 empty
    xs, te, counts, tm = moe_plan_rows(torch, gen, dev, MOE_BATCH * MOE_SEQ,
                                       H, bf, empty=E - 1)
    live = (xs[:, :1] != 0).to(bf)

    def rows(n):
        return torch.randn(xs.shape[0], n, generator=gen, device=dev).to(
            bf) * live

    hs, dys, dhg = rows(F), rows(H), rows(F)
    shape = {"m_pad": xs.shape[0], "tm": tm,
             "routed_rows": int(counts.sum())}
    table["grouped_matmul"] = run_case(
        "grouped_matmul", lambda: gm.gmm_raw(hs, wd, te, counts=counts),
        lambda: gm.gmm_reference(hs, wd, te), REL_L2_TOL,
        cost(counts, F, H, 2, 2, 2),
        grouped_mm_library(torch, counts, tm, hs, wd),
        "train forward (down)", design="wgmma",
        shape=[list(hs.shape), [E, F, H]], **shape)
    run_case("grouped_matmul", lambda: gm.gmm_raw(
        dys, wd, te, transpose_w=True, counts=counts),
        lambda: gm.gmm_reference(dys, wd, te, transpose_w=True),
        REL_L2_TOL, cost(counts, H, F, 2, 2, 2),
        grouped_mm_library(torch, counts, tm, dys, wd.transpose(1, 2)),
        "train transpose_w (down dX)", design="wgmma",
        shape=[list(dys.shape), [E, F, H]], **shape)
    run_case("grouped_matmul", lambda: gm.gmm_raw(
        dhg, wg, te, transpose_w=True, counts=counts),
        lambda: gm.gmm_reference(dhg, wg, te, transpose_w=True),
        REL_L2_TOL, cost(counts, F, H, 2, 2, 2),
        grouped_mm_library(torch, counts, tm, dhg, wg.transpose(1, 2)),
        "train transpose_w (gate dX)", design="wgmma",
        shape=[list(dhg.shape), [E, H, F]], **shape)
    no_glu = (None, "no single PyTorch call fuses the two products with "
                    "SwiGLU")
    composed = glu_composed(torch, counts, tm, xs, wg, wu)
    table["grouped_matmul_glu_hs"] = dict(run_case(
        "grouped_matmul_glu", lambda: gm.gmm_glu_raw(
            xs, wg, wu, te, counts=counts),
        lambda: gm.gmm_glu_reference(xs, wg, wu, te), REL_L2_TOL,
        cost(counts, H, F, 2, 2, 2, n_w=2), no_glu, "train, hs only",
        design="wgmma", composed=composed,
        shape=[list(xs.shape), [E, H, F]], **shape),
        name="grouped_matmul_glu_hs")
    table["grouped_matmul_glu"] = run_case(
        "grouped_matmul_glu", lambda: gm.gmm_glu_raw(
            xs, wg, wu, te, save_pre=True, counts=counts),
        lambda: gm.gmm_glu_reference(xs, wg, wu, te, save_pre=True),
        REL_L2_TOL, cost(counts, H, F, 2, 2, 2, n_w=2, n_out=3), no_glu,
        "train, save_pre", design="wgmma", composed=composed,
        shape=[list(xs.shape), [E, H, F]], **shape)
    for case, lhs, dout in (("train gate dW", xs, dhg),
                            ("train down dW", hs, dys)):
        k, n = lhs.shape[1], dout.shape[1]
        routed = int(counts.sum())
        bound = bound_ms(2 * routed * (k + n) + 2 * E * k * n,
                         2 * routed * k * n)
        got = gm.gmm_dw_raw(lhs, dout, te, counts, E)
        torch.cuda.synchronize()
        check(int(counts[E - 1]) == 0 and not got[E - 1].any(),
              f"{case}: the empty expert's gradient is not zero")
        del got
        row = run_case(
            "grouped_matmul_dw", lambda: gm.gmm_dw_raw(lhs, dout, te, counts,
                                                       E),
            lambda: gm.gmm_dw_reference(lhs, dout, te, counts, E),
            REL_L2_TOL, bound,
            grouped_mm_library(torch, counts, tm, lhs.t(), dout), case,
            design="wgmma", shape=[list(lhs.shape), list(dout.shape)],
            empty_expert_zero=True, **shape)
        table.setdefault("grouped_matmul_dw", row)
    del xs, hs, dys, dhg, live, wg, wu, wd
    torch.cuda.empty_cache()


def moe_router(torch, m, xf):
    """The router of MoE layer ``m`` over f32 rows: (probs [T, E],
    gate values [T, k], expert ids [T, k])."""
    probs = torch.softmax(xf @ m.gate.weight.float(), dim=-1)
    gv, idx = torch.topk(probs, m.gate.k, dim=-1)
    if m.gate.norm_topk_prob:
        gv = gv / gv.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gv, idx


def capacity_keep(torch, idx, group_start, capacity):
    """[T, k] bool: the routed slots a capacity-factor dispatch keeps.
    Slots run in row-major order (row t's j-th choice is slot t*k + j);
    within each page group (the rows sharing ``group_start``) an expert
    keeps its first ``capacity`` slots, one group and one expert at a
    time, the plain way."""
    k = idx.shape[1]
    flat = idx.reshape(-1)
    keep = torch.ones_like(flat, dtype=torch.bool)
    groups = group_start.repeat_interleave(k)
    for g in torch.unique(groups).tolist():
        in_group = (groups == g).nonzero()[:, 0]
        for e in torch.unique(flat[in_group]).tolist():
            slots = in_group[flat[in_group] == e]
            keep[slots[capacity:]] = False
    return keep.view(idx.shape)


def plain_moe_ffn(torch, m, hn, group_start=None, capacity=0):
    """The MoE FFN of layer ``m`` over rows hn [T, H], plain: the router
    in f32, then for each expert a loop over its routed rows (SwiGLU in
    f32 against the widened weights) combined by the gate values, plus
    the shared expert (gated where the layer has a gate).  With
    ``capacity`` and ``group_start`` [T]
    (each row's page group's first row) only the slots
    ``capacity_keep`` keeps compute.  Returns (out in hn's dtype, aux
    loss), both differentiable."""
    from paddle_tpu_torch.ops import _nn
    xf = hn.float()
    probs, gv, idx = moe_router(torch, m, xf)
    keep = None if not capacity else \
        capacity_keep(torch, idx, group_start, capacity)
    y = torch.zeros_like(xf)
    ex = m.experts
    for e in range(m.gate.num_experts):
        hit = idx == e
        if keep is not None:
            hit = hit & keep
        tok, slot = hit.nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        he = _nn.silu(xe @ ex.gate_w[e].float()) * (xe @ ex.up_w[e].float())
        y = y.index_add(0, tok, gv[tok, slot, None]
                        * (he @ ex.down_w[e].float()))
    if m.shared_gate is not None:
        sh = (_nn.silu(xf @ m.shared_gate.weight.float())
              * (xf @ m.shared_up.weight.float())) \
            @ m.shared_down.weight.float()
        if m.shared_expert_gate is not None:
            sh = sh * torch.sigmoid(xf @ m.shared_expert_gate.weight.float())
        y = y + sh
    e_n = m.gate.num_experts
    density = torch.nn.functional.one_hot(idx, e_n).float().sum(1).mean(0) \
        / m.gate.k
    aux = m.gate.balance_loss_weight * e_n * torch.sum(density
                                                       * probs.mean(0))
    return y.to(hn.dtype), aux


def plain_moe_hidden(torch, model, ids, capacity=0, page=128):
    """Final-norm hidden states [B, S, H] of a plain causal forward of a
    Qwen2-MoE or ERNIE-4.5 model over ids [B, S] (no pages, no kernels:
    embedding, per layer RMSNorm, projections with their biases if any,
    f32 rope, the flash plain version, ``plain_moe_ffn`` or, for a dense
    layer, a plain SwiGLU), and the summed aux loss of the MoE layers;
    differentiable by autograd.  ``capacity``: each ``page``-row chunk
    of the sequence is a capacity group (B = 1)."""
    from paddle_tpu_torch.models.llama import _rotate_half
    from paddle_tpu_torch.ops import _nn
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_fwd_reference
    c = model.config
    hd = c.hidden_size // c.num_attention_heads
    b, n = ids.shape
    cos = model.rope_cos[:n][None, :, None, :].float()
    sin = model.rope_sin[:n][None, :, None, :].float()

    def rope(x):
        xf = x.float()
        return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)

    def proj(x, lin):
        y = x @ lin.weight
        return y if lin.bias is None else y + lin.bias

    x = model.embed_tokens.weight[ids.long()]
    aux = 0.0
    for layer in model.layers:
        a = layer.self_attn
        hn = _nn.rms_norm(x, layer.input_layernorm.weight,
                          epsilon=c.rms_norm_eps)
        q = rope(proj(hn, a.q_proj).view(b, n, -1, hd))
        k = rope(proj(hn, a.k_proj).view(b, n, -1, hd))
        v = proj(hn, a.v_proj).view(b, n, -1, hd)
        o = flash_attention_fwd_reference(q, k, v, causal=True)[0]
        x = x + o.reshape(b, n, -1) @ a.o_proj.weight
        hn = _nn.rms_norm(x, layer.post_attention_layernorm.weight,
                          epsilon=c.rms_norm_eps)
        if not hasattr(layer.mlp, "experts"):        # a dense layer
            mlp = layer.mlp
            x = x + (_nn.silu(hn @ mlp.gate_proj.weight)
                     * (hn @ mlp.up_proj.weight)) @ mlp.down_proj.weight
            continue
        group = None if not capacity else \
            torch.arange(n, device=ids.device) // page * page
        ff, a_l = plain_moe_ffn(torch, layer.mlp, hn.reshape(b * n, -1),
                                group, capacity)
        x = x + ff.view(b, n, -1)
        aux = aux + a_l
    return _nn.rms_norm(x, model.norm.weight, epsilon=c.rms_norm_eps), aux


def moe_reference_logits(torch, model, ids, capacity=0):
    """Last-position logits of ``plain_moe_hidden`` over one prompt
    (``capacity``: ranked per 128-row page chunk)."""
    with torch.no_grad():
        return plain_moe_hidden(torch, model, ids[None],
                                capacity)[0][0, -1] @ model.lm_head.weight


def serve_moe_phase(torch, np, dev, table):
    """Qwen1.5-MoE-A2.7B (``Qwen2MoeConfig()``: 24 layers, 60 experts
    top-4, bf16, random weights from a seeded generator) through
    ``LLMEngine(max_seqs=8, max_len=2048, page_size=128)``: the serving
    mix of the Llama serve.  Every forward launches #11 three times a
    layer; each layer routes 4 slots a live row (dropless).  Then the
    logits checks against a plain forward (f32 at 2 layers, bf16 at 24)
    and a traced serve."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeConfig,
                                                   Qwen2MoeForCausalLM)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import paged_attention as pa
    cfg = Qwen2MoeConfig()
    t0 = time.perf_counter()
    model = Qwen2MoeForCausalLM(
        cfg, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(SEED + 5))
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.default_rng(SEED + 5)
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).tolist()
               for rid, n in SERVE_LENS.items()}
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "grouped_matmul": gm.gmm_raw}
    stats, results = serve_run(torch, eng, prompts, counters)
    launches = stats["launches"]
    layers = cfg.num_hidden_layers
    chunks = -(-SERVE_LENS["a200"] // 128)       # add_request's prefill
    forwards = stats["steps"] + chunks
    load = eng._moe_counts.sum(dim=0).tolist()
    per_layer = eng._moe_counts.sum(dim=1).tolist()
    live_rows = sum(SERVE_LENS.values()) + len(SERVE_LENS) * (SERVE_NEW - 1)
    emit({"phase": "serve_moe", "model": "qwen1.5_moe_a2.7b",
          "layers": layers, "experts": MOE_E, "top_k": MOE_K,
          "dtype": "bfloat16", "weight_bytes": weight_bytes,
          "setup_s": setup_s, **stats, "forwards": forwards,
          "grouped_matmul_launches_per_forward":
          launches["grouped_matmul"] / forwards,
          "expert_load": load, "routed_slots_per_layer": per_layer[0]})
    for rid, out in results.items():
        check(all(0 <= t < cfg.vocab_size for t in out),
              f"request {rid} returned a token outside the vocabulary")
    check(launches["grouped_matmul"] == 3 * layers * forwards,
          f"#11 launched {launches['grouped_matmul']} times in {forwards} "
          f"forwards, not {3 * layers} a forward")
    check(launches["ragged_paged_append_attend"] == layers * stats["steps"]
          and launches["flash_attention_fwd"] == layers * chunks,
          f"attention launches {launches}")
    check(all(n == MOE_K * live_rows for n in per_layer),
          f"routed slots per layer {per_layer}, not {MOE_K} x {live_rows} "
          f"live rows (dropless)")

    cfg32 = Qwen2MoeConfig(num_hidden_layers=2)
    model32 = Qwen2MoeForCausalLM(
        cfg32, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 6))
    eng32 = LLMEngine(model32, max_seqs=8, max_len=2048, page_size=128)
    rep = serve_reference(
        torch, dev, prompts["b37"],
        (("f32_2_layers", model32, eng32, 1e-4),
         ("bf16_24_layers", model, eng, 0.2)),
        lambda m, ids: moe_reference_logits(torch, m, ids))
    emit({"phase": "reference_moe", **rep})
    del eng32, model32
    torch.cuda.empty_cache()

    prof = profile_serve(torch, eng, {
        f"p{rid}": rng.integers(0, cfg.vocab_size, n).tolist()
        for rid, n in SERVE_LENS.items()}, max_new=8)
    emit({"phase": "serve_moe_profile", **prof})
    check_tensor_core_route(prof, "serve_moe_profile", ("grouped_matmul",),
                            design="stream")
    check_tensor_core_route(prof, "serve_moe_profile", ("ragged_attend",),
                            design="mma")
    table["ragged_paged_append_attend_group1"]["launches"] = \
        launches["ragged_paged_append_attend"]
    for name in ("grouped_matmul_f32_rows", "grouped_matmul_f32_rows_down",
                 "grouped_matmul_f32_rows_decode"):
        table[name]["launches"] = launches["grouped_matmul"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    serve_moe_capacity(torch, np, dev, model, prompts, results)
    serve_moe_capacity_reference(torch, np, dev)
    serve_moe_split_int8(torch, np, dev, model)


# capacity-factor MoE serving: the config's factor (1.25) at full depth,
# 0.5 in the f32 check (drops certain); pure-decode check requests
MOE_CF_REF = 0.5
CAP_DECODE_LENS = (64, 100, 150, 200, 250, 300, 350, 400)
CAP_DECODE_NEW = 8


def moe_capacity_of(cfg, cf, page=128):
    """The engine's per-page-group slot cap of an expert."""
    return max(math.ceil(cfg.num_experts_per_tok * page * cf
                         / cfg.num_experts), 1)


def moe_plane(eng):
    m = eng.metrics_snapshot()["moe"]
    return {"expert_tokens": m["expert_tokens"],
            "kept": sum(m["expert_tokens"]),
            "dropped_tokens": m["dropped_tokens"],
            "capacity": m["capacity"], "imbalance": m["imbalance"]}


def token_agreement(got, want):
    """Per request: the leading tokens equal and the positions equal."""
    out = {}
    for rid, w in want.items():
        g = got[rid]
        lead = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                    min(len(g), len(w)))
        out[rid] = {"leading_equal": lead,
                    "equal_positions": sum(a == b for a, b in zip(g, w)),
                    "of": len(w)}
    return out


def decode_drops(torch, np, eng, vocab, seed):
    """Dropped slots over pure-decode steps: 8 requests admitted by
    ``add_request`` (their prefill finishes at admission), then ``step``
    to the end.  Returns (dropped before, dropped after, decode steps)."""
    rng = np.random.default_rng(seed)
    for i, n in enumerate(CAP_DECODE_LENS):
        eng.add_request(f"d{i}", rng.integers(0, vocab, n).tolist(),
                        max_new_tokens=CAP_DECODE_NEW)
    before = eng.metrics_snapshot()["moe"]["dropped_tokens"]
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
    return before, eng.metrics_snapshot()["moe"]["dropped_tokens"], steps


def serve_moe_capacity(torch, np, dev, model, prompts, dropless):
    """Qwen1.5-MoE-A2.7B at full depth in bf16 with capacity-factor
    dispatch (``moe_dropless=False``; the config's factor 1.25, so cap =
    ceil(4 x 128 x 1.25 / 60) = 11 slots an expert a page group) on the
    serve mix, on the unified step and on the split path.  Checks: three
    #11 launches a layer a forward; kept + dropped = live rows x top_k x
    layers (the ``moe`` plane of ``metrics_snapshot()``); pure-decode
    steps drop nothing.  Reports TTFT, decode tokens/s, memory and the
    token agreement with the dropless serve (not held equal: drops change
    the math)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import paged_attention as pa
    cfg = model.config
    layers = cfg.num_hidden_layers
    cap = moe_capacity_of(cfg, cfg.capacity_factor)
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "paged_decode_append_attend": pa.paged_decode_append_attend,
                "grouped_matmul": gm.gmm_raw}
    live_rows = sum(SERVE_LENS.values()) + len(SERVE_LENS) * (SERVE_NEW - 1)
    for path in ("unified", "split"):
        unified = path == "unified"
        t0 = time.perf_counter()
        eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                        dtype=torch.bfloat16, moe_dropless=False,
                        unified_step=unified,
                        steps_per_sync=1 if unified else SPLIT_SPS)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if unified:
            stats, results = serve_run(torch, eng, prompts, counters)
            chunks = -(-SERVE_LENS["a200"] // 128)
            forwards = stats["steps"] + chunks
        else:
            stats = serve_split_run(torch, eng, prompts, counters)
            results = {rid: eng.result(rid) for rid in prompts}
            chunks = sum(-(-n // 128) for n in SERVE_LENS.values())
            forwards = stats["forwards"] + chunks
        plane = moe_plane(eng)
        n = stats["launches"]
        before, after, dsteps = decode_drops(torch, np, eng,
                                             cfg.vocab_size, SEED + 17)
        emit({"phase": "serve_moe_capacity", "path": path,
              "model": "qwen1.5_moe_a2.7b", "layers": layers,
              "capacity_factor": cfg.capacity_factor, "capacity": cap,
              "dtype": "bfloat16", "setup_s": setup_s, **stats,
              "forwards": forwards,
              "grouped_matmul_launches_per_forward":
              n["grouped_matmul"] / forwards,
              "live_rows": live_rows, "moe": plane,
              "routed_slots": live_rows * MOE_K * layers,
              "dropped_share": plane["dropped_tokens"]
              / (live_rows * MOE_K * layers),
              "pure_decode_steps": dsteps,
              "pure_decode_dropped": after - before,
              "agreement_with_dropless": token_agreement(results,
                                                         dropless)})
        for rid, out in results.items():
            check(all(0 <= t < cfg.vocab_size for t in out),
                  f"capacity {path}: request {rid} returned a token "
                  f"outside the vocabulary")
        check(plane["capacity"] == cap == 11,
              f"capacity {path}: cap {plane['capacity']}, not 11")
        check(n["grouped_matmul"] == 3 * layers * forwards,
              f"capacity {path}: #11 launched {n['grouped_matmul']} times "
              f"in {forwards} forwards, not {3 * layers} a forward")
        check(plane["kept"] + plane["dropped_tokens"]
              == live_rows * MOE_K * layers,
              f"capacity {path}: kept {plane['kept']} + dropped "
              f"{plane['dropped_tokens']} != {live_rows} live rows x "
              f"{MOE_K} x {layers}")
        check(after == before and dsteps > 0,
              f"capacity {path}: pure-decode steps dropped "
              f"{after - before} slots")
        if unified:
            check(n["ragged_paged_append_attend"] == layers * stats["steps"]
                  and n["flash_attention_fwd"] == layers * chunks
                  and n["paged_decode_append_attend"] == 0,
                  f"capacity unified: attention launches {n}")
        else:
            check_split_launches(stats, layers, "serve_moe_capacity")
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def serve_moe_capacity_reference(torch, np, dev):
    """Capacity-factor dispatch at f32, full width, 2 layers, factor 0.5
    (cap ceil(4 x 128 x 0.5 / 60) = 5: drops certain): the engine's
    first-token logits of a 300-id prompt (three page chunks, the split
    prefill) within 1e-4 (relative L2) of a plain forward whose MoE FFN
    keeps each expert's first 5 slots per 128-row chunk
    (``capacity_keep``), and the unified step's first token (whole
    chunks) equal to its arg max."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeConfig,
                                                   Qwen2MoeForCausalLM)
    cfg = Qwen2MoeConfig(num_hidden_layers=2)
    cap = moe_capacity_of(cfg, MOE_CF_REF)
    model = Qwen2MoeForCausalLM(
        cfg, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 18))
    ids = np.random.default_rng(SEED + 18).integers(
        0, cfg.vocab_size, 300).tolist()
    geom = dict(max_seqs=8, max_len=2048, page_size=128,
                moe_dropless=False, moe_capacity_factor=MOE_CF_REF)
    eng = LLMEngine(model, **geom, unified_step=False)
    slot = eng.cache.allocate(len(ids) + 1)
    got = eng._prefill_seq(slot, ids, 0).float()
    eng.cache.release(slot)
    plane = moe_plane(eng)
    want = moe_reference_logits(torch, model, torch.tensor(ids, device=dev),
                                capacity=cap).float()
    dropless = moe_reference_logits(torch, model,
                                    torch.tensor(ids, device=dev)).float()
    rel = ((got - want).norm() / want.norm()).item()
    rel_dropless = ((got - dropless).norm() / dropless.norm()).item()
    uni = LLMEngine(model, **geom)
    uni.begin_request("c", ids, max_new_tokens=1)
    while uni.has_work():
        uni.step()
    first = uni.pop_result("c")[0]
    rep = {"phase": "serve_moe_capacity_reference", "dtype": "float32",
           "layers": 2, "capacity_factor": MOE_CF_REF, "capacity": cap,
           "prompt_len": len(ids), "logits_rel_l2_err": rel,
           "tolerance": 1e-4, "dropless_logits_rel_l2": rel_dropless,
           "moe": plane, "unified_first_token": first,
           "plain_argmax": int(want.argmax()),
           "unified_moe": moe_plane(uni)}
    emit(rep)
    check(bool(torch.isfinite(got).all()), "capacity f32: logits not finite")
    check(plane["dropped_tokens"] > 0 and plane["capacity"] == cap,
          f"capacity f32: no slot dropped at factor {MOE_CF_REF}: {plane}")
    check(rel <= 1e-4, f"capacity f32: prefill logits off the plain "
                       f"capacity forward by {rel} (relative L2)")
    check(rel_dropless > 10 * rel,
          f"capacity f32: the drops do not show in the logits "
          f"({rel_dropless} against the dropless forward)")
    check(first == int(want.argmax()),
          f"capacity f32: unified first token {first} != plain "
          f"{int(want.argmax())}")
    del eng, uni, model
    gc.collect()
    torch.cuda.empty_cache()


def train_moe_phase(torch, np, dev, table):
    """``bench.py`` ``bench_moe``'s recipe at Qwen1.5-MoE-A2.7B width:
    ``Qwen2MoeForCausalLM(Qwen2MoeConfig(num_hidden_layers=6,
    recompute=True))`` -> amp O2 (bf16) -> AdamW(lr 1e-4) ->
    ``CompiledTrainStep``, batch 4 x seq 4096 of ``_train_batch`` data,
    5 steps (the first warms up), then a traced step.  Under full
    recompute each layer launches, a step: #12 twice (forward, and the
    recompute with save_pre), #11 five times (forward and recompute of
    the down projection, its dX, the gate and up dX), #13 three times,
    the flash forward twice, dQ and dK/dV once."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeConfig,
                                                   Qwen2MoeForCausalLM)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    from paddle_tpu_torch.ops import grouped_matmul as gm
    layers = MOE_LAYERS
    cfg = Qwen2MoeConfig(num_hidden_layers=layers, recompute=True)
    t0 = time.perf_counter()
    model = Qwen2MoeForCausalLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED + 7))
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=1e-4,
                          parameters=model.parameters())
    step = CompiledTrainStep(
        model, lambda m, b: m(b["input_ids"], labels=b["labels"]), opt)
    ids, labels = train_batch(np, cfg.vocab_size, MOE_BATCH, MOE_SEQ)
    batch = {"input_ids": torch.tensor(ids, device=dev),
             "labels": torch.tensor(labels, device=dev)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    expert_params = sum(p.numel() for n, p in model.named_parameters()
                        if ".experts." in n)
    active = n_params - expert_params + expert_params * MOE_K // MOE_E
    state_bytes = torch.cuda.memory_allocated()   # params and moments
    # the update: one launch per leaf of 1 MiB or more, one for the pack
    big = sum(p.numel() * p.element_size() >= 1 << 20 for p in params)
    counters = {
        "grouped_matmul_glu": (gm.gmm_glu_raw, 2 * layers),
        "grouped_matmul": (gm.gmm_raw, 5 * layers),
        "grouped_matmul_dw": (gm.gmm_dw_raw, 3 * layers),
        "flash_attention_fwd": (fa.flash_attention_fwd, 2 * layers),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, layers),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, layers),
        "fused_update": (ft.fused_update_flat, big + 1)}
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {n: fn.launches for n, (fn, _) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = sum(times[1:]) / (len(times) - 1)
    tokens = MOE_BATCH * MOE_SEQ
    tok_s = tokens / step_s
    # ln V + sigma^2 / 2 (sigma = 0.02 sqrt(h), see train_phase), plus
    # the aux loss: about 1 a layer at a balanced router, times 0.001
    sigma = cfg.initializer_range * math.sqrt(cfg.hidden_size)
    init_loss = math.log(cfg.vocab_size) + sigma ** 2 / 2 \
        + cfg.router_aux_loss_coef * layers
    emit({"phase": "train_moe", "model": "qwen1.5_moe_a2.7b width",
          "layers": layers, "recompute": "full", "dtype": "bfloat16",
          "batch": MOE_BATCH, "seq": MOE_SEQ, "params": n_params,
          "active_params_per_token": active, "setup_s": setup_s,
          "step_s": times, "mean_step_s": step_s, "tokens_per_s": tok_s,
          "mfu_6n_active": 6 * active * tok_s / PEAK_BF16_FLOPS,
          "losses": losses, "expected_first_loss": init_loss,
          "state_bytes": state_bytes, "max_memory_allocated": peak,
          "launches": launches,
          "launches_per_step": {n: c / TRAIN_STEPS
                                for n, c in launches.items()}})
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - init_loss) <= 0.5,
          f"first loss {losses[0]} not within 0.5 of {init_loss}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(peak < 80e9, f"peak memory {peak} bytes, not under 80 GB")
    for n, (_, per_step) in counters.items():
        check(launches[n] == per_step * TRAIN_STEPS,
              f"{n} launched {launches[n]} times in {TRAIN_STEPS} steps, "
              f"not {per_step} a step")
    for n in ("grouped_matmul", "grouped_matmul_glu", "grouped_matmul_dw"):
        table[n]["launches"] = launches[n]
    # #12 without save_pre (the forward) and with it (the recompute)
    table["grouped_matmul_glu_hs"]["launches"] = \
        launches["grouped_matmul_glu"]

    for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        table[f"{n}_moe"]["launches"] = launches[n]

    _, prof = profiled(torch, lambda: step(batch))
    emit({"phase": "train_moe_profile", **prof})
    check_tensor_core_route(prof, "train_moe",
                            FLASH_FAMILIES + GROUPED_FAMILIES)


def train_moe_reference_phase(torch, np, dev):
    """At f32 (TF32 off), Qwen1.5-MoE width, 2 layers, batch 1, seq 256:
    the loss and every gradient of ``grad_step`` (the kernels: #12, #11,
    #13 on the f32 FMA path, the flash kernels) against autograd of
    ``plain_moe_hidden`` + a log-softmax cross-entropy + the aux loss,
    with recompute off and on."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeConfig,
                                                   Qwen2MoeForCausalLM)
    from paddle_tpu_torch.ops import grouped_matmul as gm
    cfg = Qwen2MoeConfig(num_hidden_layers=2)
    model = Qwen2MoeForCausalLM(
        cfg, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 8))
    step = CompiledTrainStep(
        model, lambda m, b: m(b["input_ids"], labels=b["labels"]),
        optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters()))
    ids, labels = train_batch(np, cfg.vocab_size, 1, 256)
    batch = {"input_ids": torch.tensor(ids, device=dev),
             "labels": torch.tensor(labels, device=dev)}
    params = step.state["params"]
    x, aux = plain_moe_hidden(torch, model, batch["input_ids"])
    logp = torch.log_softmax((x @ model.lm_head.weight).float(), dim=-1)
    lab = batch["labels"].long()
    valid = lab != -100
    tok = -logp.gather(-1, torch.where(valid, lab, 0)[..., None])[..., 0]
    want_loss = (tok * valid).sum() / valid.sum() \
        + cfg.router_aux_loss_coef * aux
    want_grads = dict(zip(params, torch.autograd.grad(
        want_loss, list(params.values()))))
    wl = float(want_loss.detach())
    del x, aux, logp, tok, want_loss
    rep = {}
    for recompute_on in (False, True):
        model.config.recompute = recompute_on
        for fn in (gm.gmm_raw, gm.gmm_glu_raw, gm.gmm_dw_raw):
            fn.launches = 0
        loss, grads = step.grad_step(batch)
        rel = {n: ((grads[n] - w).norm() / w.norm().clamp(min=1e-30)).item()
               for n, w in want_grads.items()}
        worst = max(rel, key=rel.get)
        loss_rel = abs(float(loss) - wl) / abs(wl)
        rep["recompute" if recompute_on else "no_recompute"] = {
            "loss": float(loss), "loss_rel_err": loss_rel,
            "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst": worst,
            "launches": {"grouped_matmul": gm.gmm_raw.launches,
                         "grouped_matmul_glu": gm.gmm_glu_raw.launches,
                         "grouped_matmul_dw": gm.gmm_dw_raw.launches}}
        check(loss_rel <= 1e-5 and rel[worst] <= 1e-4,
              f"MoE f32, recompute {recompute_on}: loss off the plain "
              f"composition by {loss_rel}, gradient {worst} by "
              f"{rel[worst]}")
        del grads
    emit({"phase": "train_moe_reference", "dtype": "float32", "layers": 2,
          "seq": 256, **rep,
          "tolerance": {"loss_rel": 1e-5, "grad_rel_l2": 1e-4}})



# ---------------------------------------------------------------------------
# quantized and split-path serving: kernels #6, #7 and the int8 mode of #1
# ---------------------------------------------------------------------------

# the split decode kernels' serving shape: 8 rows (one with length 0),
# lengths spread over 1-2048, P 128, D 128, 129 pages (16 a row + pad)
DECODE_LENS = [0, 1, 37, 300, 777, 1000, 1500, 2047]
SPLIT_SPS = 4                      # steps_per_sync of the split serves


def int8_pools(pools):
    """Int8 codes and per-token scales of float pools (the plain
    quantization), as a serving cache would hold them."""
    from paddle_tpu_torch.quantization.ops import quantize_rows
    out = []
    for p in pools:
        codes, scale = quantize_rows(p)
        out += [codes, scale]
    return out[0], out[2], out[1], out[3]           # kc, vc, ks, vs


def decode_case(torch, gen, dev, H=32, KVH=8, int8=False):
    """Kernels #6/#7 at the serving shape: q [8, H, 128], new rows
    [8, KVH, 128] and pools [KVH, 129, 128, 128] in bf16 (int8 pools: the
    same quantized per token), tables of 16 distinct pages a row.  Returns
    (q, k_new, v_new, pools (kp, vp, ks, vs), tables, lens)."""
    B, P, D, maxp = len(DECODE_LENS), 128, 128, 16
    n_pages = B * maxp + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(B, maxp).to(torch.int32).contiguous()
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    pools = (rnd(KVH, n_pages, P, D), rnd(KVH, n_pages, P, D))
    pools = int8_pools(pools) if int8 else pools + (None, None)
    return (rnd(B, H, D), rnd(B, KVH, D), rnd(B, KVH, D), pools, tables,
            lens)


def decode_cost(H, KVH, int8, append, el_q=2, el_p=2):
    """(bytes, flops) of one #6 (append False) or #7 call at the decode
    case: each K/V token read once (codes plus scale in int8, else
    ``el_p`` bytes an element), q read and out written (``el_q``), new
    rows read and appended (#7), tables and lengths."""
    D = 128
    el_p = 1 if int8 else el_p
    tokens = sum(n + int(append) for n in DECODE_LENS)
    B = len(DECODE_LENS)
    row = D * el_p + (4 if int8 else 0)
    n_bytes = (2 * tokens * KVH * row + 2 * B * H * D * el_q
               + 4 * (B * 16 + B))
    if append:
        n_bytes += 2 * B * KVH * D * el_q + 2 * B * KVH * row
    return n_bytes, 4 * H * D * tokens


def decode_row(torch, name, kernel, plain, err, bound, bound_by):
    """A row of #7's or #6's table: ``kernel()`` and ``plain()`` timed
    (CUDA events), the kernel traced (family ``paged_decode``: its own
    device time a call, ``device_ms``) and its design held to the
    span-split one ("split")."""
    row = {"name": name, "route": "cuda",
           "source": "paddle_tpu_torch/csrc/paged_decode_attention.cu",
           "replaces": "paddle_tpu/ops/pallas/paged_attention.py:"
                       + ("274" if name.startswith("paged_attention")
                          else "422"),
           "max_abs_err": err, "ms": timed_ms(torch, kernel, 50),
           "plain_ms": timed_ms(torch, plain, 5), "bound_ms": bound,
           "bound_by": bound_by, "library_ms": None,
           **traced_kernel(torch, kernel, "paged_decode")}
    check(row["design"] == "split",
          f"{name} ran on {row['design']}, not the span-split kernel")
    return row


def decode_kernels(torch, gen, dev, table):
    """#7 and #6 (bf16 float pools and int8 pools) against their plain
    versions at the decode case, at group 4 (32/8 heads, Llama-3-8B) and
    group 1 (16/16, Qwen1.5-MoE): outputs within one bf16 step (``TOL``),
    pools after #7's append equal (int8: codes and scales equal).  The
    group-4 rows fill the kernel table (#7 float: the split serve's; #6
    float: ``PagedKVCache.attend``'s)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    for (H, KVH), int8 in ((h, i) for h in ((32, 8), (16, 16))
                           for i in (False, True)):
        q, kn, vn, pools, tables, lens = decode_case(torch, gen, dev, H, KVH,
                                                     int8)
        mode = "int8" if int8 else "bf16"
        for name, fn, plain, new in (
                ("paged_decode_append_attend", pa.paged_decode_append_attend,
                 pa.paged_decode_append_attend_reference, (kn, vn)),
                ("paged_attention", pa.paged_attention,
                 pa.paged_attention_reference, ())):
            mine = [None if p is None else p.clone() for p in pools]
            ref = [None if p is None else p.clone() for p in pools]

            def call(f, ps):
                return f(q, ps[0], ps[1], *new, tables, lens, ps[2], ps[3])
            got = call(fn, mine)
            want = call(plain, ref)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            pools_equal = all(a is None or torch.equal(a, b)
                              for a, b in zip(mine, ref))
            check(err <= TOL, f"{name} ({mode}, group {H // KVH}) off its "
                              f"plain version by {err}")
            check(pools_equal, f"{name} ({mode}, group {H // KVH}) wrote "
                               f"other pools than its plain version")
            check(not got[0].any() if not new else True,
                  f"{name}: the row of length 0 is not zero")
            bound, bound_by = bound_ms(*decode_cost(H, KVH, int8, bool(new)))
            row = decode_row(torch, name, lambda: call(fn, mine),
                             lambda: call(plain, ref), err, bound, bound_by)
            emit({"phase": "kernel", **row, "pools": mode,
                  "group": H // KVH, "heads": H, "kv_heads": KVH,
                  "lens": DECODE_LENS, "pools_equal": pools_equal,
                  "tolerance": TOL,
                  "library": "none: no one PyTorch call reads a paged pool"})
            if H == 32 and not int8:
                table[name] = row
        del q, kn, vn, pools, mine, ref, got, want
        torch.cuda.empty_cache()


def ragged_int8_kernel(torch, gen, dev, table):
    """#1's int8 mode at the unified step's shapes (``ragged_case``, the
    pools quantized per token), group 4 and group 1: codes and scales
    after the append equal the plain version's, outputs within TOL."""
    from paddle_tpu_torch.ops import paged_attention as pa
    for H, KVH in ((32, 8), (16, 16)):
        args, _, flops = ragged_case(torch, gen, dev, H=H, KVH=KVH)
        pools = int8_pools((args.pop("k_pages"), args.pop("v_pages")))
        mine = [p.clone() for p in pools]
        ref = [p.clone() for p in pools]

        def call(fn, ps):
            return fn(args["q"], ps[0], ps[1], args["k_new"], args["v_new"],
                      args["q_start"], args["q_len"], args["kv_len"],
                      args["page_tables"], ps[2], ps[3])
        got = call(pa.ragged_paged_append_attend, mine)
        want = call(pa.ragged_paged_append_attend_reference, ref)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(all(torch.equal(a, b) for a, b in zip(mine, ref)),
              f"ragged int8 (group {H // KVH}): codes or scales differ "
              f"from the plain version's")
        check(err <= TOL, f"ragged int8 (group {H // KVH}) off its plain "
                          f"version by {err}")
        n_bytes = ragged_bytes(2, 1, H, KVH, int8=True)
        row = ragged_row(
            torch, "ragged_paged_append_attend_int8",
            lambda: call(pa.ragged_paged_append_attend, mine),
            lambda: call(pa.ragged_paged_append_attend_reference, ref), err,
            bound_ms(n_bytes, flops), "3xtf32")
        emit({"phase": "kernel", **row, "group": H // KVH,
              "codes_and_scales_equal": True, "tolerance": TOL})
        if H == 32:
            table["ragged_paged_append_attend_int8"] = row
        del args, pools, mine, ref, got, want
        torch.cuda.empty_cache()


def mixed_kernels(torch, gen, dev, table):
    """The mixed-dtype mode of #1, #7 and #6: pools in another float dtype
    than q.  #1 at the unified step's shapes (``ragged_case``, group 4) in
    both directions the serving engines run (f32 q over bf16 pools: f32
    weights, bf16 pools; bf16 q over f32 pools: bf16 weights, the default
    pools), #7 and #6 at the decode case with f32 q over bf16 pools.
    Pools after an append equal the plain version's bit for bit (the new
    rows rounded to the pool dtype in both), outputs within ``TOL``."""
    from paddle_tpu_torch.ops import paged_attention as pa
    el = {torch.float32: 4, torch.bfloat16: 2}
    for qdt, pdt in ((torch.float32, torch.bfloat16),
                     (torch.bfloat16, torch.float32)):
        tag = f"{str(qdt)[6:]}_q_{str(pdt)[6:]}_pools"
        args, _, flops = ragged_case(torch, gen, dev)
        for n in ("q", "k_new", "v_new"):
            args[n] = args[n].to(qdt)
        pools = [args.pop(n).to(pdt) for n in ("k_pages", "v_pages")]
        mine = [p.clone() for p in pools]
        ref = [p.clone() for p in pools]

        def call(fn, ps):
            return fn(args["q"], ps[0], ps[1], args["k_new"], args["v_new"],
                      args["q_start"], args["q_len"], args["kv_len"],
                      args["page_tables"])
        got = call(pa.ragged_paged_append_attend, mine)
        want = call(pa.ragged_paged_append_attend_reference, ref)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        pools_equal = all(torch.equal(a, b) for a, b in zip(mine, ref))
        check(pools_equal, f"ragged {tag}: pools differ from the plain "
                           f"version's")
        check(got.dtype == qdt and err <= TOL,
              f"ragged {tag} off its plain version by {err}")
        name = f"ragged_paged_append_attend_{tag}"
        table[name] = ragged_row(
            torch, name, lambda: call(pa.ragged_paged_append_attend, mine),
            lambda: call(pa.ragged_paged_append_attend_reference, ref), err,
            bound_ms(ragged_bytes(el[qdt], el[pdt]), flops), "3xtf32")
        emit({"phase": "kernel", **table[name], "q_dtype": str(qdt)[6:],
              "pool_dtype": str(pdt)[6:], "group": 4,
              "pools_equal": pools_equal, "tolerance": TOL})
        del args, pools, mine, ref, got, want
        torch.cuda.empty_cache()

    q, kn, vn, pools, tables, lens = decode_case(torch, gen, dev)
    q, kn, vn = q.float(), kn.float(), vn.float()   # f32 q, bf16 pools
    for name, fn, plain, new in (
            ("paged_decode_append_attend", pa.paged_decode_append_attend,
             pa.paged_decode_append_attend_reference, (kn, vn)),
            ("paged_attention", pa.paged_attention,
             pa.paged_attention_reference, ())):
        mine = [p.clone() for p in pools[:2]]
        ref = [p.clone() for p in pools[:2]]

        def call(f, ps):
            return f(q, ps[0], ps[1], *new, tables, lens)
        got = call(fn, mine)
        want = call(plain, ref)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        pools_equal = all(torch.equal(a, b) for a, b in zip(mine, ref))
        check(pools_equal, f"{name} (f32 q, bf16 pools) wrote other pools "
                           f"than its plain version")
        check(got.dtype == torch.float32 and err <= TOL,
              f"{name} (f32 q, bf16 pools) off its plain version by {err}")
        bound, bound_by = bound_ms(*decode_cost(32, 8, False, bool(new),
                                                el_q=4, el_p=2))
        key = f"{name}_float32_q_bfloat16_pools"
        table[key] = decode_row(torch, key, lambda: call(fn, mine),
                                lambda: call(plain, ref), err, bound,
                                bound_by)
        emit({"phase": "kernel", **table[key], "q_dtype": "float32",
              "pool_dtype": "bfloat16", "group": 4, "lens": DECODE_LENS,
              "pools_equal": pools_equal, "tolerance": TOL})
    del q, kn, vn, pools, mine, ref, got, want
    torch.cuda.empty_cache()


def kv_bytes(cache):
    return sum(t.numel() * t.element_size() for t in (
        cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales)
        if t is not None)


def engine_weight_bytes(eng):
    """Bytes of the projection weights an engine computes with: int8
    values plus scales, or the float parameters."""
    seen, total = set(), 0
    ws = [w for layer in eng._layers for w in layer] + [eng._head_w]
    for w in ws:
        for t in (w if isinstance(w, tuple) else (w,)):
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
    return total


def cache_attend_check(torch, eng, phase, layers):
    """``PagedKVCache.attend`` (#6) on a live engine's cache, right after
    its ``add_request`` prefills, against the plain version over the
    same pools, for two layers; launches counted from 0."""
    from paddle_tpu_torch.ops import paged_attention as pa
    cache = eng.cache
    slots = sorted(r.slot for r in eng._active)
    gen = torch.Generator(device=eng.device).manual_seed(SEED + 7)
    c = eng.config
    q = torch.randn((len(slots), c.num_attention_heads, eng.head_dim),
                    generator=gen, device=eng.device, dtype=torch.bfloat16)
    table = torch.as_tensor(cache.page_table[slots], device=eng.device)
    lens = torch.as_tensor(cache.seq_lens[slots], device=eng.device)
    pa.paged_attention.launches = 0
    errs = {}
    for layer in layers:
        got = cache.attend(slots, q.to(eng._embed_w.dtype), layer)
        want = pa.paged_attention_reference(
            q.to(eng._embed_w.dtype), cache.k_pages[layer],
            cache.v_pages[layer], table, lens, *cache.scales(layer))
        torch.cuda.synchronize()
        errs[layer] = (got.float() - want.float()).abs().max().item()
    launches = pa.paged_attention.launches
    emit({"phase": "cache_attend", "engine": phase,
          "pools": cache.kv_dtype or str(cache.k_pages.dtype),
          "rows": len(slots), "lens": lens.tolist(), "layers": list(layers),
          "max_abs_err": errs, "tolerance": TOL,
          "paged_attention_launches": launches})
    check(all(e <= TOL for e in errs.values()),
          f"PagedKVCache.attend off its plain version: {errs}")
    check(launches == len(layers), f"#6 launched {launches} times")
    return launches


def serve_split_run(torch, eng, prompts, counters, attend_layers=None):
    """Serve ``prompts`` on the split path: every request through
    ``add_request`` (the flash prefill), then ``step`` windows of up to
    SPLIT_SPS host-chained forwards (kernel #7), SERVE_NEW tokens each,
    launch counts set to 0 just before and read just after.  With
    ``attend_layers`` the cache's #6 is checked after admission (its
    launches are not the serve's).  Returns the stats."""
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t_serve = time.perf_counter()
    ttft = {}
    for rid, ids in prompts.items():
        t = time.perf_counter()
        eng.add_request(rid, ids, max_new_tokens=SERVE_NEW)
        ttft[rid] = time.perf_counter() - t
    attend = None
    if attend_layers is not None:
        attend = cache_attend_check(torch, eng, "split", attend_layers)
    forwards = steps = 0
    decode_s, decode_tokens = 0.0, 0
    while eng.has_work():
        t = time.perf_counter()
        new = eng.step()                    # returns host ints: synced
        decode_s += time.perf_counter() - t
        steps += 1
        forwards += eng.last_window_steps
        decode_tokens += sum(len(v) for v in new.values())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = {n: fn.launches for n, fn in counters.items()}
    results = {rid: eng.result(rid) for rid in prompts}
    for rid, out in results.items():
        check(len(out) == SERVE_NEW,
              f"request {rid} returned {len(out)} tokens, not {SERVE_NEW}")
        check(all(0 <= t < eng.config.vocab_size for t in out),
              f"request {rid} returned a token outside the vocabulary")
    return {"serve_s": serve_s, "steps": steps, "forwards": forwards,
            "prompt_lens": {r: len(p) for r, p in prompts.items()},
            "tokens": {rid: len(v) for rid, v in results.items()},
            "ttft_s": ttft, "decode_tok_s": decode_tokens / decode_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches, "cache_attend_launches": attend}


def profile_split_serve(torch, eng, prompts, max_new=8):
    """Serve ``prompts`` on the split path (``add_request``, then
    ``step``) under torch.profiler."""
    def serve():
        for rid, ids in prompts.items():
            eng.add_request(f"p{rid}", ids, max_new_tokens=max_new)
        forwards = 0
        while eng.has_work():
            eng.step()
            forwards += eng.last_window_steps
        return forwards
    forwards, stats = profiled(torch, serve)
    return {"forwards": forwards, **stats}


def split_prompts(np, vocab, seed):
    """The split serves' five ``add_request`` prompts (37, 128, 300, 1000
    and 200 ids)."""
    rng = np.random.default_rng(seed)
    return {f"s{n}": rng.integers(0, vocab, n).tolist()
            for n in (37, 128, 300, 1000, 200)}


def check_split_launches(stats, layers, name):
    """#7 exactly once a layer a single-token forward, #1 never, the
    flash forward once a layer a prefill chunk."""
    n = stats["launches"]
    chunks = sum(-(-m // 128) for m in stats["prompt_lens"].values())
    check(n["paged_decode_append_attend"] == layers * stats["forwards"],
          f"{name}: #7 launched {n['paged_decode_append_attend']} times in "
          f"{stats['forwards']} forwards, not {layers} a forward")
    check(n["ragged_paged_append_attend"] == 0,
          f"{name}: the split path launched #1")
    check(n["flash_attention_fwd"] == layers * chunks,
          f"{name}: flash launches {n['flash_attention_fwd']}, not "
          f"{layers} x {chunks} prefill chunks")


def quant_serve_phases(torch, np, dev, table, model, prompts, bf16_pool_bytes):
    """Llama-3-8B (the ``serve`` model) on the split path in bf16
    (``serve_split``), on the unified step with both int8 knobs
    (``serve_int8``, the ``serve`` requests) and on the split path with
    both (``serve_split_int8``); #6 on the live caches (``cache_attend``)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    layers = model.config.num_hidden_layers
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "paged_decode_append_attend": pa.paged_decode_append_attend}
    sp = split_prompts(np, model.config.vocab_size, SEED + 8)
    launches = {}
    for phase, kw in (("serve_split", {}),
                      ("serve_split_int8", {"kv_dtype": "int8",
                                            "weight_dtype": "int8"})):
        t0 = time.perf_counter()
        eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                        dtype=torch.bfloat16, unified_step=False,
                        steps_per_sync=SPLIT_SPS, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        stats = serve_split_run(torch, eng, sp, counters,
                                attend_layers=(0, layers - 1))
        emit({"phase": phase, "model": "llama3_8b", "layers": layers,
              "steps_per_sync": SPLIT_SPS, **kw, "setup_s": setup_s,
              "kv_pool_bytes": kv_bytes(eng.cache),
              "weight_bytes": engine_weight_bytes(eng), **stats})
        check_split_launches(stats, layers, phase)
        launches[phase] = stats
        # where a split decode forward's time goes: fresh prompts, traced
        prof = profile_split_serve(
            torch, eng, split_prompts(np, model.config.vocab_size,
                                      SEED + 11))
        emit({"phase": f"{phase}_profile", **prof})
        check_tensor_core_route(prof, f"{phase}_profile", ("paged_decode",),
                                design="split")
        if phase == "serve_split_int8":
            check_tensor_core_route(prof, f"{phase}_profile",
                                    ("flash_fwd",), design="3xtf32")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    kv_dtype="int8", weight_dtype="int8")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stats, _ = serve_run(torch, eng, prompts, counters)
    c = eng.cache
    emit({"phase": "serve_int8", "model": "llama3_8b", "layers": layers,
          "kv_dtype": "int8", "weight_dtype": "int8", "setup_s": setup_s,
          "kv_pool_bytes": kv_bytes(c),
          "kv_code_bytes": 2 * c.k_pages.numel(),
          "kv_scale_bytes": 2 * 4 * c.k_scales.numel(),
          "bf16_kv_pool_bytes": bf16_pool_bytes,
          "weight_bytes": engine_weight_bytes(eng), **stats})
    n = stats["launches"]
    check(n["ragged_paged_append_attend"] == layers * stats["steps"]
          and n["flash_attention_fwd"] > 0
          and n["paged_decode_append_attend"] == 0,
          f"serve_int8 launches {n}")
    table["ragged_paged_append_attend_int8"]["launches"] = \
        n["ragged_paged_append_attend"]
    table["flash_attention_fwd_f32_prefill"]["launches"] = \
        launches["serve_split_int8"]["launches"]["flash_attention_fwd"]
    table["paged_decode_append_attend"]["launches"] = \
        launches["serve_split"]["launches"]["paged_decode_append_attend"]
    table["paged_attention"]["launches"] = \
        launches["serve_split"]["cache_attend_launches"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def serve_moe_split_int8(torch, np, dev, model):
    """Qwen1.5-MoE-A2.7B at full depth on the split path with both int8
    knobs: #7 int8 at group 1, #11 on the int8 expert stacks widened to
    bf16 (3 a layer a forward, prefill chunks included)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import paged_attention as pa
    layers = model.config.num_hidden_layers
    t0 = time.perf_counter()
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    unified_step=False, steps_per_sync=SPLIT_SPS,
                    kv_dtype="int8", weight_dtype="int8")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "paged_decode_append_attend": pa.paged_decode_append_attend,
                "grouped_matmul": gm.gmm_raw}
    stats = serve_split_run(torch, eng, split_prompts(
        np, model.config.vocab_size, SEED + 9), counters)
    chunks = sum(-(-m // 128) for m in stats["prompt_lens"].values())
    emit({"phase": "serve_moe_split_int8", "model": "qwen1.5_moe_a2.7b",
          "layers": layers, "steps_per_sync": SPLIT_SPS, "kv_dtype": "int8",
          "weight_dtype": "int8", "setup_s": setup_s,
          "kv_pool_bytes": kv_bytes(eng.cache),
          "weight_bytes": engine_weight_bytes(eng),
          "grouped_matmul_launches_per_forward":
          stats["launches"]["grouped_matmul"] / (stats["forwards"] + chunks),
          **stats})
    check_split_launches(stats, layers, "serve_moe_split_int8")
    check(stats["launches"]["grouped_matmul"]
          == 3 * layers * (stats["forwards"] + chunks),
          f"#11 launched {stats['launches']['grouped_matmul']} times, not "
          f"{3 * layers} a forward")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def serve_quant_reference(torch, np, dev):
    """f32, 2 layers at Llama-3-8B width, TF32 off: split-float,
    unified-int8 and split-int8 engines on the card and on the CPU (the
    plain versions) with the same weights and prompts.  Greedy tokens
    must be equal; the first-token logits within 1e-4 (relative L2) in
    float mode and 1e-3 in int8 mode, where cuBLAS and the CPU may round
    a K/V element across a code boundary (one code is 1/254 of a row's
    range) or a weight product differently before the scale."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    cfg = dataclasses.replace(llama3_8b_config(), num_hidden_layers=2)
    cpu = torch.device("cpu")
    t_models = time.perf_counter()
    model_cpu = LlamaForCausalLM(
        cfg, device=cpu, dtype=torch.float32,
        generator=torch.Generator(device=cpu).manual_seed(SEED + 10))
    model_gpu = LlamaForCausalLM(
        cfg, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 10))
    model_gpu.load_state_dict(model_cpu.state_dict())
    rng = np.random.default_rng(SEED + 10)
    prompts = {"q37": rng.integers(0, cfg.vocab_size, 37).tolist(),
               "q150": rng.integers(0, cfg.vocab_size, 150).tolist()}
    rep, seconds = {}, {"models": time.perf_counter() - t_models}
    for name, kw, tol in (
            ("split_float", {"unified_step": False}, 1e-4),
            ("unified_int8", {"kv_dtype": "int8", "weight_dtype": "int8"},
             1e-3),
            ("split_int8", {"unified_step": False, "kv_dtype": "int8",
                            "weight_dtype": "int8"}, 1e-3)):
        out = []
        for m, d in ((model_gpu, dev), (model_cpu, cpu)):
            t_eng = time.perf_counter()
            eng = LLMEngine(m, max_seqs=4, max_len=512, page_size=128,
                            steps_per_sync=SPLIT_SPS, device=d, **kw)
            slot = eng.cache.allocate(len(prompts["q37"]) + 1)
            logits = eng._prefill_seq(slot, prompts["q37"], 0).float().cpu()
            eng.cache.release(slot)
            for rid, ids in prompts.items():
                eng.add_request(rid, ids, max_new_tokens=4)
            while eng.has_work():
                eng.step()
            out.append((logits, {r: eng.result(r) for r in prompts}))
            seconds[f"{name}_{d.type}"] = time.perf_counter() - t_eng
            del eng
        (lg, tg), (lc, tc) = out
        rel = ((lg - lc).norm() / lc.norm()).item()
        rep[name] = {"logits_rel_l2_err": rel, "tolerance": tol,
                     "greedy_tokens_equal": tg == tc, "tokens": tg}
        check(bool(torch.isfinite(lg).all()), f"{name}: logits not finite")
        check(rel <= tol, f"{name}: card logits off the CPU's by {rel}")
        check(tg == tc, f"{name}: card tokens {tg} != CPU tokens {tc}")
    emit({"phase": "serve_quant_reference", "dtype": "float32", "layers": 2,
          **rep, "seconds": seconds})
    del model_cpu, model_gpu
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# KV pools in another float dtype than the weights (the mixed-dtype mode of
# #1, #6 and #7), preemption, swap and migration
# ---------------------------------------------------------------------------

SERVE_SPS = 16          # bench.py bench_engine's steps_per_sync
# the preempt phase: eight requests admitted at once, then three late ones
PREEMPT_LENS = {"e37": 37, "e128": 128, "e300": 300, "e1000": 1000,
                "e200": 200, "e64": 64, "e500": 500, "e90": 90}
PREEMPT_NEW = 48
LATE_LENS = {"n50": 50, "n150": 150, "n20": 20}
LATE_NEW = 16
MARGIN_TOL = 1e-3       # relative top-2 logit margin of a tolerated split
# bf16 logits at full depth: a tolerated split's top-2 margin in bf16 steps
# of the top logit (a step is 2^-8 to 2^-7 of it).  Coarse: two paths'
# bf16 logits over 32 random layers part by several steps (first splits
# seen at 3 and 4), so it catches gross errors only; the f32 2-layer
# checks (``f32_decode_agreement``) hold the same paths to MARGIN_TOL
BF16_MARGIN_STEPS = 8


def serve_default_pools(torch, dev, table, model, prompts):
    """The bf16 ``serve`` model with the pool dtype left at its default:
    f32 pools, as the reference builds them (``dtype=np.float32``), so #1
    runs bf16 q over f32 pools; the ``serve`` requests."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    layers = model.config.num_hidden_layers
    t0 = time.perf_counter()
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(eng.cache.k_pages.dtype == torch.float32,
          f"default pools are {eng.cache.k_pages.dtype}, not float32")
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd}
    stats, _ = serve_run(torch, eng, prompts, counters)
    emit({"phase": "serve_default_pools", "model": "llama3_8b",
          "layers": layers, "weight_dtype": "bfloat16",
          "pool_dtype": "float32", "setup_s": setup_s,
          "kv_pool_bytes": kv_bytes(eng.cache),
          "weight_bytes": engine_weight_bytes(eng), **stats})
    n = stats["launches"]
    check(n["ragged_paged_append_attend"] == layers * stats["steps"]
          and n["flash_attention_fwd"] > 0,
          f"serve_default_pools launches {n}")
    table["ragged_paged_append_attend_bfloat16_q_float32_pools"][
        "launches"] = n["ragged_paged_append_attend"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def top2_margin(logits):
    """Relative gap between the two largest logits."""
    top = logits.float().topk(2).values
    return ((top[0] - top[1]) / top[0].abs().clamp_min(1e-30)).item()


def bf16_steps(logits):
    """The top-2 margin of bf16 logits in bf16 steps (2^(e - 7) at the
    top logit's binade 2^e)."""
    top = logits.float().topk(2).values
    step = 2.0 ** (math.floor(math.log2(top[0].abs().clamp_min(1e-30)
                                        .item())) - 7)
    return ((top[0] - top[1]) / step).item()


def agreement(torch, eng, prompts, got, want):
    """Per request: tokens equal, or the first divergence with the top-2
    margin (relative) of the unpreempted run's choice there, from a
    prefill of the prompt and the unpreempted tokens before it on
    ``eng``.  Fails on a divergence whose margin exceeds MARGIN_TOL, or,
    where ``eng``'s logits are bf16 (a relative step of 2^-8 to 2^-7),
    BF16_MARGIN_STEPS bf16 steps of the top logit."""
    rep = {}
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            rep[rid] = {"equal": True}
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        seq = prompts[rid] + w[:j]
        slot = eng.cache.allocate(len(seq) + 1)
        logits = eng._prefill_seq(slot, seq, 0)
        eng.cache.release(slot)
        margin = top2_margin(logits)
        rep[rid] = {"equal": False, "first_divergence": j,
                    "top2_margin_rel": margin}
        if logits.dtype == torch.bfloat16:
            steps = bf16_steps(logits)
            rep[rid]["top2_margin_bf16_steps"] = steps
            check(steps <= BF16_MARGIN_STEPS,
                  f"request {rid} parts from the other run at token {j} "
                  f"where the top-2 margin is {steps} bf16 steps, above "
                  f"{BF16_MARGIN_STEPS}")
            continue
        check(margin <= MARGIN_TOL,
              f"request {rid} parts from the unpreempted run at token {j} "
              f"where the top-2 margin is {margin} (relative), above "
              f"{MARGIN_TOL}")
    return rep


def preempt_phase(torch, np, dev, model, kw):
    """Preemption, swap and migration on the f32-weight, bf16-pool
    engine (``kw``: the serving arguments, ``steps_per_sync`` 16).  Eight
    requests admit and run two windows; three are suspended: e128 swaps
    and is exported and imported into a second engine on the same model,
    e300 swaps into a host pool of one page (its private page: its full
    pages are registered prefix pages, unpinned and re-pinned by key),
    e1000 finds the pool full and recomputes (its registered prompt
    pages from the prefix cache, the last chunk through the flash
    prefill, its 32 generated tokens through #7).  Three late requests
    admit into the freed slots; the suspended ones resume as soon as the
    capacity allows.  Checks: the swapped-in pages equal the swapped-out
    bytes, every request returns its budget, #7 launches exactly once a
    layer a replayed token, and every request's tokens agree with an
    unpreempted run of the same prompts (``agreement``)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.ops import paged_attention as pa
    layers = model.config.num_hidden_layers
    rng = np.random.default_rng(SEED + 16)
    lens = {**PREEMPT_LENS, **LATE_LENS}
    prompts = {rid: rng.integers(0, model.config.vocab_size, n).tolist()
               for rid, n in lens.items()}
    budget = {rid: PREEMPT_NEW if rid in PREEMPT_LENS else LATE_NEW
              for rid in prompts}

    base = LLMEngine(model, **kw)                 # the unpreempted run
    for group in (PREEMPT_LENS, LATE_LENS):
        for rid in group:
            base.add_request(rid, prompts[rid], max_new_tokens=budget[rid])
        while base.has_work():
            base.step()
    want = {rid: base.result(rid) for rid in prompts}
    del base
    gc.collect()
    torch.cuda.empty_cache()

    eng = LLMEngine(model, **kw, swap_pool_pages=1)
    dst = LLMEngine(model, **kw)
    t_run = time.perf_counter()
    for rid in PREEMPT_LENS:
        eng.add_request(rid, prompts[rid], max_new_tokens=PREEMPT_NEW)
    eng.step()
    eng.step()
    cache = eng.cache
    req = eng.requests["e300"]
    written = cache._pages[req.slot][:-(-int(cache.seq_lens[req.slot])
                                        // cache.page_size)]
    before = [p[:, :, written].clone() for p in (cache.k_pages,
                                                 cache.v_pages)]
    out_at_suspend = {r: len(eng.requests[r].out)
                      for r in ("e128", "e300", "e1000")}
    t = time.perf_counter()
    armed = {"e128": eng.suspend("e128")}
    pkg = eng.export_request("e128")
    export_s = time.perf_counter() - t
    armed["e300"] = eng.suspend("e300")
    armed["e1000"] = eng.suspend("e1000")
    check(armed == {"e128": True, "e300": True, "e1000": False},
          f"swap paths armed {armed}: e1000 should find the pool full")
    check(eng.suspended_count() == 2 and eng.capacity()[0] == 3,
          f"capacity after three suspensions {eng.capacity()}")
    for rid in LATE_LENS:
        eng.add_request(rid, prompts[rid], max_new_tokens=LATE_NEW)

    t = time.perf_counter()
    dst.import_request(pkg)
    paths = {"e128": dst.resume("e128")}
    migrate_s = time.perf_counter() - t
    while dst.has_work():
        dst.step()

    pending, resume_s, replay = ["e300", "e1000"], {}, None
    swapped_equal = None
    while pending or eng.has_work():
        while pending:
            r = eng.requests[pending[0]]
            need = -(-(len(r.prompt) + r.max_new) // cache.page_size)
            slots, free = eng.capacity()
            if slots < 1 or free < need:
                break
            rid = pending.pop(0)
            pa.paged_decode_append_attend.launches = 0
            t = time.perf_counter()
            paths[rid] = eng.resume(rid)
            torch.cuda.synchronize()
            resume_s[rid] = time.perf_counter() - t
            n7 = pa.paged_decode_append_attend.launches
            if rid == "e300":
                now = cache._pages[r.slot][:len(written)]
                swapped_equal = all(
                    torch.equal(p[:, :, now], b)
                    for p, b in zip((cache.k_pages, cache.v_pages), before))
                check(n7 == 0, f"the swap-in launched #7 {n7} times")
            else:
                replay = {"tokens": out_at_suspend[rid] - 1,
                          "paged_decode_append_attend_launches": n7}
                check(n7 == layers * (out_at_suspend[rid] - 1),
                      f"the recompute launched #7 {n7} times, not "
                      f"{layers} x {out_at_suspend[rid] - 1} replayed "
                      f"tokens")
        check(eng.has_work() or not pending,
              f"{pending} cannot resume on an idle engine")
        if eng.has_work():
            eng.step()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    check(paths == {"e128": "swap_in", "e300": "swap_in",
                    "e1000": "recompute"}, f"restore paths {paths}")
    check(swapped_equal, "swapped-in pages differ from the swapped-out ones")
    got = {rid: (dst if rid == "e128" else eng).result(rid)
           for rid in prompts}
    for rid, toks in got.items():
        check(len(toks) == budget[rid],
              f"request {rid} returned {len(toks)} tokens, not "
              f"{budget[rid]}")
    rep = agreement(torch, eng, prompts, got, want)
    emit({"phase": "preempt", "model": "llama3_8b", "layers": layers,
          "weight_dtype": "float32", "pool_dtype": "bfloat16",
          "steps_per_sync": kw["steps_per_sync"], "swap_pool_pages": 1,
          "prompt_lens": lens, "max_new": budget, "paths": paths,
          "swapped_pages_equal": swapped_equal,
          "swapped_pages": len(written),
          "export_blob_bytes": len(pkg["swap"]), "export_s": export_s,
          "migrate_s": migrate_s, "resume_s": resume_s, "replay": replay,
          "run_s": run_s, "agreement": rep,
          "all_equal": all(v["equal"] for v in rep.values())})
    del eng, dst
    gc.collect()
    torch.cuda.empty_cache()


# -- sampling, the model's own decode and speculative decoding ---------------
SAMPLING = dict(decode_strategy="sampling", top_k=50, top_p=0.9,
                temperature=0.8, seed=1234)
SAMPLING_SPLIT_SPS = 8
TV_DRAWS, TV_CHUNK, TV_TOL = 65536, 2048, 0.03
DRAW_ROWS = 64              # card against CPU draws of one logits row
DRAW_GAP = 1e-5             # a row's tokens must agree above this gap
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 32
SPEC_K = 4
MIN_SELF_ACCEPTANCE = 0.9
# the f32 2-layer decode check: prompts (the first two, of equal length,
# also through generate) and new tokens
F32_DECODE_LENS, F32_DECODE_NEW = (128, 128, 37, 200), 16


def llama32_1b_draft_config(cfg):
    """A draft at Llama-3.2-1B's published widths (hidden 2048, MLP 8192,
    16 layers, 32 heads of 64, 8 KV heads, tied embeddings, rope theta
    500000; without Llama 3.2's rope scaling), the target's vocabulary
    and position limit."""
    return dataclasses.replace(
        cfg, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=8,
        tie_word_embeddings=True, rope_theta=500000.0)


def draws_card_vs_cpu(torch, np, dev, logits):
    """One bf16 logits row repeated over DRAW_ROWS rows, drawn per row on
    the card and on the CPU with the same key: the random words equal,
    and the tokens equal in every row whose two largest perturbed
    filtered logits are more than DRAW_GAP apart (``log`` rounds on its
    own on each device).  Unfiltered and with the phase's filters."""
    from paddle_tpu_torch.common import prng
    from paddle_tpu_torch.nn.generation import _filtered_logits, sample_logits
    key = prng.prng_key(SAMPLING["seed"])
    v = logits.shape[-1]
    x = logits[None].expand(DRAW_ROWS, v)
    rows = np.arange(DRAW_ROWS)
    rep = {"rows": DRAW_ROWS,
           "bits_equal": bool(torch.equal(
               prng.random_bits(key, (DRAW_ROWS, v), device=dev).cpu(),
               prng.random_bits(key, (DRAW_ROWS, v))))}
    check(rep["bits_equal"], "threefry words on the card differ from the CPU")
    keys = prng.fold_in_rows(key, torch.as_tensor(rows))
    noise = prng._gumbel_from_bits(prng._bits_at(
        keys[:, 0:1], keys[:, 1:2], torch.arange(v)[None]))
    for name, kw in (("unfiltered", {}),
                     ("filtered", {k: SAMPLING[k] for k in
                                   ("top_k", "top_p", "temperature")})):
        got, _ = sample_logits(x, key, strategy="sampling", row_ids=rows,
                               **kw)
        want, _ = sample_logits(x.cpu(), key, strategy="sampling",
                                row_ids=rows, **kw)
        filt = _filtered_logits(x.cpu(), kw.get("top_k", 0),
                                kw.get("top_p", 1.0),
                                kw.get("temperature", 1.0))
        top2 = (filt + noise).topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > DRAW_GAP
        same = got.cpu() == want
        rep[name] = {"rows_clear": int(clear.sum()),
                     "tokens_equal": int(same.sum()),
                     "unequal_clear_rows": int((clear & ~same).sum())}
        check(bool(same[clear].all()),
              f"{name} draws on the card differ from the CPU: {rep[name]}")
    return rep


def draws_fit_filtered_probs(torch, np, dev, logits):
    """TV_DRAWS per-row draws (row ids 0 ..) from one bf16 logits row
    with the phase's knobs; their histogram against ``filtered_probs``
    of the row (total variation)."""
    from paddle_tpu_torch.common import prng
    from paddle_tpu_torch.nn.generation import filtered_probs, sample_logits
    kw = {k: SAMPLING[k] for k in ("top_k", "top_p", "temperature")}
    key = prng.prng_key(SAMPLING["seed"])
    v = logits.shape[-1]
    counts = torch.zeros(v, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    for r0 in range(0, TV_DRAWS, TV_CHUNK):
        tok, _ = sample_logits(logits[None].expand(TV_CHUNK, v), key,
                               strategy="sampling",
                               row_ids=np.arange(r0, r0 + TV_CHUNK), **kw)
        counts += torch.bincount(tok.long(), minlength=v).double()
    torch.cuda.synchronize()
    p = filtered_probs(logits[None], strategy="sampling", **kw)[0].double()
    tv = 0.5 * (counts / TV_DRAWS - p).abs().sum().item()
    rep = {"draws": TV_DRAWS, "support": int((p > 0).sum()),
           "total_variation": tv, "tolerance": TV_TOL,
           "draw_s": time.perf_counter() - t0}
    check(tv <= TV_TOL, f"draws off filtered_probs: total variation {tv}")
    return rep


def top1_draws_only(torch, np, eng):
    """Make ``eng`` (``top_k=1``) check each token it draws: its logit is
    its row's largest, bit for bit (bf16 logits tie often, and top-k
    keeps every tied entry where greedy takes the first).  Returns the
    running counts of draws and of draws off the first arg max."""
    counts = {"draws": 0, "off_first_argmax": 0}
    draw = eng._sample

    def checked(logits, key, rows):
        out = draw(logits, key, rows)
        rows = np.asarray(list(rows), np.int64)
        if rows.size:
            x = logits[torch.as_tensor(rows, device=logits.device)].float()
            tok = torch.as_tensor(out[rows], device=logits.device)
            check(bool((x.gather(-1, tok[:, None])[:, 0]
                        == x.max(-1).values).all()),
                  "top_k=1 drew a token below its row's largest logit")
            counts["draws"] += int(rows.size)
            counts["off_first_argmax"] += int((tok != x.argmax(-1)).sum())
        return out

    eng._sample = checked
    return counts


def serve_sampling_phase(torch, np, dev, model, prompts, greedy, greedy_stats):
    """The ``serve`` model and requests under the sampling knobs, unified
    (twice: equal tokens for one seed), with ``top_k=1`` (the greedy
    tokens, by the margin rule), then split at steps_per_sync 8; the
    draws on the card against the CPU and against ``filtered_probs``."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    layers = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    geom = dict(max_seqs=8, max_len=2048, page_size=128,
                dtype=torch.bfloat16)
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd}
    runs = []
    for _ in range(2):
        eng = LLMEngine(model, **geom, **SAMPLING)
        stats, results = serve_run(torch, eng, prompts, counters)
        n = stats["launches"]
        check(n["ragged_paged_append_attend"] == layers * stats["steps"]
              and n["flash_attention_fwd"] == layers * -(-len(
                  prompts["a200"]) // 128),
              f"serve_sampling launches {n} in {stats['steps']} steps")
        for rid, out in results.items():
            check(all(0 <= t < vocab for t in out),
                  f"serve_sampling: {rid} drew a token outside the "
                  f"vocabulary")
        runs.append((stats, results))
    (stats, results), (_, again) = runs
    check(again == results, "serve_sampling: one seed, other tokens")
    check(results != greedy, "serve_sampling drew the greedy tokens")
    eng = LLMEngine(model, **geom, **dict(SAMPLING, top_k=1))
    ties = top1_draws_only(torch, np, eng)
    _, k1 = serve_run(torch, eng, prompts, counters)
    k1_rep = {"draws": ties, **agreement(torch, eng, prompts, k1, greedy)}
    slot = eng.cache.allocate(len(prompts["b37"]) + 1)
    logits = eng._prefill_seq(slot, prompts["b37"], 0)
    eng.cache.release(slot)
    del eng
    draws = draws_card_vs_cpu(torch, np, dev, logits)
    tv = draws_fit_filtered_probs(torch, np, dev, logits)
    split = LLMEngine(model, **geom, **SAMPLING, unified_step=False,
                      steps_per_sync=SAMPLING_SPLIT_SPS)
    counters["paged_decode_append_attend"] = pa.paged_decode_append_attend
    split_stats = serve_split_run(torch, split, prompts, counters)
    check_split_launches(split_stats, layers, "serve_sampling split")
    del split
    emit({"phase": "serve_sampling", "model": "llama3_8b", "layers": layers,
          "knobs": SAMPLING, **stats, "same_seed_tokens_equal": True,
          "greedy_decode_tok_s": greedy_stats["decode_tok_s"],
          "greedy_ttft_s": greedy_stats["ttft_s"],
          "top_k1_agreement": k1_rep, "draws_card_vs_cpu": draws,
          "draws_vs_filtered_probs": tv,
          "split": {"steps_per_sync": SAMPLING_SPLIT_SPS, **split_stats}})
    gc.collect()
    torch.cuda.empty_cache()


def generate_phase(torch, np, dev, model):
    """``model.generate`` on the ``serve`` model: GEN_BATCH prompts of
    GEN_PROMPT ids, GEN_NEW new tokens, greedy (its tokens against the
    engine's greedy tokens for the same prompts, margin rule), sampling
    with the phase's knobs twice (equal tokens), then beam search (4
    beams, 2 prompts, length penalty 1, an EOS).  Each call counts its
    launches from 0: the causal flash forward #2 once a layer (the
    prefill), matmul+rope #10 twice (q, k) and add+RMSNorm #9 once a layer
    a forward (GEN_NEW forwards: the prefill and GEN_NEW - 1 steps)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    layers = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    rng = np.random.default_rng(SEED + 15)
    ids = rng.integers(0, vocab, (GEN_BATCH, GEN_PROMPT))
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "matmul_rope": ft.matmul_rope_raw,
                "add_norm": ft.add_rms_norm_raw}
    want = {"flash_attention_fwd": layers, "matmul_rope": 2 * layers * GEN_NEW,
            "add_norm": layers * GEN_NEW}
    rep = {}

    def run(name, ids, **kw):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, scores = model.generate(torch.as_tensor(ids, device=dev),
                                     max_new_tokens=GEN_NEW, **kw)
        out, scores = out.cpu(), scores.cpu()
        dt = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        check(launches == want, f"generate {name} launched {launches}, not "
                                f"{want}")
        check(out.shape == (ids.shape[0], GEN_NEW)
              and bool(((out >= 0) & (out < vocab)).all())
              and bool(torch.isfinite(scores).all()),
              f"generate {name}: bad output {out.shape} {scores}")
        rep[name] = {"batch": int(ids.shape[0]), "seconds": dt,
                     "decode_tok_s": ids.shape[0] * GEN_NEW / dt,
                     "launches": launches, "scores": scores.tolist()}
        return out

    greedy = run("greedy", ids)
    prompts = {f"g{i}": ids[i].tolist() for i in range(GEN_BATCH)}
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    dtype=torch.bfloat16)
    for rid, p in prompts.items():
        eng.add_request(rid, p, max_new_tokens=GEN_NEW)
    while eng.has_work():
        eng.step()
    rep["greedy"]["engine_agreement"] = agreement(
        torch, eng, prompts, {r: greedy[i].tolist()
                              for i, r in enumerate(prompts)},
        {r: eng.result(r) for r in prompts})
    del eng
    a = run("sampling", ids, **SAMPLING)
    b = run("sampling_again", ids, **SAMPLING)
    check(torch.equal(a, b), "generate sampling: one seed, other tokens")
    eos = int(greedy[0, 5])
    beam = run("beam_search", ids[:2], decode_strategy="beam_search",
               num_beams=4, length_penalty=1.0, eos_token_id=eos,
               pad_token_id=0)
    for row in beam.tolist():
        if eos in row:
            check(all(t == 0 for t in row[row.index(eos) + 1:]),
                  f"beam search: tokens after EOS {row}")
    rep["beam_search"]["eos"] = eos
    emit({"phase": "generate", "model": "llama3_8b", "layers": layers,
          "dtype": "bfloat16", "prompt_len": GEN_PROMPT,
          "new_tokens": GEN_NEW, "knobs": SAMPLING, **rep})
    gc.collect()
    torch.cuda.empty_cache()


def spec_serve(torch, eng, prompts, counters):
    """``serve_run`` on a speculative engine, with its draft forwards,
    draft prefill chunks and verify windows counted from 0, and the #1,
    #2 and #7 launches checked against them: #1 once a target layer a
    plain unified step (prefill pending) or verify, #7 (the draft's only
    attention kernel; the target's unified path never runs it) once a
    draft layer a draft forward, #2 once a target layer an add_request
    prefill chunk and once a draft layer a draft prefill chunk."""
    seen = {"draft_forwards": 0, "draft_chunks": 0, "plain_steps": 0}
    draft, prefill = eng._draft_decode, eng._spec_prefill
    mixed = eng._step_mixed

    def draft_decode(*a):
        seen["draft_forwards"] += 1
        return draft(*a)

    def spec_prefill(dslot, seq):
        seen["draft_chunks"] += -(-len(seq) // eng._spec_cache.page_size)
        return prefill(dslot, seq)

    def step_mixed():
        seen["plain_steps"] += 1
        return mixed()

    eng._draft_decode, eng._spec_prefill = draft_decode, spec_prefill
    eng._step_mixed = step_mixed
    stats, results = serve_run(torch, eng, prompts, counters)
    st = eng.spec_stats
    n = stats["launches"]
    t_layers = eng.config.num_hidden_layers
    d_layers = len(eng._spec["layers"])
    P = eng.cache.page_size
    want = {"ragged_paged_append_attend":
            t_layers * (seen["plain_steps"] + st["windows"]),
            "paged_decode_append_attend": d_layers * seen["draft_forwards"],
            "flash_attention_fwd": t_layers * -(-len(prompts["a200"]) // P)
            + d_layers * seen["draft_chunks"]}
    check(n == want, f"serve_spec launches {n}, not {want} ({seen}, {st})")
    check(st["proposed"] >= st["accepted"] >= 0 and st["windows"] > 0,
          f"spec_stats inconsistent: {st}")
    for rid, out in results.items():
        check(all(0 <= t < eng.config.vocab_size for t in out),
              f"serve_spec: {rid} returned a token outside the vocabulary")
    return dict(stats, **seen, spec_stats=dict(st),
                acceptance=st["accepted"] / st["proposed"]), results


@contextlib.contextmanager
def verify_rejections(torch):
    """Within it, each greedy rejection of a speculative window records
    the target's margin of its own token over the rejected draft token in
    that verify row's logits, in bf16 steps of the row's top logit (a
    draft that is the target itself parts from it only where the two
    paths' roundings tip a near tie)."""
    from paddle_tpu_torch.inference import engine as E
    from paddle_tpu_torch.inference import speculative as SP
    seen = {"rejections": 0, "max_margin_bf16_steps": 0.0}
    state = {}
    mixed, accept = E._mixed_forward, SP.greedy_accept

    def mixed_rec(*args, **kw):
        state["logits"], state["row"] = mixed(*args, **kw), 0
        return state["logits"]

    def accept_rec(draft, target):
        toks, a = accept(draft, target)
        k, i = len(draft), state["row"]
        state["row"] += 1
        if a < k:
            x = state["logits"][i * (k + 1) + a].float()
            step = 2.0 ** (math.floor(math.log2(x.max().abs().item())) - 7)
            seen["rejections"] += 1
            seen["max_margin_bf16_steps"] = max(
                seen["max_margin_bf16_steps"],
                ((x[int(target[a])] - x[int(draft[a])]) / step).item())
        return toks, a

    E._mixed_forward, SP.greedy_accept = mixed_rec, accept_rec
    try:
        yield seen
    finally:
        E._mixed_forward, SP.greedy_accept = mixed, accept


# the CUDA runtime calls that copy to the host or wait for the card, and
# the device's copies to the host, as torch.profiler names them
SYNC_RUNTIME = ("cudaMemcpy", "cudaMemcpyAsync", "cudaStreamSynchronize",
                "cudaDeviceSynchronize", "cudaEventSynchronize")


METRICS_TRACED_NEW = 4          # new tokens a request in the traced pair


def host_syncs(torch, fn):
    """Run ``fn()`` under torch.profiler: its result and the counts of
    the ``SYNC_RUNTIME`` calls (device-to-host copies are
    ``cudaMemcpyAsync`` with a stream wait; host-to-device copies of
    host arrays go through the same call) and of the device's
    ``Memcpy DtoH`` copies."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        name = e.key
        if name in SYNC_RUNTIME or name.startswith("Memcpy DtoH"):
            key = "Memcpy DtoH" if name.startswith("Memcpy DtoH") else name
            counts[key] = counts.get(key, 0) + e.count
    return out, counts


def serve_metrics_phase(torch, np, dev, model, prompts, greedy):
    """The serve model with the engine's metrics on (the default) and
    off.  A fresh engine serves the serve mix twice, metrics off, then
    on (host-clock rates spread between calls, so the phase reports them
    beside each other and holds the work instead): the tokens must equal
    the ``serve`` phase's, and, in one traced serve
    each way, the count of CUDA runtime calls that copy to the host or
    wait for the card, and of the card's copies to the host, must be
    equal with and without metrics (the mix, deferred, 8 new tokens).  Then ``metrics_snapshot()``, the
    byte size of the registry's Prometheus text, the spans of one
    traced request (admission, steps, a suspend and resume by swap-in)
    and their Chrome trace, the memory plane's device row, and the
    cache's ``memory_rows()["device_bytes"]`` against the pools' bytes."""
    import os
    import tempfile

    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.observability import (get_registry,
                                                introspection, tracing)
    geom = dict(max_seqs=8, max_len=2048, page_size=128,
                dtype=torch.bfloat16)
    runs, seconds = [], {}
    t0 = time.perf_counter()
    for on in (False, True):
        eng = LLMEngine(model, **geom, enable_metrics=on)
        stats, results = serve_run(torch, eng, prompts, {})
        check(results == greedy,
              f"metrics {'on' if on else 'off'}: tokens differ from the "
              f"serve phase's")
        runs.append({"metrics": on, "decode_tok_s": stats["decode_tok_s"],
                     "ttft_s": stats["ttft_s"], "serve_s": stats["serve_s"],
                     "steps": stats["steps"]})
        del eng
    def short_serve(eng):
        for rid, ids in prompts.items():
            eng.begin_request(rid, ids, max_new_tokens=METRICS_TRACED_NEW)
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
        return steps

    seconds["serves"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    syncs = {}
    for on in (False, True):
        eng = LLMEngine(model, **geom, enable_metrics=on)
        steps, counts = host_syncs(torch, lambda: short_serve(eng))
        syncs["on" if on else "off"] = {
            "steps": steps, "counts": counts,
            "per_step": {k: v / steps for k, v in counts.items()}}
        if on:
            snap = eng.metrics_snapshot()
        del eng
    seconds["host_syncs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    text = get_registry().expose_text()
    eng = LLMEngine(model, **geom)
    rows = eng.cache.memory_rows()
    tr = tracing.enable_tracing()
    try:
        eng.add_request("t_a200", prompts["a200"], max_new_tokens=8)
        eng.begin_request("t_b37", prompts["b37"], max_new_tokens=8)
        for _ in range(3):
            eng.step()
        eng.suspend("t_a200")
        eng.step()
        eng.resume("t_a200")
        while eng.has_work():
            eng.step()
        spans = tr.finished_spans()
        chrome = tr.to_chrome_trace()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "serve.chrome_trace.json")
            with open(path, "w") as f:
                json.dump(chrome, f)
            chrome_bytes = os.path.getsize(path)
    finally:
        tracing.disable_tracing()
    names = sorted({s["name"] for s in spans})
    memz = introspection.memz_snapshot()
    seconds["traced_request"] = time.perf_counter() - t0
    emit({"phase": "serve_metrics", "model": "llama3_8b",
          "runs": runs, "host_syncs": syncs, "metrics_snapshot": snap,
          "prometheus_text_bytes": len(text.encode("utf-8")),
          "prometheus_series_lines": sum(
              1 for ln in text.splitlines() if not ln.startswith("#")),
          "span_names": names, "span_count": len(spans),
          "chrome_trace_events": len(chrome["traceEvents"]),
          "chrome_trace_bytes": chrome_bytes,
          "memory_rows": rows, "kv_bytes": kv_bytes(eng.cache),
          "memz_devices": memz["devices"], "seconds": seconds})
    check(syncs["on"]["steps"] == syncs["off"]["steps"]
          and syncs["on"]["counts"] == syncs["off"]["counts"],
          f"metrics on and off copy to the host or wait for the card a "
          f"different number of times: {syncs}")
    check(syncs["on"]["counts"].get("Memcpy DtoH", 0) > 0,
          f"no device-to-host copy traced: {syncs}")
    check(rows["device_bytes"] == kv_bytes(eng.cache),
          f"memory_rows device_bytes {rows['device_bytes']} != pool bytes "
          f"{kv_bytes(eng.cache)}")
    for want in ("engine.prefill_chunk", "engine.mixed_step",
                 "engine.swap_out", "engine.swap_in", "llm_engine.prefill",
                 "llm_engine.decode"):
        check(want in names, f"no {want} span in the traced request: "
                             f"{names}")
    check(snap["generated_tokens"] == len(SERVE_LENS) * METRICS_TRACED_NEW
          and snap["requests"] == len(SERVE_LENS)
          and snap["prefill_compiles"] == 0
          and snap["ttft_seconds"]["count"] == len(SERVE_LENS),
          f"metrics_snapshot of the serve: {snap}")
    check(memz["devices"] and memz["devices"][0]["bytes_in_use"] > 0,
          f"the memory plane read no device: {memz['devices']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


# -- the serving runtime (paddle_tpu_torch.serving) over the serve model -----
OVERLOAD_N = 24                 # requests in the overload burst
OVERLOAD_LEN, OVERLOAD_NEW = 256, 64
OVERLOAD_QUEUE = 16             # the scheduler's max_queue
OVERLOAD_FIRST = 18             # low-priority wave: 2 past the queue bound
OVERLOAD_DEADLINE_S = 1.5       # on every third request (host clock)
ROUTER_STEPS = 8                # router steps before drain_replica(0)
# a remote migration posts the KV blob base64 in JSON: one 128-token
# bf16 page of Llama-3-8B is 32 x 8 x 128 x 128 x 2 (K, V) x 2 bytes =
# 16 MiB, 22.4 MiB once encoded; the receiving frontend takes bodies up
# to 256 MiB (the default 4 MiB would refuse a one-page request with 413)
REMOTE_BODY_BYTES = 256 << 20


def serve_counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    return {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
            "flash_attention_fwd": fa.flash_attention_fwd}


def quantiles(vals):
    """p50 and p95 of host-clock samples (nearest rank)."""
    s = sorted(vals)
    if not s:
        return {"n": 0, "p50": None, "p95": None}
    pick = lambda q: s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]
    return {"n": len(s), "p50": pick(0.50), "p95": pick(0.95)}


def no_serving_threads():
    """Wait (10 s at most) until no ``paddle-tpu-`` thread is alive;
    returns the names of those still alive."""
    import threading
    deadline = time.monotonic() + 10.0
    while True:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith("paddle-tpu-") and t.is_alive()]
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)


def serve_sched_phase(torch, np, dev, model, prompts, greedy, greedy_stats):
    """``Scheduler`` over a fresh engine of the serve model.

    The serve mix, all five queued before the first step, with chunked
    admission (every prompt rides the unified step): tokens, steps and
    the #1 and #2 launches must equal a direct run of the engine calls
    the scheduler makes (``begin_request`` in submission order, then
    ``step``); against the ``serve`` phase's tokens (which admit a200
    through ``add_request``) the ``agreement`` rule.  Then an overload
    burst: OVERLOAD_FIRST low-priority requests (two past ``max_queue``
    shed), a step, the rest at high priority, each high-priority
    admission preempting an active low-priority request; a deadline on
    every third.  No cache out-of-memory event, every accepted request
    finished or shed, and each preempted request's tokens equal to, or
    in ``agreement`` with, an unpreempted run of its prompt."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.serving import RejectedError, Scheduler
    geom = dict(max_seqs=8, max_len=2048, page_size=128,
                dtype=torch.bfloat16)
    counters = serve_counters()
    t_phase = time.perf_counter()

    def launches():
        return {n: fn.launches for n, fn in counters.items()}

    eng = LLMEngine(model, **geom)
    for fn in counters.values():
        fn.launches = 0
    for rid in SERVE_LENS:
        eng.begin_request(rid, prompts[rid], max_new_tokens=SERVE_NEW)
    direct_steps = 0
    while eng.has_work():
        eng.step()
        direct_steps += 1
    direct = {rid: eng.result(rid) for rid in SERVE_LENS}
    direct_launches = launches()
    del eng

    eng = LLMEngine(model, **geom)
    sched = Scheduler(eng, max_queue=OVERLOAD_QUEUE, chunked_prefill=True)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for rid in SERVE_LENS:
        sched.submit(rid, prompts[rid], max_new_tokens=SERVE_NEW)
    steps, streamed = 0, {rid: [] for rid in SERVE_LENS}
    while sched.busy():
        for rid, toks in sched.step().items():
            streamed[rid] += toks
        steps += 1
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    mix_launches = launches()
    got = {rid: sched.result(rid) for rid in SERVE_LENS}
    check(got == streamed, "the scheduler's stream differs from its results")
    check(got == direct, "the scheduler's tokens differ from the direct run "
                         "of the same engine calls")
    check(steps == direct_steps and mix_launches == direct_launches,
          f"scheduler: {steps} steps, launches {mix_launches}; direct: "
          f"{direct_steps} steps, launches {direct_launches}")
    # chunked admission prefills every prompt inside the unified step:
    # #1 only (serve's a200 prefills through #2 in add_request)
    check(mix_launches["ragged_paged_append_attend"] > 0,
          f"the scheduled serve never launched #1: {mix_launches}")
    vs_serve = agreement(torch, eng, prompts, got, greedy)
    mix_snap = sched.metrics_snapshot()
    mix = {"steps": steps, "launches": mix_launches, "serve_s": mix_s,
           "serve_steps": greedy_stats["steps"],
           "serve_launches": greedy_stats["launches"],
           "direct_equal": True, "agreement_with_serve": vs_serve,
           "all_equal_serve": all(v["equal"] for v in vs_serve.values()),
           "ttft_s": {rid: sched.request_timeline(rid)["ttft"]
                      for rid in SERVE_LENS},
           "admitted": mix_snap["admitted"],
           "completed": mix_snap["completed"]}
    del sched, eng
    gc.collect()

    # -- overload: two priorities, a bounded queue, deadlines
    rng = np.random.default_rng(SEED + 17)
    vocab = model.config.vocab_size
    burst = {f"o{i:02d}": rng.integers(0, vocab, OVERLOAD_LEN).tolist()
             for i in range(OVERLOAD_N)}
    rids = list(burst)
    prio = {rid: (1 if i < OVERLOAD_FIRST else 0)
            for i, rid in enumerate(rids)}
    dl = {rid: (OVERLOAD_DEADLINE_S if i % 3 == 2 else None)
          for i, rid in enumerate(rids)}
    eng = LLMEngine(model, **geom)
    sched = Scheduler(eng, max_queue=OVERLOAD_QUEUE)
    preempted, events = set(), []

    def tap(ev):
        events.append((ev["type"], ev["rid"]))
        if ev["type"] == "preempted":
            preempted.add(ev["rid"])

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    refused = []

    def submit(rid):
        try:
            sched.submit(rid, burst[rid], max_new_tokens=OVERLOAD_NEW,
                         priority=prio[rid], deadline=dl[rid], on_event=tap)
        except RejectedError:
            refused.append(rid)

    for rid in rids[:OVERLOAD_FIRST]:
        submit(rid)
    for _ in range(4):
        sched.step()
    for rid in rids[OVERLOAD_FIRST:]:
        submit(rid)
    steps = 4
    while sched.busy():
        sched.step()
        steps += 1
        check(steps < 4000, "the overload burst did not drain")
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    snap = sched.metrics_snapshot()
    accepted = [r for r in rids if r not in refused]
    states = {r: sched.status(r) for r in accepted}
    check(all(s in ("finished", "shed") for s in states.values()),
          f"a request was lost: {states}")
    check(snap["engine"]["kv_cache"]["oom_events"] == 0,
          f"the cache ran out of pages: {snap['engine']['kv_cache']}")
    finished = {r: sched.result(r) for r, s in states.items()
                if s == "finished"}
    for r, toks in finished.items():
        check(len(toks) == OVERLOAD_NEW,
              f"{r} returned {len(toks)} tokens, not {OVERLOAD_NEW}")
    check(snap["preempted"] == len([e for e in events
                                     if e[0] == "preempted"]) > 0,
          f"no high-priority admission preempted: {snap['preempted']}")
    tl = {r: sched.request_timeline(r) for r in accepted}
    ttft = {p: quantiles([tl[r]["ttft"] for r in accepted
                          if prio[r] == p and tl[r]["ttft"] is not None])
            for p in (0, 1)}
    burst_launches = launches()
    check(all(n > 0 for n in burst_launches.values()),
          f"the overload burst never launched a kernel: {burst_launches}")
    # the preempted requests that finished, against an unpreempted run
    again = sorted(r for r in preempted if r in finished)
    base = LLMEngine(model, **geom)
    for r in again:
        base.add_request(r, burst[r], max_new_tokens=OVERLOAD_NEW)
    while base.has_work():
        base.step()
    want = {r: base.result(r) for r in again}
    del base
    rep = agreement(torch, eng, burst, {r: finished[r] for r in again},
                    want)
    qw = snap["queue_wait_seconds"]
    emit({"phase": "serve_sched", "model": "llama3_8b",
          "layers": model.config.num_hidden_layers, "mix": mix,
          "overload": {
              "requests": OVERLOAD_N, "prompt_len": OVERLOAD_LEN,
              "max_new": OVERLOAD_NEW, "max_queue": OVERLOAD_QUEUE,
              "low_priority": OVERLOAD_FIRST,
              "high_priority": OVERLOAD_N - OVERLOAD_FIRST,
              "deadline_s": OVERLOAD_DEADLINE_S,
              "with_deadline": sum(1 for v in dl.values() if v),
              "refused_at_submit": len(refused),
              "shed": dict(sched.shed_stats,
                           total=sum(sched.shed_stats.values())),
              "shed_while_waiting": sum(1 for s in states.values()
                                        if s == "shed"),
              "deadline_misses": snap["deadline_miss"],
              "preempted": snap["preempted"],
              "preempted_requests": sorted(preempted),
              "finished": len(finished), "steps": steps,
              "burst_s": burst_s, "launches": burst_launches,
              "oom_events": snap["engine"]["kv_cache"]["oom_events"],
              "swap_out_pages": snap["engine"]["kv_cache"]["swap_out_pages"],
              "swap_in_pages": snap["engine"]["kv_cache"]["swap_in_pages"],
              "ttft_s_by_priority": ttft,
              "queue_wait_s": {"count": qw["count"], "p50": qw["p50"],
                               "p95": qw["p95"], "mean": qw["mean"],
                               "source": "serving_sched_queue_wait_"
                                         "seconds (bucket-interpolated)"},
              "time_preempted_s": {
                  k: snap["time_preempted_seconds"][k]
                  for k in ("count", "p50", "p95", "mean")},
              "agreement_preempted": rep,
              "all_equal_preempted": all(v["equal"]
                                         for v in rep.values())},
          "seconds": time.perf_counter() - t_phase})
    del sched, eng
    gc.collect()
    torch.cuda.empty_cache()


def http_stream(port, rid, prompt, n):
    """Stream one ``/v1/completions``; returns (tokens, lines)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": prompt, "max_tokens": n,
                                 "id": rid}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"{rid}: HTTP {resp.status}")
        check(resp.getheader("Content-Type") == "application/x-ndjson",
              f"{rid}: {resp.getheader('Content-Type')}")
        lines = [json.loads(ln) for ln in resp.read().decode().splitlines()]
    finally:
        conn.close()
    return [t for ln in lines for t in ln.get("tokens", [])], lines


def http_get(url):
    import urllib.error
    import urllib.request
    try:
        r = urllib.request.urlopen(url, timeout=120)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serve_http_phase(torch, np, dev, model, prompts, greedy):
    """``start_http_frontend(Scheduler(...))`` on 127.0.0.1 over a fresh
    engine of the serve model: two client threads stream
    ``/v1/completions`` for b37 and a200 at once (their tokens against
    the ``serve`` phase's by the ``agreement`` rule: the two arrive in
    another batch than the mix), then ``/metrics``, ``/healthz``,
    ``/statusz`` (torch, CUDA and the card; no JAX) and ``/memz`` (the
    device bytes).  The loop thread launched every kernel and is alive
    at the end; after ``shutdown()`` no ``paddle-tpu-`` thread is."""
    import threading

    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.serving import Scheduler, start_http_frontend
    counters = serve_counters()
    t_phase = time.perf_counter()
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    dtype=torch.bfloat16)
    sched = Scheduler(eng, max_queue=OVERLOAD_QUEUE)
    fe = start_http_frontend(sched)
    want = {rid: greedy[rid] for rid in ("b37", "a200")}
    got, errors, launch_threads = {}, [], set()
    for fn in counters.values():
        fn.launches = 0
    try:
        def client(rid):
            try:
                got[rid] = http_stream(fe.port, rid, prompts[rid],
                                       SERVE_NEW)
            except BaseException as e:
                errors.append(f"{rid}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(rid,))
                   for rid in want]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        stream_s = time.perf_counter() - t0
        check(not errors, f"a streaming client failed: {errors}")
        launched = {n: fn.launches for n, fn in counters.items()}
        code_m, metrics = http_get(fe.url + "/metrics")
        code_h, hz = http_get(fe.url + "/healthz")
        code_s, st = http_get(fe.url + "/statusz")
        code_z, mz = http_get(fe.url + "/memz")
        alive = fe._loop_thread.is_alive()
        loop_error = fe.loop_error
    finally:
        fe.shutdown()
    left = no_serving_threads()
    check(alive and loop_error is None,
          f"the loop thread died: {loop_error!r}")
    tokens = {rid: got[rid][0] for rid in want}
    for rid, toks in tokens.items():
        lines = got[rid][1]
        check(len(toks) == SERVE_NEW and lines[-1].get("done")
              and lines[-1].get("state") == "finished",
              f"{rid} streamed {len(toks)} tokens, last line {lines[-1]}")
    check(all(n > 0 for n in launched.values()),
          f"the frontend's loop launched no kernel: {launched}")
    rep = agreement(torch, eng, prompts, tokens, want)
    check(code_m == 200 and b"serving_sched_admitted_total" in metrics
          and b"llm_engine_generated_tokens_total" in metrics,
          "/metrics lacks the scheduler's or the engine's series")
    hz = json.loads(hz)
    check(code_h == 200 and hz["status"] == "ok", f"/healthz {code_h} {hz}")
    check(b"jax" not in st.lower(), "/statusz names JAX")
    st = json.loads(st)
    build = st["build"]
    check(code_s == 200 and build["torch"] == torch.__version__
          and build["cuda"] == torch.version.cuda
          and build["device_name"] == torch.cuda.get_device_name(dev),
          f"/statusz build {build}")
    mz = json.loads(mz)
    kv = [r for r in mz["consumers"].values()
          if r.get("device_bytes") == kv_bytes(eng.cache)]
    check(code_z == 200 and mz["devices"][0]["bytes_in_use"] > 0 and kv,
          f"/memz did not report the device bytes: {mz['devices']}")
    check(not left, f"serving threads left after shutdown(): {left}")
    emit({"phase": "serve_http", "model": "llama3_8b",
          "requests": list(want), "stream_s": stream_s,
          "streamed_lines": {rid: len(got[rid][1]) for rid in want},
          "launches": launched, "agreement": rep,
          "all_equal_serve": all(v["equal"] for v in rep.values()),
          "metrics_bytes": len(metrics), "healthz": hz,
          "statusz_build": build,
          "memz_device": mz["devices"][0],
          "loop_thread_alive_at_end": alive,
          "threads_left": left, "seconds": time.perf_counter() - t_phase})
    del sched, eng
    gc.collect()
    torch.cuda.empty_cache()


def serve_router_phase(torch, np, dev, model, prompts, greedy):
    """Two ``Scheduler`` replicas, each with its own engine over the serve
    model on the one card, under ``ReplicaRouter``: the serve mix
    (least-loaded: b37, b300 and a200 on replica 0), ROUTER_STEPS
    router steps, then ``drain_replica(0)``: its requests migrate with
    their KV pages and finish on replica 1.  Then both replicas behind
    frontends, reached as ``RemoteReplica``s under a second router
    (replica 1's frontend takes REMOTE_BODY_BYTES bodies): a
    ``FaultPlan`` drops the reply of replica 1's first submit (the
    resubmission must ack as a duplicate: admitted once), and a drain of
    replica 0 moves its requests over HTTP.  Every request finishes once,
    streams exactly its tokens, and agrees with the ``serve`` phase's."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.serving import (Fault, FaultPlan, RemoteReplica,
                                          ReplicaRouter, Scheduler,
                                          start_http_frontend)
    counters = serve_counters()
    t_phase = time.perf_counter()
    geom = dict(max_seqs=8, max_len=2048, page_size=128,
                dtype=torch.bfloat16)
    engines = [LLMEngine(model, **geom) for _ in range(2)]
    scheds = [Scheduler(e, max_queue=OVERLOAD_QUEUE) for e in engines]
    blobs = []
    src_out = scheds[0].migrate_out

    def migrate_out(rid):                       # measure the blobs
        pkg = src_out(rid)
        if pkg is not None:
            blobs.append(len(pkg["swap"]) if pkg.get("swap") else 0)
        return pkg

    scheds[0].migrate_out = migrate_out
    router = ReplicaRouter(scheds)
    streams, finished = {rid: [] for rid in SERVE_LENS}, {}

    def tap(ev):
        if ev["type"] == "tokens":
            streams[ev["rid"]] += ev["tokens"]
        elif ev["type"] in ("finished", "cancelled", "shed"):
            finished.setdefault(ev["rid"], []).append(ev["type"])

    for fn in counters.values():
        fn.launches = 0
    placed = {rid: router.submit(rid, prompts[rid],
                                 max_new_tokens=SERVE_NEW, on_event=tap)
              for rid in SERVE_LENS}
    for _ in range(ROUTER_STEPS):
        router.step()
    at_drain = {rid: len(v) for rid, v in streams.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moved = router.drain_replica(0)
    torch.cuda.synchronize()
    migrate_s = time.perf_counter() - t0
    router.run_until_idle()
    launched = {n: fn.launches for n, fn in counters.items()}
    local_blobs = list(blobs)
    got = {rid: router.pop_result(rid) for rid in SERVE_LENS}
    check(sorted(moved) == sorted(r for r, i in placed.items() if i == 0)
          and moved, f"drain_replica(0) moved {moved}, placed {placed}")
    for rid in SERVE_LENS:
        check(finished.get(rid) == ["finished"]
              and streams[rid] == got[rid]
              and len(got[rid]) == SERVE_NEW,
              f"{rid}: terminals {finished.get(rid)}, streamed "
              f"{len(streams[rid])}, result {len(got[rid])}")
    snap1 = scheds[1].metrics_snapshot()
    check(snap1["migrated_in"] == len(moved)
          and snap1["engine"]["kv_cache"]["swap_in_pages"] > 0,
          f"replica 1 adopted {snap1['migrated_in']} requests, swapped in "
          f"{snap1['engine']['kv_cache']['swap_in_pages']} pages")
    rep = agreement(torch, engines[1], prompts, got, greedy)
    local = {"placed": placed, "moved": moved, "tokens_at_drain": at_drain,
             "migrate_s": migrate_s, "blob_bytes": local_blobs,
             "launches": launched, "agreement": rep,
             "all_equal_serve": all(v["equal"] for v in rep.values())}

    # -- the same replicas over HTTP
    scheds[0].resume_admission()
    admitted0 = [s.metrics_snapshot()["admitted"] for s in scheds]
    fes = [start_http_frontend(scheds[0]),
           start_http_frontend(scheds[1], max_body_bytes=REMOTE_BODY_BYTES)]
    try:
        # load_ttl 0: every pick reads both loads fresh, so the mix
        # alternates replicas as in-process
        reps = [RemoteReplica(fe.url, timeout=600, load_ttl=0.0)
                for fe in fes]
        plan = FaultPlan([Fault(op="submit", kind="disconnect", nth=1,
                                times=1)])
        reps[1].set_fault_plan(plan)
        rrouter = ReplicaRouter(reps)
        rstreams = {f"r_{rid}": [] for rid in SERVE_LENS}
        rfinished = {}

        def rtap(ev):
            if ev["type"] == "tokens":
                rstreams[ev["rid"]] += ev["tokens"]
            elif ev["type"] in ("finished", "cancelled", "shed"):
                rfinished.setdefault(ev["rid"], []).append(ev["type"])

        rplaced = {}
        for rid in SERVE_LENS:
            rplaced[f"r_{rid}"] = rrouter.submit(
                f"r_{rid}", prompts[rid], max_new_tokens=SERVE_NEW,
                on_event=rtap)
        check(plan.injected == {"disconnect": 1},
              f"the fault plan injected {plan.injected}")
        on0 = [r for r, i in rplaced.items() if i == 0]
        check(on0 and len(on0) < len(rplaced),
              f"the remote router placed {rplaced}")
        deadline = time.monotonic() + 300
        while any(len(rstreams[r]) < 4 for r in on0):
            rrouter.step()
            check(time.monotonic() < deadline, "remote requests stalled")
        rat_drain = {r: len(v) for r, v in rstreams.items()}
        t0 = time.perf_counter()
        rmoved = rrouter.drain_replica(0)
        rmigrate_s = time.perf_counter() - t0
        rrouter.run_until_idle()
        rgot = {r: rrouter.pop_result(r) for r in rplaced}
        alive = [fe._loop_thread.is_alive() for fe in fes]
        errors = [fe.loop_error for fe in fes]
        admitted1 = [s.metrics_snapshot()["admitted"] for s in scheds]
        snap1 = scheds[1].metrics_snapshot()
    finally:
        for fe in fes:
            fe.shutdown()
    left = no_serving_threads()
    check(all(alive) and errors == [None, None],
          f"a frontend's loop thread died: {errors}")
    check(sorted(rmoved) == sorted(on0),
          f"the remote drain moved {rmoved}, replica 0 held {on0}")
    for r in rplaced:
        check(rfinished.get(r) == ["finished"] and rstreams[r] == rgot[r]
              and len(rgot[r]) == SERVE_NEW,
              f"{r}: terminals {rfinished.get(r)}, streamed "
              f"{len(rstreams[r])}, result {len(rgot[r])}")
    n1 = sum(1 for i in rplaced.values() if i == 1)
    check([b - a for a, b in zip(admitted0, admitted1)] == [len(on0), n1],
          f"admissions over HTTP {admitted0} -> {admitted1}: a resubmitted "
          f"request was admitted twice")
    check(not left, f"serving threads left after shutdown(): {left}")
    rrep = agreement(torch, engines[1], {f"r_{k}": v for k, v in
                                         prompts.items()},
                     rgot, {f"r_{k}": v for k, v in greedy.items()})
    emit({"phase": "serve_router", "model": "llama3_8b",
          "replicas": 2, "local": local,
          "remote": {"placed": rplaced, "moved": rmoved,
                     "tokens_at_drain": rat_drain,
                     "migrate_s": rmigrate_s,
                     "blob_bytes": blobs[len(local_blobs):],
                     "max_body_bytes": REMOTE_BODY_BYTES,
                     "fault_injected": plan.injected,
                     "admitted_delta": [b - a for a, b in
                                        zip(admitted0, admitted1)],
                     "migrated_in": snap1["migrated_in"],
                     "agreement": rrep,
                     "all_equal_serve": all(v["equal"]
                                            for v in rrep.values()),
                     "loop_threads_alive_at_end": alive,
                     "threads_left": left},
          "seconds": time.perf_counter() - t_phase})
    del router, scheds, engines
    gc.collect()
    torch.cuda.empty_cache()


def serve_spec_phase(torch, np, dev, model, prompts, greedy, greedy_stats):
    """The ``serve`` model as the target with SPEC_K: a random draft at
    Llama-3.2-1B's widths (greedy: the plain engine's tokens by the margin
    rule), the target drafting for itself (its draft runs the split path,
    #7, the verify #1: in bf16 over 32 random layers they part at near
    ties, so each rejection must be within BF16_MARGIN_STEPS of the
    target's top logit; ``decode_reference`` holds its acceptance to
    MIN_SELF_ACCEPTANCE at f32), and the random draft under the sampling
    knobs (rejection acceptance)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "paged_decode_append_attend": pa.paged_decode_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd}
    geom = dict(max_seqs=8, max_len=2048, page_size=128,
                dtype=torch.bfloat16, spec_k=SPEC_K)
    dcfg = llama32_1b_draft_config(model.config)
    draft = LlamaForCausalLM(
        dcfg, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    rep = {"draft": {k: getattr(dcfg, k) for k in (
        "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "tie_word_embeddings",
        "rope_theta")}, "spec_k": SPEC_K,
        "greedy_decode_tok_s": greedy_stats["decode_tok_s"]}
    eng = LLMEngine(model, draft_model=draft, **geom)
    rep["random_draft"], got = spec_serve(torch, eng, prompts, counters)
    rep["random_draft"]["agreement"] = agreement(torch, eng, prompts, got,
                                                 greedy)
    del eng
    eng = LLMEngine(model, draft_model=model, **geom)
    with verify_rejections(torch) as rejections:
        rep["self_draft"], _ = spec_serve(torch, eng, prompts, counters)
    rep["self_draft"]["rejections"] = rejections
    check(rejections["max_margin_bf16_steps"] <= BF16_MARGIN_STEPS,
          f"the target drafting for itself was rejected away from a near "
          f"tie: {rejections}")
    del eng
    eng = LLMEngine(model, draft_model=draft, **geom, **SAMPLING)
    rep["rejection"], _ = spec_serve(torch, eng, prompts, counters)
    del eng, draft
    emit({"phase": "serve_spec", "model": "llama3_8b", **rep})
    gc.collect()
    torch.cuda.empty_cache()


def f32_decode_agreement(torch, np, dev):
    """The decode paths of this slice at f32, full width and 2 layers,
    where kernels and plain versions agree to f32 rounding (as
    ``serve_reference``): the engine's greedy tokens against
    ``generate``'s (the two prompts of equal length), against a
    speculative engine's with a random 2-layer draft at Llama-3.2-1B's
    widths and with the target drafting for itself (acceptance at least
    MIN_SELF_ACCEPTANCE), and against ``top_k=1`` sampling, each by the
    margin rule at MARGIN_TOL."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    cfg = dataclasses.replace(llama3_8b_config(), num_hidden_layers=2)
    model = LlamaForCausalLM(
        cfg, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    draft = LlamaForCausalLM(
        dataclasses.replace(llama32_1b_draft_config(cfg),
                            num_hidden_layers=2),
        device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    rng = np.random.default_rng(SEED + 16)
    prompts = {f"f{i}": rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(F32_DECODE_LENS)}
    geom = dict(max_seqs=8, max_len=2048, page_size=128)

    def serve(eng):
        for rid, ids in prompts.items():
            eng.add_request(rid, ids, max_new_tokens=F32_DECODE_NEW)
        while eng.has_work():
            eng.step()
        return {rid: eng.result(rid) for rid in prompts}

    eng = LLMEngine(model, **geom)
    plain = serve(eng)
    pair = {r: prompts[r] for r in ("f0", "f1")}
    out, _ = model.generate(torch.tensor([pair["f0"], pair["f1"]],
                                         device=dev),
                            max_new_tokens=F32_DECODE_NEW)
    rep = {"layers": 2, "prompt_lens": list(F32_DECODE_LENS),
           "new_tokens": F32_DECODE_NEW,
           "generate": agreement(torch, eng, pair, {
               r: out[i].tolist() for i, r in enumerate(pair)},
               {r: plain[r] for r in pair})}
    spec = LLMEngine(model, **geom, draft_model=draft, spec_k=SPEC_K)
    rep["spec"] = agreement(torch, eng, prompts, serve(spec), plain)
    rep["spec_stats"] = dict(spec.spec_stats)
    own = LLMEngine(model, **geom, draft_model=model, spec_k=SPEC_K)
    rep["self_draft"] = agreement(torch, eng, prompts, serve(own), plain)
    st = own.spec_stats
    rep["self_draft_acceptance"] = st["accepted"] / st["proposed"]
    check(rep["self_draft_acceptance"] >= MIN_SELF_ACCEPTANCE,
          f"f32: the target drafting for itself accepted "
          f"{rep['self_draft_acceptance']}")
    del own
    rep["top_k1"] = agreement(torch, eng, prompts, serve(LLMEngine(
        model, **geom, **dict(SAMPLING, top_k=1))), plain)
    emit({"phase": "decode_reference", "dtype": "float32", **rep})
    del eng, spec, model, draft
    gc.collect()
    torch.cuda.empty_cache()


def serve_f32w_phases(torch, np, dev, table):
    """Llama-3-8B at full width and depth with f32 weights (32.1 GB) over
    bf16 pools: the configuration of the reference's serving benches
    (``bench.py`` ``bench_engine``: ``LLMEngine(model, max_seqs=8,
    max_len=2048, page_size=128, dtype=bfloat16, steps_per_sync=16)``).
    ``serve_f32w_bf16kv``: the ``serve`` mix on the unified step (#1 f32 q
    over bf16 pools, #2 in f32 over the widened pages); its reference
    check at 2 layers against a dense f32 forward whose K and V are
    rounded to bf16; ``serve_split_f32w_bf16kv`` (#7 and, through
    ``PagedKVCache.attend``, #6 in the mixed mode); ``preempt``."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    cfg = llama3_8b_config()
    layers = cfg.num_hidden_layers
    kw = dict(max_seqs=8, max_len=2048, page_size=128, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 13))
    eng = LLMEngine(model, **kw, steps_per_sync=SERVE_SPS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.default_rng(SEED + 13)
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).tolist()
               for rid, n in SERVE_LENS.items()}
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "paged_decode_append_attend": pa.paged_decode_append_attend}
    stats, _ = serve_run(torch, eng, prompts, counters)
    emit({"phase": "serve_f32w_bf16kv", "model": "llama3_8b",
          "layers": layers, "weight_dtype": "float32",
          "pool_dtype": "bfloat16", "steps_per_sync": SERVE_SPS,
          "weight_bytes": weight_bytes, "kv_pool_bytes": kv_bytes(eng.cache),
          "setup_s": setup_s, **stats})
    n = stats["launches"]
    chunks = -(-SERVE_LENS["a200"] // 128)        # add_request's prefill
    check(n["ragged_paged_append_attend"] >= layers * stats["steps"]
          and n["ragged_paged_append_attend"] % layers == 0
          and n["flash_attention_fwd"] == layers * chunks
          and n["paged_decode_append_attend"] == 0,
          f"serve_f32w_bf16kv launches {n}")
    table["ragged_paged_append_attend_float32_q_bfloat16_pools"][
        "launches"] = n["ragged_paged_append_attend"]
    # where an f32-weight step's time goes: fresh prompts, traced
    prof = profile_serve(torch, eng, {
        f"p{rid}": rng.integers(0, cfg.vocab_size, n).tolist()
        for rid, n in SERVE_LENS.items()}, max_new=8)
    emit({"phase": "serve_f32w_bf16kv_profile", **prof})
    check_tensor_core_route(prof, "serve_f32w_bf16kv_profile",
                            ("ragged_attend",), design="3xtf32")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    model2 = LlamaForCausalLM(
        cfg2, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 14))
    eng2 = LLMEngine(model2, **kw)
    rep = serve_reference(
        torch, dev, prompts["b37"],
        (("f32_weights_bf16_pools_2_layers", model2, eng2, 1e-4),),
        lambda m, ids: dense_reference_logits(torch, m, ids,
                                              torch.bfloat16))
    emit({"phase": "reference_f32w_bf16kv", **rep})
    del eng2, model2
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = LLMEngine(model, **kw, unified_step=False,
                    steps_per_sync=SPLIT_SPS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stats = serve_split_run(torch, eng, split_prompts(
        np, cfg.vocab_size, SEED + 15), counters,
        attend_layers=(0, layers - 1))
    emit({"phase": "serve_split_f32w_bf16kv", "model": "llama3_8b",
          "layers": layers, "weight_dtype": "float32",
          "pool_dtype": "bfloat16", "steps_per_sync": SPLIT_SPS,
          "setup_s": setup_s, "kv_pool_bytes": kv_bytes(eng.cache),
          "weight_bytes": weight_bytes, **stats})
    check_split_launches(stats, layers, "serve_split_f32w_bf16kv")
    table["paged_decode_append_attend_float32_q_bfloat16_pools"][
        "launches"] = stats["launches"]["paged_decode_append_attend"]
    table["paged_attention_float32_q_bfloat16_pools"]["launches"] = \
        stats["cache_attend_launches"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    preempt_phase(torch, np, dev, model, dict(kw, steps_per_sync=SERVE_SPS))
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# GPT-2 124M: attention dropout (#2-#4) and the trained-bias gradient (#5)
# ---------------------------------------------------------------------------

def attention_cost(b, s, h, hk, d, el):
    """(flops, bytes) of the causal flash forward, dQ and dK/dV at [b, s,
    h, d] with hk kv heads and el-byte elements: each input read once,
    each output written once (lse and delta f32)."""
    pairs = b * causal_pairs(s)
    qb, kb, rows = b * s * h * d * el, b * s * hk * d * el, b * h * s * 4
    return {"fwd": (4 * d * h * pairs, 2 * qb + 2 * kb + rows),
            "dq": (6 * d * h * pairs, 3 * qb + 2 * kb + 2 * rows),
            "dkv": (8 * d * h * pairs, 2 * qb + 4 * kb + 2 * rows)}


def dropout_check(torch, fa, what, q, k, v, do, seed, tol):
    """#2, #3 and #4 in dropout mode (causal, p = GPT_DROP) against their
    plain versions fed the same seed tensor: relative L2 per output."""
    kw = dict(causal=True, dropout_p=GPT_DROP, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    got = {"out": out,
           "dq": fa.flash_attention_bwd_dq(*ops, True, GPT_DROP, seed)}
    got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(*ops, True, GPT_DROP,
                                                      seed)
    del ops
    want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, **kw)))
    want["out"], ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    errs = {"lse_max_abs_err": (lse - ref_lse).abs().max().item()}
    for n, g in got.items():
        errs[n] = {"rel_l2_err": rel_l2(g, want[n]),
                   "max_abs_err": (g.float() - want[n].float()).abs()
                   .max().item()}
    del got, want, out, lse, ref_lse
    emit({"phase": "check", "what": what, "shape": list(q.shape),
          "kv_heads": k.shape[2], "dtype": str(q.dtype),
          "dropout_p": GPT_DROP, "errors": errs,
          "tolerance": {"rel_l2_err": tol, "lse_max_abs_err": 1e-3}})
    check(errs["lse_max_abs_err"] <= 1e-3, f"{what}: lse off {errs}")
    for n in ("out", "dq", "dk", "dv"):
        check(errs[n]["rel_l2_err"] <= tol,
              f"{what}: {n} off its plain version: {errs[n]}")
    return errs


def extracted_keep_rate(torch, fa, q, k, seed):
    """The forward kernel's own keep bits for keys [0, 64): V holds the
    one-hot of those keys (D = 64), so each output row is its dropped
    probabilities over them.  They must equal ``dropout_keep`` bit for
    bit on the visible (causal) elements; returns the keep rate there."""
    b, s, h, d = q.shape
    onehot = torch.zeros(b, s, h, d, device=q.device, dtype=q.dtype)
    onehot[:, :d] = torch.eye(d, device=q.device, dtype=q.dtype)[
        None, :, None, :]
    out, _ = fa.flash_attention_fwd(q, k, onehot, causal=True,
                                    dropout_p=GPT_DROP, seed=seed)
    got = out.transpose(1, 2) > 0                       # [B, H, S, 64]
    visible = torch.arange(s, device=q.device)[:, None] >= \
        torch.arange(d, device=q.device)[None, :]
    want = fa.dropout_keep(seed, GPT_DROP, b, h, s, d) & visible
    torch.cuda.synchronize()
    check(torch.equal(got, want), "the forward kernel's keep bits differ "
                                  "from dropout_keep")
    n = int(visible.sum()) * b * h
    rate = int(want.sum()) / n
    sigma = (GPT_DROP * (1 - GPT_DROP) / n) ** 0.5
    check(abs(rate - (1 - GPT_DROP)) <= 4 * sigma,
          f"keep rate {rate} off 1 - p by more than 4 sigma ({sigma})")
    return {"elements": n, "keep_rate": rate, "sigma": sigma,
            "bits_equal": True}


def dropout_kernels(torch, gen, dev, table):
    """#2, #3 and #4 in dropout mode at GPT-2's training attention (q, k,
    v [8, 1024, 12, 64] f32, causal, p 0.1, fixed seed) against their
    plain versions (1e-5 relative L2), the keep rate of the forward's own
    bits, and timed; then the same check at Llama's [1, 8192, 32/8, 128]
    bf16 (2^-7)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d = GPT_BATCH, GPT_SEQ, GPT_HEADS, GPT_WIDTH // GPT_HEADS

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    q, k, v, do = (rnd(b, s, h, d) for _ in range(4))
    seed = torch.tensor(SEED + 11, dtype=torch.int64, device=dev)
    errs = dropout_check(torch, fa, "flash fwd + bwd, dropout, GPT-2",
                         q, k, v, do, seed, F32_REL_L2_TOL)
    keep = extracted_keep_rate(torch, fa, q, k, seed)
    emit({"phase": "check", "what": "forward kernel keep bits, keys 0-63",
          "shape": [b, s, h, d], "dropout_p": GPT_DROP, **keep})
    torch.cuda.empty_cache()

    kw = dict(causal=True, dropout_p=GPT_DROP, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_library():
        sdpa(qt, kt, vt, is_causal=True, dropout_p=GPT_DROP)

    # the backward of the same PyTorch call (its dq, dk and dv), on a
    # graph kept for repeated timing
    lib_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    lib_out = sdpa(*lib_in, is_causal=True, dropout_p=GPT_DROP)

    def bwd_library():
        torch.autograd.grad(lib_out, lib_in, dot, retain_graph=True)

    cost = attention_cost(b, s, h, h, d, 4)
    outputs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    for name, key, line, fn, plain, lib in (
            ("flash_attention_fwd_dropout", "fwd",
             "flash_attention.py:164",
             lambda: fa.flash_attention_fwd(q, k, v, **kw),
             lambda: fa.flash_attention_fwd_reference(q, k, v, **kw),
             fwd_library),
            ("flash_attention_bwd_dq_dropout", "dq",
             "flash_attention.py:390",
             lambda: fa.flash_attention_bwd_dq(*ops, True, GPT_DROP, seed),
             lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                      **kw), bwd_library),
            ("flash_attention_bwd_dkv_dropout", "dkv",
             "flash_attention.py:431",
             lambda: fa.flash_attention_bwd_dkv(*ops, True, GPT_DROP, seed),
             lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                      **kw), bwd_library)):
        flops, n_bytes = cost[key]
        outs = outputs[key]
        src = "flash_attention_fwd.cu" if key == "fwd" \
            else "flash_attention_bwd.cu"
        row = {"name": name, "route": "cuda",
               "source": f"paddle_tpu_torch/csrc/{src}",
               "replaces": f"paddle_tpu/ops/pallas/{line}",
               "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
               "ms": timed_ms(torch, fn, 10),
               "plain_ms": timed_ms(torch, plain, 2, warmup=1),
               **f32_bounds(n_bytes, flops, tensor_cores=True),
               "library_ms": timed_ms(torch, lib, 10),
               **traced_kernel(torch, fn)}
        check(row["design"] == "3xtf32",
              f"{name} ran on {row['design']}, not 3xtf32")
        emit({"phase": "kernel", **row, "shape": [b, s, h, d],
              "dtype": "float32", "causal": True, "dropout_p": GPT_DROP,
              "bound_peak": F32_TC_NOTE,
              "library_note": "scaled_dot_product_attention(dropout_p=0.1)"
                              + ("" if key == "fwd" else
                                 ", its backward (dq, dk, dv)")})
        table[name] = row
    del ops, out, lse, lib_out, lib_in, q, k, v, do, qt, kt, vt, dot
    torch.cuda.empty_cache()

    # Llama-3-8B's training attention with dropout
    q, do = (rnd(1, TRAIN_SEQ, 32, 128, dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (rnd(1, TRAIN_SEQ, 8, 128, dtype=torch.bfloat16)
            for _ in range(2))
    dropout_check(torch, fa, "flash fwd + bwd, dropout, Llama 8K",
                  q, k, v, do, seed, REL_L2_TOL)
    del q, k, v, do
    torch.cuda.empty_cache()


def dbias_cost(b, s, h, d):
    """(flops, bytes) of #5 over a causal [b, s, h, d] f32 attention with
    a bias [1, h, s, s]: S and dP for each visible pair of every (b, h);
    q, k, v and dO read once, lse and delta, the bias read and its
    gradient written."""
    flops = 4 * d * h * b * causal_pairs(s)
    n_bytes = 4 * b * s * h * d * 4 + 2 * b * h * s * 4 + 2 * h * s * s * 4
    return flops, n_bytes


def dbias_kernels(torch, gen, dev, table):
    """#5 at GPT-2's attention with a trained bias: the bias [1, 12, 1024,
    1024], [8, 1, 1024, 1024] and [1, 1, 1024, 1024] f32, p 0 and 0.1,
    and [1, 12, 1024, 1024] at GQA group 4 (3 kv heads), each against its
    plain version (1e-5 relative L2); timed at [1, 12, 1024, 1024], p
    0.1 (the ``encoder_bias`` shape)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d = GPT_BATCH, GPT_SEQ, GPT_HEADS, GPT_WIDTH // GPT_HEADS
    seed = torch.tensor(SEED + 12, dtype=torch.int64, device=dev)
    checks = []
    timed = None
    for mshape, p, hk in (((1, h, s, s), 0.0, h), ((1, h, s, s), 0.1, h),
                          ((b, 1, s, s), 0.0, h), ((b, 1, s, s), 0.1, h),
                          ((1, 1, s, s), 0.0, h), ((1, 1, s, s), 0.1, h),
                          ((1, h, s, s), 0.1, h // 4)):
        q, do = (torch.randn(b, s, h, d, generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(b, s, hk, d, generator=gen, device=dev)
                for _ in range(2))
        bias = 0.5 * torch.randn(mshape, generator=gen, device=dev)
        kw = dict(causal=True, dropout_p=p, seed=seed)
        out, lse = fa.flash_attention_fwd(q, k, v, mask=bias, **kw)
        got = fa.flash_attention_dbias(q, k, v, out, lse, do, bias, **kw)
        want = fa.flash_attention_dbias_reference(q, k, v, out, lse, do,
                                                  bias, **kw)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        checks.append({"bias": list(mshape), "dropout_p": p,
                       "kv_heads": hk, "rel_l2_err": err,
                       "max_abs_err": (got - want).abs().max().item()})
        check(err <= F32_REL_L2_TOL,
              f"dbias kernel off its plain version: {checks[-1]}")
        del got, want
        if mshape == (1, h, s, s) and p and hk == h:
            timed = (q, k, v, do, bias, out, lse, kw, checks[-1])
        else:
            del q, k, v, do, bias, out, lse
    emit({"phase": "check", "what": "dbias kernel against its plain "
          "version", "shape": [b, s, h, d], "causal": True,
          "cases": checks, "tolerance": {"rel_l2_err": F32_REL_L2_TOL}})

    q, k, v, do, bias, out, lse, kw, err = timed
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, bias)
    # the library's yardstick: scaled_dot_product_attention with an
    # attn_mask that requires grad, whose backward (one call) returns dq,
    # dk, dv and the bias gradient.  q, k and v require grad too: the
    # memory-efficient forward keeps its logsumexp only then, and its
    # backward refuses to run without it.  Where the installed PyTorch
    # still refuses these inputs, the same call is timed on the math
    # backend.  Timed only, never on the port's path.
    from torch.nn.attention import SDPBackend, sdpa_kernel
    causal = torch.zeros(s, s, device=dev).masked_fill_(
        ~torch.ones(s, s, dtype=torch.bool, device=dev).tril(),
        float("-inf"))
    lib_in = [x.transpose(1, 2).detach().requires_grad_()
              for x in (q, k, v)] + [bias.detach().requires_grad_()]
    dot = do.transpose(1, 2)
    library, refused = None, None
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                lib_out = torch.nn.functional.scaled_dot_product_attention(
                    *lib_in[:3], attn_mask=lib_in[3] + causal,
                    dropout_p=GPT_DROP)

            def library(lib_out=lib_out):
                torch.autograd.grad(lib_out, lib_in, dot, retain_graph=True)
            library()
            torch.cuda.synchronize()
            break
        except RuntimeError as e:      # the yardstick only, never the port
            library, refused = None, f"{backend.name}: {e}"[:200]
    check(library is not None, f"no PyTorch backend computes the bias "
                               f"gradient here: {refused}")
    note = (f"scaled_dot_product_attention on {backend.name} with an "
            f"attn_mask that requires grad: its backward (dq, dk, dv and "
            f"dbias in one call)")
    flops, n_bytes = dbias_cost(b, s, h, d)

    def fn():
        return fa.flash_attention_bwd_dbias(*ops[:6], bias, True, GPT_DROP,
                                            seed)
    row = {"name": "flash_attention_dbias", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention_dbias.cu",
           "replaces": "paddle_tpu/ops/pallas/flash_attention.py:608",
           "max_abs_err": err["max_abs_err"],
           "ms": timed_ms(torch, fn, 10),
           "plain_ms": timed_ms(torch, lambda: fa.flash_attention_dbias_reference(
               q, k, v, out, lse, do, bias, **kw), 2, warmup=1),
           **f32_bounds(n_bytes, flops, tensor_cores=True),
           "library_ms": timed_ms(torch, library, 10),
           **traced_kernel(torch, fn)}
    check(row["design"] == "3xtf32",
          f"flash_attention_dbias ran on {row['design']}, not 3xtf32")
    emit({"phase": "kernel", **row, "shape": [b, s, h, d],
          "bias": [1, h, s, s], "dtype": "float32", "causal": True,
          "dropout_p": GPT_DROP,
          "bound_peak": F32_TC_NOTE,
          "library_note": note, "library_refused": refused})
    table["flash_attention_dbias"] = row
    del timed, ops, q, k, v, do, bias, out, lse, lib_in, lib_out, library
    torch.cuda.empty_cache()


def gpt_batch(torch, np, dev, vocab, batch, seq):
    """``bench_gpt2``'s batch: ids from ``default_rng(0)`` [batch, seq +
    1], inputs the first seq, labels the last seq."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"x": torch.tensor(ids[:, :-1], device=dev),
            "y": torch.tensor(ids[:, 1:].astype(np.int64), device=dev)}


def gpt_trainer(torch, cfg, dev, seed):
    """``bench_gpt2``'s recipe: GPTForCausalLM -> AdamW(lr 1e-4) ->
    CompiledTrainStep on GPTPretrainingCriterion, f32."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion)
    model = GPTForCausalLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    crit = GPTPretrainingCriterion()
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    return model, CompiledTrainStep(
        model, lambda m, b: crit(m(b["x"]), b["y"]), opt, seed=seed)


def train_gpt2_phase(torch, np, dev, table):
    """GPT-2 124M at full width and depth (12 layers, vocab 50,304) on
    ``bench_gpt2``'s recipe: batch 8 x 1024, f32, attention and hidden
    dropout 0.1, GPT_STEPS steps on one repeated batch (the first warms
    up), then two traced steps."""
    from paddle_tpu_torch.models.gpt import gpt2_124m_config
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = gpt2_124m_config()
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model, step = gpt_trainer(torch, cfg, dev, SEED + 4)
    batch = gpt_batch(torch, np, dev, cfg.vocab_size, GPT_BATCH, GPT_SEQ)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    big = sum(p.numel() * p.element_size() >= (1 << 20)
              for p in model.parameters())
    # the update: one launch per leaf of 1 MiB or more (the embeddings
    # and the four projections of each layer), one for the packed rest
    counters = {"flash_attention_fwd": (fa.flash_attention_fwd, layers),
                "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq,
                                           layers),
                "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv,
                                            layers),
                "fused_update": (ft.fused_update_flat, big + 1)}
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(GPT_STEPS):
        t = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {n: fn.launches for n, (fn, _) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_s = sum(times[1:]) / (len(times) - 1)
    tokens = GPT_BATCH * GPT_SEQ
    tok_s = tokens / step_s
    f6n = 6 * n_params
    # causal attention: 6 L S h a token (the two S x S products, forward
    # and backward, over the visible half)
    fattn = f6n + 6 * layers * GPT_SEQ * cfg.hidden_size
    RESULTS["train_gpt2_mean_step_s"] = step_s
    emit({"phase": "train_gpt2", "model": "gpt2_124m", "layers": layers,
          "dtype": "float32", "seq": GPT_SEQ, "batch": GPT_BATCH,
          "dropout": {"attention": cfg.attention_probs_dropout_prob,
                      "hidden": cfg.hidden_dropout_prob},
          "params": n_params, "setup_s": setup_s, "step_s": times,
          "mean_step_s": step_s, "steps_per_s": 1 / step_s,
          "tokens_per_s": tok_s,
          "mfu_6n_attn": fattn * tok_s / PEAK_BF16_FLOPS,
          "mfu_convention": "(6N + 6 L S h) x tokens/s over 989 TFLOP/s "
                            "(bf16 dense peak); f32 recipe",
          "losses": losses, "ln_vocab": math.log(cfg.vocab_size),
          "max_memory_allocated": peak, "launches": launches,
          "launches_per_step": {n: c / GPT_STEPS
                                for n, c in launches.items()}})
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"first loss {losses[0]} not within 0.5 of ln V")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(peak < 80e9, f"peak memory {peak} bytes, not under 80 GB")
    for n, (_, per_step) in counters.items():
        check(launches[n] == per_step * GPT_STEPS,
              f"{n} launched {launches[n]} times in {GPT_STEPS} steps, "
              f"not {per_step} a step")
    for n in ("fwd", "bwd_dq", "bwd_dkv"):
        table[f"flash_attention_{n}_dropout"]["launches"] = \
            launches[f"flash_attention_{n}"]

    _, prof = profiled(torch, lambda: [step(batch) for _ in range(2)])
    emit({"phase": "train_gpt2_profile", "steps": 2, **prof})
    check_tensor_core_route(prof, "train_gpt2_profile",
                            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                            design="3xtf32")
    del model, step, batch


def plain_gpt_loss(torch, model, ids, labels):
    """GPT-2's training loss as a composition of plain versions: the
    model's own weights, plain LayerNorm, GELU and dropout, and
    ``scaled_dot_product_attention_ref`` (dense, its keep mask drawn as
    the kernels' is), in the model's order of draws, and a log-softmax
    cross-entropy over the whole f32 logits."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import _nn
    c, g = model.config, model.gpt
    b, s = ids.shape
    e, nh = c.hidden_size, c.num_attention_heads
    p_h, p_a, train = c.hidden_dropout_prob, \
        c.attention_probs_dropout_prob, model.training

    def ln(x, norm):
        return _nn.layer_norm(x, [e], norm.weight, norm.bias,
                              c.layer_norm_epsilon)

    def lin(x, layer):
        return x @ layer.weight + layer.bias

    pos = torch.arange(s, device=ids.device)
    x = _nn.dropout(g.wte.weight[ids.long()] + g.wpe.weight[pos], p_h, train)
    for blk in g.h:
        qkv = lin(ln(x, blk.ln_1), blk.attn.qkv_proj).reshape(
            b, s, 3, nh, e // nh)
        a = F.scaled_dot_product_attention_ref(
            *qkv.unbind(2), dropout_p=p_a, is_causal=True, training=train)
        x = x + _nn.dropout(lin(a.reshape(b, s, e), blk.attn.out_proj),
                            p_h, train)
        m = _nn.gelu(lin(ln(x, blk.ln_2), blk.mlp.fc_in), approximate=True)
        x = x + _nn.dropout(lin(m, blk.mlp.fc_out), p_h, train)
    logits = ln(x, g.ln_f) @ g.wte.weight.t()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def train_gpt2_reference_phase(torch, np, dev):
    """At f32 (full matmul precision), full width, 2 layers, batch 2 x
    seq 256: the loss and every gradient of ``grad_step`` (the kernels)
    against ``plain_gpt_loss`` (plain versions, autograd) from the same
    weights and the same generator seed -- at dropout 0, and at 0.1,
    where both routes draw the same masks."""
    from paddle_tpu_torch.models.gpt import gpt2_124m_config
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.random import rng_guard
    layers, seq, seed = 2, 256, SEED + 5
    results = {}
    for p in (0.0, GPT_DROP):
        cfg = dataclasses.replace(gpt2_124m_config(),
                                  num_hidden_layers=layers,
                                  hidden_dropout_prob=p,
                                  attention_probs_dropout_prob=p)
        model, step = gpt_trainer(torch, cfg, dev, seed)
        batch = gpt_batch(torch, np, dev, cfg.vocab_size, 2, seq)
        for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                   fa.flash_attention_bwd_dkv):
            fn.launches = 0
        loss, grads = step.grad_step(batch)
        launches = [fa.flash_attention_fwd.launches,
                    fa.flash_attention_bwd_dq.launches,
                    fa.flash_attention_bwd_dkv.launches]
        params = step.state["params"]
        with rng_guard(torch.Generator(device=dev).manual_seed(seed)):
            want_loss = plain_gpt_loss(torch, model, batch["x"], batch["y"])
            want = dict(zip(params, torch.autograd.grad(
                want_loss, list(params.values()))))
        rel = {n: ((grads[n] - w).norm() / w.norm()).item()
               for n, w in want.items()}
        worst = max(rel, key=rel.get)
        wl = float(want_loss.detach())
        loss_rel = abs(float(loss) - wl) / abs(wl)
        results[str(p)] = {"loss": float(loss), "loss_rel_err": loss_rel,
                           "grad_rel_l2_max": rel[worst],
                           "grad_rel_l2_worst": worst,
                           "launches_fwd_dq_dkv": launches}
        check(loss_rel <= 1e-5, f"GPT-2 loss at dropout {p} off the plain "
                                f"composition by {loss_rel} (relative)")
        check(rel[worst] <= 1e-4, f"GPT-2 gradient {worst} at dropout {p} "
                                  f"off the plain composition by "
                                  f"{rel[worst]}")
        check(launches == [layers] * 3,
              f"flash fwd, dQ, dK/dV launched {launches} in one step")
        del model, step, grads, want, want_loss
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "train_gpt2_reference", "dtype": "float32",
          "layers": layers, "seq": seq, "batch": 2, "by_dropout": results,
          "tolerance": {"loss_rel": 1e-5, "grad_rel_l2": 1e-4}})


def plain_encoder(torch, layer, x, bias):
    """The post-norm ``TransformerEncoderLayer`` as a composition of plain
    versions (dense attention with the kernels' keep mask, plain
    LayerNorm and dropout), in the layer's order of draws; returns the
    output and linear1's pre-activations."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import _nn
    mha = layer.self_attn
    b, s, e = x.shape

    def lin(t, m):
        return t @ m.weight + m.bias

    def heads(t):
        return t.reshape(b, s, mha.num_heads, mha.head_dim)

    def ln(t, norm):
        return _nn.layer_norm(t, [e], norm.weight, norm.bias, norm.epsilon)

    a = F.scaled_dot_product_attention_ref(
        heads(lin(x, mha.q_proj)), heads(lin(x, mha.k_proj)),
        heads(lin(x, mha.v_proj)), attn_mask=bias, dropout_p=mha.dropout)
    h = ln(x + _nn.dropout(lin(a.reshape(b, s, e), mha.out_proj),
                           layer.dropout1.p), layer.norm1)
    pre = lin(h, layer.linear1)
    f = lin(_nn.dropout(layer.activation(pre), layer.dropout.p),
            layer.linear2)
    return ln(h + _nn.dropout(f, layer.dropout2.p), layer.norm2), pre


def encoder_run(torch, dev, activation, counters=None, trace=False):
    """One post-norm ``TransformerEncoderLayer`` at GPT-2 width (768, 12
    heads, FFN 3072), batch 8 x seq 1024, dropout 0.1, with a trained
    ``attn_mask`` [1, 12, 1024, 1024], forward and backward through the
    kernels, then through the plain composition from the same generator
    seed.  With ``counters``, their launches count the kernel route alone;
    with ``trace``, the kernel route runs twice under the profiler
    (``prof``; a trace of one run lost the events of its first kernels on
    the card, flash forward among them).
    Returns what the bias-gradient kernel was given and gave (captured
    from the layer's own backward), both routes' dbias and outputs, how
    many of linear1's pre-activations differ in sign between them, and
    the query rows of the tokens where any does."""
    from paddle_tpu_torch.nn.transformer import TransformerEncoderLayer
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.random import rng_guard
    e, h, s, b = GPT_WIDTH, GPT_HEADS, GPT_SEQ, GPT_BATCH
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    layer = TransformerEncoderLayer(e, h, 4 * e, dropout=GPT_DROP,
                                    activation=activation, device=dev,
                                    generator=gen)
    x = torch.randn(b, s, e, generator=gen, device=dev)
    ct = torch.randn(b, s, e, generator=gen, device=dev)
    bias = torch.nn.Parameter(0.1 * torch.randn(1, h, s, s, generator=gen,
                                                device=dev))
    params = [bias] + list(layer.parameters())
    seen = {}
    grads_fn = fa._grads

    def capture(*args, **kw):          # the inputs and result of #5
        got = grads_fn(*args, **kw)
        if kw.get("bias") is not None:
            seen["args"], seen["bias"], seen["dbias"] = args, kw["bias"], \
                got[3]
        return got
    hook = layer.linear1.register_forward_hook(
        lambda m, i, o: seen.__setitem__("pre", o.detach()))
    fa._grads = capture
    try:
        for fn in (counters or {}).values():
            fn.launches = 0

        def routed():
            with rng_guard(torch.Generator(device=dev).manual_seed(
                    SEED + 7)):
                out = layer(x, bias)
                return out, torch.autograd.grad((out * ct).sum(), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if trace:
            (out, grads), prof = profiled(
                torch, lambda: [routed() for _ in range(2)][-1])
        else:
            (out, grads), prof = routed(), None
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in (counters or {}).items()}
    finally:
        fa._grads = grads_fn
        hook.remove()
    with rng_guard(torch.Generator(device=dev).manual_seed(SEED + 7)):
        want_out, want_pre = plain_encoder(torch, layer, x, bias)
        want, = torch.autograd.grad((want_out * ct).sum(), [bias])
    flipped = (seen["pre"] > 0) != (want_pre > 0)       # [B, S, FFN]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    return {"wall": wall, "launches": launches, "seen": seen, "prof": prof,
            "dbias": grads[0], "want": want, "out": out,
            "want_out": want_out, "flips": int(flipped.sum()),
            "flipped_rows": flipped.any(-1).any(0), "finite": finite}


def encoder_bias_phase(torch, dev, table):
    """The post-norm ``TransformerEncoderLayer`` with a trained bias
    (``encoder_run``), at the layer's default ReLU: the add+norm kernel's
    LayerNorm body (#9, twice: norm1 and norm2, and its backward twice),
    the flash forward, dQ, dK/dV and the bias gradient (#2-#5, once each)
    launch; #5's result
    is held within 1e-5 (relative L2) of its plain version on exactly
    the tensors the layer's backward gave it.  The layer's dbias is held
    against the plain composition's within 1e-5 where no ReLU derivative
    differs between the two routes, and the count of those that do is
    reported: ReLU's derivative jumps at 0, so two f32 routes whose
    forwards differ by rounding can flip it at a few elements.  A flip
    at token s changes only dO's row s, and dbias[h, i, j] reads only
    dO's row i, so the layer's dbias is held within 1e-5 on every query
    row but those of flipped tokens, and its whole error is reported.
    The same layer with GELU (GPT-2's activation, smooth at 0) is held
    against the plain composition within 1e-5 on every row."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    e, h, s, b = GPT_WIDTH, GPT_HEADS, GPT_SEQ, GPT_BATCH
    counters = {"add_layer_norm": ft.add_layer_norm_raw,
                "add_layer_norm_bwd": ft.add_layer_norm_backward_raw,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "flash_attention_dbias": fa.flash_attention_bwd_dbias}
    expect = {"add_layer_norm": 2, "add_layer_norm_bwd": 2,
              "flash_attention_fwd": 1,
              "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
              "flash_attention_dbias": 1}
    relu = encoder_run(torch, dev, "relu", counters)
    launches = relu["launches"]
    q, k, v, out, lse, do, causal, _, p, seed = relu["seen"]["args"]
    kernel_db = relu["seen"]["dbias"]
    plain_db = fa.flash_attention_dbias_reference(
        q, k, v, out, lse, do, relu["seen"]["bias"], causal=causal,
        dropout_p=p, seed=seed)
    iso = rel_l2(kernel_db, plain_db)
    rest = ~relu["flipped_rows"]
    relu_err = rel_l2(relu["dbias"][..., rest, :], relu["want"][..., rest, :])
    del q, k, v, out, lse, do, kernel_db, plain_db
    result = {"dbias_kernel_vs_plain_on_its_inputs_rel_l2": iso,
              "dbias_rel_l2_err_all_rows": rel_l2(relu["dbias"],
                                                  relu["want"]),
              "dbias_rel_l2_err_unflipped_rows": relu_err,
              "out_rel_l2_err": rel_l2(relu["out"], relu["want_out"]),
              "relu_sign_flips": relu["flips"],
              "flipped_query_rows": relu["flipped_rows"].nonzero()
              .flatten().tolist(),
              "fwd_bwd_wall_s": relu["wall"], "finite": relu["finite"]}
    del relu
    torch.cuda.empty_cache()
    # the GELU layer's kernel route traced (again where the profiler
    # dropped a family's events): every f32 attention kernel of it (#2-#5)
    # is a 3xTF32 one
    families = FLASH_FAMILIES + ("flash_dbias",)
    for retry in range(TRACE_RETRIES + 1):
        gelu = encoder_run(torch, dev, "gelu", trace=True)
        prof = gelu["prof"]
        if all(prof["kernel_count_by_family"].get(f) for f in families):
            break
        emit({"phase": "trace_retry", "family": "encoder_bias_profile",
              "top_kernels": prof["top_kernels"]})
    emit({"phase": "encoder_bias_profile", "trace_retries": retry, **prof})
    check_tensor_core_route(prof, "encoder_bias_profile", families,
                            design="3xtf32")
    gelu_err = rel_l2(gelu["dbias"], gelu["want"])
    gelu_res = {"dbias_rel_l2_err": gelu_err,
                "out_rel_l2_err": rel_l2(gelu["out"], gelu["want_out"]),
                "finite": gelu["finite"]}
    del gelu
    torch.cuda.empty_cache()
    emit({"phase": "encoder_bias", "shape": [b, s, e], "heads": h,
          "ffn": 4 * e, "dropout": GPT_DROP, "bias": [1, h, s, s],
          "launches": launches, "relu": result, "gelu": gelu_res,
          "pre_activations": b * s * 4 * e,
          "tolerance": {"dbias_rel_l2": F32_REL_L2_TOL}})
    check(launches == expect, f"encoder layer launches {launches}, not "
                              f"{expect}")
    check(result["finite"] and gelu_res["finite"],
          "non-finite encoder gradients")
    check(iso <= F32_REL_L2_TOL, f"the encoder's dbias kernel off its plain "
                                 f"version on its own inputs by {iso}")
    check(relu_err <= F32_REL_L2_TOL,
          f"encoder dbias (ReLU) off the plain composition by {relu_err} "
          f"on the query rows of unflipped tokens")
    check(gelu_err <= F32_REL_L2_TOL, f"encoder dbias (GELU) off the plain "
                                      f"composition by {gelu_err}")
    table["flash_attention_dbias"]["launches"] = \
        launches["flash_attention_dbias"]
    table["add_layer_norm"]["launches"] = launches["add_layer_norm"]
    table["add_layer_norm_bwd"]["launches"] = launches["add_layer_norm_bwd"]


# -- the training loop's state: schedule, clip tap, timer, checkpoints,
# the other optimizers (GPT-2 124M on bench_gpt2's recipe)

TS_STEPS = 6          # LinearWarmup over 2 steps, then the cosine
TS_LR = 1e-4


def schedule_of(optimizer):
    """``bench_gpt2``'s lr 1e-4 under a warm-up and cosine decay:
    ``LinearWarmup(CosineAnnealingDecay(1e-4, T_max=8), warmup_steps=2,
    start_lr=0, end_lr=1e-4)``."""
    lr = optimizer.lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(TS_LR, T_max=8),
                           warmup_steps=2, start_lr=0.0, end_lr=TS_LR)


def gpt_state_trainer(torch, dev, seed, *, model=None, schedule=True,
                      opt=None, **kw):
    """GPT-2 124M (full width and depth, f32, dropout 0.1) under
    ``CompiledTrainStep`` with ``ClipGradByGlobalNorm(1.0)`` and the
    grad-norm tap; AdamW on the schedule (or lr 1e-4) unless ``opt``
    makes another optimizer of the parameters."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt2_124m_config)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    if model is None:
        model = GPTForCausalLM(gpt2_124m_config(), device=dev,
                               generator=torch.Generator(
                                   device=dev).manual_seed(seed))
    crit = GPTPretrainingCriterion()
    if opt is None:
        opt = optimizer.AdamW(
            learning_rate=schedule_of(optimizer) if schedule else TS_LR,
            parameters=model.parameters(),
            grad_clip=ClipGradByGlobalNorm(1.0))
    else:
        opt = opt(model.parameters())
    kw.setdefault("grad_norm_tap", True)
    return model, CompiledTrainStep(
        model, lambda m, b: crit(m(b["x"]), b["y"]), opt, seed=seed, **kw)


@contextlib.contextmanager
def update_scalars():
    """Record the ``scalars`` tensor ([lr, step, clip scale]) of each
    step's fused update calls, by reference (nothing is read until the
    caller reads it).  The kernel counts its launches on the module's
    ``fused_update_flat``, the wrapper while it is installed; the count
    goes back to the wrapped function on exit."""
    from paddle_tpu_torch.ops import fused_train as ft
    orig, seen = ft.fused_update_flat, []

    def wrapper(*args, scalars, **kw):
        if not seen or seen[-1] is not scalars:
            seen.append(scalars)
        return orig(*args, scalars=scalars, **kw)

    wrapper.launches = orig.launches
    ft.fused_update_flat = wrapper
    try:
        yield seen
    finally:
        orig.launches = wrapper.launches
        ft.fused_update_flat = orig


def gpt_counters(torch, model, layers):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    big = sum(p.numel() * p.element_size() >= (1 << 20)
              for p in model.parameters())
    return {"flash_attention_fwd": (fa.flash_attention_fwd, layers),
            "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, layers),
            "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, layers),
            "fused_update": (ft.fused_update_flat, big + 1)}


def train_schedule_phase(torch, np, dev):
    """GPT-2 124M on ``bench_gpt2``'s recipe with the schedule, the clip
    and the grad-norm tap, a ``StepTimer`` fed by ``step_flops``:
    TS_STEPS steps.  Each step's lr as #8 read it (its scalars, read
    after the run) equals the scheduler's float in f32; launches a step
    are train_gpt2's; a traced step makes the same host copies and waits
    as a constant-lr step's; step_flops within 10 % of (6N + 6LSh) x
    tokens; the timer's MFU beside the phase's own."""
    from paddle_tpu_torch.models.gpt import gpt2_124m_config
    from paddle_tpu_torch.observability.metrics import MetricRegistry
    from paddle_tpu_torch.observability.steptimer import StepTimer
    cfg = gpt2_124m_config()
    layers = cfg.num_hidden_layers
    model, step = gpt_state_trainer(torch, dev, SEED + 6)
    batch = gpt_batch(torch, np, dev, cfg.vocab_size, GPT_BATCH, GPT_SEQ)
    tokens = GPT_BATCH * GPT_SEQ
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    flops = step.step_flops(batch)
    flops_s = time.perf_counter() - t0
    f6n_attn = (6 * n_params + 6 * layers * GPT_SEQ * cfg.hidden_size) \
        * tokens
    timer = StepTimer(registry=MetricRegistry(), prefix="train_schedule",
                      tokens_per_step=tokens, flops_per_step=flops)
    step.attach_timer(timer)
    sched = step.optimizer._lr_scheduler
    counters = gpt_counters(torch, model, layers)
    for fn, _ in counters.values():
        fn.launches = 0
    lrs, losses, taps = [], [], []
    with update_scalars() as seen:
        for _ in range(TS_STEPS):
            lrs.append(sched())
            losses.append(step(batch))
            taps.append(step.last_grad_norm)
    launches = {n: fn.launches for n, (fn, _) in counters.items()}
    read = [float(s[0]) for s in seen]
    losses = [float(x) for x in losses]
    taps = [float(x) for x in taps]
    summ = timer.summary()
    # the fence's cost: steps with the timer attached (each returns after
    # its fence) against steps without it that end in a synchronize
    # (train_gpt2's measure), in turns, on the host clock
    fenced, plain = [], []
    for _ in range(3):
        for attached, out in ((True, fenced), (False, plain)):
            step.attach_timer(timer if attached else None)
            t = time.perf_counter()
            step(batch)
            if not attached:
                torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
    step.attach_timer(None)
    # host copies and waits of one untimed step: scheduled against
    # constant lr
    _, sync_sched = host_syncs(torch, lambda: step(batch))
    _, const = gpt_state_trainer(torch, dev, SEED + 6, model=model,
                                 schedule=False)
    const(batch)
    _, sync_const = host_syncs(torch, lambda: const(batch))
    del const
    step_s = summ["step_seconds_mean"]
    rep = {"phase": "train_schedule", "model": "gpt2_124m",
           "layers": layers, "dtype": "float32", "batch": GPT_BATCH,
           "seq": GPT_SEQ, "steps": TS_STEPS,
           "schedule": "LinearWarmup(CosineAnnealingDecay(1e-4, T_max=8), "
                       "warmup_steps=2, start_lr=0, end_lr=1e-4)",
           "clip": "ClipGradByGlobalNorm(1.0)", "lrs": lrs,
           "lrs_read_by_update": read, "losses": losses,
           "grad_norm_taps": taps, "launches": launches,
           "step_flops": flops, "step_flops_s": flops_s,
           "flops_6n_attn": f6n_attn,
           "step_flops_over_6n_attn": flops / f6n_attn,
           "timer_summary": summ, "timer_mfu": summ["mfu"],
           "mfu_6n_attn": f6n_attn / (step_s * PEAK_BF16_FLOPS),
           "mfu_convention": "timer: step_flops, mfu_6n_attn: (6N + 6 L S "
                             "h) x tokens, each over the timer's mean step "
                             "time at 989 TFLOP/s (bf16 dense peak)",
           "fenced_step_s": fenced, "plain_step_s": plain,
           "timer_fence_cost_s": sorted(fenced)[1] - sorted(plain)[1],
           "host_syncs": {"scheduled": sync_sched, "constant": sync_const}}
    emit(rep)
    check(all(math.isfinite(x) for x in losses + taps),
          f"losses {losses}, taps {taps}")
    check(len(read) == TS_STEPS and all(
        r == float(np.float32(lr)) for r, lr in zip(read, lrs)),
          f"the update read lrs {read}, the scheduler gave {lrs}")
    for n, (_, per_step) in counters.items():
        check(launches[n] == per_step * TS_STEPS,
              f"{n} launched {launches[n]} times in {TS_STEPS} scheduled "
              f"steps, not {per_step} a step")
    check(abs(flops / f6n_attn - 1) <= 0.1,
          f"step_flops {flops} not within 10 % of (6N + 6LSh) x tokens "
          f"{f6n_attn}")
    for k in ("cudaMemcpyAsync", "cudaStreamSynchronize"):
        check(sync_sched.get(k, 0) == sync_const.get(k, 0),
              f"a scheduled step makes {sync_sched.get(k, 0)} {k}, a "
              f"constant-lr step {sync_const.get(k, 0)}")
    check(summ["steps"] == TS_STEPS and summ["mfu"] > 0
          and timer.summary()["steps"] == TS_STEPS + 3,
          f"timer summary {summ}, then {timer.summary()}")
    del model, step, batch


def bytes_equal(torch, a, b):
    """Two tensors hold the same bytes."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def train_resume_phase(torch, np, dev):
    """Save after 3 steps (``async_save``, a step taken at once, then
    ``wait()``: the checkpoint holds the state at the save), then 2 more
    steps: the uninterrupted losses of steps 4-6.  A fresh model and
    trainer (other seeds) load it: params bit-equal to the saved ones;
    its 3 steps run twice from the loaded state say whether the card's
    step repeats bit for bit: if it does the resumed losses must equal
    the uninterrupted ones exactly, else lie within twice that spread.
    Save and load seconds and bytes; the directory is removed."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch.models.gpt import gpt2_124m_config
    cfg = gpt2_124m_config()
    batches = [gpt_batch(torch, np, dev, cfg.vocab_size, GPT_BATCH,
                         GPT_SEQ)]
    rng = np.random.default_rng(1)
    for _ in range(5):
        ids = rng.integers(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ + 1))
        batches.append({"x": torch.tensor(ids[:, :-1], dtype=torch.int32,
                                          device=dev),
                        "y": torch.tensor(ids[:, 1:], device=dev)})
    root = tempfile.mkdtemp(prefix="train_resume_")
    path = os.path.join(root, "step_3")
    try:
        model, first = gpt_state_trainer(torch, dev, SEED + 7)
        head = [float(first(b)) for b in batches[:3]]
        saved = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = first.save_checkpoint(path, async_save=True,
                                       extra_state={"phase": "resume"})
        snapshot_s = time.perf_counter() - t0
        tail = [first(batches[3])]          # in place, at once
        handle.wait()
        save_s = time.perf_counter() - t0
        tail += [first(b) for b in batches[4:]]
        tail = [float(x) for x in tail]
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(path) for f in fs)
        del first, model
        gc.collect()
        model, second = gpt_state_trainer(torch, dev, SEED + 8)
        runs, load_s = [], []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            extra = second.load_checkpoint(path)
            torch.cuda.synchronize()
            load_s.append(time.perf_counter() - t0)
            if i == 0:
                params_equal = all(bytes_equal(torch, p.detach(), saved[n])
                                   for n, p in model.named_parameters())
            runs.append([float(second(b)) for b in batches[3:]])
        step_count = second.step_count
        del second, model, saved
    finally:
        shutil.rmtree(root, ignore_errors=True)
    spread = max(abs(a - b) for a, b in zip(*runs))
    deterministic = spread == 0.0
    off = max(abs(a - b) for r in runs for a, b in zip(r, tail))
    emit({"phase": "train_resume", "model": "gpt2_124m", "dtype": "float32",
          "batch": GPT_BATCH, "seq": GPT_SEQ, "dropout": GPT_DROP,
          "losses_before_save": head, "uninterrupted_losses": tail,
          "resumed_losses": runs, "card_step_deterministic": deterministic,
          "repeat_spread": spread, "resumed_off_uninterrupted": off,
          "params_bit_equal": params_equal, "extra_state": extra,
          "checkpoint_bytes": ckpt_bytes,
          "async_snapshot_s": snapshot_s, "async_save_s": save_s,
          "save_gb_s": ckpt_bytes / save_s / 1e9, "load_s": load_s,
          "load_gb_s": [ckpt_bytes / s / 1e9 for s in load_s],
          "step_count_after_load": 3, "step_count_after_runs": step_count,
          "criterion": "exact if the repeat is exact, else within twice "
                       "the repeat's spread"})
    check(params_equal, "loaded params differ from the saved ones")
    check(extra == {"phase": "resume"}, f"extra_state came back as {extra}")
    check(all(math.isfinite(x) for x in head + tail), "non-finite losses")
    if deterministic:
        check(all(r == tail for r in runs),
              f"resumed losses {runs} differ from the uninterrupted {tail} "
              f"though the card repeats a step exactly")
    else:
        check(off <= 2 * spread,
              f"resumed losses {runs} off the uninterrupted {tail} by {off},"
              f" over twice the repeat's spread {spread}")


PER_LEAF_OPTIMIZERS = ("Adagrad", "Adamax", "RMSProp", "Lamb", "Adadelta",
                       "ASGD", "Rprop", "NAdam", "RAdam")


def rel_max(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def train_optimizers_phase(torch, np, dev):
    """The 9 optimizers without a fused kind, 2 steps each through the
    train step on GPT-2 124M from one initial state: losses finite,
    params changed, #8 never launched, the first update's seconds (host
    clock, synchronized); the card's update of the 4 smallest leaves
    against the port's CPU update within 1e-6 of the largest element.  LBFGS (history 4, max_iter 4, lr 0.05) over the
    dropout-free model through its closure: the loss falls.  AdamW's
    per-leaf (``fused_step=False``) and fused updates of one set of
    gradients within 1e-6; #8 launches 0 and 51."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models.gpt import gpt2_124m_config
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = gpt2_124m_config()
    batch = gpt_batch(torch, np, dev, cfg.vocab_size, GPT_BATCH, GPT_SEQ)
    model, _ = gpt_state_trainer(torch, dev, SEED + 9)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    small = sorted(init, key=lambda n: init[n].numel())[:4]

    def reset():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])

    rows = {}
    for name in PER_LEAF_OPTIMIZERS:
        reset()
        _, step = gpt_state_trainer(
            torch, dev, SEED + 9, model=model, grad_norm_tap=False,
            opt=lambda ps, name=name: getattr(optimizer, name)(
                learning_rate=1e-4 if name != "Adadelta" else 1.0,
                parameters=ps))
        opt = step.optimizer
        ft.fused_update_flat.launches = 0
        t0 = time.perf_counter()
        loss0, grads = step.grad_step(batch)
        cpu_p = {n: init[n].cpu() for n in small}
        want, _ = opt.apply_gradients(
            cpu_p, {n: grads[n].cpu() for n in small},
            opt.init_state(cpu_p))
        got, _ = opt.apply_gradients(
            {n: init[n] for n in small}, {n: grads[n] for n in small},
            opt.init_state({n: init[n] for n in small}))
        small_err = max(rel_max(got[n].cpu(), want[n]) for n in small)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.apply_grads(grads)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t1
        loss1 = step(batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        changed = sum(not torch.equal(p, init[n])
                      for n, p in model.named_parameters())
        rows[name] = {"losses": [float(loss0), float(loss1)],
                      "fused_update_launches": ft.fused_update_flat.launches,
                      "params_changed": changed,
                      "small_leaves_rel_err": small_err,
                      "update_s": update_s, "seconds": secs}
        del step, opt, grads
        check(all(math.isfinite(x) for x in rows[name]["losses"]),
              f"{name}: losses {rows[name]['losses']}")
        check(rows[name]["fused_update_launches"] == 0,
              f"{name} launched the fused update")
        check(changed > 0, f"{name} changed no parameter")
        check(small_err <= 1e-6, f"{name}: the card's update of the "
                                 f"smallest leaves off the CPU's by "
                                 f"{small_err}")
    # LBFGS through its closure, dropout off so the objective repeats
    reset()
    lb = optimizer.LBFGS(learning_rate=0.05, max_iter=4, history_size=4,
                         parameters=model.parameters())
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    crit = GPTPretrainingCriterion()
    model.eval()
    evals = []

    def closure():
        loss = crit(model(batch["x"]), batch["y"])
        loss.backward()
        evals.append(float(loss.detach()))
        return loss

    t0 = time.perf_counter()
    lb_loss = float(lb.step(closure))
    lb_s = time.perf_counter() - t0
    model.train()
    for p in model.parameters():
        p.grad = None
    # AdamW per-leaf against fused on one set of gradients
    reset()
    _, fused = gpt_state_trainer(torch, dev, SEED + 9, model=model,
                                 schedule=False, grad_norm_tap=False)
    _, unfused = gpt_state_trainer(torch, dev, SEED + 9, model=model,
                                   schedule=False, grad_norm_tap=False,
                                   fused_step=False)
    _, grads = fused.grad_step(batch)
    adamw = {}
    for name, st in (("unfused", unfused), ("fused", fused)):
        reset()
        ft.fused_update_flat.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st.apply_grads(grads)
        torch.cuda.synchronize()
        adamw[name] = ({n: p.detach().clone()
                        for n, p in model.named_parameters()},
                       ft.fused_update_flat.launches,
                       time.perf_counter() - t1)
    big = sum(p.numel() * p.element_size() >= (1 << 20)
              for p in model.parameters())
    adamw_err = max(rel_max(adamw["fused"][0][n], adamw["unfused"][0][n])
                    for n in init)
    emit({"phase": "train_optimizers", "model": "gpt2_124m",
          "dtype": "float32", "batch": GPT_BATCH, "seq": GPT_SEQ,
          "per_leaf": rows, "small_leaves": small,
          "lbfgs": {"evals": evals, "final_loss": lb_loss,
                    "seconds": lb_s, "history_size": 4, "max_iter": 4},
          "adamw_fused_vs_unfused_rel_err": adamw_err,
          "adamw_fused_update_launches": {
              k: v[1] for k, v in adamw.items()},
          "adamw_update_s": {k: v[2] for k, v in adamw.items()},
          "tolerance": {"small_leaves_rel": 1e-6, "adamw_rel": 1e-6}})
    check(lb_loss < evals[0], f"LBFGS loss did not fall: {evals}")
    check(adamw["unfused"][1] == 0 and adamw["fused"][1] == big + 1,
          f"AdamW #8 launches unfused {adamw['unfused'][1]}, fused "
          f"{adamw['fused'][1]} (want 0 and {big + 1})")
    check(adamw_err <= 1e-6, f"AdamW fused off per-leaf by {adamw_err}")
    del model, init, fused, unfused, grads, adamw


# ---------------------------------------------------------------------------
# the rest of the model zoo: ERNIE-4.5 (dense and MoE), DiT-L/2 and its
# KL autoencoder, BERT-base, DeepSeekMoE-16B serving
# ---------------------------------------------------------------------------

# bench.py bench_ernie's single-chip recipe: hidden 1536, 16 layers,
# 12 / 4 heads (GQA group 3), vocab 103,424, batch 2 x seq 8192
ERNIE_WIDTH = dict(vocab_size=103424, hidden_size=1536,
                   intermediate_size=6144, num_hidden_layers=16,
                   num_attention_heads=12, num_key_value_heads=4,
                   max_position_embeddings=8192)
ERNIE_BATCH, ERNIE_SEQ = 2, 8192
# ernie45_a3b_config's widths (hidden 2560, 20 / 4 heads: group 5; 64
# experts top-6 of 1536 and 2 shared), the first layer dense, then
# ERNIE_MOE_LAYERS MoE layers, at batch 2 x 4096: the depth that keeps
# the step's peak memory under ERNIE_MOE_PEAK (each MoE layer holds
# about 9.5 GB of bf16 parameters and gradients and f32 moments: 4 MoE
# layers peaked at 48.5 GB on the card, so 6 reach about 68)
ERNIE_MOE_LAYERS, ERNIE_MOE_SEQ, ERNIE_MOE_PEAK = 6, 4096, 70e9
# bench.py bench_dit: DiT-L/2 on 32 x 32 x 4 latents, batch 16
DIT_WIDTH = dict(input_size=32, patch_size=2, hidden_size=1024, depth=24,
                 num_heads=16)
DIT_BATCH, DIT_STEPS = 16, 8
# AutoencoderKL at its own widths (base 32, 8 groups) on 8 x 3 x 256^2
VAE_BATCH, VAE_SIZE, VAE_STEPS = 8, 256, 5
# BERT-base (BertConfig() defaults, dropout 0.1) as a masked LM, batch
# 16 x 512, the last quarter of each row padded, 15 % of the rest
# predicted
BERT_BATCH, BERT_SEQ = 16, 512
ZOO_STEPS = 5


def update_launches(params):
    """Launches of the fused update (#8) a step: one for each leaf of 1
    MiB or more, one for each dtype among the smaller leaves (packed)."""
    big = sum(p.numel() * p.element_size() >= 1 << 20 for p in params)
    small = {p.dtype for p in params
             if p.numel() * p.element_size() < 1 << 20}
    return big + len(small)


def zoo_flash_rows(torch, table, tag, q, k, v, do, *, causal, mask=None,
                   dropout_p=0.0, seed=None, launches_from, pairs=None,
                   backward=True):
    """#2, #3 and #4 at one path's attention: each against its plain
    version (the same seed under dropout), timed beside its bound and
    one PyTorch call (``scaled_dot_product_attention`` with the path's
    GQA, mask and dropout; for the backward, its autograd backward:
    dq, dk and dv in one call).  16-bit rows must trace the wgmma
    kernels and stay within 2^-7 relative L2 (and 0.02 of the largest
    element); f32 rows (D 64) the 3xTF32 kernels, within 1e-5.  The
    bounds count the (query, key) pairs that causality leaves, or
    ``pairs`` (those an additive mask leaves finite); ``backward``
    False: #2 alone (decoding)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    f32 = q.dtype == torch.float32
    el = q.element_size()
    kw = dict(causal=causal, mask=mask, dropout_p=dropout_p, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    got, want = {"out": out}, {}
    if backward:
        ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, causal,
                                              mask)
        got["dq"] = fa.flash_attention_bwd_dq(*ops, causal, dropout_p, seed)
        got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(*ops, causal,
                                                          dropout_p, seed)
        want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, **kw)))
    want["out"] = fa.flash_attention_fwd_reference(q, k, v, **kw)[0]
    torch.cuda.synchronize()
    errs = {n: {"rel_l2_err": rel_l2(g, want[n]),
                "rel_to_largest": rel_err(g, want[n]),
                "max_abs_err": (g.float() - want[n].float()).abs().max()
                .item()} for n, g in got.items()}
    del want
    for n, e in errs.items():
        ok = e["rel_l2_err"] <= F32_REL_L2_TOL if f32 else \
            e["rel_l2_err"] <= REL_L2_TOL and e["rel_to_largest"] <= GRAD_TOL
        check(ok, f"flash {n} ({tag}) off its plain version: {e}")
    if pairs is None:
        pairs = fa._flops.attention_pairs(b, s, sk, causal)
    qb, kb = b * s * h * d * el, b * sk * hk * d * el
    mb = 0 if mask is None else mask.numel() * 4
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.detach().transpose(1, 2) for x in (q, k, v, do))
    lib_mask = None if mask is None else mask.to(q.dtype)
    lkw = dict(attn_mask=lib_mask, dropout_p=dropout_p, is_causal=causal)
    if hk != h:
        lkw["enable_gqa"] = True
    lq, lk, lv = (x.clone().requires_grad_() for x in (qt, kt, vt))
    lout = sdpa(lq, lk, lv, **lkw) if backward else None

    def fwd_library():
        sdpa(qt, kt, vt, **lkw)

    def bwd_library():
        torch.autograd.grad(lout, (lq, lk, lv), dot, retain_graph=True)

    rows = (
            (f"flash_attention_fwd_{tag}", "flash_attention_fwd.cu",
             "flash_attention.py:164",
             lambda: fa.flash_attention_fwd(q, k, v, **kw),
             4 * d * h * pairs, 2 * qb + 2 * kb + mb + b * h * s * 4,
             lambda: fa.flash_attention_fwd_reference(q, k, v, **kw),
             fwd_library, ("out",)),
            (f"flash_attention_bwd_dq_{tag}", "flash_attention_bwd.cu",
             "flash_attention.py:390",
             lambda: fa.flash_attention_bwd_dq(*ops, causal, dropout_p,
                                               seed),
             6 * d * h * pairs, 3 * qb + 2 * kb + mb + 2 * b * h * s * 4,
             lambda: fa.flash_attention_bwd_reference(
                 q, k, v, out, lse, do, **kw), bwd_library, ("dq",)),
            (f"flash_attention_bwd_dkv_{tag}", "flash_attention_bwd.cu",
             "flash_attention.py:431",
             lambda: fa.flash_attention_bwd_dkv(*ops, causal, dropout_p,
                                                seed),
             8 * d * h * pairs, 2 * qb + 4 * kb + mb + 2 * b * h * s * 4,
             lambda: fa.flash_attention_bwd_reference(
                 q, k, v, out, lse, do, **kw), bwd_library, ("dk", "dv")))
    for name, src, line, fn, flops, n_bytes, plain, lib, outs in \
            rows[:3 if backward else 1]:
        bound = f32_bounds(n_bytes, flops, True) if f32 else dict(zip(
            ("bound_ms", "bound_by"), bound_ms(n_bytes, flops)))
        # the plain backward holds tens of GB in the allocator's cache:
        # free it before the trace (a trace taken over a nearly full
        # card came back empty)
        plain_ms = timed_ms(torch, plain, 1, warmup=1)
        torch.cuda.empty_cache()
        row = {"name": name, "route": "cuda",
               "source": f"paddle_tpu_torch/csrc/{src}",
               "replaces": f"paddle_tpu/ops/pallas/{line}",
               "launches": None,
               "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
               "ms": timed_ms(torch, fn, 5, warmup=1),
               "plain_ms": plain_ms, **bound,
               "library_ms": timed_ms(torch, lib, 5, warmup=1),
               **traced_kernel(torch, fn)}
        want_design = "3xtf32" if f32 else "wgmma"
        check(row["design"] == want_design,
              f"{name} ran on {row['design']}, not {want_design}")
        table[name] = row
        launches_from[name] = name[:-len(tag) - 1]       # its wrapper
        torch.cuda.empty_cache()
        emit({"phase": "kernel", **row, "shape": list(q.shape),
              "kv_heads": hk, "group": h // hk, "causal": causal,
              "mask": None if mask is None else list(mask.shape),
              "dropout_p": dropout_p, "dtype": str(q.dtype),
              "errors": {o: errs[o] for o in outs},
              "plain_note": None if name.startswith("flash_attention_fwd")
              else "the whole plain backward (dq, dk, dv)",
              "library_note": "scaled_dot_product_attention"
              + ("" if name.startswith("flash_attention_fwd")
                 else "'s autograd backward (dq, dk, dv)")
              + (" (its own dropout mask)" if dropout_p else "")})
    del got, lout, lq, lk, lv
    torch.cuda.empty_cache()


def zoo_kernels(torch, np, gen, dev, table):
    """The kernels at the shapes the new paths give them, each against
    its plain version, timed beside its bound and a library call:

    - #2-#4 at ERNIE's attention [2, 8192, 12, 128] over 4 KV heads
      (group 3, causal, bf16), ERNIE-A3B's [2, 4096, 20, 128] over 4
      (group 5), BERT's [16, 512, 12, 64] bf16 with the [16, 1, 1, 512]
      padding bias and dropout 0.1, and DiT-L/2's [16, 256, 16, 64] f32
      (the reference's amp O2 leaves DiT's blocks in f32);
    - #9's LayerNorm body in bf16 at BERT's [16, 512, 768], forward and
      backward (no dh: BERT drops h);
    - #10 at ERNIE's q [16384 x 1536] x [1536 x 1536] and k [1536 x 512],
      and at ERNIE-A3B's hidden 2560 (20 heads; k 4 heads);
    - #11-#13 at ERNIE-A3B's experts: 8192 tokens top-6 of 64 experts,
      H 2560, F 1536, bf16 (tm 256), and #11's f32 rows at
      DeepSeekMoE-16B's serving step (136 rows top-6 of 64, H 2048, F
      1408).

    Returns {row: (wrapper's count name, path)} for the launches that
    the paths fill in."""
    from paddle_tpu_torch.models.llama import _rope_cos_sin
    from paddle_tpu_torch.ops import fused_train as ft
    from paddle_tpu_torch.ops import grouped_matmul as gm
    bf = torch.bfloat16
    src = {}

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    for tag, (b, s, h, hk, d, dt, causal) in (
            ("ernie", (ERNIE_BATCH, ERNIE_SEQ, 12, 4, 128, bf, True)),
            ("ernie_moe", (ERNIE_BATCH, ERNIE_MOE_SEQ, 20, 4, 128, bf,
                           True)),
            ("bert", (BERT_BATCH, BERT_SEQ, 12, 12, 64, bf, False)),
            ("dit", (DIT_BATCH, 256, 16, 16, 64, torch.float32, False))):
        q, k, v, do = (rnd(b, s, n, d, dtype=dt) for n in (h, hk, hk, h))
        mask = seed = None
        p = 0.0
        if tag == "bert":
            keep = torch.ones(b, s, device=dev)
            keep[:, s - s // 4:] = 0.0
            mask = ((keep - 1.0) * 1e30)[:, None, None, :]
            p = 0.1
            seed = torch.tensor(SEED + 31, dtype=torch.int64, device=dev)
        zoo_flash_rows(torch, table, tag, q, k, v, do, causal=causal,
                       mask=mask, dropout_p=p, seed=seed, launches_from=src)
        del q, k, v, do

    # #9, the LayerNorm body in bf16 at BERT's post-norm residuals
    shape, hdim = (BERT_BATCH, BERT_SEQ, 768), 768
    x, r = rnd(*shape), rnd(*shape)
    w = (1 + 0.1 * rnd(hdim, dtype=torch.float32)).to(bf)
    bb = (0.1 * rnd(hdim, dtype=torch.float32)).to(bf)

    def run():
        return ft.add_layer_norm_raw(x, r, w, bb, 1e-12)

    def plain():
        return ft.add_layer_norm_reference(x, r, w, bb, 1e-12)

    (hh, y), (want_h, want_y) = run(), plain()
    torch.cuda.synchronize()
    err = rel_l2(y, want_y)
    check(torch.equal(hh, want_h) and err <= REL_L2_TOL,
          f"bf16 add_layer_norm off its plain version: {err}")
    n = x.numel()
    bound, bound_by = bound_ms(4 * n * 2 + 2 * hdim * 2, 9 * n,
                               peak=PEAK_F32_FLOPS)
    table["add_layer_norm_bf16"] = {
        "name": "add_layer_norm_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/add_norm.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_train.py:322",
        "launches": None,
        "max_abs_err": (y.float() - want_y.float()).abs().max().item(),
        "ms": timed_ms(torch, run, 20),
        "device_ms": traced_kernel(torch, run, "add_norm")["device_ms"],
        "plain_ms": timed_ms(torch, plain, 5), "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None,
        "composed_ms": timed_ms(torch, lambda: torch.nn.functional.layer_norm(
            x + r, (hdim,), w, bb, 1e-12), 20)}
    emit({"phase": "kernel", **table["add_layer_norm_bf16"],
          "shape": list(shape), "dtype": "bfloat16", "rel_l2_err": err,
          "h_equal": True, "tolerance": {"rel_l2_err": REL_L2_TOL},
          "host_us": host_us(torch, lambda: ft.add_layer_norm_raw(
              x[:1, :8], r[:1, :8], w, bb, 1e-12)),
          "library_note": "no single PyTorch call adds the residual and "
                          "normalises; composed_ms: x + r, then "
                          "torch.nn.functional.layer_norm"})
    src["add_layer_norm_bf16"] = "add_layer_norm"
    del x, r, want_h, want_y
    # its backward as BERT runs it: h dropped, so no dh
    add_norm_bwd_row(torch, table, "add_layer_norm_bf16_bwd",
                     "add_layer_norm", hh, w, bb, None, rnd(*shape), 1e-12,
                     REL_L2_TOL)
    src["add_layer_norm_bf16_bwd"] = "add_layer_norm_bwd"
    del hh, y

    # #10 at ERNIE's and ERNIE-A3B's widths, tables in bf16 as amp O2
    # leaves them
    for tag, b, s, hidden, heads in (
            ("ernie_q", ERNIE_BATCH, ERNIE_SEQ, 1536, 12),
            ("ernie_k", ERNIE_BATCH, ERNIE_SEQ, 1536, 4),
            ("ernie_moe_q", ERNIE_BATCH, ERNIE_MOE_SEQ, 2560, 20),
            ("ernie_moe_k", ERNIE_BATCH, ERNIE_MOE_SEQ, 2560, 4)):
        hd = 128
        ang = _rope_cos_sin(s, hd, 500000.0)
        cos, sin = (torch.from_numpy(f(ang)).to(dev, bf)
                    for f in (np.cos, np.sin))
        x = rnd(b, s, hidden)
        w = (0.02 * rnd(hidden, heads * hd, dtype=torch.float32)).to(bf)

        def run():
            return ft.matmul_rope_raw(x, w, cos, sin, n_heads=heads,
                                      head_dim=hd)

        def plain():
            return ft.matmul_rope_reference(x, w, cos, sin, heads, hd)

        got, want = run(), plain()
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        check(err <= REL_L2_TOL,
              f"matmul_rope {tag} off its plain version: {err}")
        rows = b * s
        bound, bound_by = bound_ms(
            (x.numel() + w.numel() + got.numel() + 2 * s * hd) * 2,
            2 * rows * hidden * heads * hd)
        name = f"matmul_rope_{tag}"
        table[name] = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/matmul_rope.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_train.py:501",
            "launches": None,
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "ms": timed_ms(torch, run, 10),
            "plain_ms": timed_ms(torch, plain, 3),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": timed_ms(torch, lambda: torch.matmul(x, w), 10),
            **traced_kernel(torch, run, "matmul_rope")}
        check(table[name]["design"] == "wgmma",
              f"{name}: the bf16 call did not reach the tensor cores")
        emit({"phase": "kernel", **table[name], "shape": [b, s, hidden],
              "heads": heads, "head_dim": hd, "rel_l2_err": err,
              "tolerance": {"rel_l2_err": REL_L2_TOL},
              "library_note": "torch.matmul of the product alone (no rope)"})
        src[name] = "matmul_rope"
        del x, w, got, want

    # #11-#13 at ERNIE-A3B's experts (the MoE step's shapes, one layer)
    e, kk, hdim, fdim = 64, 6, 2560, 1536

    def stack(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(shape[1])).to(bf)

    wg, wu, wd = stack(e, hdim, fdim), stack(e, hdim, fdim), \
        stack(e, fdim, hdim)
    xs, te, counts, tm = moe_plan_rows(
        torch, gen, dev, ERNIE_BATCH * ERNIE_MOE_SEQ, hdim, bf,
        empty=e - 1, e=e, k=kk)
    live = (xs[:, :1] != 0).to(bf)
    hs = torch.randn(xs.shape[0], fdim, generator=gen, device=dev).to(
        bf) * live
    dys = torch.randn(xs.shape[0], hdim, generator=gen, device=dev).to(
        bf) * live
    routed, alive = int(counts.sum()), int((counts > 0).sum())
    for name, fn, plain, lib, flops, n_bytes, ref_line, path in (
            ("grouped_matmul_e64",
             lambda: gm.gmm_raw(hs, wd, te, counts=counts),
             lambda: gm.gmm_reference(hs, wd, te),
             grouped_mm_library(torch, counts, tm, hs, wd),
             2 * routed * fdim * hdim,
             2 * (routed * (fdim + hdim) + alive * fdim * hdim),
             "grouped_matmul.py:89", "grouped_matmul"),
            ("grouped_matmul_e64_dx",
             lambda: gm.gmm_raw(dys, wd, te, transpose_w=True,
                                counts=counts),
             lambda: gm.gmm_reference(dys, wd, te, transpose_w=True),
             grouped_mm_library(torch, counts, tm, dys, wd.transpose(1, 2)),
             2 * routed * fdim * hdim,
             2 * (routed * (fdim + hdim) + alive * fdim * hdim),
             "grouped_matmul.py:89", "grouped_matmul"),
            ("grouped_matmul_glu_e64",
             lambda: gm.gmm_glu_raw(xs, wg, wu, te, save_pre=True,
                                    counts=counts),
             lambda: gm.gmm_glu_reference(xs, wg, wu, te, save_pre=True),
             (None, "no single PyTorch call fuses the two products with "
                    "SwiGLU"),
             4 * routed * hdim * fdim,
             2 * (routed * (hdim + 3 * fdim) + 2 * alive * hdim * fdim),
             "grouped_matmul.py:161", "grouped_matmul_glu"),
            ("grouped_matmul_dw_e64",
             lambda: gm.gmm_dw_raw(hs, dys, te, counts, e),
             lambda: gm.gmm_dw_reference(hs, dys, te, counts, e),
             grouped_mm_library(torch, counts, tm, hs.t(), dys),
             2 * routed * fdim * hdim,
             2 * (routed * (fdim + hdim) + e * fdim * hdim),
             "grouped_matmul.py:278", "grouped_matmul_dw")):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [rel_l2(g, w_) for g, w_ in zip(got, want)]
        check(max(errs) <= REL_L2_TOL, f"{name} off its plain version: "
                                       f"{errs}")
        if name == "grouped_matmul_dw_e64":
            check(not got[0][e - 1].any(),
                  f"{name}: the empty expert's gradient is not zero")
        bound, bound_by = bound_ms(n_bytes, flops)
        lib_fn, lib_note = lib
        table[name] = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/grouped_matmul.cu",
            "replaces": f"paddle_tpu/ops/pallas/{ref_line}",
            "launches": None,
            "max_abs_err": max((g.float() - w_.float()).abs().max().item()
                               for g, w_ in zip(got, want)),
            "plain_ms": timed_ms(torch, plain, 1, warmup=1),
            "ms": timed_ms(torch, fn, 10),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None if lib_fn is None
            else timed_ms(torch, lib_fn, 10)}
        torch.cuda.empty_cache()
        table[name].update(traced_kernel(torch, fn, path))
        if path == "grouped_matmul_glu":    # no one call: a composition
            composed, note = glu_composed(torch, counts, tm, xs, wg, wu)
            table[name]["composed_ms"] = None if composed is None \
                else timed_ms(torch, composed, 10)
            lib_note += "; composed_ms: " + note
        check(table[name]["design"] == "wgmma",
              f"{name} ran on {table[name]['design']}, not wgmma")
        emit({"phase": "kernel", **table[name], "experts": e, "top_k": kk,
              "hidden": hdim, "ffn": fdim, "m_pad": xs.shape[0], "tm": tm,
              "routed_rows": routed, "rel_l2_err": errs,
              "tolerance": {"rel_l2_err": REL_L2_TOL},
              "library_note": lib_note})
        src[name] = path
        del got, want
    del xs, hs, dys, live, wg, wu, wd
    torch.cuda.empty_cache()

    # #11's f32 rows at DeepSeekMoE-16B's mixed serving step
    e, kk, hdim, fdim = 64, 6, 2048, 1408
    wgs = stack(e, hdim, fdim)
    xs, te, counts, tm = moe_plan_rows(torch, gen, dev, 136, hdim,
                                       torch.float32, e=e, k=kk)

    def run():
        return gm.gmm_raw(xs, wgs, te, counts=counts)

    got, want = run(), gm.gmm_reference(xs, wgs, te)
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    check(err <= F32_REL_L2_TOL, f"f32 rows at 64 experts: {err}")
    routed, alive = int(counts.sum()), int((counts > 0).sum())
    bound, bound_by = bound_ms(routed * (hdim + fdim) * 4
                               + alive * hdim * fdim * 2,
                               2 * routed * hdim * fdim,
                               peak=PEAK_F32_FLOPS)
    table["grouped_matmul_f32_rows_e64"] = {
        "name": "grouped_matmul_f32_rows_e64", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/grouped_matmul.cu",
        "replaces": "paddle_tpu/ops/pallas/grouped_matmul.py:89",
        "launches": None,
        "max_abs_err": (got - want).abs().max().item(),
        "ms": timed_ms(torch, run, 10),
        "plain_ms": timed_ms(torch, lambda: gm.gmm_reference(xs, wgs, te),
                             3),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        **traced_kernel(torch, run, "grouped_matmul")}
    check(table["grouped_matmul_f32_rows_e64"]["design"] == "stream",
          "f32 rows at 64 experts left the streaming kernel")
    emit({"phase": "kernel", **table["grouped_matmul_f32_rows_e64"],
          "case": "DeepSeekMoE-16B serve gate, f32 rows, 816 slots",
          "tm": tm, "routed_rows": routed, "rel_l2_err": err,
          "tolerance": {"rel_l2_err": F32_REL_L2_TOL},
          "library_note": "torch._grouped_mm takes bf16 operands, not "
                          "these f32 rows"})
    src["grouped_matmul_f32_rows_e64"] = "grouped_matmul"
    del xs, wgs, got, want
    torch.cuda.empty_cache()
    return src


def zoo_train(torch, step, batch, counters, steps):
    """``steps`` optimizer steps of ``step`` on one repeated batch, the
    launch counts set to 0 just before and read just after; each counter
    (wrapper, launches a step) must count exactly that.  Returns the
    losses, step times (the first warms up), launches and peak memory."""
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {n: fn.launches for n, (fn, _) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for n, (_, per_step) in counters.items():
        check(launches[n] == per_step * steps,
              f"{n} launched {launches[n]} times in {steps} steps, not "
              f"{per_step} a step")
    return {"losses": losses, "step_s": times,
            "mean_step_s": sum(times[1:]) / (len(times) - 1),
            "max_memory_allocated": peak, "launches": launches,
            "launches_per_step": {n: c / steps
                                  for n, c in launches.items()}}


def fill_launches(table, src, path_launches):
    """Each zoo row takes the launches its wrapper counted on its path."""
    for row, count in src.items():
        if count in path_launches and table[row].get("launches") is None:
            table[row]["launches"] = path_launches[count]


def ernie_trainer(torch, dev, cfg, seed):
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.ernie import Ernie45ForCausalLM
    model = Ernie45ForCausalLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            seed))
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    return model, CompiledTrainStep(
        model, lambda m, b: m(b["input_ids"], labels=b["labels"]), opt)


def train_ernie_phase(torch, np, dev, table, src, *, moe):
    """ERNIE-4.5 training.  Dense (``train_ernie``): ``bench.py``
    ``bench_ernie``'s single-chip recipe with no cut, hidden 1536, 16
    layers, 12 / 4 heads, vocab 103,424, full recompute, amp O2 (bf16),
    AdamW(1e-4), batch 2 x 8192.  MoE (``train_ernie_moe``):
    ``ernie45_a3b_config``'s widths, the first layer dense and
    ERNIE_MOE_LAYERS MoE layers, batch 2 x 4096, full recompute.  Under
    full recompute a layer launches a step: the flash forward twice, dQ
    and dK/dV once, #10 four times (q and k, forward and recompute); a
    MoE layer also #12 twice, #11 five times and #13 three times.  Then
    one step's ``step_flops`` (the timer's MFU) and a traced step."""
    from paddle_tpu_torch.models.ernie import (Ernie45Config,
                                               ernie45_a3b_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    from paddle_tpu_torch.ops import grouped_matmul as gm
    if moe:
        cfg = dataclasses.replace(
            ernie45_a3b_config(), num_hidden_layers=1 + ERNIE_MOE_LAYERS,
            max_position_embeddings=ERNIE_MOE_SEQ, recompute=True)
        phase, seq, n_moe = "train_ernie_moe", ERNIE_MOE_SEQ, ERNIE_MOE_LAYERS
    else:
        cfg = Ernie45Config(**ERNIE_WIDTH, recompute=True)
        phase, seq, n_moe = "train_ernie", ERNIE_SEQ, 0
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model, step = ernie_trainer(torch, dev, cfg, SEED + 40 + moe)
    ids, labels = train_batch(np, cfg.vocab_size, ERNIE_BATCH, seq)
    batch = {"input_ids": torch.tensor(ids, device=dev),
             "labels": torch.tensor(labels, device=dev)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    expert_params = sum(p.numel() for n, p in model.named_parameters()
                        if ".experts." in n)
    active = n_params - expert_params + (
        expert_params * cfg.moe_k // cfg.moe_num_experts if moe else 0)
    state_bytes = torch.cuda.memory_allocated()
    counters = {
        "flash_attention_fwd": (fa.flash_attention_fwd, 2 * layers),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, layers),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, layers),
        "matmul_rope": (ft.matmul_rope_raw, 4 * layers),
        "fused_update": (ft.fused_update_flat, update_launches(params))}
    if moe:
        counters.update({
            "grouped_matmul_glu": (gm.gmm_glu_raw, 2 * n_moe),
            "grouped_matmul": (gm.gmm_raw, 5 * n_moe),
            "grouped_matmul_dw": (gm.gmm_dw_raw, 3 * n_moe)})
    res = zoo_train(torch, step, batch, counters, ZOO_STEPS)
    tokens = ERNIE_BATCH * seq
    tok_s = tokens / res["mean_step_s"]
    h = cfg.hidden_size
    sigma = cfg.initializer_range * math.sqrt(h)
    init_loss = math.log(cfg.vocab_size) + sigma ** 2 / 2 \
        + cfg.moe_aux_loss_coef * n_moe
    f6n = 6 * active
    fattn = f6n + 6 * layers * seq * h
    flops = step.step_flops(batch)
    emit({"phase": phase, "model": "ernie45 a3b width" if moe
          else "ernie45 bench_ernie recipe", "layers": layers,
          "moe_layers": n_moe, "recompute": "full", "dtype": "bfloat16",
          "batch": ERNIE_BATCH, "seq": seq, "params": n_params,
          "active_params_per_token": active, "setup_s": setup_s,
          "tokens_per_s": tok_s,
          "mfu_6n": f6n * tok_s / PEAK_BF16_FLOPS,
          "mfu_6n_attn": fattn * tok_s / PEAK_BF16_FLOPS,
          "step_flops": flops,
          "step_flops_over_6n_attn": flops / (fattn * tokens),
          "timer_mfu": flops / res["mean_step_s"] / PEAK_BF16_FLOPS,
          "ln_vocab": math.log(cfg.vocab_size),
          "expected_first_loss": init_loss, "state_bytes": state_bytes,
          **res, "peak_limit": ERNIE_MOE_PEAK if moe else 80e9})
    losses = res["losses"]
    check(abs(losses[0] - init_loss) <= 0.5,
          f"{phase}: first loss {losses[0]} not within 0.5 of {init_loss}")
    check(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    check(res["max_memory_allocated"] < (ERNIE_MOE_PEAK if moe else 80e9),
          f"{phase}: peak memory {res['max_memory_allocated']}")
    tagged = {"flash_attention_fwd": "flash_attention_fwd",
              "flash_attention_bwd_dq": "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv": "flash_attention_bwd_dkv"}
    tag = "ernie_moe" if moe else "ernie"
    fill_launches(table, {f"{k}_{tag}": v for k, v in tagged.items()},
                  res["launches"])
    for proj in ("q", "k"):     # half of #10's launches are each
        table[f"matmul_rope_{tag}_{proj}"]["launches"] = \
            res["launches"]["matmul_rope"] // 2
    if moe:
        fill_launches(table, {n: p for n, p in src.items()
                              if "_e64" in n and "f32" not in n},
                      res["launches"])
    _, prof = profiled(torch, lambda: step(batch))
    emit({"phase": f"{phase}_profile", **prof})
    check_tensor_core_route(prof, phase, FLASH_FAMILIES + ("matmul_rope",)
                            + (GROUPED_FAMILIES if moe else ()))
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_ernie_reference_phase(torch, np, dev):
    """At f32 (TF32 off), ERNIE-A3B width, 2 layers (one dense, one MoE:
    group 5, 64 experts), batch 1, seq 256: the loss and every gradient
    of ``grad_step`` (the fused chain: #10's f32 route, the flash
    kernels, #11-#13 f32) against autograd of ``plain_moe_hidden``
    (dense layer included) + a log-softmax cross-entropy + the aux loss,
    with recompute off and on.  Then interleaved rope on raw weights
    (its plain rope) against contiguous rope on the weights whose q/k
    lanes ``_deinterleave_heads`` permuted (#10): logits within 1e-5."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.convert import _deinterleave_heads
    from paddle_tpu_torch.models.ernie import (Ernie45ForCausalLM,
                                               ernie45_a3b_config)
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = dataclasses.replace(ernie45_a3b_config(), num_hidden_layers=2,
                              max_position_embeddings=1024)
    model = Ernie45ForCausalLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED + 42))
    step = CompiledTrainStep(
        model, lambda m, b: m(b["input_ids"], labels=b["labels"]),
        optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters()))
    ids, labels = train_batch(np, cfg.vocab_size, 1, 256)
    batch = {"input_ids": torch.tensor(ids, device=dev),
             "labels": torch.tensor(labels, device=dev)}
    params = step.state["params"]
    x, aux = plain_moe_hidden(torch, model, batch["input_ids"])
    logp = torch.log_softmax((x @ model.lm_head.weight).float(), dim=-1)
    lab = batch["labels"].long()
    valid = lab != -100
    tok = -logp.gather(-1, torch.where(valid, lab, 0)[..., None])[..., 0]
    want_loss = (tok * valid).sum() / valid.sum() \
        + cfg.moe_aux_loss_coef * aux
    want_grads = dict(zip(params, torch.autograd.grad(
        want_loss, list(params.values()))))
    wl = float(want_loss.detach())
    del x, aux, logp, tok, want_loss
    rep = {}
    for recompute_on in (False, True):
        model.config.recompute = recompute_on
        ft.matmul_rope_raw.launches = 0
        loss, grads = step.grad_step(batch)
        rel = {n: ((grads[n] - w).norm() / w.norm().clamp(min=1e-30)).item()
               for n, w in want_grads.items()}
        worst = max(rel, key=rel.get)
        loss_rel = abs(float(loss) - wl) / abs(wl)
        rep["recompute" if recompute_on else "no_recompute"] = {
            "loss": float(loss), "loss_rel_err": loss_rel,
            "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst": worst,
            "matmul_rope_launches": ft.matmul_rope_raw.launches}
        check(loss_rel <= 1e-5 and rel[worst] <= 1e-4,
              f"ERNIE f32, recompute {recompute_on}: loss off the plain "
              f"composition by {loss_rel}, gradient {worst} by "
              f"{rel[worst]}")
        check(ft.matmul_rope_raw.launches == 4 * (1 + recompute_on),
              f"#10 launched {ft.matmul_rope_raw.launches} times")
        del grads
    del want_grads, step
    # interleaved rope on raw weights against contiguous rope on the
    # de-interleaved ones
    hd = cfg.hidden_size // cfg.num_attention_heads
    inter = Ernie45ForCausalLM(
        dataclasses.replace(cfg, rope_interleaved=True), device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 43))
    with torch.no_grad():
        for (n, p), q in zip(inter.named_parameters(), model.parameters()):
            if n.endswith(("q_proj.weight", "k_proj.weight")):
                v = _deinterleave_heads(p.cpu().numpy(), hd, axis=1)
                q.copy_(torch.from_numpy(np.ascontiguousarray(v)))
            else:
                q.copy_(p)
        ft.matmul_rope_raw.launches = 0
        a = inter(batch["input_ids"]).float()
        inter_launches = ft.matmul_rope_raw.launches
        b = model(batch["input_ids"]).float()
    rel = ((a - b).norm() / a.norm()).item()
    rep["interleaved_vs_deinterleaved"] = {
        "logits_rel_l2_err": rel, "tolerance": 1e-5,
        "interleaved_matmul_rope_launches": inter_launches,
        "contiguous_matmul_rope_launches":
        ft.matmul_rope_raw.launches - inter_launches}
    check(rel <= 1e-5, f"interleaved rope off the de-interleaved weights "
                       f"by {rel}")
    check(inter_launches == 0 and ft.matmul_rope_raw.launches == 4,
          f"#10 launches {rep['interleaved_vs_deinterleaved']}")
    emit({"phase": "train_ernie_reference", "dtype": "float32",
          "layers": 2, "seq": 256, "group": 5, "experts": 64, **rep,
          "tolerance": {"loss_rel": 1e-5, "grad_rel_l2": 1e-4}})
    del model, inter
    gc.collect()
    torch.cuda.empty_cache()


def train_dit_phase(torch, np, dev, table, src):
    """``bench.py`` ``bench_dit``'s recipe: DiT-L/2 (32 x 32 x 4 latents,
    patch 2, hidden 1024, depth 24, 16 heads) with the DDPM objective,
    amp O2 (bf16), AdamW(1e-4), batch 16, DIT_STEPS steps on one batch
    (timesteps, noise and label drop drawn anew each step from the
    trainer's generator).  The reference's promotions keep the blocks in
    f32 (the timestep features are f32), so the attention is the f32
    3xTF32 route: a step launches the flash forward, dQ and dK/dV once a
    block.  The MSE starts at about 1 (the zero-initialised final layer
    predicts 0) and falls."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.dit import DiTConfig, DiTWithDiffusion
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = DiTConfig(**DIT_WIDTH)
    t0 = time.perf_counter()
    model = DiTWithDiffusion(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED + 50))
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    step = CompiledTrainStep(model, lambda m, b: m(b["x"], b["y"]),
                             optimizer.AdamW(learning_rate=1e-4,
                                             parameters=model.parameters()),
                             seed=SEED + 51)
    rng = np.random.default_rng(SEED + 50)
    batch = {"x": torch.tensor(rng.standard_normal(
        (DIT_BATCH, cfg.in_channels, cfg.input_size, cfg.input_size)
    ).astype(np.float32), device=dev),
        "y": torch.tensor(rng.integers(0, cfg.num_classes, DIT_BATCH),
                          dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = list(model.parameters())
    blocks = cfg.depth
    counters = {
        "flash_attention_fwd": (fa.flash_attention_fwd, blocks),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, blocks),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, blocks),
        "fused_update": (ft.fused_update_flat, update_launches(params))}
    res = zoo_train(torch, step, batch, counters, DIT_STEPS)
    flops = step.step_flops(batch)
    losses = res["losses"]
    tail = sum(losses[-3:]) / 3
    emit({"phase": "train_dit", "model": "DiT-L/2", "depth": blocks,
          "hidden": cfg.hidden_size, "heads": cfg.num_heads,
          "dtype": "bfloat16 params (blocks compute in f32)",
          "batch": DIT_BATCH, "params": sum(p.numel() for p in params),
          "setup_s": setup_s, "imgs_per_s": DIT_BATCH / res["mean_step_s"],
          "step_flops": flops,
          "timer_mfu_bf16_peak": flops / res["mean_step_s"]
          / PEAK_BF16_FLOPS, "mean_last_3": tail, **res})
    check(abs(losses[0] - 1.0) <= 0.05,
          f"train_dit: first loss {losses[0]} not about 1")
    check(tail < losses[0], f"train_dit: loss did not fall: {losses}")
    fill_launches(table, {f"{k}_dit": k for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}, res["launches"])
    _, prof = profiled(torch, lambda: step(batch))
    emit({"phase": "train_dit_profile", **prof})
    check_tensor_core_route(prof, "train_dit", FLASH_FAMILIES,
                            design="3xtf32")
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()


def vae_phase(torch, np, dev):
    """``AutoencoderKL()`` at its own widths (base 32, 8 groups; conv and
    GroupNorm, no kernel of the port but the update) on 8 x 3 x 256 x
    256 images, f32 (cuDNN with TF32 off), AdamW(1e-3): its
    ``training_loss`` (reconstruction MSE + 1e-4 KL, the latent sample's
    noise from the trainer's generator) falls over VAE_STEPS steps."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.dit import AutoencoderKL
    from paddle_tpu_torch.ops import fused_train as ft
    model = AutoencoderKL(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 60))
    step = CompiledTrainStep(model, lambda m, b: m.training_loss(b["x"]),
                             optimizer.AdamW(learning_rate=1e-3,
                                             parameters=model.parameters()),
                             seed=SEED + 61)
    rng = np.random.default_rng(SEED + 60)
    batch = {"x": torch.tensor(rng.uniform(
        -1, 1, (VAE_BATCH, 3, VAE_SIZE, VAE_SIZE)).astype(np.float32),
        device=dev)}
    params = list(model.parameters())
    counters = {"fused_update": (ft.fused_update_flat,
                                 update_launches(params))}
    res = zoo_train(torch, step, batch, counters, VAE_STEPS)
    with torch.no_grad():
        mean, logvar = model.encode(batch["x"])
        recon = model.decode(mean)
    emit({"phase": "vae", "model": "AutoencoderKL(base=32, groups=8)",
          "dtype": "float32", "shape": list(batch["x"].shape),
          "params": sum(p.numel() for p in params),
          "latent_shape": list(mean.shape),
          "imgs_per_s": VAE_BATCH / res["mean_step_s"], **res})
    check(tuple(mean.shape) == (VAE_BATCH, 4, VAE_SIZE // 2, VAE_SIZE // 2)
          and tuple(recon.shape) == tuple(batch["x"].shape)
          and bool(torch.isfinite(recon).all()),
          f"vae: latent {tuple(mean.shape)}, reconstruction "
          f"{tuple(recon.shape)}")
    check(res["losses"][-1] < res["losses"][0],
          f"vae: loss did not fall: {res['losses']}")
    del model, step, batch, mean, logvar, recon
    gc.collect()
    torch.cuda.empty_cache()


def train_bert_phase(torch, np, dev, table, src):
    """BERT-base (``BertConfig()``: 12 layers of 768, 12 heads of 64,
    hidden and attention dropout 0.1) as ``BertForMaskedLM``, amp O2
    (bf16), AdamW(1e-4), batch 16 x 512 with the last quarter of each
    row padded (attention_mask 0) and 15 % of the rest predicted.  A
    step launches #2-#4 once a layer (16-bit D 64 with the [B, 1, 1, S]
    padding bias and dropout inside the kernels) and #9's LayerNorm body
    twice a layer (the post-norm residuals) with its backward kernel once
    a call."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = BertConfig()
    t0 = time.perf_counter()
    model = BertForMaskedLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 70))
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    step = CompiledTrainStep(
        model, lambda m, b: m(b["input_ids"], attention_mask=b["mask"],
                              labels=b["labels"]),
        optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters()),
        seed=SEED + 71)
    rng = np.random.default_rng(SEED + 70)
    b, s = BERT_BATCH, BERT_SEQ
    ids = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, s - s // 4:] = 0
    ids[mask == 0] = cfg.pad_token_id
    labels = np.where((rng.random((b, s)) < 0.15) & (mask == 1), ids,
                      -100).astype(np.int32)
    batch = {k: torch.tensor(v, device=dev) for k, v in
             (("input_ids", ids), ("mask", mask), ("labels", labels))}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = list(model.parameters())
    layers = cfg.num_hidden_layers
    counters = {
        "flash_attention_fwd": (fa.flash_attention_fwd, layers),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, layers),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, layers),
        "add_layer_norm": (ft.add_layer_norm_raw, 2 * layers),
        "add_layer_norm_bwd": (ft.add_layer_norm_backward_raw, 2 * layers),
        "fused_update": (ft.fused_update_flat, update_launches(params))}
    res = zoo_train(torch, step, batch, counters, ZOO_STEPS)
    flops = step.step_flops(batch)
    n_params = sum(p.numel() for p in params)
    tokens = b * s
    tok_s = tokens / res["mean_step_s"]
    sigma = cfg.initializer_range * math.sqrt(cfg.hidden_size)
    init_loss = math.log(cfg.vocab_size) + sigma ** 2 / 2
    emit({"phase": "train_bert", "model": "bert-base MLM",
          "layers": layers, "dtype": "bfloat16", "batch": b, "seq": s,
          "padded_per_row": s // 4, "predicted": int((labels != -100).sum()),
          "params": n_params, "setup_s": setup_s, "tokens_per_s": tok_s,
          "mfu_6n": 6 * n_params * tok_s / PEAK_BF16_FLOPS,
          "step_flops": flops,
          "timer_mfu": flops / res["mean_step_s"] / PEAK_BF16_FLOPS,
          "expected_first_loss": init_loss, **res})
    losses = res["losses"]
    check(abs(losses[0] - init_loss) <= 0.5,
          f"train_bert: first loss {losses[0]} not within 0.5 of "
          f"{init_loss}")
    check(losses[-1] < losses[0], f"train_bert: loss did not fall: "
                                  f"{losses}")
    fill_launches(table, {f"{k}_bert": k for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}, res["launches"])
    table["add_layer_norm_bf16"]["launches"] = \
        res["launches"]["add_layer_norm"]
    table["add_layer_norm_bf16_bwd"]["launches"] = \
        res["launches"]["add_layer_norm_bwd"]
    _, prof = profiled(torch, lambda: step(batch))
    emit({"phase": "train_bert_profile", **prof})
    check_tensor_core_route(prof, "train_bert", FLASH_FAMILIES)
    check(prof["kernel_count_by_family"].get("add_norm_bwd"),
          "train_bert: the add+norm backward kernel was not traced")
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()


def serve_deepseek_phase(torch, np, dev, table):
    """DeepSeekMoE-16B (``deepseek_moe_16b_config()``: 28 layers, 64
    experts top-6 of 1408, shared experts 2816 wide without a gate, no
    attention biases; bf16, random weights from a seeded generator, bf16
    KV pools) through ``LLMEngine(max_seqs=8, max_len=2048,
    page_size=128)`` and its Qwen2-MoE backbone on the serving mix.
    Every forward launches #11 three times a layer and routes 6 slots a
    live row a layer (dropless).  Then a 2-layer f32 model's prefill
    logits and greedy tokens against a dense plain forward (1e-4), and
    the full-depth bf16 logits (0.2)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                                   deepseek_moe_16b_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import paged_attention as pa
    cfg = deepseek_moe_16b_config()
    t0 = time.perf_counter()
    model = Qwen2MoeForCausalLM(
        cfg, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(SEED + 80))
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    pool_bytes = 2 * eng.cache.k_pages.numel() * \
        eng.cache.k_pages.element_size()
    rng = np.random.default_rng(SEED + 80)
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).tolist()
               for rid, n in SERVE_LENS.items()}
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "grouped_matmul": gm.gmm_raw}
    stats, results = serve_run(torch, eng, prompts, counters)
    launches = stats["launches"]
    layers = cfg.num_hidden_layers
    chunks = -(-SERVE_LENS["a200"] // 128)
    forwards = stats["steps"] + chunks
    per_layer = eng._moe_counts.sum(dim=1).tolist()
    live_rows = sum(SERVE_LENS.values()) + len(SERVE_LENS) * (SERVE_NEW - 1)
    k = cfg.num_experts_per_tok
    emit({"phase": "serve_deepseek", "model": "deepseek_moe_16b",
          "layers": layers, "experts": cfg.num_experts, "top_k": k,
          "dtype": "bfloat16", "weight_bytes": weight_bytes,
          "kv_pool_bytes": pool_bytes, "setup_s": setup_s, **stats,
          "forwards": forwards,
          "grouped_matmul_launches_per_forward":
          launches["grouped_matmul"] / forwards,
          "routed_slots_per_layer": per_layer[0]})
    for rid, out in results.items():
        check(all(0 <= t < cfg.vocab_size for t in out),
              f"request {rid} returned a token outside the vocabulary")
    check(launches["grouped_matmul"] == 3 * layers * forwards,
          f"#11 launched {launches['grouped_matmul']} times in {forwards} "
          f"forwards, not {3 * layers} a forward")
    check(launches["ragged_paged_append_attend"] == layers * stats["steps"]
          and launches["flash_attention_fwd"] == layers * chunks,
          f"attention launches {launches}")
    check(all(n == k * live_rows for n in per_layer),
          f"routed slots per layer {per_layer}, not {k} x {live_rows}")
    table["grouped_matmul_f32_rows_e64"]["launches"] = \
        launches["grouped_matmul"]

    cfg32 = dataclasses.replace(cfg, num_hidden_layers=2)
    model32 = Qwen2MoeForCausalLM(
        cfg32, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 81))
    eng32 = LLMEngine(model32, max_seqs=8, max_len=2048, page_size=128,
                      device=dev)
    rep = serve_reference(
        torch, dev, prompts["b37"],
        (("f32_2_layers", model32, eng32, 1e-4),
         ("bf16_28_layers", model, eng, 0.2)),
        lambda m, ids: moe_reference_logits(torch, m, ids))
    emit({"phase": "reference_deepseek", **rep})
    del eng32, model32, eng, model
    gc.collect()
    torch.cuda.empty_cache()


def zoo_paths(torch, np, dev, table, src):
    """Each new path, each model freed before the next; the zoo's kernel
    rows (``zoo_kernels``, whose rows ``src`` names) take their launches
    from them."""
    train_ernie_phase(torch, np, dev, table, src, moe=False)
    train_ernie_phase(torch, np, dev, table, src, moe=True)
    train_ernie_reference_phase(torch, np, dev)
    train_dit_phase(torch, np, dev, table, src)
    vae_phase(torch, np, dev)
    train_bert_phase(torch, np, dev, table, src)
    serve_deepseek_phase(torch, np, dev, table)
    missing = [n for n in src if table[n].get("launches") is None]
    check(not missing, f"zoo rows no path launched: {missing}")



# -- the encoder-decoder Transformer (Transformer-base) ---------------------

# Vaswani et al. 2017, Table 3 "base": d_model 512, 8 heads of 64, 6 + 6
# layers, d_ff 2048, dropout 0.1, post-norm, relu (paddle_tpu_torch's
# Transformer defaults); a shared 37,000-token vocabulary; batches of 32
# pairs, source 128 and target 120 tokens, about a quarter of each row's
# trailing positions padded; label smoothing 0.1
TF_VOCAB, TF_PAD, TF_BOS = 37000, 0, 1
TF_BATCH, TF_SRC, TF_TGT = 32, 128, 120
TF_STEPS = 6                      # the first warms up
TF_FP16_STEPS = 8
TF_SMOOTH = 0.1
TF_DECODE_SOURCES, TF_DECODE_NEW = 8, 32
# copies of #9's mixed rows' operands, timed in turn: a call's 27.5 MB
# would stay in the H100's 50 MB L2 between calls; eight (220 MB) do not
TF_NORM_COPIES = 8
# amp O1 float16 with GradScaler: a first scale that must overflow (f16
# gradients of the logits alone pass 65504 above about 2^28), backed off
# in one step to 2^16, then grown every 2 good steps
TF_SCALER = dict(init_loss_scaling=2.0 ** 40, decr_ratio=2.0 ** -24,
                 incr_every_n_steps=2, decr_every_n_nan_or_inf=1)


def sinusoid_table(torch, n, d, dev):
    """The paper's positional encodings [n, d] f32: sin on even
    dimensions, cos on odd, wavelengths 2 pi .. 10000 x 2 pi."""
    pos = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=dev)
                    * (-math.log(10000.0) / d))
    t = torch.zeros(n, d, device=dev)
    t[:, 0::2] = torch.sin(pos * div)
    t[:, 1::2] = torch.cos(pos * div)
    return t


def seq2seq_model(torch, dev, seed, layers=6):
    """Transformer-base composed from the port's layers as a user builds
    it: a shared embedding (N(0, 512^-1/2), the pad row reads zeros)
    scaled by sqrt(512) plus sinusoidal positions and dropout 0.1, the
    ``Transformer``, and the pre-softmax projection tied to the
    embedding (``F.linear`` with its transpose)."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.initializer import Normal

    class Seq2Seq(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=dev).manual_seed(seed)
            self.d_model = 512
            self.embed = pnn.Embedding(TF_VOCAB, 512, padding_idx=TF_PAD,
                                       weight_attr=Normal(0.0, 512 ** -0.5),
                                       device=dev, generator=gen)
            self.transformer = pnn.Transformer(
                num_encoder_layers=layers, num_decoder_layers=layers,
                device=dev, generator=gen)
            self.register_buffer("pos", sinusoid_table(torch, 256, 512,
                                                       dev))
            self.p = 0.1

        def embed_at(self, ids, start=0):
            x = self.embed(ids) * math.sqrt(self.d_model) + \
                self.pos[start:start + ids.shape[1]]
            return F.dropout(x, self.p, training=self.training)

        def logits(self, h):
            return F.linear(h, self.embed.weight.t())

        def forward(self, src, tgt, src_mask, tgt_mask):
            h = self.transformer(self.embed_at(src), self.embed_at(tgt),
                                 src_mask, tgt_mask, src_mask)
            return self.logits(h)

    return Seq2Seq()


def seq2seq_masks(torch, src, tgt):
    """The additive masks a user builds: key padding ``[B, 1, 1, S]``
    (-inf on pad ids) for the encoder and the cross attention, and the
    target's ``generate_square_subsequent_mask`` plus its key padding,
    ``[B, 1, T, T]``."""
    from paddle_tpu_torch.nn.transformer import Transformer
    neg = float("-inf")
    src_mask = torch.zeros(src.shape, device=src.device).masked_fill(
        src == TF_PAD, neg)[:, None, None, :]
    tgt_pad = torch.zeros(tgt.shape, device=tgt.device).masked_fill(
        tgt == TF_PAD, neg)[:, None, None, :]
    causal = Transformer.generate_square_subsequent_mask(tgt.shape[1],
                                                         device=tgt.device)
    return src_mask, causal + tgt_pad


def seq2seq_batch(torch, np, dev, seed, batch=TF_BATCH):
    """``batch`` pairs of random ids (2 .. V-1) from ``seed``: each row's
    last 0 to half of its positions padded (a quarter on average), the
    target's input starts with BOS and its labels are the target shifted
    (-> pad = ignored)."""
    rng = np.random.default_rng(seed)

    def rows(n):
        ids = rng.integers(2, TF_VOCAB, (batch, n))
        for i, k in enumerate(rng.integers(0, n // 2 + 1, batch)):
            ids[i, n - k:] = TF_PAD
        return ids

    src, out = rows(TF_SRC), rows(TF_TGT)
    tgt = np.concatenate([np.full((batch, 1), TF_BOS), out[:, :-1]], 1)
    tgt[out == TF_PAD] = TF_PAD
    b = {k: torch.tensor(v, device=dev) for k, v in
         (("src", src), ("tgt", tgt), ("labels", out))}
    b["src_mask"], b["tgt_mask"] = seq2seq_masks(torch, b["src"], b["tgt"])
    return b


def seq2seq_loss(m, b):
    """Label-smoothed cross entropy over the target's tokens, pads
    ignored."""
    from paddle_tpu_torch.nn import functional as F
    logits = m(b["src"], b["tgt"], b["src_mask"], b["tgt_mask"])
    return F.cross_entropy(logits.reshape(-1, TF_VOCAB),
                           b["labels"].reshape(-1), ignore_index=TF_PAD,
                           label_smoothing=TF_SMOOTH)


def smoothed_init_loss(sigma2=1.0):
    """The label-smoothed loss at random weights: logits of variance
    ``sigma2`` (a LayerNorm output of unit variance against embedding
    rows of variance 1/512 over 512 dimensions) give each class
    ln V + sigma2 / 2 on average, whatever the target distribution."""
    return math.log(TF_VOCAB) + sigma2 / 2


def add_norm_mixed_rows(torch, gen, dev, table, xdt, tag):
    """#9's LayerNorm body in the mixed mode at the O1 Transformer's
    post-norm residuals: x ``xdt`` (a 16-bit block output) over an f32
    residual [32, 120, 512], f32 weight and bias, forward and backward
    (no dh: the layer drops h), each against its plain version, timed
    beside its bound (bytes: x at 2, r, h, y at 4 bytes an element; the
    backward h, dy read, dx at 2 and dr at 4 written) and the library:
    ``x.float() + r`` then ``layer_norm`` / ``native_layer_norm_backward``
    from h.  Every timing takes ``TF_NORM_COPIES`` copies of x, r and dy
    in turn, so each call reads its operands from HBM, as the path
    does."""
    from paddle_tpu_torch.ops import fused_train as ft
    shape, hdim = (TF_BATCH, TF_TGT, 512), 512
    x = torch.randn(shape, generator=gen, device=dev).to(xdt)
    r = torch.randn(shape, generator=gen, device=dev)
    w = 1 + 0.1 * torch.randn(hdim, generator=gen, device=dev)
    bb = 0.1 * torch.randn(hdim, generator=gen, device=dev)
    dy = torch.randn(shape, generator=gen, device=dev)
    sets = [(x, r, dy)] + [
        tuple(torch.randn(shape, generator=gen, device=dev).to(dt)
              for dt in (xdt, torch.float32, torch.float32))
        for _ in range(TF_NORM_COPIES - 1)]
    tol = REL_L2_TOL if xdt == torch.bfloat16 else 2.0 ** -10

    def rotating(fn):
        turn = itertools.cycle(sets)
        return lambda: fn(*next(turn))

    def fwd(x, r, dy):
        return ft.add_layer_norm_raw(x, r, w, bb, 1e-5)

    def fwd_plain(x, r, dy):
        return ft.add_layer_norm_reference(x, r, w, bb, 1e-5)

    (hh, y), (want_h, want_y) = fwd(*sets[0]), fwd_plain(*sets[0])
    torch.cuda.synchronize()
    err = rel_l2(y, want_y)
    check(hh.dtype == y.dtype == torch.float32 and torch.equal(hh, want_h)
          and err <= F32_REL_L2_TOL,
          f"mixed add_layer_norm ({xdt}) off its plain version: {err}")
    n = x.numel()
    bound, bound_by = bound_ms(n * (2 + 4 + 4 + 4) + 2 * hdim * 4, 9 * n,
                               peak=PEAK_F32_FLOPS)
    name = f"add_layer_norm_{tag}"
    table[name] = {
        "name": name, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/add_norm_mixed.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_train.py:322",
        "launches": None,
        "max_abs_err": (y - want_y).abs().max().item(),
        "ms": timed_ms(torch, rotating(fwd), 20),
        "device_ms": traced_kernel(torch, rotating(fwd),
                                   "add_norm")["device_ms"],
        "plain_ms": timed_ms(torch, rotating(fwd_plain), 5),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": timed_ms(torch, rotating(
            lambda x, r, dy: torch.nn.functional.layer_norm(
                x.float() + r, (hdim,), w, bb, 1e-5)), 20)}
    emit({"phase": "kernel", **table[name], "shape": list(shape),
          "x_dtype": str(xdt), "residual_dtype": "torch.float32",
          "rel_l2_err": err, "h_equal": True, "copies": len(sets),
          "tolerance": {"rel_l2_err": F32_REL_L2_TOL},
          "library_note": "x.float() + r, then "
                          "torch.nn.functional.layer_norm"})
    # the backward's operands: each copy's h, dy and LayerNorm statistics
    hs = [fwd(*ops)[0] for ops in sets]
    stats = [torch.ops.aten.native_layer_norm(h_, [hdim], w, bb, 1e-5)[1:]
             for h_ in hs]
    sets = [(hs[i], sets[i][2], *stats[i]) for i in range(len(sets))]

    def bwd(h, dy, *_):
        return ft.add_layer_norm_backward_raw(h, w, bb, None, dy, 1e-5,
                                              x_dtype=xdt)

    def bwd_plain(h, dy, *_):
        return ft.add_layer_norm_backward_reference(h, w, bb, None, dy,
                                                    1e-5)

    ((dn, dr), dw, db), again = bwd(*sets[0]), bwd(*sets[0])
    want_d, want_dw, want_db = bwd_plain(*sets[0])
    torch.cuda.synchronize()
    errs = {"dx": rel_l2(dn, want_d.to(xdt)), "dr": rel_l2(dr, want_d),
            "dw": rel_l2(dw, want_dw), "db": rel_l2(db, want_db)}
    check(dn.dtype == xdt and dr.dtype == torch.float32
          and errs["dx"] <= tol and max(errs["dr"], errs["dw"],
                                        errs["db"]) <= F32_REL_L2_TOL,
          f"mixed add_layer_norm backward ({xdt}): {errs}")
    check(torch.equal(dw, again[1]) and torch.equal(db, again[2]),
          f"mixed add_layer_norm backward ({xdt}): dw / db differ between "
          f"two calls")
    bound, bound_by = bound_ms(n * (4 + 4 + 2 + 4) + 3 * hdim * 4, 16 * n,
                               peak=PEAK_F32_FLOPS)
    bname = f"{name}_bwd"
    table[bname] = {
        "name": bname, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/add_norm_mixed.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_train.py:322",
        "launches": None,
        "max_abs_err": (dr - want_d).abs().max().item(),
        "ms": timed_ms(torch, rotating(bwd), 20),
        "device_ms": traced_kernel(torch, rotating(bwd),
                                   "add_norm_bwd")["device_ms"],
        "plain_ms": timed_ms(torch, rotating(bwd_plain), 5),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": timed_ms(torch, rotating(
            lambda h, dy, mean, rstd:
            torch.ops.aten.native_layer_norm_backward(
                dy, h, [hdim], mean, rstd, w, bb, [True, True, True])), 20)}
    emit({"phase": "kernel", **table[bname], "shape": list(shape),
          "x_dtype": str(xdt), "rel_l2_err": errs, "copies": len(sets),
          "tolerance": {"dx": tol, "dr_dw_db": F32_REL_L2_TOL},
          "dw_db_bitwise_repeat": True,
          "library_note": "torch.ops.aten.native_layer_norm_backward from "
                          "h and its statistics (one f32 dx, dw, db)"})
    del x, r, hh, y, want_h, want_y, dn, dr, again, sets, hs, stats
    torch.cuda.empty_cache()


def transformer_kernels(torch, gen, dev, table):
    """#2-#4 and #9 at the O1 Transformer's shapes, each against its
    plain version: self attention bf16 [32, 120, 8, 64] under the -inf
    causal-plus-padding mask [32, 1, 120, 120] with dropout 0.1; cross
    attention q [32, 120, 8, 64] over k/v [32, 128, 8, 64] under the key
    padding [32, 1, 1, 128]; #2 at one-token decoding (Sq 1; Sk 1 and
    33, 8 sources); #2-#4's f16 routes at the self-attention shape;
    #9's mixed mode (bf16 and f16 x over an f32 residual).  The bounds
    count the pairs the masks leave finite (the kernels compute the
    masked ones too).  Returns {row: wrapper name} for the paths'
    launches."""
    src = {}
    b, h, d = TF_BATCH, 8, 64

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    ids = torch.zeros(b, TF_SRC, dtype=torch.long, device=dev)
    tgt = torch.zeros(b, TF_TGT, dtype=torch.long, device=dev)
    for i in range(b):
        pad = int(torch.randint(0, TF_SRC // 2 + 1, (1,), generator=gen,
                                device=dev))
        ids[i, :TF_SRC - pad] = 2
        pad = int(torch.randint(0, TF_TGT // 2 + 1, (1,), generator=gen,
                                device=dev))
        tgt[i, :TF_TGT - pad] = 2
    src_mask, tgt_mask = seq2seq_masks(torch, ids, tgt)
    for tag, dt, sk, mask, p in (
            ("tf_self", torch.bfloat16, TF_TGT, tgt_mask, 0.1),
            ("tf_cross", torch.bfloat16, TF_SRC, src_mask, 0.1),
            ("tf_self_f16", torch.float16, TF_TGT, tgt_mask, 0.1)):
        q, do = rnd(b, TF_TGT, h, d, dtype=dt), rnd(b, TF_TGT, h, d, dtype=dt)
        k, v = rnd(b, sk, h, d, dtype=dt), rnd(b, sk, h, d, dtype=dt)
        m = mask.expand(b, 1, TF_TGT, sk)
        seed = torch.tensor(SEED + 80, dtype=torch.int64, device=dev)
        zoo_flash_rows(torch, table, tag, q, k, v, do, causal=False,
                       mask=mask, dropout_p=p, seed=seed, launches_from=src,
                       pairs=int(m.isfinite().sum().item()))
        del q, k, v, do, m
    n = TF_DECODE_SOURCES
    for tag, sk in (("tf_decode1", 1), ("tf_decode33", 33)):
        q, do = rnd(n, 1, h, d), rnd(n, 1, h, d)
        k, v = rnd(n, sk, h, d), rnd(n, sk, h, d)
        zoo_flash_rows(torch, table, tag, q, k, v, do, causal=False,
                       launches_from=src, backward=False)
    for xdt, tag in ((torch.bfloat16, "tf_bf16_over_f32"),
                     (torch.float16, "tf_f16_over_f32")):
        add_norm_mixed_rows(torch, gen, dev, table, xdt, tag)
        src[f"add_layer_norm_{tag}"] = "add_layer_norm"
        src[f"add_layer_norm_{tag}_bwd"] = "add_layer_norm_bwd"
    return src


def tf_counters(layers, params):
    """Launches a step of the Transformer's kernels: #2-#4 once an
    attention (an encoder layer has one, a decoder layer two), #9's
    LayerNorm body and its backward twice an encoder layer and three
    times a decoder layer, #8 as ``update_launches`` (``params`` None:
    no fused update)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    attn = 3 * layers
    counters = {
        "flash_attention_fwd": (fa.flash_attention_fwd, attn),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, attn),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, attn),
        "add_layer_norm": (ft.add_layer_norm_raw, 5 * layers),
        "add_layer_norm_bwd": (ft.add_layer_norm_backward_raw, 5 * layers)}
    if params is not None:
        counters["fused_update"] = (ft.fused_update_flat,
                                    update_launches(params))
    return counters


def kernel_names(torch, fn):
    """The CUDA kernels one call of ``fn`` launches, by full name (a
    trace that came back empty taken again, up to TRACE_RETRIES
    times)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(TRACE_RETRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            return names
    return names


def profiled_step(torch, fn, phase):
    """``profiled`` of one ``fn()``, taken again where the trace came back
    empty (up to TRACE_RETRIES times)."""
    for _ in range(TRACE_RETRIES + 1):
        _, prof = profiled(torch, fn)
        if prof["device_busy_ms"]:
            return prof
        emit({"phase": "trace_retry", "family": phase})
    return prof


def train_transformer_phase(torch, np, dev, table, src):
    """Transformer-base (6 + 6 layers, full width) trained as users of
    the reference train it: amp O1 bf16 (``auto_cast`` around the loss;
    f32 parameters), label-smoothed cross entropy with the pads ignored,
    AdamW (beta 0.9 / 0.98, eps 1e-9) under ``NoamDecay(512, 4000)``
    entered at its peak (step 4000, lr 6.99e-4: the warm-up's first
    steps move nothing measurable in a few steps) through
    ``CompiledTrainStep`` (``fused_step=True``: #8), batch 32 x (128 +
    120) tokens.  Every step launches #2-#4 18 times (bf16, the masks'
    -inf and dropout in the kernels) and #9 and its backward 30 times
    each in the mixed mode.  Returns the trained model."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.observability.metrics import MetricRegistry
    from paddle_tpu_torch.observability.steptimer import StepTimer
    t0 = time.perf_counter()
    model = seq2seq_model(torch, dev, SEED + 90)
    model = amp.decorate(model, level="O1", dtype="bfloat16")

    def loss_fn(m, b):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return seq2seq_loss(m, b)

    sched = optimizer.lr.NoamDecay(512, 4000, last_epoch=3999)
    opt = optimizer.AdamW(learning_rate=sched, beta1=0.9, beta2=0.98,
                          epsilon=1e-9, parameters=model.parameters())
    step = CompiledTrainStep(model, loss_fn, opt, seed=SEED + 91)
    batch = seq2seq_batch(torch, np, dev, SEED + 90)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = list(model.parameters())
    check(all(p.dtype == torch.float32 for p in params),
          "amp O1 left a parameter outside f32")
    counters = tf_counters(6, params)
    tokens = int((batch["labels"] != TF_PAD).sum())
    flops = None
    res = zoo_train(torch, step, batch, counters, TF_STEPS)
    flops = step.step_flops(batch)
    timer = StepTimer(registry=MetricRegistry(), prefix="train_transformer",
                      tokens_per_step=tokens, flops_per_step=flops)
    step.attach_timer(timer)
    for _ in range(2):
        step(batch)
    step.attach_timer(None)
    n_params = sum(p.numel() for p in params)
    tok_s = tokens / res["mean_step_s"]
    init_loss = smoothed_init_loss()
    emit({"phase": "train_transformer", "model": "transformer-base",
          "layers": [6, 6], "d_model": 512, "heads": 8, "ffn": 2048,
          "vocab": TF_VOCAB, "amp": "O1 bfloat16", "batch": TF_BATCH,
          "src": TF_SRC, "tgt": TF_TGT, "target_tokens": tokens,
          "source_tokens": int((batch["src"] != TF_PAD).sum()),
          "params": n_params, "setup_s": setup_s,
          "target_tokens_per_s": tok_s,
          "mfu_6n": 6 * n_params * tok_s / PEAK_BF16_FLOPS,
          "step_flops": flops,
          "timer_mfu": flops / res["mean_step_s"] / PEAK_BF16_FLOPS,
          "step_timer": timer.summary(), "lr": sched(),
          "expected_first_loss": init_loss, **res})
    losses = res["losses"]
    check(abs(losses[0] - init_loss) <= 0.5,
          f"train_transformer: first loss {losses[0]} not within 0.5 of "
          f"{init_loss}")
    check(losses[-1] < losses[0], f"train_transformer: loss did not fall: "
                                  f"{losses}")
    for row in ("tf_self", "tf_cross"):
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
            table[f"{k}_{row}"]["launches"] = res["launches"][k]
    for k in ("add_layer_norm", "add_layer_norm_bwd"):
        table[k.replace("add_layer_norm", "add_layer_norm_tf_bf16_over_f32",
                        1)]["launches"] = res["launches"][k]
    prof = profiled_step(torch, lambda: step(batch), "train_transformer")
    emit({"phase": "train_transformer_profile", **prof})
    check_tensor_core_route(prof, "train_transformer", FLASH_FAMILIES)
    check(prof["kernel_count_by_family"].get("add_norm_bwd"),
          "train_transformer: the add+norm backward kernel was not traced")
    names = kernel_names(torch, lambda: step(batch))
    check(any("add_norm_fwd<__nv_bfloat16, float" in n for n in names),
          "train_transformer: #9 did not run in its mixed mode: "
          f"{[n for n in names if 'add_norm' in n]}")
    del step, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return model


def reference_scaler(kw, found_inf):
    """The reference ``GradScaler``'s decisions (paddle_tpu/amp/
    grad_scaler.py ``update``) for a sequence of found-inf flags: the
    state after each step."""
    scale, good, bad, out = kw["init_loss_scaling"], 0, 0, []
    for inf in found_inf:
        if inf:
            bad, good = bad + 1, 0
            if bad >= kw["decr_every_n_nan_or_inf"]:
                scale, bad = max(scale * kw["decr_ratio"], 1.0), 0
        else:
            good, bad = good + 1, 0
            if good >= kw["incr_every_n_steps"]:
                scale, good = scale * 2.0, 0
        out.append((scale, good, bad))
    return out


def train_transformer_fp16_phase(torch, np, dev, table):
    """The same model under amp O1 float16 on the eager API (``AdamW``'s
    ``step``, ``clear_grad``) with ``GradScaler``: TF_FP16_STEPS steps
    from a scale that overflows.  Each skipped step leaves every
    parameter bit-equal; the scale, good and bad counts equal the
    reference's rule on the same found-inf sequence; #2-#4 and #9 run
    in their f16 modes (traced names), launched exactly as in bf16."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.ops.random import rng_guard
    model = seq2seq_model(torch, dev, SEED + 92)
    opt = optimizer.AdamW(learning_rate=5e-4, beta1=0.9, beta2=0.98,
                          epsilon=1e-9, parameters=model.parameters())
    scaler = amp.GradScaler(**TF_SCALER)
    batch = seq2seq_batch(torch, np, dev, SEED + 92)
    counters = tf_counters(6, None)
    gen = torch.Generator(device=dev).manual_seed(SEED + 93)

    def one_step():
        with rng_guard(gen), amp.auto_cast(level="O1", dtype="float16"):
            loss = seq2seq_loss(model, batch)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss

    for fn, _ in counters.values():
        fn.launches = 0
    losses, states, skipped, times = [], [], [], []
    for _ in range(TF_FP16_STEPS):
        before = [p.detach().clone() for p in model.parameters()]
        t = time.perf_counter()
        losses.append(float(one_step().detach()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        skipped.append(all(torch.equal(a, p) for a, p in
                           zip(before, model.parameters())))
        s = scaler.state_dict()
        states.append((s["scale"], s["good_steps"], s["bad_steps"]))
        del before
    launches = {n: fn.launches for n, (fn, _) in counters.items()}
    want = reference_scaler(TF_SCALER, skipped)
    emit({"phase": "train_transformer_fp16", "amp": "O1 float16",
          "scaler": TF_SCALER, "losses": losses, "step_s": times,
          "skipped": skipped, "scaler_states": states,
          "reference_states": want, "launches": launches})
    check(all(math.isfinite(x) for x in losses), f"fp16 losses {losses}")
    check(skipped[0] and not all(skipped),
          f"fp16: the first step must overflow and a later one apply: "
          f"{skipped}")
    check(states == want, f"fp16 scaler states {states}, the reference's "
                          f"rule {want}")
    for n, (_, per_step) in counters.items():
        check(launches[n] == per_step * TF_FP16_STEPS,
              f"fp16: {n} launched {launches[n]} times in "
              f"{TF_FP16_STEPS} steps, not {per_step} a step")
    applied = [x for x, s in zip(losses, skipped) if not s]
    check(len(applied) < 2 or applied[-1] < losses[0],
          f"fp16: the loss did not fall over the applied steps: {losses}")
    names = kernel_names(torch, one_step)
    for fam, key in (("flash_fwd_wgmma", "flash_fwd_wgmma<__half"),
                     ("flash_bwd_dq_wgmma", "flash_bwd_dq_wgmma<__half"),
                     ("flash_bwd_dkv_wgmma", "flash_bwd_dkv_wgmma<__half"),
                     ("add_norm_fwd", "add_norm_fwd<__half, float"),
                     ("add_norm_bwd", "add_norm_bwd<__half, float")):
        check(any(key in n for n in names),
              f"fp16: no {fam} in its f16 mode: "
              f"{sorted(n[:60] for n in names if fam in n)}")
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        table[f"{k}_tf_self_f16"]["launches"] = launches[k]
    for k in ("add_layer_norm", "add_layer_norm_bwd"):
        table[k.replace("add_layer_norm", "add_layer_norm_tf_f16_over_f32",
                        1)]["launches"] = launches[k]
    del model, opt, batch
    gc.collect()
    torch.cuda.empty_cache()


def plain_seq2seq_loss(torch, model, b):
    """The Transformer's loss as a composition of plain versions from the
    model's weights: dense attention (``scaled_dot_product_attention_ref``),
    ``x @ W + b``, plain LayerNorm after each residual add, and the
    label-smoothed cross entropy written out over f32 log-softmax."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import _nn
    t = model.transformer

    def lin(x, layer):
        return x @ layer.weight + layer.bias

    def ln(x, norm):
        return _nn.layer_norm(x, [512], norm.weight, norm.bias, 1e-5)

    def mha(att, x, kv, mask):
        bsz = x.shape[0]
        q, k, v = (lin(a, p).reshape(bsz, a.shape[1], 8, 64) for a, p in
                   ((x, att.q_proj), (kv, att.k_proj), (kv, att.v_proj)))
        o = F.scaled_dot_product_attention_ref(q, k, v, attn_mask=mask,
                                               training=False)
        return lin(o.reshape(bsz, x.shape[1], 512), att.out_proj)

    def ffn(layer, x):
        return lin(torch.relu(lin(x, layer.linear1)), layer.linear2)

    emb = model.embed.weight
    scale = math.sqrt(512)

    def embed(ids):
        e = emb[ids] * (ids != TF_PAD)[..., None]
        return e * scale + model.pos[:ids.shape[1]]

    x = embed(b["src"])
    for layer in t.encoder.layers:
        x = ln(x + mha(layer.self_attn, x, x, b["src_mask"]), layer.norm1)
        x = ln(x + ffn(layer, x), layer.norm2)
    y = embed(b["tgt"])
    for layer in t.decoder.layers:
        y = ln(y + mha(layer.self_attn, y, y, b["tgt_mask"]), layer.norm1)
        y = ln(y + mha(layer.cross_attn, y, x, b["src_mask"]), layer.norm2)
        y = ln(y + ffn(layer, y), layer.norm3)
    logp = torch.log_softmax((y @ emb.t()).reshape(-1, TF_VOCAB).float(), -1)
    lab = b["labels"].reshape(-1)
    keep = lab != TF_PAD
    onehot = torch.zeros_like(logp).scatter_(1, lab[:, None].clamp(min=0),
                                             1.0)
    target = onehot * (1 - TF_SMOOTH) + TF_SMOOTH / TF_VOCAB
    per_tok = -(target * logp).sum(-1) * keep
    return per_tok.sum() / keep.sum()


def transformer_reference_phase(torch, np, dev):
    """At f32 (full matmul precision), base width, 2 + 2 layers, batch 8:
    the loss and every gradient of the kernel chain (the flash kernels'
    f32 route under the -inf masks, #9 in f32) against
    ``plain_seq2seq_loss``, dropout off (eval mode; autograd as in
    training): within 1e-5 and 1e-4."""
    model = seq2seq_model(torch, dev, SEED + 94, layers=2).eval()
    batch = seq2seq_batch(torch, np, dev, SEED + 94, batch=8)
    params = dict(model.named_parameters())
    counters = tf_counters(2, None)
    for fn, _ in counters.values():
        fn.launches = 0
    loss = seq2seq_loss(model, batch)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    launches = {n: fn.launches for n, (fn, _) in counters.items()}
    want_loss = plain_seq2seq_loss(torch, model, batch)
    want = dict(zip(params, torch.autograd.grad(want_loss,
                                                list(params.values()))))
    # the key projections' biases: zero gradient in exact arithmetic (a
    # shift shared by every key leaves the softmax as it is), so both
    # sides hold rounding noise, each below 1e-4 of the largest gradient
    scale = max(w.norm().item() for w in want.values())
    kbias = {n: max(grads[n].norm().item(), want[n].norm().item()) / scale
             for n in want if n.endswith("k_proj.bias")}
    rel = {n: ((grads[n] - w).norm() / w.norm()).item()
           for n, w in want.items() if n not in kbias}
    worst = max(rel, key=rel.get)
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    emit({"phase": "transformer_reference", "dtype": "float32",
          "layers": [2, 2], "batch": 8, "loss": float(loss),
          "loss_rel_err": loss_rel, "grad_rel_l2_max": rel[worst],
          "grad_rel_l2_worst": worst,
          "k_proj_bias_grad_over_largest_max": max(kbias.values()),
          "launches": launches,
          "tolerance": {"loss_rel": 1e-5, "grad_rel_l2": 1e-4,
                        "k_proj_bias_over_largest": 1e-4}})
    check(max(kbias.values()) <= 1e-4, f"transformer k_proj bias "
                                       f"gradients {kbias}")
    check(loss_rel <= 1e-5, f"transformer loss off the plain composition "
                            f"by {loss_rel}")
    check(rel[worst] <= 1e-4, f"transformer gradient {worst} off the plain "
                              f"composition by {rel[worst]}")
    for n, (_, per_step) in counters.items():
        check(launches[n] == per_step, f"transformer_reference: {n} "
                                       f"launched {launches[n]} times")
    del model, grads, want
    gc.collect()
    torch.cuda.empty_cache()


def greedy_decode(torch, model, src, src_mask, n_new, cached):
    """Greedy decoding of ``n_new`` tokens from BOS: with ``cached``, a
    token at a time through ``decoder.gen_cache(memory)`` (a ``Cache``
    for the self attention, a ``StaticCache`` for the cross attention);
    else the whole prefix through the decoder again each step under the
    subsequent mask.  Returns the tokens [B, n_new]."""
    from paddle_tpu_torch.nn.transformer import Transformer
    t = model.transformer
    memory = t.encoder(model.embed_at(src), src_mask)
    ys = torch.full((src.shape[0], 1), TF_BOS, dtype=torch.long,
                    device=src.device)
    cache = t.decoder.gen_cache(memory) if cached else None
    for i in range(n_new):
        if cached:
            h, cache = t.decoder(model.embed_at(ys[:, -1:], start=i), memory,
                                 None, src_mask, cache)
        else:
            mask = Transformer.generate_square_subsequent_mask(
                ys.shape[1], device=src.device)
            h = t.decoder(model.embed_at(ys), memory, mask, src_mask)
        nxt = model.logits(h[:, -1]).float().argmax(-1)
        ys = torch.cat([ys, nxt[:, None]], 1)
    return ys[:, 1:]


def translate_phase(torch, np, dev, table, src, model):
    """Greedy translation of TF_DECODE_SOURCES sources (padded, with the
    memory mask) by the trained model in eval mode, TF_DECODE_NEW tokens:
    in f32 the cached decode's tokens must equal the full recompute's;
    decode tokens/s for f32 and for amp O1 bf16 (#2 at Sq 1 in bf16,
    #9 mixed), whose launches fill the decode rows."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    model.eval()
    b = seq2seq_batch(torch, np, dev, SEED + 95, batch=TF_DECODE_SOURCES)
    s, sm = b["src"], b["src_mask"]
    out = {}
    with torch.no_grad():
        for tag, ctx in (("f32", contextlib.nullcontext),
                         ("o1_bf16", lambda: amp.auto_cast(
                             level="O1", dtype="bfloat16"))):
            with ctx():
                greedy_decode(torch, model, s, sm, 2, True)      # warm-up
                fa.flash_attention_fwd.launches = 0
                ft.add_layer_norm_raw.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = greedy_decode(torch, model, s, sm, TF_DECODE_NEW,
                                     True)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            out[tag] = {"tokens": toks, "seconds": dt,
                        "tokens_per_s": toks.numel() / dt,
                        "flash_fwd_launches": fa.flash_attention_fwd.launches,
                        "add_norm_launches": ft.add_layer_norm_raw.launches}
        full = greedy_decode(torch, model, s, sm, TF_DECODE_NEW, False)
    layers = 6
    want_fwd = layers + layers * 2 * TF_DECODE_NEW
    agree = float((out["o1_bf16"]["tokens"] == out["f32"]["tokens"])
                  .float().mean())
    emit({"phase": "translate", "sources": TF_DECODE_SOURCES,
          "new_tokens": TF_DECODE_NEW,
          **{f"{k}_{m}": v[m] for k, v in out.items()
             for m in ("seconds", "tokens_per_s", "flash_fwd_launches",
                       "add_norm_launches")},
          "f32_equal_full_recompute": bool(torch.equal(out["f32"]["tokens"],
                                                       full)),
          "o1_bf16_token_agreement_with_f32": agree})
    check(torch.equal(out["f32"]["tokens"], full),
          "translate: the cached f32 decode's tokens differ from the full "
          "recompute's")
    for tag in out:
        check(out[tag]["flash_fwd_launches"] == want_fwd,
              f"translate {tag}: #2 launched "
              f"{out[tag]['flash_fwd_launches']} times, not {want_fwd}")
    for row in ("tf_decode1", "tf_decode33"):
        table[f"flash_attention_fwd_{row}"]["launches"] = \
            out["o1_bf16"]["flash_fwd_launches"]
    model.train()


def transformer_paths(torch, np, dev, table, src):
    """The encoder-decoder Transformer's paths, after the zoo: its
    training under O1 bf16 and f16, the f32 check of its chain, and
    translation; the new kernel rows (``src``) take their launches from
    them."""
    model = train_transformer_phase(torch, np, dev, table, src)
    translate_phase(torch, np, dev, table, src, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train_transformer_fp16_phase(torch, np, dev, table)
    transformer_reference_phase(torch, np, dev)
    missing = [n for n in src if table[n].get("launches") is None]
    check(not missing, f"transformer rows no path launched: {missing}")


# -- the high-level trainer: hapi.Model.fit over the io loaders ------------

FIT_BATCHES, FIT_EPOCHS, FIT_CLASSES = 8, 2, 4
FIT_EVAL_BATCHES = 2
# fit_resume: batches an epoch, checkpoint every RESUME_SAVE_STEPS steps,
# interrupted after RESUME_STOP, at full width and RESUME_LAYERS deep
RESUME_BATCHES, RESUME_SAVE_STEPS, RESUME_STOP, RESUME_LAYERS = 6, 2, 3, 12
# fit_gpt2_tokens: the token file, its sub-vocabulary (so that a few
# steps lower the loss) and the steps fit takes
TOKEN_SEQS, TOKEN_SUBVOCAB, TOKEN_FIT_STEPS = 512, 4096, 8
WORKER_TIMEOUT_S = 120          # a hung worker fails the phase


def fit_counters(ft, fa):
    """The kernels of a BERT step and their wrappers."""
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "add_layer_norm": ft.add_layer_norm_raw,
            "add_layer_norm_bwd": ft.add_layer_norm_backward_raw,
            "fused_update": ft.fused_update_flat}


def bert_classifier(torch, dev, cfg, seed):
    """``BertForSequenceClassification`` behind a forward of ``(ids,
    attention_mask)`` (its third positional argument is position_ids),
    cast to bf16 as amp O2 does."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertForSequenceClassification

    class BertCls(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cls = BertForSequenceClassification(
                cfg, num_classes=FIT_CLASSES, device=dev,
                generator=torch.Generator(device=dev).manual_seed(seed))

        def forward(self, ids, mask):
            return self.cls(ids, attention_mask=mask)

    return amp.decorate(BertCls(), level="O2", dtype="bfloat16")


def classifier_rows(np, cfg, n, seed):
    """[n, 512] ids with the last quarter of each row padded (id and mask
    0) and labels made from the ids."""
    rng = np.random.default_rng(seed)
    s = BERT_SEQ
    ids = rng.integers(1, cfg.vocab_size, (n, s)).astype(np.int32)
    mask = np.ones((n, s), np.int32)
    mask[:, s - s // 4:] = 0
    ids[mask == 0] = cfg.pad_token_id
    labels = (ids[:, 0] % FIT_CLASSES).astype(np.int64)
    return ids, mask, labels


def step_log(counters, stop_after=None):
    """A hapi callback recording each step's logs, its launches of the
    ``counters`` kernels (from the step's begin to its end), its host
    times and each epoch's wait for its first batch; it stops ``fit``
    after ``stop_after`` steps."""
    import numpy as np

    from paddle_tpu_torch.hapi import Callback

    class StepLog(Callback):
        def __init__(self):
            super().__init__()
            self.logs, self.launches = [], []
            self.step_s, self.interval_s, self.epoch_of = [], [], []
            self.first_batch_wait_s = []
            self._last_end = None

        def on_epoch_begin(self, epoch, logs=None):
            self._epoch = epoch
            self._last_end = None
            self._epoch_t0 = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            self._before = {n: f.launches for n, f in counters.items()}
            self._t0 = time.perf_counter()
            if step == 0:           # the loader's start (its workers)
                self.first_batch_wait_s.append(self._t0 - self._epoch_t0)

        def on_train_batch_end(self, step, logs=None):
            t = time.perf_counter()
            self.step_s.append(t - self._t0)
            self.interval_s.append(None if self._last_end is None
                                   else t - self._last_end)
            self._last_end = t
            self.epoch_of.append(self._epoch)
            self.launches.append({n: f.launches - self._before[n]
                                  for n, f in counters.items()})
            self.logs.append({k: float(np.asarray(v).ravel()[0])
                              for k, v in (logs or {}).items()})
            if stop_after is not None and len(self.logs) >= stop_after:
                self.model.stop_training = True

    return StepLog()


def mean_after_first(vals, epochs):
    """The mean of per-step values, each epoch's first step left out (it
    starts the workers, and the first one also prices the step)."""
    keep = [v for i, v in enumerate(vals) if v is not None and i > 0
            and epochs[i] == epochs[i - 1]]
    return sum(keep) / len(keep) if keep else None


def check_step_launches(log, per_step, extra_first, name):
    """Every step launched ``per_step``; the first one also the kernels of
    ``step_flops``' forward and backward (``extra_first``)."""
    for i, got in enumerate(log.launches):
        want = {n: c + (extra_first.get(n, 0) if i == 0 else 0)
                for n, c in per_step.items()}
        check(got == want, f"{name}: step {i} launched {got}, not {want}")


def numpy_topk_hits(np, logits, labels, ks):
    """Top-k accuracy of f32 logits by numpy (a stable sort)."""
    order = np.argsort(-logits, axis=-1, kind="stable")
    return [float((order[:, :k] == labels[:, None]).any(-1).mean())
            for k in ks]


def fit_bert_phase(torch, np, dev, table):
    """BERT-base (``BertConfig()``: 12 x 768, 12 heads of 64, dropout 0.1)
    as a 4-way classifier, amp O2 bf16, through ``hapi.Model``: ``fit``
    for FIT_EPOCHS epochs over a shuffled ``DataLoader`` (two worker
    processes) of FIT_BATCHES batches of 16 x 512 (a quarter of each row
    padded), an eval each epoch, ``LRScheduler`` and ``VisualDL``
    callbacks; then ``evaluate``, ``predict``, ``save`` and ``load``.
    Its losses must equal, bit for bit, a direct ``CompiledTrainStep``
    loop (seed 0, as ``Model`` builds it) over the same batches in the
    same order from a copy of the same weights; its launches a step equal
    #2-#4 12 each, #9 24 + 24 and #8 ``update_launches``; its train
    accuracies numpy's over that loop's logits."""
    import copy
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.hapi import LRScheduler, Model, VisualDL
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = BertConfig()
    layers = cfg.num_hidden_layers
    b, n = BERT_BATCH, FIT_BATCHES * BERT_BATCH
    t0 = time.perf_counter()
    net = bert_classifier(torch, dev, cfg, SEED + 90)
    direct_net = copy.deepcopy(net)
    ids, mask, labels = classifier_rows(np, cfg, n, SEED + 90)
    eids, emask, elabels = classifier_rows(
        np, cfg, FIT_EVAL_BATCHES * b, SEED + 91)
    train_ds = TensorDataset([ids, mask, labels])
    eval_ds = TensorDataset([eids, emask, elabels])
    loss_fn = CrossEntropyLoss()
    model = Model(net)
    model.prepare(optimizer.AdamW(1e-4, parameters=net.parameters()),
                  loss_fn, Accuracy(topk=(1, 2)))
    counters = fit_counters(ft, fa)
    params = list(net.parameters())
    per_step = {"flash_attention_fwd": layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers,
                "add_layer_norm": 2 * layers,
                "add_layer_norm_bwd": 2 * layers,
                "fused_update": update_launches(params)}
    extra = {n: c for n, c in per_step.items() if n != "fused_update"}
    log = step_log(counters)
    root = tempfile.mkdtemp(prefix="fit_bert_")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    try:
        loader = DataLoader(train_ds, batch_size=b, shuffle=True,
                            num_workers=2, timeout=WORKER_TIMEOUT_S)
        vdl = VisualDL(os.path.join(root, "vdl"))
        # its writer imports TensorBoard where one is installed, which can
        # draw from the global numpy stream: opened before the seed
        vdl._w()
        np.random.seed(SEED + 92)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        model.fit(loader, eval_data=eval_ds, batch_size=b,
                  epochs=FIT_EPOCHS, verbose=0, num_workers=2,
                  callbacks=[log, LRScheduler(), vdl])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {n: f.launches for n, f in counters.items()}
        with open(os.path.join(root, "vdl", "scalars.jsonl")) as fh:
            scalars = [json.loads(line) for line in fh]
        mfu = [s["value"] for s in scalars if s["tag"] == "train/mfu"]
        t0 = time.perf_counter()
        ev = model.evaluate(eval_ds, batch_size=b, verbose=0)
        evaluate_s = time.perf_counter() - t0
        pred = model.predict(eval_ds, batch_size=b, stack_outputs=True)[0]
        net.eval()
        with torch.no_grad():
            plain_pred = torch.cat([
                net(torch.from_numpy(eids[i:i + b]).to(dev),
                    torch.from_numpy(emask[i:i + b]).to(dev))
                for i in range(0, len(eids), b)]).float().cpu().numpy()
        net.train()
        path = os.path.join(root, "ckpt", "bert")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        file_bytes = sum(os.path.getsize(path + ext)
                         for ext in (".pdparams", ".pdopt"))
        fresh = Model(bert_classifier(torch, dev, cfg, SEED + 93))
        fresh.prepare(optimizer.AdamW(1e-4), loss_fn, Accuracy(topk=(1, 2)))
        t0 = time.perf_counter()
        fresh.load(path)
        load_s = time.perf_counter() - t0
        fresh_pred = fresh.predict(eval_ds, batch_size=b,
                                   stack_outputs=True)[0]
        fresh._ensure_train_step()
        opt_equal = all(
            bytes_equal(torch, fresh._train_step.state["opt"]["slots"][p][k],
                        v)
            for p, s in model._train_step.state["opt"]["slots"].items()
            for k, v in s.items())
        del fresh
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the direct loop: the same batches in the same order (the loader's
    # permutations of the global numpy stream from the same seed), a
    # CompiledTrainStep as Model builds it
    def direct_loss(m, bt):
        out = m(*bt["inputs"])
        return loss_fn(out, *bt["labels"]), (out,)

    step = CompiledTrainStep(
        direct_net, direct_loss,
        optimizer.AdamW(1e-4, parameters=direct_net.parameters()),
        has_aux=True)
    np.random.seed(SEED + 92)
    orders = [np.random.permutation(n) for _ in range(FIT_EPOCHS)]
    direct, direct_acc, direct_s = [], [], []
    for order in orders:
        for i in range(FIT_BATCHES):
            idx = order[i * b:(i + 1) * b]
            cpu = [t[torch.from_numpy(idx)] for t in train_ds.tensors]
            # timed as fit's step is: the copies to the card, the step,
            # the loss read on the host
            t = time.perf_counter()
            ins = tuple(x.to(dev) for x in cpu)
            loss, (logits,) = step({"inputs": ins[:2], "labels": ins[2:]})
            direct.append(float(loss))
            direct_s.append(time.perf_counter() - t)
            direct_acc.append(numpy_topk_hits(
                np, logits.float().cpu().numpy(), labels[idx], (1, 2)))
    fit_losses = [l["loss"] for l in log.logs]
    fit_acc = [[l["acc_top1"], l["acc_top2"]] for l in log.logs]

    # host copies and waits a step: one more epoch of 3 batches through
    # fit (in-process loader), against the direct loop's 3 steps
    small = TensorDataset([ids[:3 * b], mask[:3 * b], labels[:3 * b]])
    _, fit_syncs = host_syncs(torch, lambda: model.fit(
        small, batch_size=b, epochs=1, shuffle=False, verbose=0))
    _, direct_syncs = host_syncs(torch, lambda: [float(step({
        "inputs": tuple(small.tensors[k][i * b:(i + 1) * b].to(dev)
                        for k in (0, 1)),
        "labels": (small.tensors[2][i * b:(i + 1) * b].to(dev),)})[0])
        for i in range(3)])
    fit_step_s = mean_after_first(log.step_s, log.epoch_of)
    fit_interval_s = mean_after_first(log.interval_s, log.epoch_of)
    direct_step_s = sum(direct_s[1:]) / (len(direct_s) - 1)
    emit({"phase": "fit_bert", "model": "bert-base classifier",
          "layers": layers, "dtype": "bfloat16 (amp O2)", "batch": b,
          "seq": BERT_SEQ, "padded_per_row": BERT_SEQ // 4,
          "steps": len(fit_losses), "epochs": FIT_EPOCHS,
          "loader": "DataLoader(shuffle=True, num_workers=2)",
          "setup_s": setup_s, "fit_s": fit_s, "losses": fit_losses,
          "direct_losses": direct, "losses_bit_equal": fit_losses == direct,
          "ln_classes": math.log(FIT_CLASSES), "train_acc": fit_acc,
          "numpy_acc": direct_acc, "eval": ev, "evaluate_s": evaluate_s,
          "fit_step_s": fit_step_s, "fit_interval_s": fit_interval_s,
          "direct_step_s": direct_step_s,
          "step_s": log.step_s, "direct_s": direct_s,
          "first_batch_wait_s": log.first_batch_wait_s,
          "timer_mfu": mfu, "host_syncs_fit_3_steps": fit_syncs,
          "host_syncs_direct_3_steps": direct_syncs,
          "launches": launches, "launches_per_step": log.launches,
          "predict_equal_no_grad_forward": bool(
              np.array_equal(pred, plain_pred)),
          "save_s": save_s, "load_s": load_s, "saved_bytes": file_bytes,
          "reload_predict_bit_equal": bool(np.array_equal(pred, fresh_pred)),
          "reload_opt_state_bit_equal": opt_equal,
          "kernel_rows_at_these_shapes": [
              "flash_attention_fwd_bert", "flash_attention_bwd_dq_bert",
              "flash_attention_bwd_dkv_bert", "add_layer_norm_bf16",
              "add_layer_norm_bf16_bwd", "fused_update"]})
    check(all(math.isfinite(x) for x in fit_losses), f"losses {fit_losses}")
    check(fit_losses == direct,
          f"fit_bert: fit's losses {fit_losses} are not bit-equal to the "
          f"direct loop's {direct}")
    check(abs(fit_losses[0] - math.log(FIT_CLASSES)) <= 0.3,
          f"fit_bert: first loss {fit_losses[0]} not within 0.3 of ln 4")
    check(fit_acc == direct_acc,
          f"fit_bert: train accuracies {fit_acc} differ from numpy's "
          f"{direct_acc}")
    check_step_launches(log, per_step, extra, "fit_bert")
    check(np.array_equal(pred, plain_pred),
          "fit_bert: predict differs from a no_grad forward")
    check(np.array_equal(pred, fresh_pred) and opt_equal,
          "fit_bert: a loaded model predicts otherwise, or its optimizer "
          "state differs")
    check(all(0.0 <= ev[k] <= 1.0 for k in ("acc_top1", "acc_top2"))
          and math.isfinite(ev["loss"]), f"fit_bert: evaluate gave {ev}")
    check(mfu and all(0.0 < m < 1.0 for m in mfu),
          f"fit_bert: StepTimer MFU {mfu}")
    for row, name in (("flash_attention_fwd_bert", "flash_attention_fwd"),
                      ("flash_attention_bwd_dq_bert",
                       "flash_attention_bwd_dq"),
                      ("flash_attention_bwd_dkv_bert",
                       "flash_attention_bwd_dkv"),
                      ("add_layer_norm_bf16", "add_layer_norm"),
                      ("add_layer_norm_bf16_bwd", "add_layer_norm_bwd"),
                      ("fused_update", "fused_update")):
        table[row]["launches_fit_bert"] = launches[name]
    del model, net, direct_net, step
    gc.collect()
    torch.cuda.empty_cache()


def fit_resume_phase(torch, np, dev):
    """``fit`` over a ``CheckpointableLoader`` (shuffled, seeded) of
    RESUME_BATCHES batches of BERT-base classifier rows with
    ``checkpoint_dir`` and ``save_steps=RESUME_SAVE_STEPS``: uninterrupted,
    then stopped by a callback after RESUME_STOP steps, then resumed by
    a fresh model (other weights) with ``auto_resume``.  The resumed
    losses must equal the uninterrupted run's bit for bit.  Save and
    restore seconds and GB/s from the manager's calls."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import CheckpointableLoader, TensorDataset
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.nn import CrossEntropyLoss
    cfg = dataclasses.replace(BertConfig(), num_hidden_layers=RESUME_LAYERS)
    b = BERT_BATCH
    ids, mask, labels = classifier_rows(np, cfg, RESUME_BATCHES * b,
                                        SEED + 94)
    ds = TensorDataset([ids, mask, labels])

    def run(seed, root=None, stop=None):
        net = bert_classifier(torch, dev, cfg, seed)
        model = Model(net)
        model.prepare(optimizer.AdamW(1e-4, parameters=net.parameters()),
                      CrossEntropyLoss())
        log = step_log({}, stop_after=stop)
        times = {"save": [], "restore": []}
        manager = None
        if root is not None:
            manager = CheckpointManager(root)
            for what in ("save", "restore"):
                def timed(*a, _f=getattr(manager, what), _w=what, **k):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = _f(*a, **k)
                    times[_w].append(time.perf_counter() - t)
                    return out
                setattr(manager, what, timed)
        model.fit(CheckpointableLoader(ds, batch_size=b, shuffle=True,
                                       seed=SEED + 95),
                  epochs=1, verbose=0, callbacks=[log],
                  checkpoint_dir=manager, save_steps=RESUME_SAVE_STEPS)
        del model, net
        gc.collect()
        torch.cuda.empty_cache()
        return [l["loss"] for l in log.logs], times

    root = tempfile.mkdtemp(prefix="fit_resume_")
    t0 = time.perf_counter()
    try:
        whole, _ = run(SEED + 96)
        head, saves = run(SEED + 96, root, stop=RESUME_STOP)
        steps_on_disk = CheckpointManager(root).steps_on_disk()
        ckpt_bytes = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(os.path.join(
                root, f"step_{RESUME_STOP:08d}"))
            for f in fs)
        tail, resumed = run(SEED + 97, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t0
    emit({"phase": "fit_resume", "model": "bert-base classifier",
          "layers": RESUME_LAYERS, "dtype": "bfloat16 (amp O2)", "batch": b,
          "seq": BERT_SEQ, "steps": RESUME_BATCHES,
          "save_steps": RESUME_SAVE_STEPS, "stopped_after": RESUME_STOP,
          "uninterrupted_losses": whole, "losses_before_stop": head,
          "resumed_losses": tail, "steps_on_disk_at_stop": steps_on_disk,
          "checkpoint_bytes": ckpt_bytes,
          "save_s": saves["save"] + resumed["save"],
          "save_gb_s": [ckpt_bytes / s / 1e9
                        for s in saves["save"] + resumed["save"]],
          "restore_s": resumed["restore"],
          "restore_gb_s": [ckpt_bytes / s / 1e9
                           for s in resumed["restore"]],
          "phase_s": phase_s})
    check(head == whole[:RESUME_STOP],
          f"fit_resume: the interrupted run's losses {head} differ from "
          f"the uninterrupted {whole[:RESUME_STOP]}")
    check(tail == whole[RESUME_STOP:],
          f"fit_resume: resumed losses {tail} are not bit-equal to the "
          f"uninterrupted run's {whole[RESUME_STOP:]}")
    check(steps_on_disk == [RESUME_SAVE_STEPS, RESUME_STOP],
          f"fit_resume: checkpoints at {steps_on_disk}")


def fit_gpt2_tokens_phase(torch, np, dev, table):
    """GPT-2 124M on ``bench_gpt2``'s recipe (f32, dropout 0.1, batch 8 x
    1024) fed from a token file: TOKEN_SEQS seeded sequences of 1025 ids
    (drawn from TOKEN_SUBVOCAB ids).  The native ``TokenFileLoader``
    (``core/csrc/dataio.cpp``, built here) must load, cover the file and
    give its batch rate; then a map-style dataset over
    ``TokenFileDataset`` yielding ``(ids[:-1], ids[1:])`` feeds
    ``DataLoader(num_workers=2)`` (worker processes forked from this
    CUDA-initialised process) into ``Model(GPTForCausalLM)`` with
    ``GPTPretrainingCriterion`` for TOKEN_FIT_STEPS steps: losses start
    within 0.5 of ln 50304 and fall; #2-#4 12 launches a step, #8 one a
    leaf of 1 MiB or more and one for the rest."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core import load_native
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import (DataLoader, Dataset, Subset,
                                     TokenFileDataset, TokenFileLoader)
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt2_124m_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = gpt2_124m_config()
    seq = GPT_SEQ + 1
    root = tempfile.mkdtemp(prefix="fit_gpt2_")
    try:
        rng = np.random.default_rng(SEED + 98)
        sub = rng.choice(cfg.vocab_size, TOKEN_SUBVOCAB, replace=False)
        tokens = sub[rng.integers(0, TOKEN_SUBVOCAB, TOKEN_SEQS * seq)
                     ].astype(np.int32)
        path = os.path.join(root, "tokens.bin")
        tokens.tofile(path)
        t0 = time.perf_counter()
        lib = load_native()
        build_s = time.perf_counter() - t0
        reader = TokenFileLoader(path, seq_len=seq, batch_size=GPT_BATCH,
                                 shuffle_seed=SEED + 99)
        native = reader.is_native
        check(native, "fit_gpt2_tokens: the native token reader did not "
                      f"load (library {lib})")
        t0 = time.perf_counter()
        blocks = [reader.next() for _ in range(len(reader))]
        read_s = time.perf_counter() - t0
        reader.close()
        covered = np.array_equal(np.sort(np.concatenate(
            [x.ravel() for x in blocks])), np.sort(tokens))
        check(covered, "fit_gpt2_tokens: the reader's epoch does not cover "
                       "the file")

        class Shifted(Dataset):
            def __init__(self, tds):
                self.tds = tds

            def __getitem__(self, i):
                ids = self.tds[i]
                return ids[:-1], ids[1:].astype(np.int64)

            def __len__(self):
                return len(self.tds)

        data = Subset(Shifted(TokenFileDataset(path, seq)),
                      range(TOKEN_FIT_STEPS * GPT_BATCH))
        loader = DataLoader(data, batch_size=GPT_BATCH, shuffle=True,
                            num_workers=2, timeout=WORKER_TIMEOUT_S)
        net = GPTForCausalLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED + 99))
        model = Model(net)
        model.prepare(optimizer.AdamW(1e-4, parameters=net.parameters()),
                      GPTPretrainingCriterion())
        layers = cfg.num_hidden_layers
        counters = {n: f for n, f in fit_counters(ft, fa).items()
                    if not n.startswith("add_layer_norm")}
        big = sum(p.numel() * p.element_size() >= (1 << 20)
                  for p in net.parameters())
        per_step = {"flash_attention_fwd": layers,
                    "flash_attention_bwd_dq": layers,
                    "flash_attention_bwd_dkv": layers,
                    "fused_update": big + 1}
        extra = {n: c for n, c in per_step.items() if n != "fused_update"}
        log = step_log(counters)
        np.random.seed(SEED + 99)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, verbose=0, callbacks=[log])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {n: f.launches for n, f in counters.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = [l["loss"] for l in log.logs]
    step_s = mean_after_first(log.step_s, log.epoch_of)
    interval_s = mean_after_first(log.interval_s, log.epoch_of)
    emit({"phase": "fit_gpt2_tokens", "model": "gpt2_124m",
          "dtype": "float32", "batch": GPT_BATCH, "seq": GPT_SEQ,
          "token_file": {"sequences": TOKEN_SEQS, "ids_a_sequence": seq,
                         "sub_vocabulary": TOKEN_SUBVOCAB,
                         "bytes": int(tokens.nbytes)},
          "native_reader": native, "native_build_s": build_s,
          "reader_batches": len(blocks), "reader_s": read_s,
          "reader_batches_per_s": len(blocks) / read_s,
          "step_batches_per_s": 1 / step_s, "fit_s": fit_s,
          "fit_step_s": step_s, "fit_interval_s": interval_s,
          "step_s": log.step_s, "first_batch_wait_s": log.first_batch_wait_s,
          "losses": losses, "ln_vocab": math.log(cfg.vocab_size),
          "loader": "DataLoader(shuffle=True, num_workers=2), fork",
          "launches": launches, "launches_per_step": log.launches})
    check(len(losses) == TOKEN_FIT_STEPS, f"fit_gpt2_tokens: {len(losses)} "
                                          f"steps, not {TOKEN_FIT_STEPS}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"fit_gpt2_tokens: first loss {losses[0]} not within 0.5 of ln V")
    check(losses[-1] < losses[0],
          f"fit_gpt2_tokens: loss did not fall: {losses}")
    check_step_launches(log, per_step, extra, "fit_gpt2_tokens")
    for n in ("fwd", "bwd_dq", "bwd_dkv"):
        table[f"flash_attention_{n}_dropout"]["launches_fit_gpt2_tokens"] = \
            launches[f"flash_attention_{n}"]
    table["fused_update"]["launches_fit_gpt2_tokens"] = \
        launches["fused_update"]
    del model, net
    gc.collect()
    torch.cuda.empty_cache()


def fit_paths(torch, np, dev, table):
    """The high-level trainer's paths: BERT-base through ``Model.fit``
    against a direct loop, its crash-safe resume, GPT-2 fed from the
    native token reader."""
    fit_bert_phase(torch, np, dev, table)
    fit_resume_phase(torch, np, dev)
    fit_gpt2_tokens_phase(torch, np, dev, table)


# -- multi-device training: a gang through the port's launcher -------------

DIST_STEPS = 4
DIST_STAGES = (1, 2, 3)
DIST_DEVICE = None          # each rank's card (its local rank)


def gpt_sharded_trainer(torch, cfg, dev, seed, stage):
    """``gpt_trainer``'s recipe through fleet: ``distributed_model`` /
    ``distributed_optimizer`` and ``ShardedTrainStep`` at ``stage``."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import ShardedTrainStep, fleet
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion)
    model = fleet.distributed_model(GPTForCausalLM(
        cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed)))
    crit = GPTPretrainingCriterion()
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()))
    return model, ShardedTrainStep(model, lambda m, b: crit(m(b["x"]),
                                                            b["y"]),
                                   opt, stage=stage, seed=seed, device=dev)


def dist_counters(fa, ft):
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_update": ft.fused_update_flat}


def dist_run(torch, step, batch, counters):
    """DIST_STEPS steps: losses (floats), host step times, launches, the
    last step's collectives and the peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(DIST_STEPS):
        t = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return {"losses": [float(x) for x in losses], "step_s": times,
            "mean_step_s": sum(times[1:]) / (len(times) - 1),
            "launches": {n: fn.launches for n, fn in counters.items()},
            "comm": dict(getattr(step, "comm", {})),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def whole_slots(torch, step):
    """The sharded trainer's slots whole (gathered over the sharding
    group: every rank calls this)."""
    from paddle_tpu_torch import distributed as dist
    g = step.hcg.get_sharding_parallel_group()
    out = {}
    for n, slots in step.state["opt"]["slots"].items():
        d = step.plan.slot_dim(n)
        for k, v in slots.items():
            if d is None:
                out[(n, k)] = v
                continue
            parts = []
            dist.all_gather(parts, v.contiguous(), group=g)
            out[(n, k)] = torch.cat(parts, dim=d)
    return out


def dist_train_worker(out_dir):
    """One rank of the ``dist_train`` gang (started by the port's
    launcher): GPT-2 124M on ``bench_gpt2``'s recipe, first through the
    unsharded ``CompiledTrainStep`` on this card, then through fleet and
    ``ShardedTrainStep`` at stages 1, 2 and 3; a stage-3 checkpoint saved
    by the gang reloads into a single-card ``CompiledTrainStep``.  At a
    world of one the recipe is the one ``train_gpt2`` runs (dropout 0.1);
    in a larger gang dropout is 0, so the world's losses can be held
    against a single card's, and stages 2 and 3 shard over every card.
    Writes ``rank<r>.json`` into ``out_dir``."""
    import numpy as np
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models.gpt import gpt2_124m_config
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    hcg = dist.fleet.init(device=DIST_DEVICE)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist.barrier()                      # NCCL's communicator comes up here
    first_s = time.perf_counter() - t0
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = dist.env.get_device()
    cfg = gpt2_124m_config()
    if world > 1:
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    seed = SEED + 4
    batch = gpt_batch(torch, np, dev, cfg.vocab_size, GPT_BATCH, GPT_SEQ)
    counters = dist_counters(fa, ft)
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "native_store": dist.env.get_store().is_native,
           "nccl": ".".join(str(v) for v in torch.cuda.nccl.version()),
           "init_s": init_s, "first_collective_s": first_s,
           "topology": hcg.topology(), "stages": {}}

    model, step = gpt_trainer(torch, cfg, dev, seed)
    res["unsharded"] = dist_run(torch, step, batch, counters)
    res["n_leaves"] = len(step.state["params"])
    ref = {n: p.detach().clone() for n, p in step.state["params"].items()}
    del model, step
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = os.path.join(out_dir, "ckpt_stage3")
    for stage in DIST_STAGES:
        if stage > 1 and world > 1:
            # stages 2 and 3 shard over every card (fleet.init() alone
            # made them all data parallel)
            strategy = dist.DistributedStrategy()
            strategy.hybrid_configs = {"sharding_degree": world}
            dist.fleet.init(strategy=strategy, device=DIST_DEVICE)
        model, step = gpt_sharded_trainer(torch, cfg, dev, seed, stage)
        run = dist_run(torch, step, batch, counters)
        full = step.full_params()
        run["updated_leaves"] = len(step.state["params"])
        run["params_equal"] = all(torch.equal(full[n], ref[n]) for n in ref)
        run["params_max_rel"] = max(
            float((full[n] - ref[n]).abs().max() /
                  ref[n].abs().max().clamp_min(1e-30)) for n in ref)
        if stage == 3:
            step.save_checkpoint(ckpt)
            slots = whole_slots(torch, step)
            if rank == 0:
                _, single = gpt_trainer(torch, cfg, dev, seed + 1)
                t0 = time.perf_counter()
                single.load_checkpoint(ckpt)
                torch.cuda.synchronize()
                run["ckpt_load_s"] = time.perf_counter() - t0
                run["ckpt_params_equal"] = all(
                    torch.equal(single.state["params"][n], full[n])
                    for n in full)
                run["ckpt_slots_equal"] = all(
                    torch.equal(single.state["opt"]["slots"][n][k], v)
                    for (n, k), v in slots.items())
                run["ckpt_step_count"] = single.step_count
                del single
            del slots
            dist.barrier()
        res["stages"][str(stage)] = run
        del model, step, full
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def dist_train_phase(torch, table):
    """``dist_train``: the port's launcher starts one rank a card (NCCL,
    the native store); each rank runs ``dist_train_worker``.  At a world
    of one the sharded steps equal the unsharded one bit for bit
    (losses and parameters), #2-#4 launch once a layer a step and #8
    once a leaf a step, and the stage-3 checkpoint reloads bit-equal into
    a single-card ``CompiledTrainStep``; a larger gang's losses are held
    against one card's at 1e-5 relative (the CPU tests' bound)."""
    import tempfile
    n = torch.cuda.device_count()
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = tempfile.mkdtemp(prefix="dist_train_")
    logs = os.path.join(out_dir, "logs")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(n), "--log_dir", logs,
         os.path.join(here, "chip_smoke.py"), "--dist-train-worker",
         out_dir], cwd=here, capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    tails = ""
    if os.path.isdir(logs):
        for f in sorted(os.listdir(logs)):
            with open(os.path.join(logs, f)) as fh:
                tails += f"\n--- {f}\n" + fh.read()[-4000:]
    check(proc.returncode == 0,
          f"dist_train gang exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}{tails}")
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    layers, leaves = GPT_LAYERS_124M, r0["n_leaves"]
    stages = r0["stages"]
    emit({"phase": "dist_train", "model": "gpt2_124m", "world": n,
          "backend": r0["backend"], "native_store": r0["native_store"],
          "nccl_version": r0["nccl"], "init_s": r0["init_s"],
          "first_collective_s": r0["first_collective_s"],
          "launcher_wall_s": wall_s, "topology": r0["topology"],
          "train_gpt2_mean_step_s": RESULTS.get("train_gpt2_mean_step_s"),
          "unsharded": r0["unsharded"], "stages": stages,
          "ranks": [{k: r[k] for k in ("rank", "init_s")} for r in ranks]})
    check(all(r["backend"] == "nccl" for r in ranks),
          f"dist_train ran on {[r['backend'] for r in ranks]}, not nccl")
    check(r0["native_store"], "the gang's store is not the native one")
    base = r0["unsharded"]["losses"]
    for st, run in stages.items():
        per_step = {"flash_attention_fwd": layers,
                    "flash_attention_bwd_dq": layers,
                    "flash_attention_bwd_dkv": layers,
                    "fused_update": run["updated_leaves"]}
        for name, k in per_step.items():
            got = run["launches"][name]
            check(got == k * DIST_STEPS,
                  f"dist_train stage {st}: {name} launched {got} times in "
                  f"{DIST_STEPS} steps, not {k} a step")
        if n == 1:
            check(run["updated_leaves"] == leaves,
                  f"stage {st} updated {run['updated_leaves']} leaves of "
                  f"{leaves}")
            check(run["losses"] == base,
                  f"stage {st} losses {run['losses']} != unsharded {base}")
            check(run["params_equal"],
                  f"stage {st} parameters differ from the unsharded "
                  f"step's (max relative {run['params_max_rel']})")
        else:
            rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                          base))
            check(rel <= 1e-5, f"stage {st} world {n} losses off one "
                               f"card's by {rel}")
        check(all(math.isfinite(x) for x in run["losses"]),
              f"stage {st} losses {run['losses']}")
    s3 = stages["3"]
    check(s3["ckpt_params_equal"] and s3["ckpt_slots_equal"],
          "the stage-3 checkpoint did not reload bit-equal into a "
          "single-card CompiledTrainStep")
    check(s3["ckpt_step_count"] == DIST_STEPS,
          f"reloaded step count {s3['ckpt_step_count']}")
    table["fused_update"]["dist_train_launches"] = \
        stages["3"]["launches"]["fused_update"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    import numpy as np

    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi reported no GPU")
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- build: one nvcc per source, all started together
    t0 = time.perf_counter()
    built = _build.build(["ragged_paged_attention", "flash_attention_fwd",
                          "flash_attention_bwd", "flash_attention_dbias",
                          "fused_update", "add_norm", "add_norm_half",
                          "add_norm_mixed", "matmul_rope",
                          "grouped_matmul", "paged_decode_attention"])
    for name, rep in built.items():
        print(f"--- ptxas report, {name}\n{rep['ptxas']}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": {n: r["seconds"] for n, r in built.items()
                    if r["seconds"] is not None}})
    # the tensor-core kernels' registers and spills (0 spill bytes each),
    # from each library's own build report, fresh or cached
    usage = ptxas_usage(built)
    emit({"phase": "ptxas", "kernels": usage})
    check(usage and all(u.get("spill_bytes", 1) == 0
                        for u in usage.values()),
          f"a tensor-core kernel spills (or reported nothing): {usage}")
    for fam in ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                "flash_bwd_dkv_wgmma", "matmul_rope_wgmma", "gmm_wgmma",
                "dw_wgmma", "flash_fwd_3xtf32", "gmm_rows_stream",
                "glu_wgmma", "ragged_attend_mma", "ragged_attend_3xtf32",
                "flash_bwd_dkv_3xtf32", "paged_decode_split",
                "flash_bwd_dq_3xtf32", "flash_dbias_3xtf32"):
        check(any(fam in n for n in usage), f"no ptxas report of {fam}")

    # -- kernels against their plain versions, full-width bf16 shapes
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = {}

    args, n_bytes, flops = ragged_case(torch, gen, dev)
    pools = (args["k_pages"], args["v_pages"])

    def ragged(fn, kp, vp):
        return fn(args["q"], kp, vp, args["k_new"], args["v_new"],
                  args["q_start"], args["q_len"], args["kv_len"],
                  args["page_tables"])

    kp_k, vp_k = (p.clone() for p in pools)
    kp_p, vp_p = (p.clone() for p in pools)
    got = ragged(pa.ragged_paged_append_attend, kp_k, vp_k)
    want = ragged(pa.ragged_paged_append_attend_reference, kp_p, vp_p)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(kp_k, kp_p) and torch.equal(vp_k, vp_p),
          "ragged kernel appended other K/V than its plain version")
    check(err <= TOL, f"ragged kernel off its plain version by {err}")
    table["ragged_paged_append_attend"] = ragged_row(
        torch, "ragged_paged_append_attend",
        lambda: ragged(pa.ragged_paged_append_attend, kp_k, vp_k),
        lambda: ragged(pa.ragged_paged_append_attend_reference, kp_p, vp_p),
        err, bound_ms(n_bytes, flops), "mma")
    emit({"phase": "kernel", **table["ragged_paged_append_attend"],
          "group": 4, "tolerance": TOL})
    del args, pools, kp_k, vp_k, kp_p, vp_p, got, want

    args, n_bytes, flops = flash_case(torch, gen, dev)
    kw = dict(causal=False, mask=args["mask"])
    out, lse = fa.flash_attention_fwd(args["q"], args["k"], args["v"], **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(
        args["q"], args["k"], args["v"], **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    check(err <= TOL, f"flash kernel off its plain version by {err}")
    check(lse_err <= 1e-3, f"flash kernel lse off by {lse_err}")
    qt, kt, vt = (args[n].transpose(1, 2) for n in ("q", "k", "v"))
    mask_b = args["mask"].to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(qt, kt, vt, attn_mask=mask_b, enable_gqa=True)

        def library():
            sdpa(qt, kt, vt, attn_mask=mask_b, enable_gqa=True)
    except TypeError:                   # a PyTorch without enable_gqa
        kr, vr = (x.repeat_interleave(4, dim=1) for x in (kt, vt))

        def library():
            sdpa(qt, kr, vr, attn_mask=mask_b)
    bound, bound_by = bound_ms(n_bytes, flops)
    table["flash_attention_fwd"] = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:164",
        "max_abs_err": err,
        "ms": timed_ms(torch, lambda: fa.flash_attention_fwd(
            args["q"], args["k"], args["v"], **kw), 20),
        "plain_ms": timed_ms(torch, lambda: fa.flash_attention_fwd_reference(
            args["q"], args["k"], args["v"], **kw), 5),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": timed_ms(torch, library, 20),
        **traced_kernel(torch, lambda: fa.flash_attention_fwd(
            args["q"], args["k"], args["v"], **kw))}
    emit({"phase": "kernel", **table["flash_attention_fwd"],
          "lse_max_abs_err": lse_err, "tolerance": TOL})
    del args, out, lse, ref_out, ref_lse, qt, kt, vt, mask_b

    f32_prefill_kernel(torch, gen, dev, table)
    flash_train_kernels(torch, gen, dev, table)
    dropout_kernels(torch, gen, dev, table)
    dbias_kernels(torch, gen, dev, table)
    update_kernel(torch, gen, dev, table)
    add_norm_kernel(torch, gen, dev, table)
    matmul_rope_kernel(torch, np, gen, dev, table)
    group1_kernels(torch, gen, dev, table)
    moe_kernels(torch, gen, dev, table)
    decode_kernels(torch, gen, dev, table)
    ragged_int8_kernel(torch, gen, dev, table)
    mixed_kernels(torch, gen, dev, table)
    # #1, #7, #6 and #2 at a tp > 1 rank's heads (printed by serve_tp)
    tp_rows = tp_shard_kernels(torch, torch.Generator(
        device=dev).manual_seed(SEED + 50), dev)
    torch.cuda.empty_cache()
    # #2-#4 and #10 at an mp > 1 rank's heads (printed by train_mp)
    mp_rows = mp_shard_kernels(torch, np, torch.Generator(
        device=dev).manual_seed(SEED + 60), dev)
    torch.cuda.empty_cache()
    zoo_rows = zoo_kernels(torch, np, torch.Generator(
        device=dev).manual_seed(SEED + 30), dev, table)
    gc.collect()
    torch.cuda.empty_cache()
    # #2-#4 and #9's mixed mode at the encoder-decoder Transformer's
    # shapes (its paths run after the zoo's)
    tf_rows = transformer_kernels(torch, torch.Generator(
        device=dev).manual_seed(SEED + 40), dev, table)
    emit({"phase": "transformer_kernels", "rows": sorted(tf_rows)})
    gc.collect()
    torch.cuda.empty_cache()

    # -- serve Llama-3-8B through the engine's entry points
    cfg = llama3_8b_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    pool_bytes = 2 * eng.cache.k_pages.numel() * \
        eng.cache.k_pages.element_size()
    rng = np.random.default_rng(SEED)
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).tolist()
               for rid, n in SERVE_LENS.items()}
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd}
    stats, results = serve_run(torch, eng, prompts, counters)
    launches = stats["launches"]
    emit({"phase": "serve", "model": "llama3_8b", "layers":
          cfg.num_hidden_layers, "dtype": "bfloat16",
          "weight_bytes": weight_bytes, "kv_pool_bytes": pool_bytes,
          "setup_s": setup_s, **stats})
    for rid, out in results.items():
        check(all(0 <= t < cfg.vocab_size for t in out),
              f"request {rid} returned a token outside the vocabulary")
    for name, n in launches.items():
        check(n > 0, f"the serving path never launched {name}")
        table[name]["launches"] = n

    # -- what comes out agrees with a dense plain forward: f32 at full
    # width and 2 layers, bf16 at full depth
    cfg32 = dataclasses.replace(cfg, num_hidden_layers=2)
    model32 = LlamaForCausalLM(
        cfg32, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    eng32 = LLMEngine(model32, max_seqs=8, max_len=2048, page_size=128)
    rep = serve_reference(
        torch, dev, prompts["b37"],
        (("f32_2_layers", model32, eng32, 1e-4),
         ("bf16_32_layers", model, eng, 0.2)),
        lambda m, ids: dense_reference_logits(torch, m, ids))
    emit({"phase": "reference", **rep})
    del eng32, model32

    # -- where a serving step's time goes: the same mix, traced
    # (fresh prompts of the same lengths: no prefix-cache hits)
    prof = profile_serve(torch, eng, {
        f"p{rid}": rng.integers(0, cfg.vocab_size, n).tolist()
        for rid, n in SERVE_LENS.items()}, max_new=8)
    emit({"phase": "profile", **prof})
    check_tensor_core_route(prof, "profile", ("ragged_attend",),
                            design="mma")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # -- the same model and requests sampled, through generate, and with a
    # draft model
    serve_sampling_phase(torch, np, dev, model, prompts, results, stats)
    generate_phase(torch, np, dev, model)
    serve_spec_phase(torch, np, dev, model, prompts, results, stats)
    f32_decode_agreement(torch, np, dev)
    serve_metrics_phase(torch, np, dev, model, prompts, results)
    serve_sched_phase(torch, np, dev, model, prompts, results, stats)
    serve_http_phase(torch, np, dev, model, prompts, results)
    serve_router_phase(torch, np, dev, model, prompts, results)

    # -- the same model on the split path and with int8 pools and weights,
    # then with the pools at their default dtype (f32)
    quant_serve_phases(torch, np, dev, table, model, prompts, pool_bytes)
    serve_default_pools(torch, dev, table, model, prompts)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    serve_quant_reference(torch, np, dev)

    # -- f32 weights over bf16 pools, the reference's serving benches'
    # configuration; preemption, swap and migration on it
    serve_f32w_phases(torch, np, dev, table)

    # -- train at 8B width: the unfused chain, then the headline recipe
    # (fused regions, core_attn remat) at twice the depth; then the f32
    # checks of both chains
    train_phase(torch, np, dev, table, phase="train", layers=TRAIN_LAYERS,
                fused=False)
    gc.collect()
    torch.cuda.empty_cache()
    train_phase(torch, np, dev, table, phase="train_fused",
                layers=FUSED_LAYERS, fused=True)
    gc.collect()
    torch.cuda.empty_cache()
    train_reference_phase(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # -- Qwen1.5-MoE-A2.7B: serve at full depth, train at 6 layers, then
    # the f32 checks of the training chain (the Llama models are freed)
    serve_moe_phase(torch, np, dev, table)
    gc.collect()
    torch.cuda.empty_cache()
    train_moe_phase(torch, np, dev, table)
    gc.collect()
    torch.cuda.empty_cache()
    train_moe_reference_phase(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # -- GPT-2 124M: train on bench_gpt2's recipe (dropout in the flash
    # kernels), the f32 checks of its chain, and a post-norm encoder
    # layer with a trained attention bias
    train_gpt2_phase(torch, np, dev, table)
    gc.collect()
    torch.cuda.empty_cache()
    train_gpt2_reference_phase(torch, np, dev)
    encoder_bias_phase(torch, dev, table)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the training loop's state on the same recipe: a schedule with the
    # clip tap and the step timer, an exact resume from a checkpoint, the
    # optimizers without a fused kind
    train_schedule_phase(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_resume_phase(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_optimizers_phase(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the rest of the model zoo (its kernel rows ran above): ERNIE-4.5
    # dense and MoE training and their f32 checks, DiT-L/2, the KL
    # autoencoder, BERT-base, DeepSeekMoE-16B serving
    zoo_paths(torch, np, dev, table, zoo_rows)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the encoder-decoder Transformer (Transformer-base; its kernel rows
    # ran above): O1 bf16 training and translation, O1 f16 with
    # GradScaler, the f32 check of its chain
    transformer_paths(torch, np, dev, table, tf_rows)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the high-level trainer (hapi.Model) over the io loaders: BERT-base
    # fit against a direct loop, its exact resume, GPT-2 from token files
    fit_paths(torch, np, dev, table)
    gc.collect()
    torch.cuda.empty_cache()

    # -- multi-device training: one rank a card through the port's
    # launcher, NCCL, ZeRO stages 1-3 against the unsharded step
    dist_train_phase(torch, table)

    # -- tensor-parallel training: fleet at mp_degree 1 in an NCCL world
    # of one in this process, the annotated Llama's mp forward against
    # CompiledTrainStep (its process group stays up for serve_tp)
    train_mp_phase(torch, np, dev, table, mp_rows)
    gc.collect()
    torch.cuda.empty_cache()

    # -- tensor-parallel serving: the serve mix through a serving mesh of
    # one (NCCL, this process; last, so no phase runs after its process
    # group)
    serve_tp_phase(torch, dev, prompts, results, stats, tp_rows)

    # each tensor-core row: its kernel's registers and spills (the most
    # registers and the summed spills over that kernel's instantiations)
    for row in table.values():
        if row.get("design") in ("wgmma", "3xtf32", "stream", "mma",
                                 "split"):
            name = row["name"]
            fam = (f"ragged_attend_{row['design']}" if name.startswith(
                       "ragged")
                   else "paged_decode_split" if row["design"] == "split"
                   else ("flash_bwd_dkv_3xtf32" if "bwd_dkv" in name
                         else "flash_bwd_dq_3xtf32" if "bwd_dq" in name
                         else "flash_dbias_3xtf32" if "dbias" in name
                         else "flash_fwd_3xtf32")
                   if row["design"] == "3xtf32"
                   else "gmm_rows_stream" if row["design"] == "stream"
                   else "matmul_rope_wgmma" if name.startswith("matmul_rope")
                   else "glu_wgmma" if name.startswith("grouped_matmul_glu")
                   else "dw_wgmma" if name.startswith("grouped_matmul_dw")
                   else "gmm_wgmma" if name.startswith("grouped_matmul")
                   else "flash_bwd_dq_wgmma" if "bwd_dq" in name
                   else "flash_bwd_dkv_wgmma" if "bwd_dkv" in name
                   else "flash_fwd_wgmma")
            got = [u for n, u in usage.items() if fam in n]
            row["ptxas_registers"] = max(
                (u.get("registers", 0) for u in got), default=None)
            row["ptxas_spill_bytes"] = sum(u.get("spill_bytes", 0)
                                           for u in got) if got else None
    emit({"kernels": [table[n] for n in (
        "ragged_paged_append_attend", "ragged_paged_append_attend_group1",
        "flash_attention_fwd",
        "flash_attention_fwd_causal_8k", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "flash_attention_fwd_moe",
        "flash_attention_bwd_dq_moe", "flash_attention_bwd_dkv_moe",
        "flash_attention_fwd_dropout", "flash_attention_fwd_f32_prefill",
        "flash_attention_bwd_dq_dropout", "flash_attention_bwd_dkv_dropout",
        "flash_attention_dbias", "fused_update", "add_norm",
        "add_norm_bwd", "add_layer_norm", "add_layer_norm_bwd",
        "matmul_rope", "grouped_matmul", "grouped_matmul_f32_rows",
        "grouped_matmul_f32_rows_down", "grouped_matmul_f32_rows_decode",
        "grouped_matmul_glu",
        "grouped_matmul_glu_hs", "grouped_matmul_dw", "paged_attention",
        "paged_decode_append_attend", "ragged_paged_append_attend_int8",
        "ragged_paged_append_attend_float32_q_bfloat16_pools",
        "ragged_paged_append_attend_bfloat16_q_float32_pools",
        "paged_decode_append_attend_float32_q_bfloat16_pools",
        "paged_attention_float32_q_bfloat16_pools")] + [
            table[n] for n in zoo_rows] + [table[n] for n in tf_rows]})
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-train-worker":
        dist_train_worker(sys.argv[2])
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
