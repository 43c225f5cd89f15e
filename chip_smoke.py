#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA GPU, the
CUDA toolkit (nvcc) and PyTorch built for CUDA.  It builds the port's
kernels from ``paddle_tpu_torch/csrc`` (one nvcc per source, all
started together) and holds each against its plain PyTorch version at
the main paths' full-width shapes (the attention kernels also at GQA
group 1, with int8 pools and with dropout, the grouped matmuls at the
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
  LayerNorm body, the flash kernels and the bias gradient #5).

Each phase prints one JSON line; the last three lines are the kernel
table, the card's name and power limit as nvidia-smi reports them, and
``{"ok": true, ...}``.  Any failed phase exits non-zero before the
``ok`` line.  Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 tensor-core rate, for the least time the card could take
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # f32 inputs on the tensor cores (TF32)
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
# relative L2 error of an f32 output against its plain version: f32 sums
# in another order
F32_REL_L2_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
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


def rel_err(got, want):
    """Largest absolute error over the largest |want| element."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def ragged_case(torch, gen, dev, H=32, KVH=8):
    """The unified step's shapes: T = S = 136 rows (max_seqs 8 + prefill
    budget 128), P 128, D 128, H query and KVH KV heads (Llama-3-8B: 32
    and 8; Qwen1.5-MoE-A2.7B: 16 and 16): four decode rows at mixed
    lengths, one 128-row chunk, and one prompt split over two
    descriptors at a page boundary."""
    T, P, D, maxp = 136, 128, 128, 16
    n_pages = 8 * maxp + 1
    seqs = [(36, 1), (127, 1), (300, 1), (1031, 1), (256, 128), (126, 2),
            (128, 2)]                               # (kv_len, q_len)
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
    live = [(kl, ql) for kl, ql in seqs]
    pages_read = sum(-(-(kl + ql) // P) for kl, ql in live) * KVH
    rows = sum(ql for _, ql in live)
    n_bytes = (2 * pages_read * P * D * 2          # K and V pages read
               + rows * H * D * 2                  # q rows
               + 2 * 2 * rows * KVH * D * 2        # new rows in, appended
               + T * P * H * D * 2                 # out [S, P, H, D]
               + 4 * (3 * T + T * maxp))           # descriptors, tables
    flops = sum(4 * H * D * (kl + r + 1) for kl, ql in live
                for r in range(ql))
    return args, n_bytes, flops


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


def plain_hidden(torch, model, ids):
    """Final-norm hidden states [B, S, H] of a plain causal forward over
    ids [B, S] (no pages, no kernels, no chunking: embedding, per layer
    RMSNorm, projections, f32 rope, the flash plain version, SwiGLU),
    differentiable by autograd."""
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
        o = flash_attention_fwd_reference(q, k, v, causal=True)[0]
        x = x + o.reshape(b, n, -1) @ a.o_proj.weight
        hn = _nn.rms_norm(x, layer.post_attention_layernorm.weight,
                          epsilon=c.rms_norm_eps)
        x = x + (_nn.silu(hn @ m.gate_proj.weight)
                 * (hn @ m.up_proj.weight)) @ m.down_proj.weight
    return _nn.rms_norm(x, lm.norm.weight, epsilon=c.rms_norm_eps)


def dense_reference_logits(torch, model, ids):
    """Last-position logits of a plain causal forward over one prompt."""
    with torch.no_grad():
        return plain_hidden(torch, model, ids[None])[0, -1] \
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
                     ("add_norm", "add_norm"),
                     ("matmul_rope", "matmul_rope"),
                     ("gmm_bf16", "grouped_matmul"),
                     ("gmm_t_f32", "grouped_matmul"),
                     ("gmm_rows_f32", "grouped_matmul"),
                     ("glu_bf16", "grouped_matmul_glu"),
                     ("glu_f32", "grouped_matmul_glu"),
                     ("dw_bf16", "grouped_matmul_dw"),
                     ("dw_f32", "grouped_matmul_dw")):
        if key in name:
            return fam
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "gemv", "sm90",
                              "nvjet")):
        return "matmul"
    return "other"


def profiled(torch, fn):
    """Run ``fn()`` under torch.profiler; return its result and the wall
    time, the summed kernel time by family, and the device's idle share
    of the wall time (one stream: kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    fams, top = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                        # host ops: their kernels count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            fam = kernel_family(e.key)
            fams[fam] = fams.get(fam, 0.0) + us / 1e3
            top.append((us / 1e3, e.key[:80], e.count))
    busy = sum(fams.values())
    top.sort(reverse=True)
    return out, {"wall_ms": wall_ms,
                 "device_busy_ms": busy if busy else None,
                 "idle_share": 1 - busy / wall_ms if busy else None,
                 "kernel_ms_by_family": fams,
                 "top_kernels": [{"ms": ms, "name": n, "count": c}
                                 for ms, n, c in top[:8]]}


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

    s, d, h, hk = TRAIN_SEQ, 128, 32, 8
    q, k, v, do = attention_case(torch, gen, dev, s)
    errs = flash_check(torch, fa, s, q, k, v, do)
    torch.cuda.empty_cache()
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
    # repeated to 32 heads (it takes no GQA; its dK/dV come per query
    # head, the group sum not included)
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
    for name, src, line, fn, flops, n_bytes, plain, lib in (
            ("flash_attention_fwd_causal_8k", "flash_attention_fwd.cu",
             "flash_attention.py:164",
             lambda: fa.flash_attention_fwd(q, k, v, causal=True),
             4 * d * h * pairs, 2 * qb + 2 * kb + h * s * 4,
             lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True),
             fwd_library),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "flash_attention.py:390",
             lambda: fa.flash_attention_bwd_dq(*ops, True),
             6 * d * h * pairs, 3 * qb + 2 * kb + 2 * h * s * 4,
             lambda: fa.flash_attention_bwd_reference(
                 q, k, v, out, lse, do, causal=True), bwd_library),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "flash_attention.py:431",
             lambda: fa.flash_attention_bwd_dkv(*ops, True),
             8 * d * h * pairs, 2 * qb + 4 * kb + 2 * h * s * 4,
             lambda: fa.flash_attention_bwd_reference(
                 q, k, v, out, lse, do, causal=True), bwd_library)):
        bound, bound_by = bound_ms(n_bytes, flops)
        ms = timed_ms(torch, fn, 3, warmup=1)
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": f"paddle_tpu/ops/pallas/{line}",
            "max_abs_err": None, "ms": ms,
            "plain_ms": timed_ms(torch, plain, 1, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None if lib is None else timed_ms(torch, lib, 3,
                                                            warmup=1)}
        torch.cuda.empty_cache()
    for name, outs in (("flash_attention_fwd_causal_8k", ("out",)),
                       ("flash_attention_bwd_dq", ("dq",)),
                       ("flash_attention_bwd_dkv", ("dk", "dv"))):
        rows[name]["max_abs_err"] = max(errs[o]["max_abs_err"]
                                        for o in outs)
    for name, row in rows.items():
        note = {"shape": [1, s, h, d], "kv_heads": hk, "causal": True}
        if name != "flash_attention_fwd_causal_8k":
            note["plain_note"] = "the whole plain backward (dq, dk, dv)"
            note["library_note"] = bwd_note or \
                "aten flash backward on K/V repeated to 32 heads"
        emit({"phase": "kernel", **row, **note})
        table[name] = row


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


def add_norm_kernel(torch, gen, dev, table):
    """The add+norm kernel (#9) at its paths' shapes: the RMS body at the
    Llama training path's post-attention residual add, x (the attention
    output) and r (the residual) [1, 8192, 4096] bf16, w [4096] bf16 (h
    equal to its plain version, y within 2^-7 relative L2); the
    LayerNorm body with a bias at the post-norm encoder layer's shape
    (``encoder_bias``), [8, 1024, 768] f32 (h equal, y within 1e-5
    relative L2)."""
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
        else:
            vectors, flops = 2, 9

            def run():
                return ft.add_layer_norm_raw(x, r, w, b, 1e-5)

            def plain():
                return ft.add_layer_norm_reference(x, r, w, b, 1e-5)
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
               "plain_ms": timed_ms(torch, plain, 5),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        emit({"phase": "kernel", **row, "body": name, "shape": list(shape),
              "dtype": str(dt), "rel_l2_err": err, "h_equal": True,
              "tolerance": {"rel_l2_err": tol},
              "library_note": "no single PyTorch call adds the residual "
                              "and normalises"})
        table[row["name"]] = row
        del x, r, h, y, want_h, want_y


def matmul_rope_kernel(torch, np, gen, dev, table):
    """The matmul+rope kernel (#10) at the training shape: x [1, 8192,
    4096] bf16 against Wq [4096, 4096] (32 heads) and Wk [4096, 1024] (8
    heads), head_dim 128, the rope tables [8192, 128] in bf16 as amp O2
    leaves them; each within 2^-7 relative L2 of its plain version.  The
    library figure is torch.matmul of the same product alone.  Then the
    f32 path (exact FMA products) at seq 1024 against its plain version
    (relative L2 1e-5: f32 sums in another order)."""
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

        def run():
            return ft.matmul_rope_raw(x, w, cos, sin, n_heads=heads,
                                      head_dim=hd)

        def plain():
            return ft.matmul_rope_reference(x, w, cos, sin, heads, hd)

        got, want = run(), plain()
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        check(got.shape == (1, s, heads, hd) and err <= REL_L2_TOL,
              f"matmul_rope ({proj}) off its plain version: relative L2 "
              f"{err}")
        n_out = s * heads * hd
        bound, bound_by = bound_ms(
            (x.numel() + w.numel() + n_out + 2 * s * hd) * 2,
            2 * s * hidden * heads * hd)
        row = {"name": "matmul_rope", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/matmul_rope.cu",
               "replaces": "paddle_tpu/ops/pallas/fused_train.py:501",
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "ms": timed_ms(torch, run, 10),
               "plain_ms": timed_ms(torch, plain, 5),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": timed_ms(torch, lambda: torch.matmul(x, w), 10)}
        emit({"phase": "kernel", **row, "projection": proj,
              "shape": [1, s, hidden], "heads": heads, "head_dim": hd,
              "rel_l2_err": err, "tolerance": {"rel_l2_err": REL_L2_TOL},
              "library_note": "torch.matmul of the product alone (no "
                              "rope)"})
        if proj == "q":
            table["matmul_rope"] = row
        del got, want
    s32 = min(1024, s)
    x32 = torch.randn((1, s32, hidden), generator=gen, device=dev)
    w32 = 0.02 * torch.randn(hidden, 32 * hd, generator=gen, device=dev)
    c32, s32t = cos[:s32].float(), sin[:s32].float()
    got = ft.matmul_rope_raw(x32, w32, c32, s32t, n_heads=32, head_dim=hd)
    want = ft.matmul_rope_reference(x32, w32, c32, s32t, 32, hd)
    torch.cuda.synchronize()
    err = rel_l2(got, want)
    emit({"phase": "check", "what": "matmul_rope f32 (FMA path)",
          "shape": [1, s32, hidden], "heads": 32, "rel_l2_err": err,
          "tolerance": 1e-5})
    check(err <= 1e-5, f"f32 matmul_rope off its plain version: {err}")


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
    # layer, but not the flash forward (its output is kept).
    counters = {
        "flash_attention_fwd": (fa.flash_attention_fwd, layers),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, layers),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, layers),
        "fused_update": (ft.fused_update_flat, 7 * layers + 3)}
    if fused:
        counters["add_norm"] = (ft.add_rms_norm_raw, 2 * layers)
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
        floss, fgrads = fstep.grad_step(batch)
        f_loss_rel, f_rel, f_worst = errors(floss, fgrads)
        fused[str(policy)] = {
            "loss_rel_err": f_loss_rel, "grad_rel_l2_max": f_rel[f_worst],
            "grad_rel_l2_worst": f_worst,
            "flash_fwd_launches": fa.flash_attention_fwd.launches}
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


def group1_kernels(torch, gen, dev):
    """The ragged kernel and the flash forward at GQA group 1 (16 query
    and 16 KV heads, D 128: Qwen1.5-MoE-A2.7B's attention), held against
    their plain versions and timed: the unified step's ragged shapes, the
    prefill chunk, and the causal forward and backward at the MoE
    training shape [4, 4096, 16, 128]."""
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
    bound, bound_by = bound_ms(n_bytes, flops)
    emit({"phase": "kernel", "name": "ragged_paged_append_attend",
          "group": 1, "heads": 16, "kv_heads": 16, "max_abs_err": err,
          "tolerance": TOL,
          "ms": timed_ms(torch, lambda: ragged(
              pa.ragged_paged_append_attend, kp_k, vp_k), 20),
          "plain_ms": timed_ms(torch, lambda: ragged(
              pa.ragged_paged_append_attend_reference, kp_p, vp_p), 5),
          "bound_ms": bound, "bound_by": bound_by, "library_ms": None})
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
                                                     attn_mask=mask_b), 20)})
    del args, out, lse, ref_out, ref_lse, qt, kt, vt, mask_b

    s, b, h, d = MOE_SEQ, MOE_BATCH, 16, 128
    q, k, v, do = attention_case(torch, gen, dev, s, b=b, h=h, kvh=h)
    flash_check(torch, fa, s, q, k, v, do)
    torch.cuda.empty_cache()
    # q, k, v read and the output written (bf16), the f32 lse written
    bound, bound_by = bound_ms(4 * b * s * h * d * 2 + b * h * s * 4,
                               4 * d * h * b * causal_pairs(s))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    emit({"phase": "kernel", "name": "flash_attention_fwd", "group": 1,
          "causal": True, "shape": [b, s, h, d],
          "ms": timed_ms(torch, lambda: fa.flash_attention_fwd(
              q, k, v, causal=True), 3, warmup=1),
          "bound_ms": bound, "bound_by": bound_by,
          "plain_ms": timed_ms(torch, lambda: fa.flash_attention_fwd_reference(
              q, k, v, causal=True), 1, warmup=1),
          "library_ms": timed_ms(torch, lambda: sdpa(qt, kt, vt,
                                                     is_causal=True), 3,
                                 warmup=1)})
    del q, k, v, do, qt, kt, vt
    torch.cuda.empty_cache()


def moe_plan_rows(torch, gen, dev, tokens, h, dtype, empty=None):
    """Routes of ``tokens`` tokens to 4 distinct of 60 experts (the top 4
    of random router scores; expert ``empty`` is never chosen), their
    dropless plan at the reference's row tile, and random rows scattered
    into the padded buffer (padding rows zero).  Returns (xs, tile_expert,
    counts, tm)."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    scores = torch.rand(tokens, MOE_E, generator=gen, device=dev)
    if empty is not None:
        scores[:, empty] = -1.0
    idx = scores.topk(MOE_K, dim=-1).indices
    tm = gm._auto_tm(MOE_E, tokens * MOE_K)
    _, dest, te, counts, m_pad = gm.make_dropless_plan(idx, MOE_E, tm)
    rows = torch.randn(tokens * MOE_K, h, generator=gen, device=dev)
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


def moe_kernels(torch, gen, dev, table):
    """#11 (gmm), #12 (gmm_glu) and #13 (gmm_dw) at the MoE paths'
    shapes, each against its plain version and timed:

    - serving, one mixed step of 136 rows x top-4 (544 slots, tm 128,
      m_pad 8,320): #11 with f32 rows against the bf16 gate stack
      [60, 2048, 1408] and down stack [60, 1408, 2048] (f32 FMA path,
      relative L2 1e-5);
    - training, 4 x 4096 tokens x top-4 (65,536 slots, tm 256, m_pad
      80,896; expert 59 gets no rows, so #13's zero expert shows): #11
      forward (down), #11 transpose_w for the down and gate dX, #12 with
      and without save_pre, #13 for the gate and down weights (bf16 on
      mma.sync, relative L2 2^-7; #13's empty expert exactly zero).

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

    def run_case(name, fn, plain, tol, bound, library, note, **extra):
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
        emit({"phase": "kernel", **row, "case": note, "rel_l2_err": errs,
              "tolerance": {"rel_l2_err": tol}, "library_note": lib_note,
              **extra})
        return row

    # -- serving: f32 rows, bf16 stacks, tm 128
    xs, te, counts, tm = moe_plan_rows(torch, gen, dev, 136, H,
                                       torch.float32)
    no_lib = (None, "torch._grouped_mm takes bf16 operands, not these f32 "
                    "rows")
    run_case("grouped_matmul", lambda: gm.gmm_raw(xs, wg, te, counts=counts),
             lambda: gm.gmm_reference(xs, wg, te), 1e-5,
             cost(counts, H, F, 4, 2, 4), no_lib, "serve gate, f32 rows",
             shape=[list(xs.shape), [E, H, F]], tm=tm)
    hs = torch.randn(xs.shape[0], F, generator=gen, device=dev) \
        * (xs[:, :1] != 0)
    run_case("grouped_matmul", lambda: gm.gmm_raw(hs, wd, te, counts=counts),
             lambda: gm.gmm_reference(hs, wd, te), 1e-5,
             cost(counts, F, H, 4, 2, 4), no_lib, "serve down, f32 rows",
             shape=[list(hs.shape), [E, F, H]], tm=tm)
    del xs, hs

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
        "train forward (down)", shape=[list(hs.shape), [E, F, H]], **shape)
    run_case("grouped_matmul", lambda: gm.gmm_raw(
        dys, wd, te, transpose_w=True, counts=counts),
        lambda: gm.gmm_reference(dys, wd, te, transpose_w=True),
        REL_L2_TOL, cost(counts, H, F, 2, 2, 2),
        grouped_mm_library(torch, counts, tm, dys, wd.transpose(1, 2)),
        "train transpose_w (down dX)", shape=[list(dys.shape), [E, F, H]],
        **shape)
    run_case("grouped_matmul", lambda: gm.gmm_raw(
        dhg, wg, te, transpose_w=True, counts=counts),
        lambda: gm.gmm_reference(dhg, wg, te, transpose_w=True),
        REL_L2_TOL, cost(counts, F, H, 2, 2, 2),
        grouped_mm_library(torch, counts, tm, dhg, wg.transpose(1, 2)),
        "train transpose_w (gate dX)", shape=[list(dhg.shape), [E, H, F]],
        **shape)
    no_glu = (None, "no single PyTorch call fuses the two products with "
                    "SwiGLU")
    run_case("grouped_matmul_glu", lambda: gm.gmm_glu_raw(
        xs, wg, wu, te, counts=counts),
        lambda: gm.gmm_glu_reference(xs, wg, wu, te), REL_L2_TOL,
        cost(counts, H, F, 2, 2, 2, n_w=2), no_glu, "train, hs only",
        shape=[list(xs.shape), [E, H, F]], **shape)
    table["grouped_matmul_glu"] = run_case(
        "grouped_matmul_glu", lambda: gm.gmm_glu_raw(
            xs, wg, wu, te, save_pre=True, counts=counts),
        lambda: gm.gmm_glu_reference(xs, wg, wu, te, save_pre=True),
        REL_L2_TOL, cost(counts, H, F, 2, 2, 2, n_w=2, n_out=3), no_glu,
        "train, save_pre", shape=[list(xs.shape), [E, H, F]], **shape)
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
            shape=[list(lhs.shape), list(dout.shape)], empty_expert_zero=True,
            **shape)
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


def plain_moe_ffn(torch, m, hn):
    """The MoE FFN of layer ``m`` over rows hn [T, H], plain: the router
    in f32, then for each expert a loop over its routed rows (SwiGLU in
    f32 against the widened weights) combined by the gate values, plus
    the gated shared expert.  Returns (out in hn's dtype, aux loss), both
    differentiable."""
    from paddle_tpu_torch.ops import _nn
    xf = hn.float()
    probs, gv, idx = moe_router(torch, m, xf)
    y = torch.zeros_like(xf)
    ex = m.experts
    for e in range(m.gate.num_experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        he = _nn.silu(xe @ ex.gate_w[e].float()) * (xe @ ex.up_w[e].float())
        y = y.index_add(0, tok, gv[tok, slot, None]
                        * (he @ ex.down_w[e].float()))
    sh = (_nn.silu(xf @ m.shared_gate.weight.float())
          * (xf @ m.shared_up.weight.float())) @ m.shared_down.weight.float()
    sh = sh * torch.sigmoid(xf @ m.shared_expert_gate.weight.float())
    e_n = m.gate.num_experts
    density = torch.nn.functional.one_hot(idx, e_n).float().sum(1).mean(0) \
        / m.gate.k
    aux = m.gate.balance_loss_weight * e_n * torch.sum(density
                                                       * probs.mean(0))
    return (y + sh).to(hn.dtype), aux


def plain_moe_hidden(torch, model, ids):
    """Final-norm hidden states [B, S, H] of a plain causal forward of a
    Qwen2-MoE model over ids [B, S] (no pages, no kernels: embedding,
    per layer RMSNorm, biased projections, f32 rope, the flash plain
    version, ``plain_moe_ffn``), and the summed aux loss; differentiable
    by autograd."""
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
        return x @ lin.weight + lin.bias

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
        ff, a_l = plain_moe_ffn(torch, layer.mlp, hn.reshape(b * n, -1))
        x = x + ff.view(b, n, -1)
        aux = aux + a_l
    return _nn.rms_norm(x, model.norm.weight, epsilon=c.rms_norm_eps), aux


def moe_reference_logits(torch, model, ids):
    """Last-position logits of ``plain_moe_hidden`` over one prompt."""
    with torch.no_grad():
        return plain_moe_hidden(torch, model, ids[None])[0][0, -1] \
            @ model.lm_head.weight


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
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128)
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
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    serve_moe_split_int8(torch, np, dev, model)


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

    _, prof = profiled(torch, lambda: step(batch))
    emit({"phase": "train_moe_profile", **prof})


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


def decode_cost(H, KVH, int8, append):
    """(bytes, flops) of one #6 (append False) or #7 call at the decode
    case: each K/V token read once (codes plus scale in int8), q read,
    out written, new rows read and appended (#7), tables and lengths."""
    D, el = 128, 1 if int8 else 2
    tokens = sum(n + int(append) for n in DECODE_LENS)
    B = len(DECODE_LENS)
    row = D * el + (4 if int8 else 0)
    n_bytes = (2 * tokens * KVH * row + 2 * B * H * D * 2
               + 4 * (B * 16 + B))
    if append:
        n_bytes += 2 * B * KVH * D * 2 + 2 * B * KVH * row
    return n_bytes, 4 * H * D * tokens


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
            row = {"name": name, "route": "cuda",
                   "source": "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                   "replaces": "paddle_tpu/ops/pallas/paged_attention.py:"
                               + ("422" if new else "274"),
                   "max_abs_err": err,
                   "ms": timed_ms(torch, lambda: call(fn, mine), 50),
                   "plain_ms": timed_ms(torch, lambda: call(plain, ref), 5),
                   "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": None}
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
        # int8 pages and their scales read, the rest as ragged_case counts
        T, P, D, maxp = 136, 128, 128, 16
        live = [(36, 1), (127, 1), (300, 1), (1031, 1), (256, 128),
                (126, 2), (128, 2)]
        pages_read = sum(-(-(kl + ql) // P) for kl, ql in live) * KVH
        rows = sum(ql for _, ql in live)
        n_bytes = (2 * pages_read * P * (D + 4) + rows * H * D * 2
                   + 2 * rows * KVH * D * 2 + 2 * rows * KVH * (D + 4)
                   + T * P * H * D * 2 + 4 * (3 * T + T * maxp))
        bound, bound_by = bound_ms(n_bytes, flops)
        row = {"name": "ragged_paged_append_attend_int8", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
               "replaces": "paddle_tpu/ops/pallas/paged_attention.py:912",
               "max_abs_err": err,
               "ms": timed_ms(torch, lambda: call(
                   pa.ragged_paged_append_attend, mine), 20),
               "plain_ms": timed_ms(torch, lambda: call(
                   pa.ragged_paged_append_attend_reference, ref), 5),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        emit({"phase": "kernel", **row, "group": H // KVH,
              "codes_and_scales_equal": True, "tolerance": TOL})
        if H == 32:
            table["ragged_paged_append_attend_int8"] = row
        del args, pools, mine, ref, got, want
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
                        unified_step=False, steps_per_sync=SPLIT_SPS, **kw)
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
    rep = {}
    for name, kw, tol in (
            ("split_float", {"unified_step": False}, 1e-4),
            ("unified_int8", {"kv_dtype": "int8", "weight_dtype": "int8"},
             1e-3),
            ("split_int8", {"unified_step": False, "kv_dtype": "int8",
                            "weight_dtype": "int8"}, 1e-3)):
        out = []
        for m, d in ((model_gpu, dev), (model_cpu, cpu)):
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
            del eng
        (lg, tg), (lc, tc) = out
        rel = ((lg - lc).norm() / lc.norm()).item()
        rep[name] = {"logits_rel_l2_err": rel, "tolerance": tol,
                     "greedy_tokens_equal": tg == tc, "tokens": tg}
        check(bool(torch.isfinite(lg).all()), f"{name}: logits not finite")
        check(rel <= tol, f"{name}: card logits off the CPU's by {rel}")
        check(tg == tc, f"{name}: card tokens {tg} != CPU tokens {tc}")
    emit({"phase": "serve_quant_reference", "dtype": "float32", "layers": 2,
          **rep})
    del model_cpu, model_gpu
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
        bound, bound_by = bound_ms(n_bytes, flops, peak=PEAK_F32_FLOPS)
        bound_tf32, _ = bound_ms(n_bytes, flops, peak=PEAK_TF32_FLOPS)
        src = "flash_attention_fwd.cu" if key == "fwd" \
            else "flash_attention_bwd.cu"
        row = {"name": name, "route": "cuda",
               "source": f"paddle_tpu_torch/csrc/{src}",
               "replaces": f"paddle_tpu/ops/pallas/{line}",
               "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
               "ms": timed_ms(torch, fn, 10),
               "plain_ms": timed_ms(torch, plain, 2, warmup=1),
               "bound_ms": bound, "bound_by": bound_by,
               "bound_tf32_ms": bound_tf32,
               "library_ms": timed_ms(torch, lib, 10)}
        emit({"phase": "kernel", **row, "shape": [b, s, h, d],
              "dtype": "float32", "causal": True, "dropout_p": GPT_DROP,
              "bound_peak": "f32 67 TFLOP/s (bound_tf32_ms: 495)",
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
    flops = 4 * d * h * b * causal_pairs(s)         # s and dP per pair
    n_bytes = 4 * b * s * h * d * 4 + 2 * b * h * s * 4 + 2 * h * s * s * 4
    bound, bound_by = bound_ms(n_bytes, flops, peak=PEAK_F32_FLOPS)
    row = {"name": "flash_attention_dbias", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention_dbias.cu",
           "replaces": "paddle_tpu/ops/pallas/flash_attention.py:608",
           "max_abs_err": err["max_abs_err"],
           "ms": timed_ms(torch, lambda: fa.flash_attention_bwd_dbias(
               *ops[:6], bias, True, GPT_DROP, seed), 10),
           "plain_ms": timed_ms(torch, lambda: fa.flash_attention_dbias_reference(
               q, k, v, out, lse, do, bias, **kw), 2, warmup=1),
           "bound_ms": bound, "bound_by": bound_by,
           "bound_tf32_ms": bound_ms(n_bytes, flops, peak=PEAK_TF32_FLOPS)[0],
           "library_ms": timed_ms(torch, library, 10)}
    emit({"phase": "kernel", **row, "shape": [b, s, h, d],
          "bias": [1, h, s, s], "dtype": "float32", "causal": True,
          "dropout_p": GPT_DROP,
          "bound_peak": "f32 67 TFLOP/s (bound_tf32_ms: 495)",
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


def encoder_run(torch, dev, activation, counters=None):
    """One post-norm ``TransformerEncoderLayer`` at GPT-2 width (768, 12
    heads, FFN 3072), batch 8 x seq 1024, dropout 0.1, with a trained
    ``attn_mask`` [1, 12, 1024, 1024], forward and backward through the
    kernels, then through the plain composition from the same generator
    seed.  With ``counters``, their launches count the kernel route alone.
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rng_guard(torch.Generator(device=dev).manual_seed(SEED + 7)):
            out = layer(x, bias)
            grads = torch.autograd.grad((out * ct).sum(), params)
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
    return {"wall": wall, "launches": launches, "seen": seen,
            "dbias": grads[0], "want": want, "out": out,
            "want_out": want_out, "flips": int(flipped.sum()),
            "flipped_rows": flipped.any(-1).any(0), "finite": finite}


def encoder_bias_phase(torch, dev, table):
    """The post-norm ``TransformerEncoderLayer`` with a trained bias
    (``encoder_run``), at the layer's default ReLU: the add+norm kernel's
    LayerNorm body (#9, twice: norm1 and norm2), the flash forward, dQ,
    dK/dV and the bias gradient (#2-#5, once each) launch; #5's result
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
                "flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "flash_attention_dbias": fa.flash_attention_bwd_dbias}
    expect = {"add_layer_norm": 2, "flash_attention_fwd": 1,
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
    gelu = encoder_run(torch, dev, "gelu")
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
                          "fused_update", "add_norm", "matmul_rope",
                          "grouped_matmul", "paged_decode_attention"])
    for name, rep in built.items():
        print(f"--- ptxas report, {name}\n{rep['ptxas']}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": {n: r["seconds"] for n, r in built.items()}})

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
    bound, bound_by = bound_ms(n_bytes, flops)
    table["ragged_paged_append_attend"] = {
        "name": "ragged_paged_append_attend", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:912",
        "max_abs_err": err,
        "ms": timed_ms(torch, lambda: ragged(
            pa.ragged_paged_append_attend, kp_k, vp_k), 20),
        "plain_ms": timed_ms(torch, lambda: ragged(
            pa.ragged_paged_append_attend_reference, kp_p, vp_p), 5),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    emit({"phase": "kernel", **table["ragged_paged_append_attend"],
          "tolerance": TOL})
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
        "library_ms": timed_ms(torch, library, 20)}
    emit({"phase": "kernel", **table["flash_attention_fwd"],
          "lse_max_abs_err": lse_err, "tolerance": TOL})
    del args, out, lse, ref_out, ref_lse, qt, kt, vt, mask_b

    flash_train_kernels(torch, gen, dev, table)
    dropout_kernels(torch, gen, dev, table)
    dbias_kernels(torch, gen, dev, table)
    update_kernel(torch, gen, dev, table)
    add_norm_kernel(torch, gen, dev, table)
    matmul_rope_kernel(torch, np, gen, dev, table)
    group1_kernels(torch, gen, dev)
    moe_kernels(torch, gen, dev, table)
    decode_kernels(torch, gen, dev, table)
    ragged_int8_kernel(torch, gen, dev, table)
    torch.cuda.empty_cache()

    # -- serve Llama-3-8B through the engine's entry points
    cfg = llama3_8b_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128)
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
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # -- the same model on the split path and with int8 pools and weights
    quant_serve_phases(torch, np, dev, table, model, prompts, pool_bytes)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    serve_quant_reference(torch, np, dev)

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

    emit({"kernels": [table[n] for n in (
        "ragged_paged_append_attend", "flash_attention_fwd",
        "flash_attention_fwd_causal_8k", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "flash_attention_fwd_dropout",
        "flash_attention_bwd_dq_dropout", "flash_attention_bwd_dkv_dropout",
        "flash_attention_dbias", "fused_update", "add_norm",
        "add_layer_norm", "matmul_rope", "grouped_matmul",
        "grouped_matmul_glu", "grouped_matmul_dw", "paged_attention",
        "paged_decode_append_attend", "ragged_paged_append_attend_int8")]})
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
