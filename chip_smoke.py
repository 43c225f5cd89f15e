#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA GPU, the
CUDA toolkit (nvcc) and PyTorch built for CUDA.  It builds the port's
kernels from ``paddle_tpu_torch/csrc``, holds each against its plain
PyTorch version at the serving path's full-width shapes, then serves
Llama-3-8B (full width, 32 layers, bf16, random weights from a seeded
generator) through ``LLMEngine`` and checks that the serving path went
through both kernels.  Each phase prints one JSON line; the last three
lines are the kernel table, the card's name and power limit as
nvidia-smi reports them, and ``{"ok": true, ...}``.  Any failed phase
exits non-zero before the ``ok`` line.  Without a CUDA device it exits
non-zero at once.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 tensor-core rate, for the least time the card could take
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
TOL = 2e-2          # bf16 outputs: one rounding of values of order 1
SEED = 0


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


def bound_ms(n_bytes, flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def ragged_case(torch, gen, dev):
    """The unified step's shapes at Llama-3-8B width: T = S = 136 rows
    (max_seqs 8 + prefill budget 128), P 128, KVH 8, H 32, D 128: four
    decode rows at mixed lengths, one 128-row chunk, and one prompt split
    over two descriptors at a page boundary."""
    T, P, KVH, H, D, maxp = 136, 128, 8, 32, 128, 16
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


def flash_case(torch, gen, dev):
    """The synchronous prefill chunk at Llama-3-8B width: q [1, 128, 32,
    128] against the sequence's gathered pages [1, 2048, 8, 128] (strided
    views, as the engine passes them) under the f32 position mask
    [1, 1, 128, 2048] of chunk 7 of a 1000-token prompt."""
    P, H, KVH, D, maxp, prev = 128, 32, 8, 128, 16, 896
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


def dense_reference_logits(torch, model, ids):
    """Last-position logits of a plain causal forward (no pages, no
    kernels: the flash plain version on the whole prompt)."""
    from paddle_tpu_torch.models.llama import _rotate_half
    from paddle_tpu_torch.ops import _nn
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_fwd_reference
    c = model.config
    hd = c.hidden_size // c.num_attention_heads
    n = ids.shape[0]
    lm = model.llama
    cos = lm.rope_cos[:n][:, None, :]
    sin = lm.rope_sin[:n][:, None, :]

    def rope(x):
        xf = x.float()
        return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)

    x = lm.embed_tokens.weight[ids]
    with torch.no_grad():
        for layer in lm.layers:
            a, m = layer.self_attn, layer.mlp
            hn = _nn.rms_norm(x, layer.input_layernorm.weight,
                              epsilon=c.rms_norm_eps)
            q = rope((hn @ a.q_proj.weight).view(n, -1, hd))
            k = rope((hn @ a.k_proj.weight).view(n, -1, hd))
            v = (hn @ a.v_proj.weight).view(n, -1, hd)
            o = flash_attention_fwd_reference(q[None], k[None], v[None],
                                              causal=True)[0][0]
            x = x + o.reshape(n, -1) @ a.o_proj.weight
            hn = _nn.rms_norm(x, layer.post_attention_layernorm.weight,
                              epsilon=c.rms_norm_eps)
            x = x + (_nn.silu(hn @ m.gate_proj.weight)
                     * (hn @ m.up_proj.weight)) @ m.down_proj.weight
        x = _nn.rms_norm(x, lm.norm.weight, epsilon=c.rms_norm_eps)
        return x[-1] @ model.lm_head.weight


def kernel_family(name):
    for key, fam in (("ragged_attend", "ragged_attend"),
                     ("ragged_append", "ragged_append"),
                     ("flash_fwd", "flash_fwd")):
        if key in name:
            return fam
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "gemv", "sm90")):
        return "matmul"
    return "other"


def profile_serve(torch, eng, prompts, max_new):
    """Serve ``prompts`` (deferred admission) under torch.profiler and
    return the wall time, the summed kernel time by family, and the
    device's idle share of the wall time (one stream: kernels do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rid, ids in prompts.items():
            eng.begin_request(rid, ids, max_new_tokens=max_new)
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
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
    return {"wall_ms": wall_ms, "steps": steps,
            "device_busy_ms": busy if busy else None,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "kernel_ms_by_family": fams,
            "top_kernels": [{"ms": ms, "name": n, "count": c}
                            for ms, n, c in top[:8]]}


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
    built = _build.build(["ragged_paged_attention", "flash_attention_fwd"])
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
    lens = {"b37": 37, "b128": 128, "b300": 300, "b1000": 1000,
            "a200": 200}
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).tolist()
               for rid, n in lens.items()}
    max_new = 32

    torch.cuda.reset_peak_memory_stats()
    pa.ragged_paged_append_attend.launches = 0
    fa.flash_attention_fwd.launches = 0
    t_serve = time.perf_counter()
    submit, ttft, toks = {}, {}, {rid: [] for rid in prompts}
    for rid in ("b37", "b128", "b300", "b1000"):
        submit[rid] = time.perf_counter()
        eng.begin_request(rid, prompts[rid], max_new_tokens=max_new)
    submit["a200"] = time.perf_counter()
    eng.add_request("a200", prompts["a200"], max_new_tokens=max_new)
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
    launches = {"ragged_paged_append_attend":
                pa.ragged_paged_append_attend.launches,
                "flash_attention_fwd": fa.flash_attention_fwd.launches}
    results = {rid: eng.result(rid) for rid in prompts}
    emit({"phase": "serve", "model": "llama3_8b", "layers":
          cfg.num_hidden_layers, "dtype": "bfloat16",
          "weight_bytes": weight_bytes, "kv_pool_bytes": pool_bytes,
          "setup_s": setup_s, "serve_s": serve_s, "steps": steps,
          "prompt_lens": lens,
          "tokens": {rid: len(v) for rid, v in results.items()},
          "ttft_s": ttft, "decode_steps": decode_steps,
          "decode_tok_s": decode_tokens / decode_s if decode_s else None,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    for rid, out in results.items():
        check(len(out) == max_new and out == toks[rid],
              f"request {rid} returned {len(out)} tokens, not {max_new}")
        check(all(0 <= t < cfg.vocab_size for t in out),
              f"request {rid} returned a token outside the vocabulary")
    for name, n in launches.items():
        check(n > 0, f"the serving path never launched {name}")
        table[name]["launches"] = n

    # -- what comes out agrees with a dense plain forward (no pages, no
    # kernels).  f32 at full width, depth cut to 2 layers: the kernels
    # and their plain versions agree to f32 rounding, so logits must
    # match closely and greedy tokens exactly, through both admission
    # paths.  bf16 at full depth: roundings compound over 32 random
    # layers, so only a coarse bound (0.2 relative L2) catches gross
    # errors there.
    ids = prompts["b37"]
    cfg32 = dataclasses.replace(cfg, num_hidden_layers=2)
    model32 = LlamaForCausalLM(
        cfg32, device=dev, dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    eng32 = LLMEngine(model32, max_seqs=8, max_len=2048, page_size=128)
    rep = {"prompt_len": len(ids)}
    for name, m, e, tol in (("f32_2_layers", model32, eng32, 1e-4),
                            ("bf16_32_layers", model, eng, 0.2)):
        slot = e.cache.allocate(len(ids) + 1)
        got = e._prefill_seq(slot, ids, 0).float()       # flash kernel
        e.cache.release(slot)
        want = dense_reference_logits(torch, m, torch.tensor(
            ids, device=dev)).float()
        check(bool(torch.isfinite(got).all()), f"{name}: logits not finite")
        rel = ((got - want).norm() / want.norm()).item()
        rep[name] = {"logits_rel_l2_err": rel, "tolerance": tol,
                     "argmax_equal": int(got.argmax()) == int(want.argmax())}
        check(rel <= tol, f"{name}: prefill logits off a dense forward "
                          f"by {rel} (relative L2)")
    want_toks, seq = [], list(ids)
    for _ in range(4):
        tok = int(dense_reference_logits(torch, model32, torch.tensor(
            seq, device=dev)).argmax())
        want_toks.append(tok)
        seq.append(tok)
    eng32.begin_request("r", ids, max_new_tokens=4)      # ragged kernel
    while eng32.has_work():
        eng32.step()
    rep["f32_2_layers"]["greedy_tokens_equal"] = \
        eng32.result("r") == want_toks
    emit({"phase": "reference", **rep})
    check(rep["f32_2_layers"]["greedy_tokens_equal"],
          f"greedy tokens {eng32.result('r')} != dense {want_toks}")
    del eng32, model32

    # -- where a serving step's time goes: the same mix, traced
    # (fresh prompts of the same lengths: no prefix-cache hits)
    prof = profile_serve(torch, eng, {
        f"p{rid}": rng.integers(0, cfg.vocab_size, n).tolist()
        for rid, n in lens.items()}, max_new=8)
    emit({"phase": "profile", **prof})

    emit({"kernels": [table[n] for n in ("ragged_paged_append_attend",
                                         "flash_attention_fwd")]})
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
