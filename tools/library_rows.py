#!/usr/bin/env python3
"""Kernel rows beside their one-call library versions, for routes that
``chip_smoke.py``'s kernel table does not time.

    python3 tools/library_rows.py

Run from the root of a checkout on a machine with a CUDA GPU.  Rows:

- ``fused_update_gpt2_wte``: the fused clip + AdamW update (#8) on GPT-2
  124M's largest leaf, the tied embedding [50304, 768], f32 parameter,
  gradient and moments, lr 1e-4, step 3, weight decay 0.01, clip scale
  0.5, against one ``torch._fused_adamw_`` call with the clip passed as
  ``grad_scale`` (PyTorch divides the gradient by it: 1 / 0.5);
- ``flash_attention_bwd_dq_f32_d128`` and ``..._dkv_f32_d128``: #3 and
  #4's f32 route at head_dim 128 (the FMA-pipe kernels) at the f32
  checks' attention, q [1, 1024, 32, 128] against 8 kv heads, causal,
  against ``scaled_dot_product_attention``'s backward (dq, dk, dv);
- ``flash_attention_dbias_f32_d128``: #5 over that attention with a
  trained bias [1, 32, 1024, 1024] f32;
- ``flash_attention_dbias_bf16``: #5 for 16-bit inputs at GPT-2's
  attention [8, 1024, 12, 64] bf16 with a bias [1, 12, 1024, 1024];
  both against SDPA's backward with an ``attn_mask`` that requires grad
  (dq, dk, dv and the bias gradient).

Each prints a JSON line: CUDA-event ms, the traced device ms a call of
the kernel's family, the plain version's ms, ``bound_ms`` (bytes at
3.35 TB/s or operations at the f32 FMA rate, 67 TFLOP/s, or bf16's),
the library's ms and the error against the plain version.  It checks
nothing: ``chip_smoke.py`` is the check.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import fused_train as ft  # noqa: E402

GPT_WTE = (50304, 768)
CLIP = 0.5


def traced_ms(fn, family, calls=3):
    _, prof = cs.profiled(torch, lambda: [fn() for _ in range(calls)])
    return prof["kernel_ms_by_family"].get(family, 0.0) / calls


def update_row(dev, gen):
    p = torch.randn(GPT_WTE, generator=gen, device=dev) * 0.02
    g = torch.randn(GPT_WTE, generator=gen, device=dev) * 1e-3
    m = torch.randn(GPT_WTE, generator=gen, device=dev) * 1e-4
    v = torch.rand(GPT_WTE, generator=gen, device=dev) * 1e-7
    hyper = {"weight_decay": 0.01, "decoupled": True, "beta1": 0.9,
             "beta2": 0.999, "epsilon": 1e-8}
    scal = torch.tensor([1e-4, 3.0, CLIP], device=dev)
    slots = {"moment1": m.clone(), "moment2": v.clone()}

    def kernel():
        ft.fused_update_flat("adam", p, g, slots, scalars=scal,
                             has_clip=True, hyper=hyper)

    def plain():
        return ft.fused_update_reference(
            "adam", p, g, slots, lr=scal[0], step_f=scal[1],
            clip_scale=scal[2], hyper=hyper)

    lp, lm, lv = p.clone(), m.clone(), v.clone()
    step = torch.tensor(3.0, device=dev)
    scale = torch.tensor(1.0 / CLIP, device=dev)

    def library():
        torch._fused_adamw_([lp], [g], [lm], [lv], [], [step], lr=1e-4,
                            beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False,
                            grad_scale=scale, found_inf=None)

    # one update of each from the same state, to compare what they compute
    p0 = p.clone()
    want_p, _ = plain()
    kernel()
    library()
    torch.cuda.synchronize()
    row = {"name": "fused_update_gpt2_wte", "shape": list(GPT_WTE),
           "dtype": "float32", "max_abs_err": (p - want_p).abs().max().item(),
           "library_vs_kernel_max_abs_diff": (lp - p).abs().max().item(),
           "param_max_abs_step": (p - p0).abs().max().item()}
    n = p.numel()
    # 28 bytes an element: p read and written, g read, two moments read
    # and written, all f32
    row["bound_ms"], row["bound_by"] = cs.bound_ms(
        28 * n, ft.update_flop_estimate("adam", n, has_clip=True),
        peak=cs.PEAK_F32_FLOPS)
    row["ms"] = cs.timed_ms(torch, kernel, 20)
    row["device_ms"] = traced_ms(kernel, "fused_update")
    row["plain_ms"] = cs.timed_ms(torch, plain, 3, warmup=1)
    row["library_ms"] = cs.timed_ms(torch, library, 20)
    row["library_note"] = ("torch._fused_adamw_, the clip as grad_scale "
                           f"(1 / {CLIP})")
    print(json.dumps(row), flush=True)


def sdpa_backward(q, k, v, do, bias=None):
    """One timed callable: SDPA's backward on a graph kept for repeated
    calls (K/V repeated to q's heads)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt, vt = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))
    ins = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    kw = {"is_causal": True}
    if bias is not None:
        ins.append(bias.detach().to(q.dtype).requires_grad_())
        kw = {"attn_mask": ins[3] + torch.full(
            bias.shape[-2:], float("-inf"), device=q.device,
            dtype=q.dtype).triu(1)}
    out = sdpa(*ins[:3], **kw)

    def fn():
        torch.autograd.grad(out, ins, dot, retain_graph=True)
    return fn


def attention(dev, gen, b, s, h, hk, d, dtype):
    q, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


def bwd_rows(dev, gen):
    """#3 and #4 at the f32 checks' attention (head_dim 128)."""
    b, s, h, hk, d = 1, 1024, 32, 8, 128
    q, k, v, do = attention(dev, gen, b, s, h, hk, d, torch.float32)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=True)
    cost = cs.attention_cost(b, s, h, hk, d, 4)
    library = sdpa_backward(q, k, v, do)
    for key, fn, outs in (
            ("dq", lambda: (fa.flash_attention_bwd_dq(*ops, True),),
             want[:1]),
            ("dkv", lambda: fa.flash_attention_bwd_dkv(*ops, True),
             want[1:])):
        got = fn()
        torch.cuda.synchronize()
        flops, n_bytes = cost[key]
        row = {"name": f"flash_attention_bwd_{key}_f32_d128",
               "shape": [b, s, h, d], "kv_heads": hk, "dtype": "float32",
               "rel_l2_err": max(cs.rel_l2(g, w) for g, w in zip(got, outs)),
               "max_abs_err": max((g - w).abs().max().item()
                                  for g, w in zip(got, outs)),
               **cs.f32_bounds(n_bytes, flops, tensor_cores=False),
               "ms": cs.timed_ms(torch, fn, 10),
               "device_ms": traced_ms(fn, f"flash_bwd_{key}"),
               "plain_ms": cs.timed_ms(
                   torch, lambda: fa.flash_attention_bwd_reference(
                       q, k, v, out, lse, do, causal=True), 3, warmup=1),
               "library_ms": cs.timed_ms(torch, library, 10),
               "library_note": "scaled_dot_product_attention's backward "
                               "(dq, dk, dv), f32"}
        print(json.dumps(row), flush=True)


def dbias_row(dev, gen, name, b, s, h, hk, d, dtype):
    """#5 over a causal attention with a bias [1, h, s, s]."""
    q, k, v, do = attention(dev, gen, b, s, h, hk, d, dtype)
    bias = 0.5 * torch.randn((1, h, s, s), generator=gen, device=dev)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, mask=bias)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, bias)

    def fn():
        return fa.flash_attention_bwd_dbias(*ops[:6], bias, True)
    got = fn()
    want = fa.flash_attention_dbias_reference(q, k, v, out, lse, do, bias,
                                              causal=True)
    torch.cuda.synchronize()
    el = q.element_size()
    pairs = b * cs.causal_pairs(s)
    # q and dO, k and v read once, lse and delta, the f32 bias read and
    # its gradient written
    n_bytes = (2 * b * s * h * d + 2 * b * s * hk * d) * el \
        + 2 * b * h * s * 4 + 2 * h * s * s * 4
    flops = 4 * d * h * pairs
    if dtype == torch.float32:
        bounds = cs.f32_bounds(n_bytes, flops, tensor_cores=False)
    else:
        bound, by = cs.bound_ms(n_bytes, flops)
        bounds = {"bound_ms": bound, "bound_by": by}
    row = {"name": name, "shape": [b, s, h, d], "kv_heads": hk,
           "dtype": str(dtype).split(".")[-1], "bias": [1, h, s, s],
           "rel_l2_err": cs.rel_l2(got, want),
           "max_abs_err": (got - want).abs().max().item(), **bounds,
           "ms": cs.timed_ms(torch, fn, 10),
           "device_ms": traced_ms(fn, "flash_dbias"),
           "plain_ms": cs.timed_ms(
               torch, lambda: fa.flash_attention_dbias_reference(
                   q, k, v, out, lse, do, bias, causal=True), 3, warmup=1),
           "library_ms": cs.timed_ms(torch, sdpa_backward(q, k, v, do,
                                                          bias), 10),
           "library_note": "scaled_dot_product_attention's backward with "
                           "an attn_mask that requires grad (dq, dk, dv, "
                           "dbias), causal mask folded into it"}
    print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        print("library_rows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    update_row(dev, gen)
    torch.cuda.empty_cache()
    bwd_rows(dev, gen)
    torch.cuda.empty_cache()
    dbias_row(dev, gen, "flash_attention_dbias_f32_d128", 1, 1024, 32, 8,
              128, torch.float32)
    torch.cuda.empty_cache()
    dbias_row(dev, gen, "flash_attention_dbias_bf16", cs.GPT_BATCH,
              cs.GPT_SEQ, cs.GPT_HEADS, cs.GPT_HEADS,
              cs.GPT_WIDTH // cs.GPT_HEADS, torch.bfloat16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
