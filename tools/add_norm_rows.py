#!/usr/bin/env python3
"""#9 (add + norm) at its paths' shapes, forward and backward, and the
paths it runs on, for the tree at ``--root`` (default: this checkout).

    python3 tools/add_norm_rows.py [--root DIR] [--paths [PHASES]]

Run on a machine with a CUDA GPU.  ``--root`` names the root of a
checkout whose ``paddle_tpu_torch`` and ``chip_smoke.py`` are measured,
so one call can time a parent commit unpacked beside this one (``git
archive`` into a directory that ``.gitignore`` lists) with this script.
It uses only what every tree since #9's port has: the forward wrappers,
their plain versions and autograd, so a parent whose backward is the
plain chain is timed the same way as a kernel.

For each shape (Llama's RMS bf16 [1, 8192, 4096] with h's own gradient,
BERT's LN bf16 [16, 512, 768] with a bias and no dh, the post-norm
encoder's LN f32 [8, 1024, 768] with a bias and no dh) it prints one
JSON line: the forward's CUDA-event ms and traced device ms, the
backward's (one ``torch.autograd.grad`` on a retained graph: every
kernel it launches, the ``kernels`` a call), and the host microseconds
a call of each at a one-block shape (1000 calls, none synchronised).
A last line gives the host microseconds a call of the other functions
on a host-bound training step's path, the same way: a bf16 ``Linear``
of 768 forward, and ``F.cross_entropy`` with ``ignore_index`` over
[64, 1000] bf16 logits.  ``--paths`` runs instead ``chip_smoke.py``'s
``train_fused`` and ``train_bert`` phases of that tree (their step
times, peak memory, launches and traced families), or those of the
comma-separated ``PHASES``.  It checks nothing: ``chip_smoke.py`` is the
check.
"""
import argparse
import collections
import json
import sys
import time
from pathlib import Path

SHAPES = (("llama_rms_bf16", (1, 8192, 4096), "bf16", False, True),
          ("bert_ln_bf16", (16, 512, 768), "bf16", True, False),
          ("encoder_ln_f32", (8, 1024, 768), "f32", True, False))


def row(torch, cs, ft, dev, name, shape, dt, ln, dh_on):
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    hdim = shape[-1]

    def inputs(shp):
        x, r = (torch.randn(shp, generator=gen, device=dev, dtype=dt)
                .requires_grad_() for _ in range(2))
        w = (1 + 0.1 * torch.randn(hdim, generator=gen, device=dev)).to(
            dt).requires_grad_()
        b = (0.1 * torch.randn(hdim, generator=gen, device=dev)).to(
            dt).requires_grad_() if ln else None
        return x, r, w, b

    def fwd(x, r, w, b):
        return ft.add_layer_norm_raw(x, r, w, b, 1e-5) if ln else \
            ft.add_rms_norm_raw(x, r, w, 1e-5)

    def graph(shp):
        x, r, w, b = inputs(shp)
        h, y = fwd(x, r, w, b)
        outs, cts = [y], [torch.randn_like(y)]
        if dh_on:
            outs.append(h)
            cts.append(torch.randn_like(h))
        leaves = [t for t in (x, r, w, b) if t is not None]
        return lambda: torch.autograd.grad(outs, leaves, cts,
                                           retain_graph=True)

    x, r, w, b = inputs(shape)
    with torch.no_grad():
        out = {"name": name, "shape": list(shape), "dtype": str(dt),
               "fwd_ms": cs.timed_ms(torch, lambda: fwd(x, r, w, b), 20),
               "fwd_device_ms": cs.traced_kernel(
                   torch, lambda: fwd(x, r, w, b), "add_norm")["device_ms"]}
        xs, rs, ws, bs = inputs((1, 8, hdim))
        out["fwd_host_us"] = host_us(torch, lambda: fwd(xs, rs, ws, bs))
    del x, r
    bwd = graph(shape)
    out["bwd_ms"] = cs.timed_ms(torch, bwd, 20)
    _, prof = cs.profiled(torch, lambda: [bwd() for _ in range(3)])
    out["bwd_device_ms"] = prof["device_busy_ms"] / 3
    out["bwd_kernels"] = sum(prof["kernel_count_by_family"].values()) / 3
    out["bwd_families"] = prof["kernel_ms_by_family"]
    out["bwd_top_kernels"] = prof["top_kernels"][:4]
    del bwd
    out["bwd_host_us"] = host_us(torch, graph((1, 8, hdim)))
    out["launches"] = {k: getattr(ft, k).launches for k in (
        "add_rms_norm_raw", "add_layer_norm_raw",
        "add_rms_norm_backward_raw", "add_layer_norm_backward_raw")
        if hasattr(ft, k)}
    print(json.dumps(out), flush=True)
    torch.cuda.empty_cache()


def host_us(torch, fn, calls=1000):
    """``chip_smoke.host_us``, which a parent tree may lack."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def other_host_us(torch, dev):
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.common import Linear
    lin = Linear(768, 768, device=dev).to(torch.bfloat16)
    x = torch.randn(1, 8, 768, device=dev, dtype=torch.bfloat16)
    logits = torch.randn(64, 1000, device=dev, dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (64,), device=dev)
    labels[::4] = -100
    with torch.no_grad():
        out = {"name": "host_us",
               "linear_fwd": host_us(torch, lambda: lin(x)),
               "cross_entropy": host_us(torch, lambda: F.cross_entropy(
                   logits, labels, ignore_index=-100))}
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--paths", nargs="?", const="train_fused,train_bert")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("add_norm_rows: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_train as ft
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(names)
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "build_s": time.perf_counter() - t0}), flush=True)
    if not args.paths:
        for spec in SHAPES:
            row(torch, cs, ft, dev, *spec)
        other_host_us(torch, dev)
    else:
        table = collections.defaultdict(dict)
        phases = args.paths.split(",")
        if "train_fused" in phases:
            cs.train_phase(torch, np, dev, table, phase="train_fused",
                           layers=cs.FUSED_LAYERS, fused=True)
            torch.cuda.empty_cache()
        if "train_bert" in phases:
            cs.train_bert_phase(torch, np, dev, table, {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
