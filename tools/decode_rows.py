#!/usr/bin/env python3
"""The split decode kernels' rows (#7, #6) and the f32 dropout backward
rows (#4's dK/dV, #3's dQ) and #5's f32 row alone, as ``chip_smoke.py``
builds them.

    python3 tools/decode_rows.py [--decode-only | --dkv-only | --dq-only
                                  | --dbias-only]

Run from the root of a checkout (or of a copy holding a variant of
``paddle_tpu_torch/csrc/paged_decode_attention.cu``,
``flash_attention_bwd.cu`` or ``flash_attention_dbias.cu``; the script
reads nothing of the checkout beyond ``chip_smoke.py``'s case builders)
on a machine with a CUDA GPU.  At the split serve's decode shape
(``chip_smoke.decode_case``) it holds #7 and #6 against their plain
versions in five modes (bf16 pools at GQA group 4 and 1, int8 pools at
group 4 and 1, f32 q over bf16 pools); at GPT-2's training attention
([8, 1024, 12, 64] f32, causal, dropout 0.1) the dK/dV and the dQ
kernels against the plain backward; and at the trained bias of
``encoder_bias`` ([1, 12, 1024, 1024] over that attention) the bias
gradient against its plain version.  It prints a JSON line each:
CUDA-event ms, the traced device ms a call of the kernel's family, the
names of the traced kernels, the bound, the errors and whether two
launches give the same bits (decode: whether the pools equal the plain
version's).  With no option it runs every row; an option runs its rows
alone.  It checks nothing: ``chip_smoke.py`` is the check.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

DECODE_MODES = (("bf16_g4", 32, 8, False, torch.bfloat16),
                ("bf16_g1", 16, 16, False, torch.bfloat16),
                ("int8_g4", 32, 8, True, torch.bfloat16),
                ("int8_g1", 16, 16, True, torch.bfloat16),
                ("f32q_bf16p_g4", 32, 8, False, torch.float32))


def traced(fn, family, calls=3):
    """Device ms a call of ``family``'s kernels and their names."""
    _, prof = cs.profiled(torch, lambda: [fn() for _ in range(calls)])
    names = [n for n in prof["routed_kernel_ms"]
             if cs.kernel_family(n) == family] or [
        t["name"] for t in prof["top_kernels"]
        if cs.kernel_family(t["name"]) == family]
    return (prof["kernel_ms_by_family"].get(family, 0.0) / calls,
            prof["kernel_count_by_family"].get(family, 0), names)


def decode_rows(dev, gen):
    for name, H, KVH, int8, qdt in DECODE_MODES:
        q, kn, vn, pools, tables, lens = cs.decode_case(torch, gen, dev, H,
                                                        KVH, int8)
        q, kn, vn = q.to(qdt), kn.to(qdt), vn.to(qdt)
        for kname, fn, plain, new in (
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
            equal = all(a is None or torch.equal(a, b)
                        for a, b in zip(mine, ref))
            ms = cs.timed_ms(torch, lambda: call(fn, mine), 50)
            dev_ms, count, names = traced(lambda: call(fn, mine),
                                          "paged_decode")
            el_q = 4 if qdt == torch.float32 else 2
            bound = cs.bound_ms(*cs.decode_cost(H, KVH, int8, bool(new),
                                                el_q=el_q))
            print(json.dumps({"name": f"{kname}_{name}", "ms": ms,
                              "device_ms": dev_ms, "traced_count": count,
                              "kernels": names, "bound_ms": bound[0],
                              "bound_by": bound[1], "max_abs_err": err,
                              "pools_equal": equal}), flush=True)
        del q, kn, vn, pools, mine, ref, got, want
        torch.cuda.empty_cache()


def gpt_attention(dev, gen):
    """GPT-2's training attention: q, k, v, dO [8, 1024, 12, 64] f32, the
    seed and keyword arguments of its dropout."""
    b, s, h, d = cs.GPT_BATCH, cs.GPT_SEQ, cs.GPT_HEADS, \
        cs.GPT_WIDTH // cs.GPT_HEADS
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   for _ in range(4))
    seed = torch.tensor(cs.SEED + 11, dtype=torch.int64, device=dev)
    return (q, k, v, do), seed, dict(causal=True, dropout_p=cs.GPT_DROP,
                                     seed=seed)


def bwd_row(dev, gen, key):
    """#4's dK/dV (``key`` "dkv") or #3's dQ ("dq") at GPT-2's dropout
    attention."""
    (q, k, v, do), seed, kw = gpt_attention(dev, gen)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    launch = fa.flash_attention_bwd_dkv if key == "dkv" \
        else fa.flash_attention_bwd_dq

    def fn():
        got = launch(*ops, True, cs.GPT_DROP, seed)
        return got if key == "dkv" else (got,)
    got = fn()
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    want = want[1:] if key == "dkv" else want[:1]
    torch.cuda.synchronize()
    names = ("dk", "dv") if key == "dkv" else ("dq",)
    errs = {n: {"rel_l2_err": cs.rel_l2(g, w), "rel_err": cs.rel_err(g, w)}
            for n, g, w in zip(names, got, want)}
    again = fn()
    torch.cuda.synchronize()
    flops, n_bytes = cs.attention_cost(*q.shape[:3], k.shape[2],
                                       q.shape[3], 4)[key]
    ms = cs.timed_ms(torch, fn, 10)
    dev_ms, count, kernels = traced(fn, f"flash_bwd_{key}")
    print(json.dumps({"name": f"flash_attention_bwd_{key}_dropout",
                      "ms": ms, "device_ms": dev_ms, "traced_count": count,
                      "kernels": kernels,
                      **cs.f32_bounds(n_bytes, flops, tensor_cores=True),
                      "errors": errs,
                      "bit_identical": all(torch.equal(a, b)
                                           for a, b in zip(again, got))}),
          flush=True)


def dbias_row(dev, gen):
    """#5 at ``encoder_bias``'s bias [1, 12, 1024, 1024] over GPT-2's
    dropout attention."""
    (q, k, v, do), seed, kw = gpt_attention(dev, gen)
    b, s, h, d = q.shape
    bias = 0.5 * torch.randn((1, h, s, s), generator=gen, device=dev)
    out, lse = fa.flash_attention_fwd(q, k, v, mask=bias, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, bias)

    def fn():
        return fa.flash_attention_bwd_dbias(*ops[:6], bias, True,
                                            cs.GPT_DROP, seed)
    got = fn()
    want = fa.flash_attention_dbias_reference(q, k, v, out, lse, do, bias,
                                              **kw)
    again = fn()
    torch.cuda.synchronize()
    flops, n_bytes = cs.dbias_cost(b, s, h, d)
    ms = cs.timed_ms(torch, fn, 10)
    dev_ms, count, kernels = traced(fn, "flash_dbias")
    print(json.dumps({"name": "flash_attention_dbias", "ms": ms,
                      "device_ms": dev_ms, "traced_count": count,
                      "kernels": kernels,
                      **cs.f32_bounds(n_bytes, flops, tensor_cores=True),
                      "errors": {"rel_l2_err": cs.rel_l2(got, want),
                                 "rel_err": cs.rel_err(got, want)},
                      "bit_identical": torch.equal(again, got)}),
          flush=True)


ROWS = {"--decode-only": decode_rows,
        "--dkv-only": lambda dev, gen: bwd_row(dev, gen, "dkv"),
        "--dq-only": lambda dev, gen: bwd_row(dev, gen, "dq"),
        "--dbias-only": dbias_row}


def main():
    if not torch.cuda.is_available():
        print("decode_rows: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    chosen = [opt for opt in ROWS if opt in sys.argv[1:]] or list(ROWS)
    for opt in chosen:
        ROWS[opt](dev, gen)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
