#!/usr/bin/env python3
"""#1's kernel rows alone, as ``chip_smoke.py`` builds them.

    python3 tools/ragged_rows.py

Run from the root of a checkout (or of a copy holding a variant of
``paddle_tpu_torch/csrc/ragged_paged_attention.cu``) on a machine with
a CUDA GPU.  At the unified step's shapes (``chip_smoke.ragged_case``)
it holds the ragged kernel against its plain version in five modes
(bf16 at GQA group 4 and 1, int8 pools, f32 q over bf16 pools, bf16 q
over f32 pools) and prints a JSON line each: CUDA-event ms, the traced
device ms of the append and attention kernels (``chip_smoke.ragged_row``),
the bound, the largest error, whether the pools equal the plain
version's, and the traced kernels a call.  It checks nothing beyond the
design label: ``chip_smoke.py`` is the check.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

MODES = (("bf16_g4", 32, 8, torch.bfloat16, torch.bfloat16),
         ("bf16_g1", 16, 16, torch.bfloat16, torch.bfloat16),
         ("int8_g4", 32, 8, torch.bfloat16, "int8"),
         ("f32q_bf16p", 32, 8, torch.float32, torch.bfloat16),
         ("bf16q_f32p", 32, 8, torch.bfloat16, torch.float32))


def main():
    if not torch.cuda.is_available():
        print("ragged_rows: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    el = {torch.float32: 4, torch.bfloat16: 2}
    for name, H, KVH, qdt, pdt in MODES:
        args, n_bytes, flops = cs.ragged_case(torch, gen, dev, H=H, KVH=KVH)
        for n in ("q", "k_new", "v_new"):
            args[n] = args[n].to(qdt)
        pools = [args.pop(n) for n in ("k_pages", "v_pages")]
        if pdt == "int8":
            pools = list(cs.int8_pools(pools))
            design = "3xtf32"
            n_bytes = cs.ragged_bytes(el[qdt], 1, H, KVH, int8=True)
        else:
            pools = [p.to(pdt) for p in pools]
            design = "mma" if pdt == qdt else "3xtf32"
            n_bytes = cs.ragged_bytes(el[qdt], el[pdt], H, KVH)
        mine = [p.clone() for p in pools]
        ref = [p.clone() for p in pools]

        def call(fn, ps):
            return fn(args["q"], ps[0], ps[1], args["k_new"], args["v_new"],
                      args["q_start"], args["q_len"], args["kv_len"],
                      args["page_tables"], *ps[2:])
        got = call(pa.ragged_paged_append_attend, mine)
        want = call(pa.ragged_paged_append_attend_reference, ref)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        row = cs.ragged_row(torch, name, lambda: call(
            pa.ragged_paged_append_attend, mine), lambda: want, err,
            cs.bound_ms(n_bytes, flops), design)
        _, prof = cs.profiled(torch, lambda: [call(
            pa.ragged_paged_append_attend, mine) for _ in range(3)])
        print(json.dumps({"name": name, "ms": row["ms"],
                          "device_ms": row["device_ms"],
                          "bound_ms": row["bound_ms"], "max_abs_err": err,
                          "pools_equal": all(torch.equal(a, b)
                                             for a, b in zip(mine, ref)),
                          "top_kernels": prof["top_kernels"][:4]}),
              flush=True)
        del args, pools, mine, ref, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
