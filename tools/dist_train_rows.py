#!/usr/bin/env python3
"""``chip_smoke.py``'s ``dist_train`` phase alone (GPT-2 124M through the
port's launcher over NCCL, ZeRO stages 1-3 against the unsharded step),
for the tree at ``--root`` (default: this checkout).

    python3 tools/dist_train_rows.py [--root DIR] [--with-train-gpt2]

Run on a machine with a CUDA GPU.  It builds the kernels the phase
launches (one ``nvcc`` a source, all started together), optionally runs
``train_gpt2`` first (so the phase prints its step time beside the
gang's), then the phase with ``chip_smoke.py``'s own checks: a failed
check exits non-zero.  The card's name and power limit, as
``nvidia-smi`` gives them, come last.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--with-train-gpt2", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("dist_train_rows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build(["flash_attention_fwd", "flash_attention_bwd",
                  "fused_update"])
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    table = {"fused_update": {"name": "fused_update"}}
    if args.with_train_gpt2:
        for n in ("fwd", "bwd_dq", "bwd_dkv"):
            table[f"flash_attention_{n}_dropout"] = {}
        cs.train_gpt2_phase(torch, np, dev, table)
    t0 = time.perf_counter()
    cs.dist_train_phase(torch, table)
    cs.emit({"phase": "dist_train_wall", "seconds":
             time.perf_counter() - t0})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"fused_update": table["fused_update"],
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:          # chip_smoke.SmokeFailure included
        print(f"dist_train_rows: FAILED: {e}", file=sys.stderr)
        raise
