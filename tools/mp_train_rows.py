#!/usr/bin/env python3
"""Tensor-parallel (mp) training on the cards: Llama-3-8B width through
``fleet.init`` (dp x mp x sharding), ``fleet.distributed_model`` and
``ShardedTrainStep``, one rank a card, started through the port's
launcher over NCCL.

    python3 tools/mp_train_rows.py [--root DIR] [--mp 1,2,4] [--layers 8]
                                   [--full-depth] [--smoke-phases]
                                   [--device cpu]

The recipe is ``bench.py``'s headline one: bf16 (amp O2), seq 8192,
``fuse_norm_rope``, ``core_attn`` remat, the fused linear +
cross-entropy, AdamW (lr 1e-4) under ``ClipGradByGlobalNorm(1.0)``, a
warm-up step and then 3 steps on one batch, weights from one seed.

- For each mp of ``--mp`` that the machine's cards can hold, one gang of
  ``mp`` ranks at mp ``mp`` (dp 1, stage 1) and ``--layers`` layers, on
  one sequence: the same batch and weights at every mp, so the losses
  are held against mp 1's (the largest relative gap is printed).
- ``--full-depth`` adds the 32-layer model at mp 4 and at mp 2 x
  sharding 2 (stage 3, two sequences, one a data coordinate) on four
  cards: the configuration one card cannot hold.

Each rank reports its step times, peak memory, the launches of #2-#4,
#8 and #10 and the step's collectives (the mp ones apart, with their
bytes); rank 0's come out as one JSON line a run with tokens/s, MFU (6N
over the gang's cards) and the peak GB of the fullest card, and the
mp collectives a step are held against
``chip_smoke.mp_collectives_a_step``.  The card's name and power limit,
as ``nvidia-smi`` gives them, come last.

``--smoke-phases`` instead runs ``chip_smoke.py``'s ``mp_shard_kernels``
and ``train_mp`` phases alone on one card.  ``--device cpu`` rehearses
the gangs on the CPU (gloo, 4 processes) at a tiny Llama (4 KV heads,
seq 32), with no card and no kernels.

Run on a machine with CUDA GPUs.  It builds the kernels the path
launches (one ``nvcc`` a source, all started together) before the
gangs start.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

KERNELS = ["flash_attention_fwd", "flash_attention_bwd", "fused_update",
           "add_norm", "matmul_rope"]
STEPS = 3
# run name: (layers, mp, sharding, stage); dp is 1 throughout
FULL_DEPTH = {"full_mp4": (32, 4, 1, 1), "full_mp2_s2_stage3": (32, 2, 2, 3)}


def _config(device, layers):
    from paddle_tpu_torch.models.llama import (llama3_8b_config,
                                               llama_tiny_config)
    if device == "cpu":
        return dataclasses.replace(llama_tiny_config(),
                                   num_key_value_heads=4,
                                   num_hidden_layers=layers,
                                   recompute=True,
                                   recompute_granularity="core_attn")
    return dataclasses.replace(llama3_8b_config(), num_hidden_layers=layers,
                               fuse_norm_rope=True, recompute=True,
                               recompute_granularity="core_attn")


def rank_main(root, out_dir, name, spec, device):
    """One rank of run ``name``: ``spec`` is (layers, mp, sharding,
    stage); writes ``<name>_rank<r>.json``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import ShardedTrainStep, fleet
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_train as ft
    layers, mp, sharding, stage = spec
    cpu = device == "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strategy = dist.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": mp,
                               "sharding_degree": sharding}
    t0 = time.perf_counter()
    hcg = fleet.init(strategy=strategy, device="cpu" if cpu else None)
    dist.barrier()                      # NCCL's communicator comes up here
    init_s = time.perf_counter() - t0
    dev = dist.env.get_device()
    cfg = _config(device, layers)
    seq = 32 if cpu else cs.TRAIN_SEQ
    rows = hcg.data_coordinate()[1]
    ids, labels = cs.train_batch(np, cfg.vocab_size, rows, seq)
    batch = {"input_ids": ids, "labels": labels}
    t0 = time.perf_counter()
    model = fleet.distributed_model(LlamaForCausalLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            cs.SEED + 6)))
    if not cpu:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    step = ShardedTrainStep(
        model, lambda m, b: m(b["input_ids"], labels=b["labels"]), opt,
        stage=stage, device=dev)
    setup_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(s)) for s in step.plan.global_shapes.values())
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "matmul_rope": ft.matmul_rope_raw,
                "fused_update": ft.fused_update_flat}
    losses = [float(step(batch))]                # the warm-up step
    if not cpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(STEPS):
        t = time.perf_counter()
        losses.append(float(step(batch)))        # a host float: synced
        times.append(time.perf_counter() - t)
    res = {"run": name, "rank": dist.get_rank(), "world":
           dist.get_world_size(), "backend": dist.get_backend(),
           "layers": layers, "mp": mp, "sharding": sharding,
           "stage": stage, "sequences": rows, "seq": seq,
           "params": n_params, "leaves": len(step.state["params"]),
           "init_s": init_s, "setup_s": setup_s, "losses": losses,
           "step_s": times, "comm": dict(step.comm),
           "launches": {n: fn.launches for n, fn in counters.items()},
           "peak_bytes": None if cpu else torch.cuda.max_memory_allocated(),
           "topology": hcg.topology()}
    with open(os.path.join(out_dir, f"{name}_rank{res['rank']}.json"),
              "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _summary(cs, out_dir, name, world, cpu):
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{name}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    step_s = sum(r0["step_s"]) / len(r0["step_s"])
    tok_s = r0["sequences"] * r0["seq"] / step_s
    want_n, want_bytes = cs.mp_collectives_a_step(
        r0["layers"], r0["seq"] * r0["sequences"] // r0["sharding"],
        64 if cpu else 4096, el=4 if cpu else 2)
    peaks = [r["peak_bytes"] for r in ranks]
    return {"phase": "mp_train", **{k: r0[k] for k in (
                "run", "world", "backend", "layers", "mp", "sharding",
                "stage", "sequences", "seq", "params", "leaves", "init_s",
                "setup_s", "losses", "step_s", "comm", "launches",
                "topology")},
            "mean_step_s": step_s, "tokens_per_s": tok_s,
            "mfu_6n": None if cpu else
            6 * r0["params"] * tok_s / (world * cs.PEAK_BF16_FLOPS),
            "peak_gb_card": None if cpu else max(peaks) / 1e9,
            "peak_gb_by_rank": None if cpu else [p / 1e9 for p in peaks],
            "mp_collectives_formula": want_n,
            "mp_bytes_formula": want_bytes,
            "ranks_equal_losses": all(r["losses"] == r0["losses"]
                                      for r in ranks)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--mp", default="1,2,4")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--full-depth", action="store_true")
    ap.add_argument("--smoke-phases", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rank-worker", nargs=3,
                    metavar=("OUT_DIR", "NAME", "SPEC"))
    args = ap.parse_args()
    if args.rank_worker:
        out_dir, name, spec = args.rank_worker
        rank_main(args.root, out_dir, name, json.loads(spec), args.device)
        return 0
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("mp_train_rows: no CUDA device", file=sys.stderr)
        return 1
    smi = ""
    if not cpu:
        t0 = time.perf_counter()
        _build.build(KERNELS)
        cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    if args.smoke_phases:
        _smoke_phases(torch, np, cs)
        print(json.dumps({"nvidia_smi": smi}), flush=True)
        return 0
    n_cards = 4 if cpu else torch.cuda.device_count()
    runs = {f"mp{m}": (args.layers, m, 1, 1)
            for m in (int(t) for t in args.mp.split(","))}
    if args.full_depth:
        runs.update({n: (2 if cpu else layers, mp, s, st) for n, (
            layers, mp, s, st) in FULL_DEPTH.items()})
    out_dir = tempfile.mkdtemp(prefix="mp_train_")
    here = os.path.abspath(__file__)
    env = dict(os.environ)
    env["PYTHONPATH"] = args.root + os.pathsep + env.get("PYTHONPATH", "")
    base = None
    for name, spec in runs.items():
        world = spec[1] * spec[2]
        if world > n_cards:
            cs.emit({"phase": "mp_train", "run": name,
                     "skipped": f"{n_cards} card(s) on this machine"})
            continue
        logs = os.path.join(out_dir, f"logs_{name}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(world), "--log_dir", logs, here,
             "--root", args.root, "--device", args.device,
             "--rank-worker", out_dir, name, json.dumps(spec)],
            cwd=args.root, env=env, capture_output=True, text=True,
            timeout=480)
        wall_s = time.perf_counter() - t0
        tails = ""
        if os.path.isdir(logs):
            for f in sorted(os.listdir(logs)):
                with open(os.path.join(logs, f)) as fh:
                    tails += f"\n--- {f}\n" + fh.read()[-4000:]
        cs.check(proc.returncode == 0,
                 f"{name} gang exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}{tails}")
        row = _summary(cs, out_dir, name, world, cpu)
        row["launcher_wall_s"] = wall_s
        if name.startswith("mp") and spec[0] == args.layers:
            if base is None and spec[1] == 1:
                base = row["losses"]
            if base is not None:
                row["losses_max_rel_gap_to_mp1"] = max(
                    abs(a - b) / abs(b) for a, b in zip(row["losses"], base))
        cs.emit(row)
        cs.check(row["ranks_equal_losses"], f"{name}: the ranks' losses "
                                            f"differ")
        cs.check(all(np.isfinite(row["losses"])),
                 f"{name}: losses {row['losses']}")
        cs.check((row["comm"]["mp_collectives"], row["comm"]["mp_bytes"])
                 == (row["mp_collectives_formula"],
                     row["mp_bytes_formula"]),
                 f"{name}: {row['comm']} against the formula's "
                 f"{row['mp_collectives_formula']} collectives of "
                 f"{row['mp_bytes_formula']} bytes")
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    return 0


def _smoke_phases(torch, np, cs):
    """``mp_shard_kernels`` then ``train_mp`` on one card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rows = cs.mp_shard_kernels(torch, np, torch.Generator(
        device=dev).manual_seed(cs.SEED + 60), dev)
    torch.cuda.empty_cache()
    cs.train_mp_phase(torch, np, dev, {"fused_update": {}}, rows)
    from paddle_tpu_torch import distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:          # chip_smoke.SmokeFailure included
        print(f"mp_train_rows: FAILED: {e}", file=sys.stderr)
        raise
