#!/usr/bin/env python3
"""Tensor-parallel serving on the cards: ``LLMEngine(mesh=serving_mesh(tp))``
with one rank a card, started through the port's launcher over NCCL.

    python3 tools/tp_serve_rows.py [--root DIR] [--tp 1,2,4] [--serve-tp]

For each tp of ``--tp`` that the machine's cards can hold, one gang of
``tp`` ranks serves ``chip_smoke.py``'s serve mix (prompts of 37-1000
ids, 32 new tokens each, ``max_seqs=8``, ``max_len=2048``,
``page_size=128``, bf16 pools) with every rank making the same calls:

- Llama-3-8B at full depth, bf16: the unified step (``unified``), the
  split path (``split``) and, at tp 1 and 4, int8 pools (``int8``);
- Qwen1.5-MoE-A2.7B at full depth (``moe``), at tp 1 and 4.

Each rank builds the model on its card from one seed (the same weights
on every rank), builds the engine (a tp > 1 engine copies its slices)
and frees the model where the engine holds copies, so the bytes a card
are what a tensor-parallel replica holds.  A rank reports the weight
and pool bytes its card holds, its peak memory, TTFT, decode tokens/s,
#1/#2/#7/#11 launches, the gathers and bytes a forward, and, on rank
0, the device's idle share over a traced serve of fresh prompts; every
rank's tokens must be identical, and at tp > 1 they are held against
tp 1's by ``chip_smoke.agreement`` (equal, or parting only at a near
tie).  One JSON line a (tp, config) comes out; the card's name and power
limit, as ``nvidia-smi`` gives them, come last.

``--serve-tp`` instead runs ``chip_smoke.py``'s kernel rows at the
shard shapes, ``serve`` and its ``serve_tp`` phase (a mesh of one in
this process) alone on one card.

Run on a machine with CUDA GPUs.  It builds the kernels the paths launch
(one ``nvcc`` a source, all started together) before the gangs start.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CONFIGS = {1: ("unified", "split", "int8", "moe"),
           2: ("unified", "split"),
           4: ("unified", "split", "int8", "moe")}
KERNELS = ["ragged_paged_attention", "flash_attention_fwd",
           "grouped_matmul", "paged_decode_attention"]


def _held_bytes(eng):
    """Bytes of the distinct device storages the engine's weights use."""
    import torch
    seen = {}

    def walk(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    walk(eng._layers)
    walk((eng._norm_w, eng._embed_w, eng._head_w, eng._rope,
          eng._rope_prefill))
    return sum(seen.values())


def _model(torch, cs, kind, dev):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeConfig,
                                                   Qwen2MoeForCausalLM)
    if kind == "moe":
        return Qwen2MoeForCausalLM(
            Qwen2MoeConfig(), device=dev, dtype=torch.bfloat16,
            generator=torch.Generator(device=dev).manual_seed(cs.SEED + 5))
    return LlamaForCausalLM(
        llama3_8b_config(), device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(cs.SEED))


def _serve_config(torch, np, cs, dist, mesh, cfg_name, out_dir, tp):
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import paged_attention as pa
    rank = dist.get_rank()
    dev = dist.env.get_device()
    kind = "moe" if cfg_name == "moe" else "llama"
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = _model(torch, cs, kind, dev)
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    dtype=torch.bfloat16, mesh=mesh,
                    unified_step=cfg_name != "split",
                    kv_dtype="int8" if cfg_name == "int8" else None)
    vocab = eng.config.vocab_size
    if tp > 1:
        del model                      # the engine holds its slices
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    held = _held_bytes(eng)
    rows = eng.cache.memory_rows()
    resident = torch.cuda.memory_allocated() - base
    seed = cs.SEED + (5 if kind == "moe" else 0)
    rng = np.random.default_rng(seed)
    prompts = {rid: rng.integers(0, vocab, n).tolist()
               for rid, n in cs.SERVE_LENS.items()}
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd,
                "paged_decode_append_attend": pa.paged_decode_append_attend}
    if kind == "moe":
        counters["grouped_matmul"] = gm.gmm_raw
    before = eng.tp_comm()
    with cs.counted_forwards(collectives=True) as counts:
        if cfg_name == "split":
            prompts = cs.split_prompts(np, vocab, cs.SEED + 2)
            stats = cs.serve_split_run(torch, eng, prompts, counters)
            results = {rid: eng.result(rid) for rid in prompts}
        else:
            stats, results = cs.serve_run(torch, eng, prompts, counters)
    comm = {k: v - before[k] for k, v in eng.tp_comm().items()}
    fwd = counts["forwards"]
    res = {"rank": rank, "tp": tp, "config": cfg_name,
           "model": "qwen1.5_moe_a2.7b" if kind == "moe" else "llama3_8b",
           "setup_s": setup_s, "weight_bytes_card": held,
           "kv_pool_bytes": rows["device_bytes"],
           "kv_pool_bytes_card": rows["device_bytes_per_shard"],
           "resident_bytes_card": resident, **stats,
           "peak_bytes_card": stats["max_memory_allocated"],
           "forwards": fwd, "gathers": comm["gathers"],
           "gather_bytes": comm["bytes"],
           "gathers_per_forward": comm["gathers"] / max(fwd, 1),
           "gather_bytes_per_forward": comm["bytes"] / max(fwd, 1),
           "collective_calls": {k: v for k, v in counts.items()
                                if k != "forwards"},
           "tokens_out": results}
    layers = len(eng._layers)
    per_layer = 2 if kind == "moe" else 4
    cs.check(comm["gathers"] == per_layer * layers * fwd,
             f"tp {tp} {cfg_name}: {comm['gathers']} gathers in {fwd} "
             f"forwards, not {per_layer * layers} a forward")
    cs.check(counts["other"] == 0, f"tp {tp} {cfg_name}: collectives "
                                   f"besides the gathers: {counts}")
    if cfg_name != "split":
        # rank 0's device idle share over a traced serve of fresh prompts
        # (every rank makes the same calls; only rank 0 is traced)
        fresh = {f"p{rid}": rng.integers(0, vocab, n).tolist()
                 for rid, n in cs.SERVE_LENS.items()}

        def serve():
            for rid, ids in fresh.items():
                eng.begin_request(rid, ids, max_new_tokens=8)
            while eng.has_work():
                eng.step()
        if rank == 0:
            _, prof = cs.profiled(torch, serve)
            res["profile"] = {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share",
                "kernel_ms_by_family")}
        else:
            serve()
    ref_path = os.path.join(out_dir, f"tp1_{cfg_name}_rank0.json")
    if tp > 1 and os.path.exists(ref_path):
        with open(ref_path) as f:
            want = json.load(f)["tokens_out"]
        res["agreement"] = cs.agreement(torch, eng, prompts, results, want)
    with open(os.path.join(out_dir, f"tp{tp}_{cfg_name}_rank{rank}.json"),
              "w") as f:
        json.dump(res, f)
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _gather_latency(torch, mesh, tp, calls=200):
    """Host and wall µs a call of the engine's gather
    (``all_gather_concat`` on the last dim, bf16) at two of a decode
    forward's widths: o_proj's output (136 rows x 4096 / tp) and the
    SwiGLU hidden (136 x 14336 / tp)."""
    from paddle_tpu_torch.distributed.collective import all_gather_concat
    out = {}
    for name, cols in (("o_proj_out", 4096 // tp), ("hidden", 14336 // tp)):
        x = torch.randn((136, cols), device="cuda", dtype=torch.bfloat16)
        for _ in range(10):
            all_gather_concat(x, -1, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            all_gather_concat(x, -1, mesh)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {"host_us": 1e6 * host / calls,
                     "wall_us": 1e6 * wall / calls,
                     "bytes_sent": x.numel() * 2}
    return out


def rank_main(root, out_dir, tp):
    """One rank of a gang of ``tp``: every config of ``CONFIGS[tp]``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dist.init_parallel_env()
    dist.barrier()                      # NCCL's communicator comes up here
    init_s = time.perf_counter() - t0
    mesh = dist.topology.serving_mesh(tp)
    latency = _gather_latency(torch, mesh, tp)
    for cfg_name in CONFIGS[tp]:
        _serve_config(torch, np, cs, dist, mesh, cfg_name, out_dir, tp)
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, f"tp{tp}_init.json"), "w") as f:
            json.dump({"init_s": init_s, "backend": dist.get_backend(),
                       "gather_latency": latency}, f)
    dist.barrier()
    dist.destroy_process_group()


def _summary(out_dir, tp, cfg_name):
    ranks = []
    for r in range(tp):
        with open(os.path.join(out_dir,
                               f"tp{tp}_{cfg_name}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    same = all(r["tokens_out"] == r0["tokens_out"] for r in ranks)
    keep = ("model", "setup_s", "weight_bytes_card", "kv_pool_bytes",
            "kv_pool_bytes_card", "resident_bytes_card", "peak_bytes_card",
            "serve_s", "steps", "forwards", "ttft_s", "decode_tok_s",
            "launches", "gathers", "gather_bytes", "gathers_per_forward",
            "gather_bytes_per_forward", "collective_calls", "profile",
            "agreement")
    return {"phase": "tp_serve", "tp": tp, "config": cfg_name,
            **{k: r0.get(k) for k in keep},
            "ranks_identical_tokens": same,
            "peak_bytes_card_by_rank": [r["peak_bytes_card"]
                                        for r in ranks],
            "decode_tok_s_by_rank": [r["decode_tok_s"] for r in ranks]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--tp", default="1,2,4")
    ap.add_argument("--serve-tp", action="store_true")
    ap.add_argument("--rank-worker", nargs=2, metavar=("OUT_DIR", "TP"))
    args = ap.parse_args()
    if args.rank_worker:
        rank_main(args.root, args.rank_worker[0], int(args.rank_worker[1]))
        return 0
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("tp_serve_rows: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build(KERNELS)
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.serve_tp:
        _serve_tp_alone(torch, np, cs)
        print(json.dumps({"nvidia_smi": smi}), flush=True)
        return 0
    n_cards = torch.cuda.device_count()
    out_dir = tempfile.mkdtemp(prefix="tp_serve_")
    here = os.path.abspath(__file__)
    for tp in (int(t) for t in args.tp.split(",")):
        if tp > n_cards:
            cs.emit({"phase": "tp_serve", "tp": tp,
                     "skipped": f"{n_cards} card(s) on this machine"})
            continue
        logs = os.path.join(out_dir, f"logs_tp{tp}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(tp), "--log_dir", logs, here,
             "--root", args.root, "--rank-worker", out_dir, str(tp)],
            cwd=args.root, capture_output=True, text=True, timeout=1800)
        wall_s = time.perf_counter() - t0
        tails = ""
        if os.path.isdir(logs):
            for f in sorted(os.listdir(logs)):
                with open(os.path.join(logs, f)) as fh:
                    tails += f"\n--- {f}\n" + fh.read()[-4000:]
        cs.check(proc.returncode == 0,
                 f"tp {tp} gang exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}{tails}")
        with open(os.path.join(out_dir, f"tp{tp}_init.json")) as f:
            init = json.load(f)
        cs.emit({"phase": "tp_gang", "tp": tp, "wall_s": wall_s, **init})
        for cfg_name in CONFIGS[tp]:
            row = _summary(out_dir, tp, cfg_name)
            cs.emit(row)
            cs.check(row["ranks_identical_tokens"],
                     f"tp {tp} {cfg_name}: the ranks' tokens differ")
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    return 0


def _serve_tp_alone(torch, np, cs):
    """``serve`` then ``serve_tp`` (and its shard rows) on one card."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tp_rows = cs.tp_shard_kernels(torch, torch.Generator(
        device=dev).manual_seed(cs.SEED + 50), dev)
    cfg = llama3_8b_config()
    model = LlamaForCausalLM(
        cfg, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(cs.SEED))
    eng = LLMEngine(model, max_seqs=8, max_len=2048, page_size=128,
                    dtype=torch.bfloat16)
    rng = np.random.default_rng(cs.SEED)
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).tolist()
               for rid, n in cs.SERVE_LENS.items()}
    counters = {"ragged_paged_append_attend": pa.ragged_paged_append_attend,
                "flash_attention_fwd": fa.flash_attention_fwd}
    stats, results = cs.serve_run(torch, eng, prompts, counters)
    cs.emit({"phase": "serve", **stats})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cs.serve_tp_phase(torch, dev, prompts, results, stats, tp_rows)
    cs.emit({"phase": "serve_tp_wall", "seconds": time.perf_counter() - t0})


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:          # chip_smoke.SmokeFailure included
        print(f"tp_serve_rows: FAILED: {e}", file=sys.stderr)
        raise
