#!/usr/bin/env python3
"""``chip_smoke.py``'s high-level trainer phases alone: ``fit_bert``,
``fit_resume`` and ``fit_gpt2_tokens`` (``fit_paths``), for the tree at
``--root`` (default: this checkout).

    python3 tools/fit_rows.py [--root DIR] [--phases fit_bert,...]
    python3 tools/fit_rows.py --overhead

Run on a machine with a CUDA GPU.  It builds the kernels those phases
launch (one ``nvcc`` a source, all started together), then runs each
named phase with ``chip_smoke.py``'s own checks: a failed check exits
non-zero.  The rows those phases fill in the kernel table (their
``launches_fit_*`` counts) are printed last, with the card's name and
power limit as ``nvidia-smi`` gives them.

``--overhead`` instead times where ``fit`` spends its host time on
``fit_bert``'s step (BERT-base classifier, bf16 O2, 16 x 512): the mean
s/step of a direct ``CompiledTrainStep`` loop (the copies to the card,
the step, the loss read) and of ``fit`` with, in turn, no metric and
no worker, ``Accuracy``, ``Accuracy`` and ``VisualDL``, and both with
two loader workers, each over 8 steps (the first left out), the set
run twice in alternation; then the trainer layer's functions by host
time under ``cProfile`` over one more ``fit`` epoch.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROWS = ("flash_attention_fwd_bert", "flash_attention_bwd_dq_bert",
        "flash_attention_bwd_dkv_bert", "add_layer_norm_bf16",
        "add_layer_norm_bf16_bwd", "fused_update",
        "flash_attention_fwd_dropout", "flash_attention_bwd_dq_dropout",
        "flash_attention_bwd_dkv_dropout")
PHASES = ("fit_bert", "fit_resume", "fit_gpt2_tokens")


def overhead(torch, np, dev, cs):
    import cProfile
    import io as _io
    import os
    import pstats
    import shutil
    import tempfile

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.hapi import Model, VisualDL
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.nn import CrossEntropyLoss
    cfg = BertConfig()
    b, steps = cs.BERT_BATCH, 8
    ids, mask, labels = cs.classifier_rows(np, cfg, steps * b, cs.SEED)
    ds = TensorDataset([ids, mask, labels])
    loss_fn = CrossEntropyLoss()
    net = cs.bert_classifier(torch, dev, cfg, cs.SEED)
    opt = optimizer.AdamW(1e-4, parameters=net.parameters())
    step = CompiledTrainStep(net, lambda m, bt: loss_fn(
        m(*bt["inputs"]), *bt["labels"]), opt)
    root = tempfile.mkdtemp(prefix="fit_overhead_")

    def direct():
        times = []
        for i in range(steps):
            cpu = [t[i * b:(i + 1) * b] for t in ds.tensors]
            t = time.perf_counter()
            ins = [x.to(dev) for x in cpu]
            float(step({"inputs": tuple(ins[:2]), "labels": (ins[2],)}))
            times.append(time.perf_counter() - t)
        return times

    model = Model(net)

    def fit(metrics, vdl, workers):
        model.prepare(opt, loss_fn, Accuracy(topk=(1, 2)) if metrics
                      else None)
        log = cs.step_log({})
        cbs = [log]
        if vdl:
            cbs.append(VisualDL(os.path.join(root, str(time.time()))))
        model.fit(DataLoader(ds, batch_size=b, num_workers=workers),
                  epochs=1, verbose=0, callbacks=cbs)
        return log.step_s

    variants = {"direct": direct,
                "fit": lambda: fit(False, False, 0),
                "fit_accuracy": lambda: fit(True, False, 0),
                "fit_accuracy_visualdl": lambda: fit(True, True, 0),
                "fit_accuracy_visualdl_2_workers": lambda: fit(True, True,
                                                               2)}
    for fn in variants.values():           # warm up each way once
        fn()
    runs = {n: [] for n in variants}
    for _ in range(2):
        for n, fn in variants.items():
            times = fn()
            runs[n].append(sum(times[1:]) / (len(times) - 1))
    prof = cProfile.Profile()
    prof.enable()
    fit(True, True, 2)
    prof.disable()
    out = _io.StringIO()
    st = pstats.Stats(prof, stream=out)
    st.sort_stats("tottime").print_stats(
        "hapi|steptimer|visualdl|metric|dataloader|jit/train|queues|"
        "threading|connection", 25)
    shutil.rmtree(root, ignore_errors=True)
    cs.emit({"phase": "fit_overhead", "model": "bert-base classifier",
             "batch": b, "seq": cs.BERT_SEQ, "steps": steps,
             "mean_step_s": runs})
    print(out.getvalue(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--overhead", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("fit_rows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build(["flash_attention_fwd", "flash_attention_bwd",
                  "fused_update", "add_norm", "add_norm_half",
                  "add_norm_mixed"])
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    if args.overhead:
        overhead(torch, np, dev, cs)
        return 0
    table = {n: {"name": n} for n in ROWS}
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        if name == "fit_resume":
            cs.fit_resume_phase(torch, np, dev)
        else:
            getattr(cs, f"{name}_phase")(torch, np, dev, table)
        cs.emit({"phase": f"{name}_wall", "seconds":
                 time.perf_counter() - t0})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"rows": table, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:          # chip_smoke.SmokeFailure included
        print(f"fit_rows: FAILED: {e}", file=sys.stderr)
        raise
