#!/usr/bin/env python3
"""Where a launch of the split decode kernel (#7) spends its time, block by
block.

    python3 tools/decode_timeline.py

Run from the root of a checkout on a machine with a CUDA GPU.  It copies
``paddle_tpu_torch/`` into ``smoke_trial_timeline/`` (listed in
``.gitignore``), adds ``%globaltimer`` stamps to that copy of
``csrc/paged_decode_attention.cu`` (a block's entry, its scores in
shared memory, its P V summed, its exit; dead, live or merging), builds
it and launches #7 at ``chip_smoke.decode_case`` (bf16 pools at GQA
group 4 and 1, int8 pools at group 4).  It prints a JSON line a case:
the launch's span in µs (first entry to last exit), and for dead blocks
(no key of their span), live blocks and the blocks that merged a row's
spans the median and largest start, end and phase times.  The stamps
cost a few registers and stores: the launch runs somewhat slower than
the kernel alone (``tools/decode_rows.py`` times that).  The stamps
find their places by the kernel's source text and fail loudly when it
has changed.
"""
import ctypes
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path.cwd()
COPY = ROOT / "smoke_trial_timeline"


def stamped(src):
    """The kernel source with the timeline stamps: slot 0 entry, 1 scores
    in, 2 P V summed, 3 exit, 4 kind (0 dead, 1 live, 2 merging), 5 SM."""
    edits = [
        ("namespace ptt {\nnamespace pd {",
         "namespace ptt {\nnamespace pd {\n"
         "__device__ unsigned long long pd_tl[65536 * 6];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n"
         "__device__ __forceinline__ unsigned smid_() {\n"
         "  unsigned t;\n  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(t));\n"
         "  return t;\n}\n"),
        ("  const int len = a.lens[b] + a.append;",
         "  const size_t bid = blockIdx.x + (size_t)gridDim.x * (blockIdx.y"
         " + (size_t)gridDim.y * blockIdx.z);\n"
         "  const unsigned long long tE = gtime();\n"
         "  unsigned long long* tl = pd_tl + bid * 6;\n"
         "  const int len = a.lens[b] + a.append;"),
        ("  if (sp >= nsplit) return;\n",
         "  if (sp >= nsplit) {\n    if (threadIdx.x == 0) {\n"
         "      tl[0] = tE; tl[1] = tl[2] = 0; tl[3] = gtime();\n"
         "      tl[4] = 0; tl[5] = smid_();\n    }\n    return;\n  }\n"),
        ("  __syncthreads();\n\n  // 3. the span's max",
         "  __syncthreads();\n  const unsigned long long tS = gtime();\n\n"
         "  // 3. the span's max"),
        ("  // 5. one span: the output;",
         "  const unsigned long long tP = gtime();\n"
         "  // 5. one span: the output;"),
        ("  if (nsplit == 1) return;\n",
         "  if (nsplit == 1) {\n    if (tid == 0) {\n"
         "      tl[0] = tE; tl[1] = tS; tl[2] = tP; tl[3] = gtime();\n"
         "      tl[4] = 1; tl[5] = smid_();\n    }\n    return;\n  }\n"),
        ("  if (!last) return;\n",
         "  if (!last) {\n    if (tid == 0) {\n"
         "      tl[0] = tE; tl[1] = tS; tl[2] = tP; tl[3] = gtime();\n"
         "      tl[4] = 1; tl[5] = smid_();\n    }\n    return;\n  }\n"),
        ("  if (tid == 0) a.counters[bk] = 0;       // for the next launch\n",
         "  if (tid == 0) a.counters[bk] = 0;       // for the next launch\n"
         "  if (tid == 0) {\n"
         "    tl[0] = tE; tl[1] = tS; tl[2] = tP; tl[3] = gtime();\n"
         "    tl[4] = 2; tl[5] = smid_();\n  }\n"),
        ("const char* paged_decode_attention_error_string(int e) {",
         "int paged_decode_timeline(unsigned long long* host, int n) {\n"
         "  return cudaMemcpyFromSymbol(host, ptt::pd::pd_tl,\n"
         "                              (size_t)n * 6 * 8);\n}\n\n"
         "const char* paged_decode_attention_error_string(int e) {"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"decode_timeline: the kernel source changed "
                             f"where a stamp goes: {old!r}")
        src = src.replace(old, new)
    return src


def summary(t):
    """Phase times (µs) of the blocks' stamps [n, 6]."""
    t0 = t[:, 0].min()
    rel = (t[:, :4] - t0) / 1e3
    out = {"launch_us": float((t[:, 3].max() - t0) / 1e3),
           "sms": int(len(set(t[:, 5].tolist())))}
    for kind, name in ((0, "dead"), (1, "live"), (2, "merging")):
        r = rel[t[:, 4] == kind]
        if not len(r):
            continue
        d = {"blocks": int(len(r)),
             "start_us_p50_max": [float(np.median(r[:, 0])),
                                  float(r[:, 0].max())],
             "end_us_p50_max": [float(np.median(r[:, 3])),
                                float(r[:, 3].max())]}
        if kind:
            for key, (a, b) in (("to_scores_us", (0, 1)),
                                ("softmax_pv_us", (1, 2)),
                                ("out_merge_us", (2, 3))):
                x = r[:, b] - r[:, a]
                d[key + "_p50_max"] = [float(np.median(x)), float(x.max())]
        out[name] = d
    return out


def main():
    if not torch.cuda.is_available():
        print("decode_timeline: no CUDA device", file=sys.stderr)
        return 1
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(ROOT / "paddle_tpu_torch", COPY / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    cu = COPY / "paddle_tpu_torch/csrc/paged_decode_attention.cu"
    cu.write_text(stamped(cu.read_text()))
    sys.path[:0] = [str(COPY), str(ROOT)]
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    assert Path(pa.__file__).resolve().is_relative_to(COPY)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for H, KVH, int8 in ((32, 8, False), (16, 16, False), (32, 8, True)):
        q, kn, vn, pools, tables, lens = cs.decode_case(torch, gen, dev, H,
                                                        KVH, int8)

        def call():
            return pa.paged_decode_append_attend(q, pools[0], pools[1], kn,
                                                 vn, tables, lens, pools[2],
                                                 pools[3])
        for _ in range(6):
            call()
        torch.cuda.synchronize()
        lib = _build.load("paged_decode_attention")
        span = lib.paged_decode_span(128, 3 if int8 else 1)
        n = -(-tables.shape[1] * pools[0].shape[2] // span) * KVH * \
            tables.shape[0]
        buf = (ctypes.c_ulonglong * (n * 6))()
        assert lib.paged_decode_timeline(buf, n) == 0
        t = np.frombuffer(buf, dtype=np.uint64).reshape(n, 6).astype(
            np.int64)
        print(json.dumps({"case": f"#7 heads {H}/{KVH}, "
                                  f"{'int8' if int8 else 'bf16'} pools",
                          "span": span, **summary(t)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
