"""The rank program of the tensor-parallel serving tests (no JAX: it runs
in child processes started by ``paddle_tpu_torch.distributed.launch``).

``python tests/torch_tp_worker.py <dir>`` on every rank of a gloo gang
of 2.  ``<dir>/inputs.npz`` holds the reference models' weights (tiny
Llama under ``llama/``, tiny Qwen2-MoE under ``moe/``); ``<dir>/in/``
what the single-process port engine exported (a migration package and
a capsule).  Each rank serves every case of ``CASES`` on a tp 2 engine
over ``serving_mesh(2)`` and writes ``<dir>/rank<r>.json``:

- every case's script result (tokens, restore paths, prefix hits, spec
  stats), the scripts being the ones the test runs on the reference's
  engines and the single-process port engine;
- ``collectives``: the gathers and every ``torch.distributed`` call one
  forward makes (split and unified decode, a two-chunk prefill, MoE);
- ``memory``: ``memory_rows()`` and ``memory_brief()`` of an int8 tp 2
  engine;
- ``logits``: a prompt's prefill logits;
- ``migrate_out`` / ``migrate_in``: a request exported by the gang (its
  blob written by rank 0 to ``<dir>/out/``) and one imported from the
  single-process engine's package, decoded to the end;
- ``capsule``: replay of a tp 2 capsule on the tp 2 engine and on a
  single-process engine, and of the single-process capsule on tp 2;
- ``refusals``: tp not dividing the KV heads, a rank built with another
  seed (both ranks raise), the serving runtime over tp 2, and a rank
  outside a mesh of one.

The scripts take an engine and return JSON-able results; the test
imports them to drive the reference's engines the same way.
"""
import dataclasses
import json
import os
import sys

import numpy as np

GEOM = dict(max_seqs=4, max_len=64, page_size=8, steps_per_sync=4)
REQS = [("a", [5, 9, 2, 14], 8), ("b", [3, 3, 7], 6),
        ("c", list(range(1, 14)), 5)]
COMMON = [7, 7, 3, 1, 9, 2, 8, 5, 5, 1]
SAMPLING = dict(decode_strategy="sampling", top_k=5, top_p=0.9,
                temperature=0.8, seed=11)
MIGRATE = ("mg", [5, 9, 2, 14], 12)
LOGIT_PROMPT = list(range(3, 16))


def staggered(eng, deferred=False):
    """The reference's ``_REQS`` admitted one a step (the second through
    ``begin_request`` when ``deferred``), then drained."""
    for i, (rid, prompt, n) in enumerate(REQS):
        if deferred and i == 1:
            eng.begin_request(rid, prompt, max_new_tokens=n)
        else:
            eng.add_request(rid, prompt, max_new_tokens=n)
        eng.step()
    while eng.has_work():
        eng.step()
    return {"tokens": {rid: eng.result(rid) for rid, _, _ in REQS}}


def prefix(eng):
    """Two prompts over one cached prefix: the second hits it."""
    reqs = [("p1", COMMON + [4], 6), ("p2", COMMON + [11], 6)]
    for rid, prompt, n in reqs:
        eng.add_request(rid, prompt, max_new_tokens=n)
        eng.step()
    while eng.has_work():
        eng.step()
    return {"tokens": {rid: eng.result(rid) for rid, _, _ in reqs},
            "hit_tokens": int(eng.prefix_stats["hit_tokens"])}


def preempt(eng):
    """Suspend mid-decode, resume (swap or recompute), drain."""
    eng.add_request("s", [5, 9, 2, 14], max_new_tokens=12)
    eng.step()
    eng.step()
    armed = bool(eng.suspend("s"))
    path = eng.resume("s")
    while eng.has_work():
        eng.step()
    return {"tokens": {"s": eng.result("s")}, "armed": armed,
            "path": path}


def abort(eng):
    """Abort one request mid-decode while two others run on."""
    for rid, prompt, n in REQS[:2]:
        eng.add_request(rid, prompt, max_new_tokens=n)
    eng.step()
    live = bool(eng.abort("a"))
    rid, prompt, n = REQS[2]
    eng.add_request(rid, prompt, max_new_tokens=n)
    while eng.has_work():
        eng.step()
    return {"tokens": {rid: eng.result(rid) for rid, _, _ in REQS},
            "aborted_live": live,
            "cancelled": bool(eng.requests["a"].cancelled)}


def spec(eng):
    """Greedy speculative decoding: three prompts drained."""
    for rid, prompt, n in REQS:
        eng.add_request(rid, prompt, max_new_tokens=n)
    while eng.has_work():
        eng.step()
    return {"tokens": {rid: eng.result(rid) for rid, _, _ in REQS},
            "spec": {k: int(v) for k, v in eng.spec_stats.items()}}


def migrate_export(eng):
    """``MIGRATE`` decoded two steps, suspended and exported: (armed,
    package)."""
    rid, prompt, n = MIGRATE
    eng.add_request(rid, prompt, max_new_tokens=n)
    eng.step()
    eng.step()
    armed = bool(eng.suspend(rid))
    return armed, eng.export_request(rid)


def migrate_import(eng, pkg):
    """Import a package, resume it, drain: (path, tokens)."""
    eng.import_request(pkg)
    path = eng.resume(pkg["rid"])
    while eng.has_work():
        eng.step()
    return path, eng.result(pkg["rid"])


# case -> (model, engine keywords, script); "draft": the model drafts
# for itself.  The split path carries the int8 weights (over int8 pools)
# and sampling: the unified step's are the same product and draw code,
# and the reference's split programs compile in half the time
CASES = {
    "unified": ("llama", {"unified_step": True},
                lambda e: staggered(e, deferred=True)),
    "split": ("llama", {"unified_step": False}, staggered),
    "unified_int8_kv": ("llama", {"unified_step": True,
                                  "kv_dtype": "int8"},
                        lambda e: staggered(e, deferred=True)),
    "split_int8": ("llama", {"unified_step": False, "kv_dtype": "int8",
                             "weight_dtype": "int8"}, staggered),
    "sampling": ("llama", dict(SAMPLING, unified_step=False), staggered),
    "prefix": ("llama", {"enable_prefix_caching": True}, prefix),
    "swap_in": ("llama", {"swap_pool_pages": 8, "unified_step": False},
                preempt),
    "recompute": ("llama", {"swap_pool_pages": 0,
                            "unified_step": False}, preempt),
    "abort": ("llama", {"unified_step": True}, abort),
    "moe": ("moe", {"unified_step": True}, staggered),
    "spec": ("llama", {"draft": True, "spec_k": 3}, spec),
}


def engine_kwargs(kw, model):
    """A case's keywords with GEOM and the draft model filled in."""
    out = dict(GEOM)
    out.update(kw)
    if out.pop("draft", False):
        out["draft_model"] = model
    return out


def blob_arrays(blob):
    """A swap blob's meta record and arrays (numpy), for comparison."""
    import io
    with np.load(io.BytesIO(blob)) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        return meta, {k: np.array(z[k]) for k in z.files if k != "meta"}


def save_package(path, pkg):
    """A migration package as JSON beside its blob."""
    with open(path + ".json", "w") as f:
        json.dump({k: v for k, v in pkg.items() if k != "swap"}, f)
    with open(path + ".bin", "wb") as f:
        f.write(pkg["swap"])


def load_package(path):
    with open(path + ".json") as f:
        pkg = json.load(f)
    with open(path + ".bin", "rb") as f:
        pkg["swap"] = f.read()
    return pkg


# -- the rank -----------------------------------------------------------------

def _models(root):
    import torch  # noqa: F401
    from paddle_tpu_torch.models.from_jax import load_raw_state_dict
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                                   qwen2_moe_tiny_config)
    data = np.load(os.path.join(root, "inputs.npz"))
    models = {"llama": LlamaForCausalLM(llama_tiny_config(), device="cpu"),
              "moe": Qwen2MoeForCausalLM(qwen2_moe_tiny_config(),
                                         device="cpu")}
    for name, m in models.items():
        load_raw_state_dict(m, {k.split("/", 1)[1]: data[k]
                                for k in data.files
                                if k.startswith(name + "/")})
        m.eval()
    return models


def _one_forward(eng, act):
    """Forwards, gathers (with the bytes this rank sent) and every
    ``torch.distributed`` collective ``act()`` makes on ``eng``
    (``chip_smoke.counted_forwards``: all-gathers apart, the rest as
    "other")."""
    from chip_smoke import counted_forwards
    before = eng.tp_comm()
    with counted_forwards(collectives=True) as calls:
        act()
    return {k: v - before[k] for k, v in eng.tp_comm().items()} | {
        "calls": dict(calls)}


def collectives(mk, models):
    out = {}
    for name, model, kw in (("split", "llama", {"unified_step": False}),
                            ("unified", "llama", {"unified_step": True}),
                            ("moe", "moe", {"unified_step": True})):
        eng = mk(models[model], steps_per_sync=1, **kw)
        rid, prompt, n = REQS[2]
        # a 13-token prompt: two page chunks of the synchronous prefill
        out[f"{name}_prefill"] = _one_forward(
            eng, lambda: eng.add_request(rid, prompt, max_new_tokens=n))
        out[f"{name}_decode"] = _one_forward(eng, eng.step)
        eng.abort(rid)
    return out


def memory(mk, models):
    import gc

    from paddle_tpu_torch.observability.introspection import memory_brief
    gc.collect()
    eng = mk(models["llama"], kv_dtype="int8")
    rows = eng.cache.memory_rows()
    brief = memory_brief(device="cpu")
    return {"rows": {k: rows[k] for k in ("device_bytes",
                                          "device_bytes_per_shard", "tp",
                                          "bytes_per_token")},
            "brief": {k: brief[k] for k in ("device_pool_bytes",
                                            "device_pool_bytes_per_shard")},
            "k_pages_shape": list(eng.cache.k_pages.shape)}


def logits(mk, models):
    eng = mk(models["llama"])
    slot = eng.cache.allocate(len(LOGIT_PROMPT) + 1)
    got = eng._prefill_seq(slot, LOGIT_PROMPT, 0)
    eng.cache.release(slot)
    return got.tolist()


def capsules(mk, models, root):
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.observability import capsule as C
    C.enable_capsule_capture()
    try:
        eng = mk(models["llama"])
        eng.add_request("g", [5, 9, 2, 14], max_new_tokens=10)
        while eng.has_work():
            eng.step()
        cap = C.get_capsule_store().get("g")
        single = LLMEngine(models["llama"], device="cpu", **GEOM)
        with open(os.path.join(root, "in", "capsule_tp1.json")) as f:
            cap1 = json.load(f)
        return {"fingerprint_tp": cap["fingerprint"]["tp"],
                "on_tp2": C.replay_capsule(cap, eng)["first_divergence"],
                "tp2_on_single": C.replay_capsule(
                    cap, single)["first_divergence"],
                "tp1_on_tp2": C.replay_capsule(cap1, eng)[
                    "first_divergence"],
                "tokens": eng.result("g")}
    finally:
        C.disable_capsule_capture()


def _raises(fn):
    try:
        fn()
    except Exception as e:              # the refusal's type and message
        return {"type": type(e).__name__, "msg": str(e)}
    return None


def refusals(dist, mk, models, rank):
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.serving import Scheduler
    out = {}
    mqa = LlamaForCausalLM(dataclasses.replace(
        llama_tiny_config(), num_key_value_heads=1), device="cpu")
    out["kv_heads"] = _raises(lambda: mk(mqa))
    out["fingerprint"] = _raises(lambda: mk(models["llama"], seed=rank))
    eng = mk(models["llama"])
    out["runtime"] = _raises(lambda: Scheduler(eng))
    mesh1 = dist.topology.serving_mesh(1)
    res = {}

    def serve_on_one():
        e = LLMEngine(models["llama"], mesh=mesh1, device="cpu", **GEOM)
        res.update(staggered(e))
    out["outside_mesh"] = _raises(serve_on_one)
    out["outside_mesh_tokens"] = res.get("tokens")
    return out


def main(root):
    import torch
    torch.set_num_threads(2)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.inference.engine import LLMEngine
    dist.init_parallel_env(device="cpu")
    rank = dist.get_rank()
    mesh = dist.topology.serving_mesh(2)
    models = _models(root)

    def mk(model, **kw):
        return LLMEngine(model, mesh=mesh, device="cpu",
                         **engine_kwargs(kw, model))

    out = {"world": dist.get_world_size(), "backend": dist.get_backend(),
           "memory": memory(mk, models)}
    out["collectives"] = collectives(mk, models)
    out["cases"] = {}
    for case, (model, kw, script) in CASES.items():
        eng = mk(models[model], **kw)
        out["cases"][case] = script(eng)
    out["logits"] = logits(mk, models)
    armed, pkg = migrate_export(mk(models["llama"]))
    if rank == 0:
        os.makedirs(os.path.join(root, "out"), exist_ok=True)
        save_package(os.path.join(root, "out", "pkg_tp2"), pkg)
    meta, arrays = blob_arrays(pkg["swap"])
    out["migrate_out"] = {
        "armed": armed, "meta": meta,
        "sums": {k: float(np.abs(v.astype(np.float64)).sum())
                 for k, v in arrays.items()}}
    path, toks = migrate_import(
        mk(models["llama"]),
        load_package(os.path.join(root, "in", "pkg_tp1")))
    out["migrate_in"] = {"path": path, "tokens": toks}
    out["capsule"] = capsules(mk, models, root)
    out["refusals"] = refusals(dist, mk, models, rank)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
