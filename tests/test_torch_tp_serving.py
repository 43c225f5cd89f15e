"""Tensor-parallel serving: the port's ``LLMEngine(mesh=serving_mesh(2))``
on a gloo gang of 2 against the reference's engines at tp 1 and tp 2.

The reference's tiny Llama (``llama_tiny_config``, 4 heads over 2 KV
heads) and tiny Qwen2-MoE (``qwen2_moe_tiny_config``, 4 / 2), built
after ``paddle.seed(0)``, carry their weights into the port with
``load_raw_state_dict``.  One gang of 2 ranks, started through the
port's launcher running ``tests/torch_tp_worker.py`` (no JAX in the
ranks), serves every case once a module while this process runs the
same scripts on the reference's engines (tp 1, and tp 2 on the root
conftest's 8 virtual CPU devices) and on the single-process port engine.

Tolerances: tokens exact.  Every case's tokens on both ranks equal the
reference's tp 2 engine's, its tp 1 engine's and the single-process port
engine's; so do the restore paths, prefix hits and speculative counts.
Logits (a prefill's, f32) on the gang are within 1e-5 of the
single-process engine's.  A swap blob exported by the gang holds what a
single-process engine's export of the same schedule holds (meta record
and arrays equal), and migrations both ways decode the reference's
tokens.  A forward's only collectives are the gathers: 4 a dense layer,
2 an MoE layer (2 layers here).  In-process: ``TPShardings``' hash, eq
and repr, and the weight plan (every array a rank holds equals the
reference engine's shard on that device of a 2-device mesh).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import requires_mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.topology import serving_mesh as ref_mesh
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_llama_config
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as RefQwen
from paddle_tpu.models.qwen2_moe import \
    qwen2_moe_tiny_config as ref_moe_config

from paddle_tpu_torch.distributed.sharding import TPShardings
from paddle_tpu_torch.distributed.topology import ServingMesh
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                               qwen2_moe_tiny_config)
from paddle_tpu_torch.observability import capsule as C
from paddle_tpu_torch.quantization.ops import quantize_absmax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_tp_worker as W  # noqa: E402

pytestmark = requires_mesh(2)
LOGIT_ATOL = 1e-5
LAYERS = 2


def _clean_env():
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("PADDLE_", "XLA_", "JAX_")):
            env.pop(k)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _ref_models():
    out = {}
    for name, cls, cfg in (("llama", RefLlama, ref_llama_config),
                           ("moe", RefQwen, ref_moe_config)):
        paddle.seed(0)
        m = cls(cfg())
        m.eval()
        out[name] = m
    return out


def _port_models(ref):
    out = {"llama": LlamaForCausalLM(llama_tiny_config(), device="cpu"),
           "moe": Qwen2MoeForCausalLM(qwen2_moe_tiny_config(),
                                      device="cpu")}
    for name, m in out.items():
        load_raw_state_dict(m, {k: np.asarray(v) for k, v in
                                ref[name].raw_state_dict().items()})
        m.eval()
    return out


def _port(model, **kw):
    return LLMEngine(model, device="cpu", **W.engine_kwargs(kw, model))


def _ref(model, tp=None, **kw):
    return RefEngine(model, mesh=ref_mesh(tp) if tp else None,
                     **W.engine_kwargs(kw, model))


def _drain(eng, rid, prompt, n):
    eng.add_request(rid, prompt, max_new_tokens=n)
    while eng.has_work():
        eng.step()
    return eng.result(rid)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on the gang (both ranks' results), the reference at tp
    1 and 2, and the single-process port engine."""
    root = str(tmp_path_factory.mktemp("tp_serving"))
    ref = _ref_models()
    port = _port_models(ref)
    np.savez(os.path.join(root, "inputs.npz"), **{
        f"{name}/{k}": np.asarray(v) for name, m in ref.items()
        for k, v in m.raw_state_dict().items()})
    # what the gang imports: a single-process package and capsule
    os.makedirs(os.path.join(root, "in"))
    _, pkg1 = W.migrate_export(_port(port["llama"]))
    W.save_package(os.path.join(root, "in", "pkg_tp1"), pkg1)
    C.enable_capsule_capture()
    try:
        eng = _port(port["llama"])
        _drain(eng, "g", [5, 9, 2, 14], 10)
        with open(os.path.join(root, "in", "capsule_tp1.json"), "w") as f:
            json.dump(C.get_capsule_store().get("g"), f)
    finally:
        C.disable_capsule_capture()

    logs = os.path.join(root, "logs")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", logs, WORKER, root],
        env=_clean_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    # the reference at tp 2 in a process of its own meanwhile (its
    # programs compile anew for each mesh shape)
    env = _clean_env()
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs.append(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), root], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True))
    try:
        out = {"ref1": {}, "port": {}}
        for case, (model, kw, script) in W.CASES.items():
            out["ref1"][case] = script(_ref(ref[model], **kw))
            out["port"][case] = script(_port(port[model], **kw))
        out["migrate_want"] = _drain(_ref(ref["llama"]), *W.MIGRATE)
        single = _port(port["llama"])
        slot = single.cache.allocate(len(W.LOGIT_PROMPT) + 1)
        out["logits"] = single._prefill_seq(slot, W.LOGIT_PROMPT, 0)
        single.cache.release(slot)
        out["memory"] = _port(port["llama"],
                              kv_dtype="int8").cache.memory_rows()
        out["pkg1_blob"] = W.blob_arrays(pkg1["swap"])
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    tails = ""
    if os.path.isdir(logs):
        for f in sorted(os.listdir(logs)):
            with open(os.path.join(logs, f)) as fh:
                tails += f"\n--- {f}\n" + fh.read()[-3000:]
    assert procs[0].returncode == 0, f"gang failed: {errs[0][-2000:]}{tails}"
    assert procs[1].returncode == 0, f"reference tp 2: {errs[1][-3000:]}"
    with open(os.path.join(root, "ref2.json")) as f:
        out["ref2"] = json.load(f)
    out["ranks"] = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            out["ranks"].append(json.load(f))
    out["pkg2"] = W.load_package(os.path.join(root, "out", "pkg_tp2"))
    out["port_models"] = port
    return out


@pytest.mark.parametrize("case", list(W.CASES))
def test_case_equals_reference_tp1_and_tp2(world, case):
    want = world["ref1"][case]
    assert world["ref2"][case] == want, "the reference's tp 2 != its tp 1"
    assert world["port"][case] == want, "single-process port != reference"
    for r, rank in enumerate(world["ranks"]):
        assert rank["cases"][case] == want, f"rank {r} != reference"


def test_gang_is_gloo_of_two(world):
    assert [(r["world"], r["backend"]) for r in world["ranks"]] == \
        [(2, "gloo")] * 2


def test_paths_were_the_ones_asked(world):
    c = world["ranks"][0]["cases"]
    assert (c["swap_in"]["armed"], c["swap_in"]["path"]) == (True,
                                                            "swap_in")
    assert (c["recompute"]["armed"], c["recompute"]["path"]) == (
        False, "recompute")
    assert c["prefix"]["hit_tokens"] > 0
    assert c["abort"]["aborted_live"] and c["abort"]["cancelled"]
    assert c["spec"]["spec"]["accepted"] == c["spec"]["spec"]["proposed"]


@pytest.mark.parametrize("path", ["split", "unified", "moe"])
def test_forward_collectives_are_the_gathers(world, path):
    """One decode forward (steps_per_sync 1) and a two-chunk prefill:
    4 gathers a dense layer, 2 an MoE layer, and no other collective
    (no float all-reduce)."""
    per_layer = 2 if path == "moe" else 4
    for rank in world["ranks"]:
        got = rank["collectives"]
        for what, forwards in (("decode", 1), ("prefill", 2)):
            c = got[f"{path}_{what}"]
            assert c["gathers"] == per_layer * LAYERS * forwards, c
            assert c["calls"] == {"forwards": forwards, "other": 0,
                                  "all_gather_into_tensor": c["gathers"]}
            assert c["bytes"] > 0


def test_logits_equal_single_process(world):
    want = world["logits"].numpy()
    for rank in world["ranks"]:
        np.testing.assert_allclose(np.asarray(rank["logits"]), want,
                                   rtol=0, atol=LOGIT_ATOL)


def test_memory_rows_and_brief_per_shard(world):
    one = world["memory"]
    for rank in world["ranks"]:
        rows, brief = rank["memory"]["rows"], rank["memory"]["brief"]
        assert rows["tp"] == 2
        assert rows["device_bytes_per_shard"] * 2 == rows["device_bytes"]
        assert rows["device_bytes"] == one["device_bytes"]
        assert rows["bytes_per_token"] == one["bytes_per_token"]
        assert brief["device_pool_bytes_per_shard"] * 2 == \
            brief["device_pool_bytes"]
        assert rank["memory"]["k_pages_shape"][1] == 1     # 2 KV heads / 2


def test_export_blob_equals_single_process(world):
    """The gang's blob of the schedule holds what one card's does, and
    both ranks export the same one."""
    meta1, arrays1 = world["pkg1_blob"]
    meta2, arrays2 = W.blob_arrays(world["pkg2"]["swap"])
    assert meta2 == meta1
    assert sorted(arrays2) == sorted(arrays1)
    for k in arrays1:
        np.testing.assert_array_equal(arrays2[k], arrays1[k])
    r0, r1 = (r["migrate_out"] for r in world["ranks"])
    assert r0 == r1 and r0["armed"]


def test_migration_tp2_to_single_process(world):
    eng = _port(world["port_models"]["llama"])
    path, toks = W.migrate_import(eng, world["pkg2"])
    assert path == "swap_in"
    assert toks == world["migrate_want"]


def test_migration_single_process_to_tp2(world):
    for rank in world["ranks"]:
        assert rank["migrate_in"] == {"path": "swap_in",
                                      "tokens": world["migrate_want"]}


def test_capsule_replay_on_and_across_tp(world):
    for rank in world["ranks"]:
        c = rank["capsule"]
        assert c["fingerprint_tp"] == 2
        assert c["on_tp2"] is None
        assert c["tp2_on_single"] is None
        assert c["tp1_on_tp2"] is None


@pytest.mark.parametrize("what,error,match", [
    ("kv_heads", "InvalidArgumentError", "num_key_value_heads"),
    ("fingerprint", "InvalidArgumentError", "seed"),
    ("runtime", "NotImplementedError", "Multi-device"),
])
def test_refusals_on_both_ranks(world, what, error, match):
    for rank in world["ranks"]:
        got = rank["refusals"][what]
        assert got is not None and got["type"] == error, got
        assert match in got["msg"], got


def test_rank_outside_a_mesh_of_one_raises(world):
    r0, r1 = (r["refusals"] for r in world["ranks"])
    assert r0["outside_mesh"] is None
    assert r0["outside_mesh_tokens"] == world["ref1"]["unified"]["tokens"]
    assert r1["outside_mesh"]["type"] == "InvalidArgumentError"
    assert "not on the serving mesh" in r1["outside_mesh"]["msg"]


# -- in-process: the plan ------------------------------------------------------

def _plan(rank, tp=2, axis="tp"):
    return TPShardings(ServingMesh(list(range(tp)), None, (axis,), rank),
                       axis)


def test_tp_shardings_hash_eq_repr():
    a, b = _plan(0), _plan(1)
    assert a == b and hash(a) == hash(b)      # one mesh, seen from 2 ranks
    assert a != _plan(0, tp=1) and a != _plan(0, axis="mp")
    assert repr(a) == "TPShardings(tp=2, axis='tp')"
    assert (a.tp, a.rank, b.rank) == (2, 0, 1)
    assert a.group.shape == {"tp": 2}
    with pytest.raises(ValueError, match="serving mesh"):
        TPShardings(object())


def test_slice_then_quantize_equals_quantize_then_slice():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 128)).astype(np.float32))
    q, s = quantize_absmax(w, axis=0)
    for r in range(2):
        plan = _plan(r)
        qr, sr = quantize_absmax(plan.put(w, -1), axis=0)
        assert torch.equal(qr, q[:, r * 64:(r + 1) * 64])
        assert torch.equal(sr, s[r * 64:(r + 1) * 64])
        assert torch.equal(torch.stack(plan.put((q, s), -1)[1:]),
                           s[None, r * 64:(r + 1) * 64])


@pytest.mark.parametrize("model", ["llama", "moe"])
def test_weight_plan_matches_reference_placement(model):
    """Every array a rank's engine holds equals the reference tp 2
    engine's shard of it on that rank's device (the projections by
    output columns, norms, router and MoE FFN whole)."""
    from paddle_tpu_torch.inference.backbone import resolve_backbone
    ref = _ref_models()
    port = _port_models(ref)
    ref_eng = _ref(ref[model], 2)
    devices = list(ref_eng._shardings.mesh.devices.flat)
    eng = _port(port[model])
    layers = resolve_backbone(port[model]).layers
    for r in range(2):
        eng._sh = _plan(r)
        mine = eng._dense_layers(layers, eng._sh) if model == "llama" \
            else [eng._moe_layer(l) for l in layers]
        for j, stacked in enumerate(ref_eng._stack):
            shard = next(s.data for s in stacked.addressable_shards
                         if s.device == devices[r])
            for li, lw in enumerate(mine):
                if lw[j] is None:       # the reference's [L, 1, 1] zeros
                    continue
                np.testing.assert_array_equal(
                    np.asarray(shard)[li], lw[j].numpy(),
                    err_msg=f"stack entry {j}, layer {li}, rank {r}")


def _reference_tp2(root):
    """Every case on the reference's tp 2 engine, into ``ref2.json``."""
    ref = _ref_models()
    out = {case: script(_ref(ref[model], 2, **kw))
           for case, (model, kw, script) in W.CASES.items()}
    with open(os.path.join(root, "ref2.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    _reference_tp2(sys.argv[1])
