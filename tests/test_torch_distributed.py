"""The port's multi-device training runtime against the reference's, on
the CPU.

One gloo gang of 4 ranks and one of 2, started through the port's own
launcher (``python -m paddle_tpu_torch.distributed.launch``) running
``tests/torch_dist_worker.py`` (no JAX in the ranks), compute everything
once a module; the checks are parametrised over their results.

- Collectives: every eager op and ``ReduceOp`` at worlds 2 and 4 against
  numpy on the ranks' inputs (exact: small integers and halves).
- Training: tiny GPT-2 (weights of the reference's ``paddle.seed(42)``
  model, carried over with ``load_raw_state_dict``), 8 AdamW steps (lr
  1e-3, weight decay 0.01) under ``ClipGradByGlobalNorm(1.0)``, dropout
  0, batch 8 x 31, on the reference's three cases: dp 4, dp 2 x
  sharding 2 at stage 2, sharding 4 at stage 3.  Against the
  reference's ``ShardedTrainStep`` on a 4-device CPU mesh: losses within
  1e-5 relative (they agree to about 1e-7), final parameters within
  1e-3 relative L2 a leaf (the worst leaf is near 3e-4: a bias that
  starts at 0, where Adam's normalised steps turn f32 sums taken in
  another order into differences of that size; the reference's own
  4-device run and the port's single process differ by as much);
  against the port's own single-process ``CompiledTrainStep``: the same
  bounds, and the slots within 1e-4; the per-leaf update
  (``fused_step=False``) at stage 3 against the fused one: the same.
- The sharding plan (the sharded dim of every parameter and slot) and
  the gradient bucket plan equal the reference's.
- Checkpoints saved by the gang (stages 2 and 3) reload bit-equal at
  world 4 and into a single-process ``CompiledTrainStep``; the
  reference's ``validate_checkpoint`` passes them and its
  ``load_state_dict`` reads them onto its CPU mesh bit-equal; a
  single-process checkpoint loads bit-equal onto the world-4 stage-3
  gang.
- A batch whose labels are masked unevenly over the ranks: the port's
  loss is the mean of the ranks' means, which differs from the
  reference's global mean (ROADMAP §C); both figures are pinned.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as ref_ckpt
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed.sharding import ShardingPlan as RefPlan
from paddle_tpu.distributed.trainer import ShardedTrainStep as RefSharded
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCriterion
from paddle_tpu.models.gpt import gpt2_tiny_config as ref_tiny_config

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.distributed.sharding import ShardingPlan
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         gpt2_tiny_config)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

from helpers import make_strategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_dist_worker as W  # noqa: E402

CASES = {"dp4": dict(dp=4), "dp2_s2_stage2": dict(dp=2, sharding=2),
         "s4_stage3": dict(sharding=4)}
STAGE = {"dp4": 1, "dp2_s2_stage2": 2, "s4_stage3": 3}
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-3
SLOT_RTOL = 1e-4


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _clean_env():
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("PADDLE_", "XLA_", "JAX_")):
            env.pop(k)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def launch_gang(root, n, task, timeout=240):
    """The worker on ``n`` gloo ranks through the port's launcher; every
    rank's results."""
    logs = os.path.join(root, "logs")
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(n), "--log_dir", logs, WORKER, str(root),
         task], env=_clean_env(), cwd=REPO, capture_output=True, text=True,
        timeout=timeout)
    tails = ""
    if os.path.isdir(logs):
        for f in sorted(os.listdir(logs)):
            with open(os.path.join(logs, f)) as fh:
                tails += f"\n--- {f}\n" + fh.read()[-3000:]
    assert out.returncode == 0, f"gang failed: {out.stderr[-2000:]}{tails}"
    return [dict(np.load(os.path.join(root, f"rank{r}.npz")))
            for r in range(n)]


def _batches():
    """The reference parity test's batches (``run_training``, seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(W.STEPS):
        ids = ((np.arange(32)[None, :] + rng.integers(0, 8, (8, 1))) % 32
               ).astype(np.int32)
        out.append({"x": ids[:, :-1], "y": ids[:, 1:].astype(np.int64)})
    return out


def _masked_batch():
    """Labels masked (-100) unevenly: rank r's two rows lose 6 r tokens."""
    b = _batches()[0]
    y = b["y"].copy()
    for r in range(4):
        y[2 * r:2 * r + 2, :3 * r] = -100
    return b["x"], y


@pytest.fixture(scope="module")
def weights():
    paddle.seed(42)
    ref = RefGPT(ref_tiny_config())
    return {k: np.asarray(v) for k, v in ref.raw_state_dict().items()}


def _port_model(weights):
    m = GPTForCausalLM(gpt2_tiny_config(), device="cpu")
    load_raw_state_dict(m, weights)
    return m


def _port_single(weights):
    model = _port_model(weights)
    crit = GPTPretrainingCriterion()
    opt = optim.AdamW(learning_rate=W.LR, weight_decay=0.01,
                      parameters=model.parameters(),
                      grad_clip=ClipGradByGlobalNorm(1.0))
    return CompiledTrainStep(model, lambda m, b: crit(m(b["x"]), b["y"]),
                             opt, seed=0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("gang4")


@pytest.fixture(scope="module")
def single(weights, root):
    """The port's own single-process run; its checkpoint is what the
    gang loads at world 4."""
    step = _port_single(weights)
    losses = [float(step(b)) for b in _batches()]
    step.save_checkpoint(str(root / "ckpt_w1"))
    return {"losses": np.array(losses),
            "params": {n: p.detach().numpy().copy()
                       for n, p in step.state["params"].items()},
            "slots": {f"{n}/{k}": v.numpy().copy()
                      for n, s in step.state["opt"]["slots"].items()
                      for k, v in s.items()}}


@pytest.fixture(scope="module")
def gang4(weights, single, root):
    arrays = {f"w/{k}": v for k, v in weights.items()}
    for i, b in enumerate(_batches()):
        arrays[f"x{i}"], arrays[f"y{i}"] = b["x"], b["y"]
    arrays["mask_x"], arrays["mask_y"] = _masked_batch()
    np.savez(root / "inputs.npz", **arrays)
    return launch_gang(root, 4, "train")


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    return launch_gang(tmp_path_factory.mktemp("gang2"), 2, "collectives")


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's ShardedTrainStep on 4 CPU devices, each case: its
    losses, final state and bucket plan."""
    out = {}
    for case, degrees in CASES.items():
        ref_fleet.init(strategy=make_strategy(**degrees),
                       devices=jax.devices()[:4])
        paddle.seed(42)
        model = RefGPT(ref_tiny_config())
        crit = RefCriterion()
        opt = paddle.optimizer.AdamW(
            learning_rate=W.LR, weight_decay=0.01,
            grad_clip=paddle.ClipGradByGlobalNorm(1.0))
        step = RefSharded(model, lambda m, b: crit(m(b["x"]), b["y"]), opt,
                          stage=STAGE[case], seed=0)
        losses = [float(step(b)) for b in _batches()]
        out[case] = {
            "losses": np.array(losses), "buckets": step.grad_buckets(),
            "params": {n: np.asarray(v)
                       for n, v in step.state["params"].items()},
            "slots": {f"{n}/{k}": np.asarray(v)
                      for n, s in step.state["opt"]["slots"].items()
                      for k, v in s.items()},
            "state": step.state, "mesh": step.mesh}
        ref_fleet.reset()
    return out


# -- the sharding plan ---------------------------------------------------------

def _norm_spec(spec, ndim):
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple("sharding" if e == "sharding" or (
        isinstance(e, tuple) and "sharding" in e) else None
        for e in entries)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_sharding_plan_matches_reference(stage):
    ref_mesh = ref_fleet.init(strategy=make_strategy(sharding=4),
                              devices=jax.devices()[:4]).mesh
    paddle.seed(0)
    ref = RefPlan(RefGPT(ref_tiny_config()), ref_mesh, stage=stage)
    port = ShardingPlan(GPTForCausalLM(gpt2_tiny_config(), device="cpu"),
                        degree=4, stage=stage)
    assert set(port.param_specs) == set(ref.param_specs)
    sharded = 0
    for n, shape in port.shapes.items():
        assert port.param_specs[n] == _norm_spec(ref.param_specs[n],
                                                 len(shape)), n
        assert port.slot_specs[n] == _norm_spec(ref.slot_specs[n],
                                                len(shape)), n
        sharded += port.slot_dim(n) is not None
    assert sharded > 0


@pytest.mark.parametrize("case", list(CASES))
def test_grad_buckets_match_reference(case, gang4, reference):
    got = json.loads(str(gang4[0][f"{case}/buckets"]))
    assert got == reference[case]["buckets"]
    for r in gang4[1:]:
        assert json.loads(str(r[f"{case}/buckets"])) == got


# -- training ------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_reference(case, gang4, reference):
    ref = reference[case]
    losses = gang4[0][f"{case}/losses"]
    for r in gang4[1:]:
        np.testing.assert_array_equal(r[f"{case}/losses"], losses)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    for n, want in ref["params"].items():
        got = gang4[0][f"{case}/param/{n}"]
        assert _rel_l2(want, got) <= PARAM_RTOL, (n, _rel_l2(want, got))


@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_single_process(case, gang4, single):
    np.testing.assert_allclose(gang4[0][f"{case}/losses"],
                               single["losses"], rtol=LOSS_RTOL)
    for n, want in single["params"].items():
        got = gang4[0][f"{case}/param/{n}"]
        assert _rel_l2(want, got) <= PARAM_RTOL, (n, _rel_l2(want, got))
    for k, want in single["slots"].items():
        got = gang4[0][f"{case}/slot/{k}"]
        assert _rel_l2(want, got) <= SLOT_RTOL, (k, _rel_l2(want, got))


def test_per_leaf_update_matches_the_fused_one(gang4):
    """``fused_step=False`` at stage 3: the optimizer's per-leaf update on
    this rank's parts, the global-norm clip's scale from the gang's norm,
    against the fused kernel's path (the same bounds)."""
    np.testing.assert_allclose(gang4[0]["unfused/losses"],
                               gang4[0]["s4_stage3/losses"], rtol=LOSS_RTOL)
    for n in gang4[0]:
        if n.startswith("unfused/param/"):
            want = gang4[0]["s4_stage3/param/" + n[len("unfused/param/"):]]
            assert _rel_l2(want, gang4[0][n]) <= PARAM_RTOL, n


def test_masked_labels_loss_is_the_mean_of_rank_means(gang4, weights):
    """The pinned gap (ROADMAP §C): with ignore_index rows spread
    unevenly, the gang's loss is the mean of the ranks' own means, not
    the global mean over valid tokens the reference computes."""
    local = np.array([float(r["masked/local_loss"]) for r in gang4])
    got = float(gang4[0]["masked/loss"])
    np.testing.assert_allclose(got, local.mean(), rtol=1e-6)
    x, y = _masked_batch()
    model = _port_model(weights)
    with torch.no_grad():
        whole = float(GPTPretrainingCriterion()(
            model(torch.from_numpy(x)), torch.from_numpy(y)))
    # at initialisation every token's loss is near ln V, so the gap is
    # small (1.9e-5 relative here) but some twenty times f32 noise
    gap = abs(got - whole) / whole
    assert 5e-6 < gap < 1e-3, (got, whole, gap)
    assert abs(local.mean() - whole) / whole > 5e-6


# -- checkpoints -----------------------------------------------------------------

STAGED = ["dp2_s2_stage2", "s4_stage3"]


@pytest.mark.parametrize("case", STAGED)
def test_checkpoint_reloads_bit_equal_at_world_4(case, gang4):
    for r in gang4:
        assert bool(r[f"{case}/reload_w4_equal"])
        a, b = r[f"{case}/reload_w4_next"]
        assert a == b


def _single_template():
    model = GPTForCausalLM(gpt2_tiny_config(), device="cpu")
    opt = optim.AdamW(learning_rate=W.LR, weight_decay=0.01,
                      parameters=model.parameters(),
                      grad_clip=ClipGradByGlobalNorm(1.0))
    crit = GPTPretrainingCriterion()
    return CompiledTrainStep(model, lambda m, b: crit(m(b["x"]), b["y"]),
                             opt, seed=0)


@pytest.mark.parametrize("case", STAGED)
def test_checkpoint_reloads_bit_equal_at_world_1(case, gang4, root):
    step = _single_template()
    step.load_checkpoint(str(root / f"ckpt_{case}"))
    for n, p in step.state["params"].items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      gang4[0][f"{case}/param/{n}"])
    for n, s in step.state["opt"]["slots"].items():
        for k, v in s.items():
            np.testing.assert_array_equal(v.numpy(),
                                          gang4[0][f"{case}/slot/{n}/{k}"])
    assert step.step_count == W.STEPS


@pytest.mark.parametrize("case", STAGED)
def test_reference_validates_and_reads_the_checkpoint(case, gang4, root,
                                                      reference):
    path = str(root / f"ckpt_{case}")
    meta = ref_ckpt.validate_checkpoint(path)
    # the sharded slots were written as several chunks, one a part
    assert any(len(e["chunks"]) > 1 for e in meta["arrays"].values())
    ref_state = reference[case]["state"]
    template = {"state": {"params": dict(ref_state["params"]),
                          "opt": {"slots": {n: dict(s) for n, s in
                                            ref_state["opt"]["slots"].items()}}}}
    ref_ckpt.load_state_dict(template, path)
    for n, v in template["state"]["params"].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      gang4[0][f"{case}/param/{n}"])
    for n, s in template["state"]["opt"]["slots"].items():
        for k, v in s.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          gang4[0][f"{case}/slot/{n}/{k}"])


def test_single_process_checkpoint_loads_onto_world_4(gang4, single):
    assert int(gang4[0]["w1_to_w4/step_count"]) == W.STEPS
    for n, want in single["params"].items():
        np.testing.assert_array_equal(gang4[0][f"w1_to_w4/param/{n}"], want)
    for k, want in single["slots"].items():
        np.testing.assert_array_equal(gang4[0][f"w1_to_w4/slot/{k}"], want)


# -- collectives ---------------------------------------------------------------------

def _inputs(rank, world):
    base = np.arange(world * 6, dtype=np.float32).reshape(world * 2, 3) \
        + 100.0 * rank
    small = np.array([rank + 1.0, 2.0 - rank, 0.5 * (rank + 1)], np.float32)
    return base, small


def _expected(name, rank, world):
    bases = [_inputs(r, world)[0] for r in range(world)]
    smalls = np.stack([_inputs(r, world)[1] for r in range(world)])
    chunk = lambda a, i: np.split(a, world)[i]   # noqa: E731
    return {
        "all_reduce_SUM": smalls.sum(0), "all_reduce_MAX": smalls.max(0),
        "all_reduce_MIN": smalls.min(0), "all_reduce_PROD": smalls.prod(0),
        "all_reduce_AVG": smalls.mean(0),
        "all_gather_list": np.stack(bases),
        "all_gather": np.concatenate(bases),
        "reduce_scatter": chunk(sum(bases), rank),
        "reduce_scatter_list": chunk(sum(bases), rank),
        "all_to_all": np.concatenate([chunk(b, rank) for b in bases]),
        "all_to_all_list": np.stack([chunk(b, rank) for b in bases]),
        "all_to_all_single": np.concatenate([chunk(b, rank)
                                             for b in bases]),
        "broadcast": bases[1], "scatter": np.full(3, 10.0 * rank + 1),
        "reduce": smalls.sum(0), "gather": smalls,
        "psum": smalls.sum(0), "pmean": smalls.mean(0),
        "pmax": smalls.max(0),
        "all_gather_object": np.array([10.0 * r + r for r in range(world)]),
        "broadcast_object_list": np.array([2.0, 1.0]),
        "scatter_object_list": np.array([7.0 * rank]),
        "subgroup_all_reduce": smalls[:2].sum(0) if rank < 2
        else smalls[rank],
        "subgroup_of_one": smalls[rank],
    }[name]


COLLECTIVES = ["all_reduce_SUM", "all_reduce_MAX", "all_reduce_MIN",
               "all_reduce_PROD", "all_reduce_AVG", "all_gather_list",
               "all_gather", "reduce_scatter", "reduce_scatter_list",
               "all_to_all", "all_to_all_list", "all_to_all_single",
               "broadcast", "scatter", "reduce", "gather", "psum", "pmean",
               "pmax", "all_gather_object", "broadcast_object_list",
               "scatter_object_list", "subgroup_all_reduce",
               "subgroup_of_one"]


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("world", [2, 4])
def test_collective_matches_numpy(world, name, gang2, gang4):
    gang = gang2 if world == 2 else gang4
    for rank, res in enumerate(gang):
        assert str(res["backend"]) == "gloo" and int(res["world"]) == world
        np.testing.assert_allclose(res[f"coll/{name}"],
                                   _expected(name, rank, world), rtol=1e-6,
                                   err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("call", [
    lambda: dist.send(torch.ones(2), 1), lambda: dist.recv(torch.ones(2), 0),
    lambda: dist.isend(torch.ones(2), 1),
    lambda: dist.irecv(torch.ones(2), 0),
    lambda: dist.collective.ppermute(torch.ones(2), None, [(0, 1)]),
    lambda: dist.collective.axis_index(None)],
    ids=["send", "recv", "isend", "irecv", "ppermute", "axis_index"])
def test_point_to_point_raises(call):
    with pytest.raises(NotImplementedError, match="Multi-device"):
        call()
