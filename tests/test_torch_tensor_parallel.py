"""The port's tensor-parallel (mp) training against the reference's, on
the CPU.

One gloo gang of 4 ranks, started through the port's launcher
(``python -m paddle_tpu_torch.distributed.launch``) running
``tests/torch_mp_worker.py`` (no JAX in the ranks), computes everything
once a module; the checks are parametrised over its results.

- Layers, at mp 4 and at mp 2 (under dp 2), against the reference's
  ``parallel_layers`` built on a 4-device CPU mesh of the same degrees
  (eager, forward and gradients, within 1e-5): the column -> row MLP
  both ways (the reference's own check, ``tests/test_distributed.py``
  ``test_column_row_matches_plain_mlp``), ``VocabParallelEmbedding``,
  ``ParallelCrossEntropy`` with ignored labels, ``ScatterOp`` /
  ``GatherOp`` round trips; the vocab-parallel
  ``fused_linear_cross_entropy`` against the whole one (the port's and
  the reference's), untied and tied, three chunks (9 all-reduces
  forward, 1 backward); a seeded layer's parts put together equal one
  process's layer.
- Tiny Llama's other routes at dp 2 x mp 2 (``fuse_qkv``, a tied head
  with the unfused cross-entropy, ``core_attn`` and ``dots``
  recompute): loss and gradients against one process's.
- The sharding plan of tiny Llama at mp 2 x sharding 2 equals the
  reference's ``ShardingPlan`` at stages 1-3 (one leaf split on two
  dims).
- Training: 8 AdamW steps (lr 1e-3, weight decay 0.01) under
  ``ClipGradByGlobalNorm(1.0)`` on the batches of
  ``tests/test_torch_distributed.py``, with the weights of the
  reference's ``paddle.seed(42)`` models: tiny Llama at dp 2 x mp 2
  (stage 1), mp 2 x sharding 2 (stage 3), mp 4 (4 KV heads), and tiny
  GPT-2 at dp 2 x mp 2 (replicated over mp, as the reference runs it).
  Against the reference's ``ShardedTrainStep`` on the CPU mesh: losses
  within 1e-5 relative, parameters within 1e-3 relative L2 a leaf;
  against the port's single-process ``CompiledTrainStep``: the same,
  and the slots within 1e-4 (the bounds of
  ``tests/test_torch_distributed.py``).  The bucket plans equal the
  reference's; the mp collectives a step equal the formula (4 a layer,
  the embedding's, the head's, 3 a cross-entropy chunk, the clip's) and
  their bytes the shapes'.
- The mp 2 x sharding 2 stage-3 checkpoint reloads bit-equal at world 4
  (the same next step), onto dp 4 at mp 1, and into a single-process
  ``CompiledTrainStep``; the reference's ``load_state_dict`` reads it
  onto its mesh bit-equal.
- Refusals: KV heads that mp does not divide; Qwen2-MoE, ERNIE-4.5 and
  DiT under mp 2 (in the gang); pipeline, sequence and expert degrees;
  degrees whose product is not the world size (a plain ``ValueError``).
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as ref_ckpt
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed import parallel_layers as ref_pl
from paddle_tpu.distributed.sharding import ShardingPlan as RefPlan
from paddle_tpu.distributed.trainer import ShardedTrainStep as RefSharded
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCriterion
from paddle_tpu.models.gpt import gpt2_tiny_config as ref_gpt_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_llama_tiny
from paddle_tpu.ops import _nn as ref_nn

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import parallel_layers as pl
from paddle_tpu_torch.distributed.sharding import ShardingPlan
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         gpt2_tiny_config)
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import _nn

from helpers import make_strategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_mp_worker as W  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-3
SLOT_RTOL = 1e-4
LAYER_TOL = 1e-5
MPS = [2, 4]
LLAMA_CASES = [c for c, v in W.CASES.items() if v[0] != "gpt"]
CKPT = "llama_mp2_s2_stage3"


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


def _batches():
    """``tests/test_torch_distributed.py``'s batches (seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(W.STEPS):
        ids = ((np.arange(32)[None, :] + rng.integers(0, 8, (8, 1))) % 32
               ).astype(np.int32)
        out.append({"x": ids[:, :-1], "y": ids[:, 1:].astype(np.int64)})
    return out


@pytest.fixture(scope="module")
def batches():
    return _batches()


def _ref_model(kind):
    paddle.seed(42)
    if kind == "gpt":
        return RefGPT(ref_gpt_tiny())
    cfg = ref_llama_tiny()
    if kind == "llama_kv4":
        cfg = dataclasses.replace(cfg, num_key_value_heads=4)
    return RefLlama(cfg)


def _ref_loss_fn(kind):
    if kind == "gpt":
        crit = RefCriterion()
        return lambda m, b: crit(m(b["x"]), b["y"])
    return lambda m, b: m(b["x"], labels=b["y"])


@pytest.fixture(scope="module")
def weights():
    return {kind: {k: np.asarray(v)
                   for k, v in _ref_model(kind).raw_state_dict().items()}
            for kind in ("llama", "llama_kv4", "gpt")}


def _ref_layers(mp):
    """The reference's column -> row pair and vocab-parallel embedding,
    built under a mesh with ``mp``."""
    ref_fleet.init(strategy=make_strategy(dp=4 // mp, mp=mp),
                   devices=jax.devices()[:4])
    paddle.seed(0)
    col = ref_pl.ColumnParallelLinear(16, 32, gather_output=False)
    row = ref_pl.RowParallelLinear(32, 8, input_is_parallel=True)
    emb = ref_pl.VocabParallelEmbedding(64, 16)
    return col, row, emb


@pytest.fixture(scope="module")
def layer_inputs():
    rng = np.random.default_rng(7)
    col, row, emb = _ref_layers(4)
    ref_fleet.reset()
    f32 = np.float32
    label = rng.integers(0, 64, 40)
    label[[3, 17, 30]] = -100
    ce_label = rng.integers(0, 64, 12)
    ce_label[[2, 9]] = -100
    return {
        "mlp/w1": np.asarray(col.weight.numpy()),
        "mlp/b1": rng.normal(size=32).astype(f32),
        "mlp/w2": np.asarray(row.weight.numpy()),
        "mlp/b2": rng.normal(size=8).astype(f32),
        "mlp/x": rng.normal(size=(4, 16)).astype(f32),
        "mlp/cot": rng.normal(size=(4, 8)).astype(f32),
        "emb/w": np.asarray(emb.weight.numpy()),
        "emb/ids": rng.integers(0, 64, (4, 8)),
        "emb/cot": rng.normal(size=(4, 8, 16)).astype(f32),
        "ce/logits": (3 * rng.normal(size=(12, 64))).astype(f32),
        "ce/label": ce_label, "ce/cot": rng.normal(size=12).astype(f32),
        "seq/x": rng.normal(size=(2, 8, 6)).astype(f32),
        "seq/cot": rng.normal(size=(2, 8, 6)).astype(f32),
        "flce/x": rng.normal(size=(2, 20, 16)).astype(f32),
        "flce/w": (0.3 * rng.normal(size=(16, 64))).astype(f32),
        "flce/label": label.reshape(2, 20),
        "mlpt/x": rng.normal(size=(8, 16)).astype(f32),
        "mlpt/y": rng.normal(size=(8, 8)).astype(f32)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("mp_gang")


@pytest.fixture(scope="module")
def gang(weights, layer_inputs, root):
    arrays = dict(layer_inputs)
    for kind, w in weights.items():
        arrays.update({f"w_{kind}/{k}": v for k, v in w.items()})
    for i, b in enumerate(_batches()):
        arrays[f"x{i}"], arrays[f"y{i}"] = b["x"], b["y"]
    np.savez(root / "inputs.npz", **arrays)
    logs = root / "logs"
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "4", "--log_dir", str(logs), WORKER,
         str(root)], env=_clean_env(), cwd=REPO, capture_output=True,
        text=True, timeout=300)
    tails = ""
    if logs.is_dir():
        for f in sorted(os.listdir(logs)):
            tails += f"\n--- {f}\n" + (logs / f).read_text()[-3000:]
    assert out.returncode == 0, f"gang failed: {out.stderr[-2000:]}{tails}"
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def reference():
    """The reference's ShardedTrainStep on 4 CPU devices, each case."""
    out = {}
    for case, (kind, dp, sharding, mp, stage) in W.CASES.items():
        ref_fleet.init(strategy=make_strategy(dp=dp, sharding=sharding,
                                              mp=mp),
                       devices=jax.devices()[:4])
        opt = paddle.optimizer.AdamW(
            learning_rate=W.LR, weight_decay=0.01,
            grad_clip=paddle.ClipGradByGlobalNorm(1.0))
        step = RefSharded(_ref_model(kind), _ref_loss_fn(kind), opt,
                          stage=stage, seed=0)
        losses = [float(step(b)) for b in _batches()]
        out[case] = {
            "losses": np.array(losses), "buckets": step.grad_buckets(),
            "params": {n: np.asarray(v)
                       for n, v in step.state["params"].items()},
            "state": step.state}
        ref_fleet.reset()
    return out


def _port_single(kind, weights):
    if kind == "gpt":
        model = GPTForCausalLM(gpt2_tiny_config(), device="cpu")
        crit = GPTPretrainingCriterion()
        loss_fn = lambda m, b: crit(m(b["x"]), b["y"])  # noqa: E731
    else:
        cfg = llama_tiny_config()
        if kind == "llama_kv4":
            cfg = dataclasses.replace(cfg, num_key_value_heads=4)
        model = LlamaForCausalLM(cfg, device="cpu")
        loss_fn = lambda m, b: m(b["x"], labels=b["y"])  # noqa: E731
    load_raw_state_dict(model, weights[kind])
    opt = optim.AdamW(learning_rate=W.LR, weight_decay=0.01,
                      parameters=model.parameters(),
                      grad_clip=ClipGradByGlobalNorm(1.0))
    return CompiledTrainStep(model, loss_fn, opt, seed=0)


@pytest.fixture(scope="module")
def single(weights):
    """The port's own single-process runs, one a model."""
    out = {}
    for kind in ("llama", "llama_kv4", "gpt"):
        step = _port_single(kind, weights)
        losses = [float(step(b)) for b in _batches()]
        out[kind] = {
            "losses": np.array(losses),
            "params": {n: p.detach().numpy().copy()
                       for n, p in step.state["params"].items()},
            "slots": {f"{n}/{k}": v.numpy().copy()
                      for n, s in step.state["opt"]["slots"].items()
                      for k, v in s.items()}}
    return out


# -- layers ------------------------------------------------------------------------

def _p(a, grad=True):
    return paddle.to_tensor(np.asarray(a), stop_gradient=not grad)


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=LAYER_TOL,
                               atol=LAYER_TOL, err_msg=what)


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("way", ["split", "gathered"])
def test_column_row_mlp_matches_reference(mp, way, gang, layer_inputs):
    """Column -> row against the reference's pair on a mesh of this mp
    (eager: its layers are the plain product there), output and every
    gradient; each rank of the gang holds the same whole results."""
    li = layer_inputs
    col, row, _ = _ref_layers(mp)
    col.weight.set_value(li["mlp/w1"])
    col.bias.set_value(li["mlp/b1"])
    row.weight.set_value(li["mlp/w2"])
    row.bias.set_value(li["mlp/b2"])
    x = _p(li["mlp/x"])
    y = row(paddle.nn.functional.relu(col(x)))
    (y * _p(li["mlp/cot"], False)).sum().backward()
    ref_fleet.reset()
    want = {"y": y.numpy(), "dx": x.grad.numpy(),
            "dw1": col.weight.grad.numpy(), "db1": col.bias.grad.numpy(),
            "dw2": row.weight.grad.numpy(), "db2": row.bias.grad.numpy()}
    for r in gang:
        for k, w in want.items():
            _close(r[f"layer/mp{mp}/mlp_{way}/{k}"], w, f"rank {k}")


@pytest.mark.parametrize("mp", MPS)
def test_vocab_parallel_embedding_matches_reference(mp, gang, layer_inputs):
    li = layer_inputs
    _, _, emb = _ref_layers(mp)
    emb.weight.set_value(li["emb/w"])
    e = emb(_p(li["emb/ids"], False))
    (e * _p(li["emb/cot"], False)).sum().backward()
    ref_fleet.reset()
    for r in gang:
        _close(r[f"layer/mp{mp}/emb/y"], e.numpy(), "embedding")
        _close(r[f"layer/mp{mp}/emb/dw"], emb.weight.grad.numpy(),
               "embedding gradient")


@pytest.mark.parametrize("mp", MPS)
def test_parallel_cross_entropy_matches_reference(mp, gang, layer_inputs):
    """Three all-reduces (max, sum of exponentials, label logit); the
    ignored labels' rows are 0 with no gradient."""
    li = layer_inputs
    ref_fleet.init(strategy=make_strategy(dp=4 // mp, mp=mp),
                   devices=jax.devices()[:4])
    logits = _p(li["ce/logits"])
    loss = ref_pl.ParallelCrossEntropy(ignore_index=-100)(
        logits, _p(li["ce/label"], False))
    (loss * _p(li["ce/cot"], False)).sum().backward()
    ref_fleet.reset()
    ignored = li["ce/label"] == -100
    for r in gang:
        got = r[f"layer/mp{mp}/ce/loss"]
        _close(got, loss.numpy(), "loss")
        _close(r[f"layer/mp{mp}/ce/dlogits"], logits.grad.numpy(),
               "logits gradient")
        assert np.all(got[ignored] == 0)
        assert np.all(r[f"layer/mp{mp}/ce/dlogits"][ignored] == 0)


@pytest.mark.parametrize("mp", MPS)
def test_scatter_gather_round_trip(mp, gang, layer_inputs):
    """``ScatterOp`` gives each rank its part of the sequence, ``GatherOp``
    puts it back: the round trip is the reference's (an identity there),
    values and gradient."""
    x, cot = layer_inputs["seq/x"], layer_inputs["seq/cot"]
    ref_fleet.init(strategy=make_strategy(dp=4 // mp, mp=mp),
                   devices=jax.devices()[:4])
    xr = _p(x)
    back = ref_pl.GatherOp.apply(ref_pl.ScatterOp.apply(xr))
    (back * _p(cot, False)).sum().backward()
    ref_fleet.reset()
    s = x.shape[1] // mp
    for rank, r in enumerate(gang):
        i = rank % mp
        np.testing.assert_array_equal(r[f"layer/mp{mp}/seq/part"],
                                      x[:, i * s:(i + 1) * s])
        np.testing.assert_array_equal(r[f"layer/mp{mp}/seq/back"],
                                      back.numpy())
        np.testing.assert_array_equal(r[f"layer/mp{mp}/seq/dx"],
                                      xr.grad.numpy())


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_vocab_parallel_fused_linear_ce_matches_the_whole_one(
        mp, tied, gang, layer_inputs):
    """The chunked linear + CE over a vocab-split head against the whole
    one, the port's and the reference's: loss, x's gradient (the parts
    all-reduced by ``_c_identity``) and the head's; 3 chunks of 16
    tokens make 9 all-reduces forward, ``_c_identity`` 1 backward."""
    li = layer_inputs
    w = li["flce/w"].T.copy() if tied else li["flce/w"]
    xt = torch.tensor(li["flce/x"], requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = _nn.fused_linear_cross_entropy(
        xt, wt, torch.tensor(li["flce/label"]), transpose_weight=tied,
        chunk_size=16)
    loss.backward()

    def ref(x, w):
        return ref_nn.fused_linear_cross_entropy(
            x, w, jnp.asarray(li["flce/label"]), transpose_weight=tied,
            chunk_size=16)
    rl, (rdx, rdw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(li["flce/x"]), jnp.asarray(w))
    t = f"layer/mp{mp}/flce_{'tied' if tied else 'untied'}"
    for r in gang:
        for got, whole, want, what in (
                (r[f"{t}/loss"], loss.detach().numpy(), rl, "loss"),
                (r[f"{t}/dx"], xt.grad.numpy(), rdx, "dx"),
                (r[f"{t}/dw"], wt.grad.numpy(), rdw, "dw")):
            _close(got, whole, f"{what} against the port's whole one")
            _close(got, want, f"{what} against the reference's")
        assert int(r[f"{t}/mp_collectives"]) == 3 * 3 + 1


@pytest.mark.parametrize("mp", MPS)
def test_seeded_layer_parts_equal_one_process(mp, gang):
    """A layer draws its whole weight from its generator and keeps its
    slice: the gang's parts put together equal one process's weight,
    and ``dist_spec`` stays on the parameter."""
    fleet.reset()
    whole = pl.ColumnParallelLinear(
        16, 32, device="cpu", generator=torch.Generator().manual_seed(5))
    for r in gang:
        np.testing.assert_array_equal(r[f"layer/mp{mp}/seeded_w"],
                                      whole.weight.detach().numpy())
        assert json.loads(str(r[f"layer/mp{mp}/seeded_spec"])) == \
            [None, "mp"]


@pytest.mark.parametrize("update", ["fused", "per_leaf"])
def test_parallel_layers_train_through_the_sharded_step(update, gang,
                                                       layer_inputs):
    """A model built of ``parallel_layers`` under ``fleet.init`` holds its
    mp parts, and ``ShardedTrainStep`` trains it at dp 2 x mp 2 (the
    clip's norm summed over mp), with #8 or with the per-leaf update
    (``fused_step=False``): 4 AdamW steps equal one process's plain
    layers within the training bounds; a step's mp collectives are the
    row product's sum and the clip's (the batch needs no gradient, so
    the column's ``_c_identity`` reduces none)."""
    li = layer_inputs
    fleet.reset()
    model = W.LayerMLP()
    with torch.no_grad():
        model.col.weight.copy_(torch.tensor(li["mlp/w1"]))
        model.col.bias.copy_(torch.tensor(li["mlp/b1"]))
        model.row.weight.copy_(torch.tensor(li["mlp/w2"]))
        model.row.bias.copy_(torch.tensor(li["mlp/b2"]))
    step = CompiledTrainStep(model, W.layer_mlp_loss,
                             W.layer_mlp_optimizer(model))
    batch = {"x": torch.tensor(li["mlpt/x"]),
             "y": torch.tensor(li["mlpt/y"])}
    losses = [float(step(batch)) for _ in range(4)]
    tag = f"layer_mlp/{update}"
    for r in gang:
        np.testing.assert_allclose(r[f"{tag}/losses"], losses,
                                   rtol=LOSS_RTOL)
        assert int(r[f"{tag}/mp_collectives"]) == 2
    for n, p in step.state["params"].items():
        got = gang[0][f"{tag}/param/{n}"]
        assert _rel_l2(p.detach().numpy(), got) <= PARAM_RTOL, n


@pytest.mark.parametrize("route", list(W.ROUTES))
def test_llama_routes_match_one_process(route, gang, batches):
    """Tiny Llama at dp 2 x mp 2 through each projection, head and
    recompute route (``fuse_qkv`` concatenates the rank's q/k/v parts; a
    tied head is vocab-parallel from the vocab-sharded embedding; a
    recompute re-issues no collective): the loss within 1e-5 relative
    and every gradient within 1e-4 relative L2 (the slots' bound) of one
    process's model on the same weights, and 4 mp collectives a layer,
    the embedding's, the head's and 3 for the cross-entropy."""
    model = W.route_model(route)
    b = batches[0]
    loss = model(torch.tensor(b["x"]), labels=torch.tensor(b["y"]))
    loss.backward()
    layers = model.config.num_hidden_layers
    for r in gang:
        np.testing.assert_allclose(r[f"route/{route}/loss"],
                                   loss.detach().numpy(), rtol=LOSS_RTOL)
        assert int(r[f"route/{route}/mp_collectives"]) == 4 * layers + 5
        for n, p in model.named_parameters():
            got = r[f"route/{route}/grad/{n}"]
            assert _rel_l2(p.grad.numpy(), got) <= SLOT_RTOL, (n, route)


# -- the plan ------------------------------------------------------------------------

def _norm_spec(spec, ndim):
    entries = list(spec) + [None] * (ndim - len(spec))
    out = []
    for e in entries:
        axes = e if isinstance(e, tuple) else (e,)
        named = [a for a in axes if a in ("mp", "sharding")]
        assert len(named) <= 1, spec
        out.append(named[0] if named else None)
    return tuple(out)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_sharding_plan_matches_reference(stage):
    """Tiny Llama at mp 2 x sharding 2: every parameter's and slot's
    spec equals the reference's (the mp dim from ``dist_spec``, the ZeRO
    dim beside it), and this rank's part is the global shape cut on the
    mp dim."""
    ref_mesh = ref_fleet.init(strategy=make_strategy(mp=2, sharding=2),
                              devices=jax.devices()[:4]).mesh
    paddle.seed(0)
    ref = RefPlan(RefLlama(ref_llama_tiny()), ref_mesh, stage=stage)
    ref_fleet.reset()
    port = ShardingPlan(LlamaForCausalLM(llama_tiny_config(), device="cpu"),
                        degree=2, stage=stage, mp=2)
    assert set(port.param_specs) == set(ref.param_specs)
    two_dims = 0
    for n, shape in port.global_shapes.items():
        assert port.param_specs[n] == _norm_spec(ref.param_specs[n],
                                                 len(shape)), n
        assert port.slot_specs[n] == _norm_spec(ref.slot_specs[n],
                                                len(shape)), n
        md = port.mp_dim(n)
        want = list(shape)
        if md is not None:
            want[md] //= 2
        assert list(port.shapes[n]) == want, n
        two_dims += md is not None and port.slot_dim(n) is not None
    assert two_dims > 0


# -- training ------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(W.CASES))
def test_training_matches_reference(case, gang, reference):
    ref = reference[case]
    losses = gang[0][f"{case}/losses"]
    for r in gang[1:]:
        np.testing.assert_array_equal(r[f"{case}/losses"], losses)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    for n, want in ref["params"].items():
        got = gang[0][f"{case}/param/{n}"]
        assert _rel_l2(want, got) <= PARAM_RTOL, (n, _rel_l2(want, got))


@pytest.mark.parametrize("case", list(W.CASES))
def test_training_matches_single_process(case, gang, single):
    one = single[W.CASES[case][0]]
    np.testing.assert_allclose(gang[0][f"{case}/losses"], one["losses"],
                               rtol=LOSS_RTOL)
    for n, want in one["params"].items():
        got = gang[0][f"{case}/param/{n}"]
        assert _rel_l2(want, got) <= PARAM_RTOL, (n, _rel_l2(want, got))
    for k, want in one["slots"].items():
        got = gang[0][f"{case}/slot/{k}"]
        assert _rel_l2(want, got) <= SLOT_RTOL, (k, _rel_l2(want, got))


@pytest.mark.parametrize("case", list(W.CASES))
def test_grad_buckets_match_reference(case, gang, reference):
    got = json.loads(str(gang[0][f"{case}/buckets"]))
    assert got == reference[case]["buckets"]
    for r in gang[1:]:
        assert json.loads(str(r[f"{case}/buckets"])) == got


def _mp_formula(case):
    """(mp collectives, their bytes) a step of a tiny Llama case, by the
    formula ``chip_smoke.py`` holds the card's ``train_mp`` to: a layer's
    2 forward all-reduces (o_proj, down_proj) and 2 backward
    (``_c_identity`` before q/k/v and gate/up), each of the rank's
    hidden states in f32; the embedding's; the head input's gradient;
    3 a cross-entropy chunk of f32 rows; the clip's f32 scalar."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    kind, dp, sharding, mp, _ = W.CASES[case]
    cfg = llama_tiny_config()
    tokens = 8 // (dp * sharding) * 31
    return cs.mp_collectives_a_step(cfg.num_hidden_layers, tokens,
                                    cfg.hidden_size, el=4)


@pytest.mark.parametrize("case", list(W.CASES))
def test_mp_collectives_a_step_follow_the_formula(case, gang):
    """The last step's mp collectives and bytes on every rank: Llama's by
    the formula (a recompute would re-issue none: every policy keeps the
    row products' sums); GPT-2, replicated over mp, makes none."""
    for r in gang:
        total, _, n_mp, mp_bytes = (int(v) for v in r[f"{case}/comm"])
        if W.CASES[case][0] == "gpt":
            assert n_mp == 0 and mp_bytes == 0
            continue
        assert (n_mp, mp_bytes) == _mp_formula(case)
        # the data axes' reductions come on top where there are any
        kind, dp, sharding, mp, _ = W.CASES[case]
        assert total > n_mp if dp * sharding > 1 else total == n_mp


@pytest.mark.parametrize("case", list(W.CASES))
def test_ranks_hold_their_parts(case, gang, weights):
    """Every rank keeps its mp part (a ZeRO part of it at stage 3) of the
    Llama leaves the reference annotates; GPT-2's leaves stay whole."""
    kind, dp, sharding, mp, stage = W.CASES[case]
    shapes = json.loads(str(gang[0][f"{case}/local_shapes"]))
    whole = {n: list(v.shape) for n, v in weights[kind].items()}
    z = sharding if stage >= 3 else 1
    if kind == "gpt":
        assert shapes == whole
        return
    for n, shape in shapes.items():
        got = int(np.prod(shape))
        if n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight",
                       "o_proj.weight", "gate_proj.weight",
                       "up_proj.weight", "down_proj.weight",
                       "embed_tokens.weight", "lm_head.weight")):
            assert got * mp * z == int(np.prod(whole[n])), (n, shape)
        else:
            assert got * z == int(np.prod(whole[n])), (n, shape)


# -- checkpoints ---------------------------------------------------------------------

def test_checkpoint_reloads_in_the_same_layout(gang):
    for r in gang:
        assert bool(r["ckpt/same_layout_equal"])
        a, b = r["ckpt/same_layout_next"]
        assert a == b


def test_checkpoint_reloads_onto_another_mp_degree(gang):
    """Saved at mp 2 x sharding 2 (parts on two dims), loaded at dp 4 and
    mp 1: every parameter and slot whole, bit-equal."""
    for r in gang:
        assert bool(r["ckpt/dp4_params_equal"])
        assert bool(r["ckpt/dp4_slots_equal"])
        assert int(r["ckpt/dp4_step_count"]) == W.STEPS


def test_checkpoint_reloads_into_one_process(gang, root, weights):
    step = _port_single("llama", weights)
    step.load_checkpoint(str(root / "ckpt_mp2_s2"))
    for n, p in step.state["params"].items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      gang[0][f"{CKPT}/param/{n}"])
    for n, s in step.state["opt"]["slots"].items():
        for k, v in s.items():
            np.testing.assert_array_equal(v.numpy(),
                                          gang[0][f"{CKPT}/slot/{n}/{k}"])
    assert step.step_count == W.STEPS


def test_reference_reads_the_checkpoint(gang, root, reference):
    path = str(root / "ckpt_mp2_s2")
    meta = ref_ckpt.validate_checkpoint(path)
    # a q_proj weight: 2 mp parts x 2 sharding parts, four chunks
    q = [k for k in meta["arrays"] if k.endswith("0.self_attn.q_proj.weight")
         and "slots" not in k]
    assert len(meta["arrays"][q[0]]["chunks"]) == 4
    ref_state = reference[CKPT]["state"]
    template = {"state": {"params": dict(ref_state["params"]),
                          "opt": {"slots": {n: dict(s) for n, s in
                                            ref_state["opt"]["slots"].items()}}}}
    ref_ckpt.load_state_dict(template, path)
    for n, v in template["state"]["params"].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      gang[0][f"{CKPT}/param/{n}"])
    for n, s in template["state"]["opt"]["slots"].items():
        for k, v in s.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          gang[0][f"{CKPT}/slot/{n}/{k}"])


# -- refusals -------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama_kv2_mp4", "qwen2_moe", "ernie",
                                  "dit"])
def test_refusals_in_a_gang(name, gang):
    for r in gang:
        msg = str(r[f"refuse/{name}"])
        assert msg.startswith("NotImplementedError") and \
            "Multi-device" in msg, msg


@pytest.mark.parametrize("knob", ["pp_degree", "sep_degree", "ep_degree"])
def test_other_degrees_raise_beside_mp(knob):
    s = dist.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2, knob: 2}
    with pytest.raises(NotImplementedError, match="Multi-device"):
        fleet.init(strategy=s, device="cpu")


@pytest.mark.parametrize("degrees", [{"mp_degree": 2},
                                     {"dp_degree": 2, "mp_degree": 2}])
def test_degree_product_must_be_the_world(degrees):
    s = dist.DistributedStrategy()
    s.hybrid_configs = degrees
    with pytest.raises(ValueError, match="the world has 1"):
        fleet.init(strategy=s, device="cpu")
