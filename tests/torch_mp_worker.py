"""The rank program of the tensor-parallel tests (no JAX: it runs in child
processes started by ``paddle_tpu_torch.distributed.launch``).

``python tests/torch_mp_worker.py <dir>`` on every rank of a gloo gang
of 4.  ``<dir>/inputs.npz`` holds what the test process prepared (the
reference models' weights, the batches, the layer cases' weights and
inputs); each rank writes what it computed to ``<dir>/rank<r>.npz``:

- ``layer/mp<k>/...`` (k = 2 under dp 2 x mp 2, k = 4 under mp 4): the
  column -> row MLP both ways (``gather_output`` / ``input_is_parallel``),
  ``VocabParallelEmbedding``, ``ParallelCrossEntropy`` with ignored
  labels, a ``ScatterOp`` / ``GatherOp`` round trip and the
  vocab-parallel ``fused_linear_cross_entropy`` (untied and tied):
  outputs and gradients, whole (gathered over the mp group), and a
  seeded ``ColumnParallelLinear``'s whole weight;
- ``layer_mlp/...``: a column -> row MLP of ``parallel_layers``, 4
  AdamW steps through ``ShardedTrainStep`` at dp 2 x mp 2, the fused
  update and the per-leaf one;
- ``route/<route>/...``: tiny Llama's loss, whole gradients and mp
  collectives on one batch at dp 2 x mp 2 through ``fuse_qkv``, a tied
  head with the unfused cross-entropy, and ``core_attn`` / ``dots``
  recompute;
- ``<case>/...``: 8 AdamW steps with a global-norm clip of tiny Llama at
  dp 2 x mp 2 (stage 1), mp 2 x sharding 2 (stage 3) and mp 4 (4 KV
  heads), and tiny GPT-2 at dp 2 x mp 2 (replicated over mp): losses,
  whole parameters and slots, the step's collectives, the bucket plan;
- ``ckpt/...``: the mp 2 x sharding 2 stage-3 checkpoint reloaded at
  world 4 in the same layout and onto dp 4 (mp 1);
- ``refuse/...``: the refusals that need a gang (KV heads that do not
  split over mp 4; Qwen2-MoE, ERNIE-4.5 and DiT under mp 2).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

STEPS = 8
LR = 1e-3
# case: (model, dp, sharding, mp, stage)
CASES = {"llama_dp2_mp2": ("llama", 2, 1, 2, 1),
         "llama_mp2_s2_stage3": ("llama", 1, 2, 2, 3),
         "llama_mp4": ("llama_kv4", 1, 1, 4, 1),
         "gpt_dp2_mp2": ("gpt", 2, 1, 2, 1)}


def _strategy(dp=1, sharding=1, mp=1):
    from paddle_tpu_torch.distributed import DistributedStrategy
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "sharding_degree": sharding,
                        "mp_degree": mp}
    return s


def _init(dp=1, sharding=1, mp=1):
    from paddle_tpu_torch.distributed import fleet
    return fleet.init(strategy=_strategy(dp, sharding, mp), device="cpu")


def _whole(t, dim, group):
    """``t`` put together over ``group`` on ``dim`` (None: as it is)."""
    from paddle_tpu_torch.distributed import collective as C
    if dim is None:
        return t.detach()
    return C.all_gather_concat(t.detach().contiguous(), dim, group)


def _model(kind, data):
    from paddle_tpu_torch.models.from_jax import load_raw_state_dict
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_tiny_config
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    if kind == "gpt":
        m = GPTForCausalLM(gpt2_tiny_config(), device="cpu")
    else:
        cfg = llama_tiny_config()
        if kind == "llama_kv4":
            cfg = dataclasses.replace(cfg, num_key_value_heads=4)
        m = LlamaForCausalLM(cfg, device="cpu")
    prefix = f"w_{kind}/"
    load_raw_state_dict(m, {k[len(prefix):]: data[k] for k in data.files
                            if k.startswith(prefix)})
    return m


def _loss_fn(kind):
    if kind == "gpt":
        from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
        crit = GPTPretrainingCriterion()
        return lambda m, b: crit(m(b["x"]), b["y"])
    return lambda m, b: m(b["x"], labels=b["y"])


def _trainer(kind, data, dp, sharding, mp, stage):
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed import ShardedTrainStep, fleet
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    _init(dp, sharding, mp)
    model = fleet.distributed_model(_model(kind, data))
    opt = fleet.distributed_optimizer(optim.AdamW(
        learning_rate=LR, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    return ShardedTrainStep(model, _loss_fn(kind), opt, stage=stage,
                            seed=0, device="cpu")


def _whole_slots(step):
    """Every slot whole: put together over the sharding group on its
    ZeRO dim, then over the mp group on its mp dim."""
    from paddle_tpu_torch.distributed import collective as C
    sg = step.hcg.get_sharding_parallel_group()
    out = {}
    for n, slots in step.state["opt"]["slots"].items():
        d, md = step.plan.slot_dim(n), step.plan.mp_dim(n)
        for k, v in slots.items():
            if d is not None:
                v = C.all_gather_concat(v.contiguous(), d, sg)
            out[f"{n}/{k}"] = _whole(v, md, step._mpgroup).numpy().copy()
    return out


def _state_equal(a, b) -> bool:
    for n, t in a.state["params"].items():
        if not torch.equal(t.detach(), b.state["params"][n].detach()):
            return False
        for k, v in a.state["opt"]["slots"][n].items():
            if not torch.equal(v, b.state["opt"]["slots"][n][k]):
                return False
    return torch.equal(a.state["opt"]["step"], b.state["opt"]["step"])


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def layers(data, rank, out):
    """The layer cases at mp 4, then at mp 2 (under dp 2)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import parallel_layers as pl
    from paddle_tpu_torch.ops import _nn
    for mp, hcg in ((4, None), (2, None)):
        hcg = _init(mp=4) if mp == 4 else _init(dp=2, mp=2)
        g = hcg.get_model_parallel_group()
        tag = f"layer/mp{mp}"
        # column -> row both ways
        for way, (gather, parallel) in (("split", (False, True)),
                                        ("gathered", (True, False))):
            col = pl.ColumnParallelLinear(16, 32, gather_output=gather,
                                          device="cpu")
            row = pl.RowParallelLinear(32, 8, input_is_parallel=parallel,
                                       device="cpu")
            with torch.no_grad():
                col.weight.copy_(pl.C._part(_t(data["mlp/w1"]), 1, g))
                col.bias.copy_(pl.C._part(_t(data["mlp/b1"]), 0, g))
                row.weight.copy_(pl.C._part(_t(data["mlp/w2"]), 0, g))
                row.bias.copy_(_t(data["mlp/b2"]))
            x = _t(data["mlp/x"], grad=True)
            y = row(torch.relu(col(x)))
            (y * _t(data["mlp/cot"])).sum().backward()
            out[f"{tag}/mlp_{way}/y"] = y.detach().numpy()
            out[f"{tag}/mlp_{way}/dx"] = x.grad.numpy()
            out[f"{tag}/mlp_{way}/dw1"] = _whole(col.weight.grad, 1, g).numpy()
            out[f"{tag}/mlp_{way}/db1"] = _whole(col.bias.grad, 0, g).numpy()
            out[f"{tag}/mlp_{way}/dw2"] = _whole(row.weight.grad, 0, g).numpy()
            out[f"{tag}/mlp_{way}/db2"] = row.bias.grad.numpy()
        # embedding
        emb = pl.VocabParallelEmbedding(64, 16, device="cpu")
        with torch.no_grad():
            emb.weight.copy_(pl.C._part(_t(data["emb/w"]), 0, g))
        e = emb(_t(data["emb/ids"]))
        (e * _t(data["emb/cot"])).sum().backward()
        out[f"{tag}/emb/y"] = e.detach().numpy()
        out[f"{tag}/emb/dw"] = _whole(emb.weight.grad, 0, g).numpy()
        # cross-entropy over vocab-parallel logits, ignored labels
        logits = pl.C._part(_t(data["ce/logits"]), 1, g).requires_grad_(True)
        loss = pl.ParallelCrossEntropy(ignore_index=-100)(
            logits, _t(data["ce/label"]))
        (loss * _t(data["ce/cot"])).sum().backward()
        out[f"{tag}/ce/loss"] = loss.detach().numpy()
        out[f"{tag}/ce/dlogits"] = _whole(logits.grad, 1, g).numpy()
        # sequence scatter / gather
        x = _t(data["seq/x"], grad=True)
        part = pl.ScatterOp.apply(x)
        back = pl.GatherOp.apply(part)
        (back * _t(data["seq/cot"])).sum().backward()
        out[f"{tag}/seq/part"] = part.detach().numpy()
        out[f"{tag}/seq/back"] = back.detach().numpy()
        out[f"{tag}/seq/dx"] = x.grad.numpy()
        # the vocab-parallel fused linear + cross-entropy, untied and tied
        for tied in (False, True):
            w = _t(data["flce/w"])
            if tied:
                w = w.t().contiguous()
            w = pl.C._part(w, 0 if tied else 1, g).requires_grad_(True)
            x = _t(data["flce/x"], grad=True)
            comm = {}
            with C.count_mp(comm):
                loss = _nn.fused_linear_cross_entropy(
                    C._c_identity(x, g), w, _t(data["flce/label"]),
                    transpose_weight=tied, chunk_size=16, mp_group=g)
                loss.backward()
            t = f"{tag}/flce_{'tied' if tied else 'untied'}"
            out[f"{t}/loss"] = loss.detach().numpy()
            out[f"{t}/dx"] = x.grad.numpy()
            out[f"{t}/dw"] = _whole(w.grad, 0 if tied else 1, g).numpy()
            out[f"{t}/mp_collectives"] = np.array(comm["mp_collectives"])
        # a seeded layer's weight, put together
        seeded = pl.ColumnParallelLinear(
            16, 32, device="cpu", generator=torch.Generator().manual_seed(5))
        out[f"{tag}/seeded_w"] = _whole(seeded.weight, 1, g).numpy()
        out[f"{tag}/seeded_spec"] = np.array(json.dumps(
            seeded.weight.dist_spec))


class LayerMLP(torch.nn.Module):
    """Column -> relu -> row, built of ``parallel_layers`` (whole and
    plain without ``fleet.init``)."""

    def __init__(self):
        super().__init__()
        from paddle_tpu_torch.distributed import parallel_layers as pl
        self.col = pl.ColumnParallelLinear(16, 32, gather_output=False,
                                           device="cpu")
        self.row = pl.RowParallelLinear(32, 8, input_is_parallel=True,
                                        device="cpu")

    def forward(self, x):
        return self.row(torch.relu(self.col(x)))


def layer_mlp_loss(m, b):
    return ((m(b["x"]) - b["y"]) ** 2).mean()


def layer_mlp_optimizer(model):
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    return optim.AdamW(learning_rate=1e-2, weight_decay=0.01,
                       parameters=model.parameters(),
                       grad_clip=ClipGradByGlobalNorm(0.5))


def layer_mlp_train(data, out):
    """``LayerMLP`` with the layer cases' weights, 4 AdamW steps under a
    global-norm clip through ``ShardedTrainStep`` at dp 2 x mp 2, with
    the fused update and the per-leaf one (``fused_step=False``): whole
    parameters, losses and the last step's mp collectives."""
    from paddle_tpu_torch.distributed import ShardedTrainStep, fleet
    for fused in (True, False):
        g = _init(dp=2, mp=2).get_model_parallel_group()
        model = fleet.distributed_model(LayerMLP())
        with torch.no_grad():
            model.col.weight.copy_(C_part(data["mlp/w1"], 1, g))
            model.col.bias.copy_(C_part(data["mlp/b1"], 0, g))
            model.row.weight.copy_(C_part(data["mlp/w2"], 0, g))
            model.row.bias.copy_(_t(data["mlp/b2"]))
        step = ShardedTrainStep(model, layer_mlp_loss,
                                fleet.distributed_optimizer(
                                    layer_mlp_optimizer(model)),
                                fused_step=fused, device="cpu")
        batch = {"x": data["mlpt/x"], "y": data["mlpt/y"]}
        tag = f"layer_mlp/{'fused' if fused else 'per_leaf'}"
        out[f"{tag}/losses"] = np.array([float(step(batch))
                                         for _ in range(4)])
        out[f"{tag}/mp_collectives"] = np.array(
            step.comm["mp_collectives"])
        for n, t in step.full_params().items():
            out[f"{tag}/param/{n}"] = t.numpy().copy()


def C_part(a, dim, g):
    from paddle_tpu_torch.distributed import collective as C
    return C._part(_t(a), dim, g)


# the Llama routes a tensor-parallel forward and backward take beside
# the training cases' default (fuse_norm_rope, the fused linear + CE)
ROUTES = {"fuse_qkv": {"fuse_qkv": True},
          "tied_unfused_ce": {"tie_word_embeddings": True,
                              "fuse_linear_cross_entropy": False},
          "core_attn": {"recompute": True,
                        "recompute_granularity": "core_attn"},
          "dots": {"recompute": True, "recompute_granularity": "dots"}}
ROUTE_SEED = 11


def route_model(route):
    """Tiny Llama on ``route``'s knobs, its weights drawn from
    ``ROUTE_SEED`` (the same in every process)."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    cfg = dataclasses.replace(llama_tiny_config(), **ROUTES[route])
    return LlamaForCausalLM(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(ROUTE_SEED))


def routes(data, out):
    """Each route's loss and whole gradients on the whole first batch at
    dp 2 x mp 2 (every rank the same rows), and its mp collectives."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    hcg = _init(dp=2, mp=2)
    g = hcg.get_model_parallel_group()
    for route in ROUTES:
        model = fleet.distributed_model(route_model(route))
        comm = {}
        with C.count_mp(comm):
            loss = model(_t(data["x0"]), labels=_t(data["y0"]))
            loss.backward()
        out[f"route/{route}/loss"] = loss.detach().numpy()
        out[f"route/{route}/mp_collectives"] = np.array(
            comm["mp_collectives"])
        for n, p in model.named_parameters():
            spec = getattr(p, "dist_spec", None) or ()
            dim = spec.index("mp") if "mp" in spec else None
            out[f"route/{route}/grad/{n}"] = _whole(p.grad, dim, g).numpy()


def train(data, rank, out, root):
    batches = [{"x": data[f"x{i}"], "y": data[f"y{i}"]}
               for i in range(STEPS)]
    for case, (kind, dp, sharding, mp, stage) in CASES.items():
        step = _trainer(kind, data, dp, sharding, mp, stage)
        losses = [float(step(b)) for b in batches]
        out[f"{case}/losses"] = np.array(losses, np.float64)
        out[f"{case}/comm"] = np.array(
            [step.comm["collectives"], step.comm["bytes"],
             step.comm["mp_collectives"], step.comm["mp_bytes"]], np.int64)
        full = step.full_params()
        slots = _whole_slots(step)
        if rank == 0:
            for n, t in full.items():
                out[f"{case}/param/{n}"] = t.numpy().copy()
            for n, v in slots.items():
                out[f"{case}/slot/{n}"] = v
        out[f"{case}/buckets"] = np.array(json.dumps(step.grad_buckets()))
        out[f"{case}/local_shapes"] = np.array(json.dumps(
            {n: list(t.shape) for n, t in step.state["params"].items()}))
        if case == "llama_mp2_s2_stage3":
            checkpoints(data, step, full, slots, root, out, batches[0])


def checkpoints(data, step, full, slots, root, out, nxt):
    """The stage-3 checkpoint at mp 2 x sharding 2: reloaded in the same
    layout (bit-equal state, the same next step) and onto dp 4 at mp 1
    (every parameter and slot whole, bit-equal)."""
    path = os.path.join(root, "ckpt_mp2_s2")
    step.save_checkpoint(path)
    again = _trainer("llama", data, 1, 2, 2, 3)
    again.load_checkpoint(path)
    out["ckpt/same_layout_equal"] = np.array(_state_equal(step, again))
    out["ckpt/same_layout_next"] = np.array([float(step(nxt)),
                                             float(again(nxt))])
    other = _trainer("llama", data, 4, 1, 1, 1)
    other.load_checkpoint(path)
    got = other.full_params()
    got_slots = _whole_slots(other)
    out["ckpt/dp4_params_equal"] = np.array(all(
        torch.equal(got[n], full[n]) for n in full))
    out["ckpt/dp4_slots_equal"] = np.array(all(
        np.array_equal(got_slots[k], slots[k]) for k in slots))
    out["ckpt/dp4_step_count"] = np.array(other.step_count)


def refusals(out):
    """What raises under mp in a gang: a KV-head count mp does not
    divide, and the models the reference annotates for mp but the port
    does not split."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.dit import DiT, dit_tiny_config
    from paddle_tpu_torch.models.ernie import (Ernie45ForCausalLM,
                                               ernie45_tiny_config)
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                                   qwen2_moe_tiny_config)
    cases = {"llama_kv2_mp4": (4, lambda: LlamaForCausalLM(
                 llama_tiny_config(), device="cpu")),
             "qwen2_moe": (2, lambda: Qwen2MoeForCausalLM(
                 qwen2_moe_tiny_config(), device="cpu")),
             "ernie": (2, lambda: Ernie45ForCausalLM(
                 ernie45_tiny_config(), device="cpu")),
             "dit": (2, lambda: DiT(dit_tiny_config(), device="cpu"))}
    for name, (mp, build) in cases.items():
        _init(dp=4 // mp, mp=mp)
        try:
            fleet.distributed_model(build())
            out[f"refuse/{name}"] = np.array("no error")
        except NotImplementedError as e:
            out[f"refuse/{name}"] = np.array(f"NotImplementedError: {e}")


def main(root):
    torch.set_num_threads(2)
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env(device="cpu")
    rank = dist.get_rank()
    data = np.load(os.path.join(root, "inputs.npz"))
    out = {"world": np.array(dist.get_world_size())}
    layers(data, rank, out)
    layer_mlp_train(data, out)
    routes(data, out)
    train(data, rank, out, root)
    refusals(out)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
