"""The rank program of the port's multi-process tests (no JAX: it runs in
child processes started by ``paddle_tpu_torch.distributed.launch``).

``python tests/torch_dist_worker.py <dir> <task>`` on every rank of a
gloo gang.  ``<dir>/inputs.npz`` holds what the test process prepared
(the reference GPT's weights, the batches, the collectives' inputs);
each rank writes what it computed to ``<dir>/rank<r>.npz``:

- ``collectives``: every eager collective and ``ReduceOp`` on per-rank
  inputs, the object collectives and a subset group;
- ``train`` (world 4): tiny GPT-2 under dp 4 (stage 1), dp 2 x sharding
  2 (stage 2) and sharding 4 (stage 3), 8 AdamW steps with a global-norm
  clip: losses, whole parameters and slots; sharding 4 at stage 3 again
  with the per-leaf update (``fused_step=False``); stage 2 and 3 checkpoints
  saved at world 4 and reloaded at world 4 (bit-equality flags); the
  single-process checkpoint in ``<dir>/ckpt_w1`` loaded at world 4 under
  stage 3; one step on a batch with labels masked unevenly over the
  ranks.

``spawn_main(<dir>)`` runs ``spawn_rank`` on two ranks through
``distributed.spawn``.
"""
import json
import os
import sys

import numpy as np
import torch

CASES = {"dp4": (4, 1, 1), "dp2_s2_stage2": (2, 2, 2), "s4_stage3": (1, 4, 3)}
STEPS = 8
LR = 1e-3


def _strategy(dp, sharding):
    from paddle_tpu_torch.distributed import DistributedStrategy
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "sharding_degree": sharding}
    return s


def collectives(dist, rank, world, out):
    """Each rank's results of every collective, under ``coll/<name>``."""
    c = dist.collective
    base = torch.arange(world * 2 * 3, dtype=torch.float32).reshape(
        world * 2, 3) + 100.0 * rank
    small = torch.tensor([rank + 1.0, 2.0 - rank, 0.5 * (rank + 1)])
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        out[f"coll/all_reduce_{op}"] = dist.all_reduce(
            small.clone(), getattr(dist.ReduceOp, op)).numpy()
    lst = []
    dist.all_gather(lst, base.clone())
    out["coll/all_gather_list"] = torch.stack(lst).numpy()
    out["coll/all_gather"] = dist.all_gather(base.clone()).numpy()
    out["coll/reduce_scatter"] = dist.reduce_scatter(base.clone()).numpy()
    rs = torch.empty(2, 3)
    dist.reduce_scatter(rs, list(base.clone().chunk(world)))
    out["coll/reduce_scatter_list"] = rs.numpy()
    out["coll/all_to_all"] = dist.all_to_all(base.clone()).numpy()
    got = []
    dist.all_to_all(got, list(base.clone().chunk(world)))
    out["coll/all_to_all_list"] = torch.stack(got).numpy()
    single = torch.empty_like(base)
    dist.all_to_all_single(single, base.clone())
    out["coll/all_to_all_single"] = single.numpy()
    out["coll/broadcast"] = dist.broadcast(base.clone(), src=1).numpy()
    sc = torch.empty(3)
    dist.scatter(sc, [torch.full((3,), 10.0 * j + rank)
                      for j in range(world)] if rank == 1 else None, src=1)
    out["coll/scatter"] = sc.numpy()
    out["coll/reduce"] = dist.reduce(small.clone(), dst=0).numpy()
    out["coll/gather"] = torch.stack(dist.gather(small.clone())).numpy()
    dist.barrier()
    out["coll/psum"] = c.psum(small, None).numpy()
    out["coll/pmean"] = c.pmean(small, None).numpy()
    out["coll/pmax"] = c.pmax(small, None).numpy()
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "sq": [rank] * rank})
    out["coll/all_gather_object"] = np.array(
        [o["rank"] * 10 + len(o["sq"]) for o in objs], np.float32)
    blist = [f"r{rank}"] * (rank + 1)
    dist.broadcast_object_list(blist, src=1)
    out["coll/broadcast_object_list"] = np.array(
        [len(blist), int(blist[0][1:])], np.float32)
    sol = [None]
    dist.scatter_object_list(sol, [[j * 7] for j in range(world)]
                             if rank == 1 else None, src=1)
    out["coll/scatter_object_list"] = np.array(sol[0], np.float32)
    sub = dist.new_group(ranks=[0, 1])
    out["coll/subgroup_all_reduce"] = dist.all_reduce(
        small.clone(), group=sub).numpy()
    one = dist.new_group(ranks=[0])
    out["coll/subgroup_of_one"] = dist.all_reduce(small.clone(),
                                                  group=one).numpy()


def _trainer(weights, dp, sharding, stage, fused_step=True):
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed import ShardedTrainStep, fleet
    from paddle_tpu_torch.models.from_jax import load_raw_state_dict
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt2_tiny_config)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    fleet.init(strategy=_strategy(dp, sharding), device="cpu")
    model = GPTForCausalLM(gpt2_tiny_config(), device="cpu")
    load_raw_state_dict(model, weights)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optim.AdamW(
        learning_rate=LR, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    crit = GPTPretrainingCriterion()
    step = ShardedTrainStep(model, lambda m, b: crit(m(b["x"]), b["y"]),
                            opt, stage=stage, seed=0, device="cpu",
                            fused_step=fused_step)
    return model, crit, step


def _whole_slots(dist, step):
    """Every slot whole: the sharded ones all-gathered over the sharding
    group and put together on their dim."""
    g = step.hcg.get_sharding_parallel_group()
    out = {}
    for n, slots in step.state["opt"]["slots"].items():
        d = step.plan.slot_dim(n)
        for k, v in slots.items():
            if d is None:
                out[f"{n}/{k}"] = v.numpy().copy()
                continue
            parts = []
            dist.all_gather(parts, v.contiguous(), group=g)
            out[f"{n}/{k}"] = torch.cat(parts, dim=d).numpy()
    return out


def _state_equal(a, b) -> bool:
    """Two trainers' states (this rank's parts), bit for bit."""
    for n, t in a.state["params"].items():
        if not torch.equal(t.detach(), b.state["params"][n].detach()):
            return False
        for k, v in a.state["opt"]["slots"][n].items():
            if not torch.equal(v, b.state["opt"]["slots"][n][k]):
                return False
    return torch.equal(a.state["opt"]["step"], b.state["opt"]["step"])


def train(dist, rank, data, out, root):
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w/")}
    batches = [{"x": data[f"x{i}"], "y": data[f"y{i}"]}
               for i in range(STEPS)]
    for case, (dp, sharding, stage) in CASES.items():
        _, _, step = _trainer(weights, dp, sharding, stage)
        losses = [float(step(b)) for b in batches]
        out[f"{case}/losses"] = np.array(losses, np.float64)
        out[f"{case}/comm"] = np.array([step.comm["collectives"],
                                        step.comm["bytes"]], np.int64)
        full = step.full_params()
        slots = _whole_slots(dist, step)
        if rank == 0:
            for n, t in full.items():
                out[f"{case}/param/{n}"] = t.numpy().copy()
            for n, v in slots.items():
                out[f"{case}/slot/{n}"] = v
        out[f"{case}/buckets"] = np.array(json.dumps(step.grad_buckets()))
        if stage >= 2:
            path = os.path.join(root, f"ckpt_{case}")
            step.save_checkpoint(path)
            _, _, again = _trainer(weights, dp, sharding, stage)
            again.load_checkpoint(path)
            out[f"{case}/reload_w4_equal"] = np.array(
                _state_equal(step, again))
            # the next step from the reloaded state is the next step
            nxt = batches[0]
            out[f"{case}/reload_w4_next"] = np.array(
                [float(step(nxt)), float(again(nxt))])
    # the per-leaf update (fused_step=False) at stage 3: the clip takes
    # the gang's norm there too
    _, _, step = _trainer(weights, 1, 4, 3, fused_step=False)
    out["unfused/losses"] = np.array([float(step(b)) for b in batches])
    full = step.full_params()
    if rank == 0:
        for n, t in full.items():
            out[f"unfused/param/{n}"] = t.numpy().copy()
    # the single-process checkpoint onto world 4 at stage 3
    _, _, step = _trainer(weights, 1, 4, 3)
    step.load_checkpoint(os.path.join(root, "ckpt_w1"))
    full = step.full_params()
    slots = _whole_slots(dist, step)
    if rank == 0:
        for n, t in full.items():
            out[f"w1_to_w4/param/{n}"] = t.numpy().copy()
        for n, v in slots.items():
            out[f"w1_to_w4/slot/{n}"] = v
    out["w1_to_w4/step_count"] = np.array(step.step_count)
    # the loss of a batch whose labels are masked unevenly over the ranks
    model, crit, step = _trainer(weights, 4, 1, 1)
    xm, ym = data["mask_x"], data["mask_y"]
    rows = xm.shape[0] // 4
    with torch.no_grad():
        local = crit(model(torch.from_numpy(
            xm[rank * rows:(rank + 1) * rows])), torch.from_numpy(
                ym[rank * rows:(rank + 1) * rows]))
    out["masked/local_loss"] = np.array(float(local))
    out["masked/loss"] = np.array(float(step({"x": xm, "y": ym})))


def main(root, task):
    torch.set_num_threads(2)
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"backend": np.array(dist.get_backend()),
           "world": np.array(world)}
    collectives(dist, rank, world, out)
    if task == "train":
        data = np.load(os.path.join(root, "inputs.npz"))
        train(dist, rank, data, out, root)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()




def spawn_rank(root):
    """``distributed.spawn``'s rank function: join the gloo gang, sum the
    ranks and write them."""
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env(device="cpu")
    rank = dist.get_rank()
    t = dist.all_reduce(torch.tensor([rank + 1.0]))
    with open(os.path.join(root, f"spawn{rank}"), "w") as f:
        f.write(f"{float(t[0])} {dist.get_world_size()} "
                f"{dist.get_backend()}")
    dist.destroy_process_group()


def spawn_main(root):
    from paddle_tpu_torch import distributed as dist
    dist.spawn(spawn_rank, args=(root,), nprocs=2)
    print("SPAWN_OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
