"""ShardedTrainStep: data-parallel training with ZeRO stages 1-3
(counterpart of ``paddle_tpu/distributed/trainer.py``).

The reference compiles one program over its device mesh and lets GSPMD
emit the collectives.  Here each rank is a process driving one card, and
the step issues its collectives itself (``torch.distributed`` over the
groups of ``fleet.init``'s topology, NCCL on the card):

- **Batch.** Every rank is handed the global batch (the reference's
  contract for a host array under a global sharding) and takes the rows
  of its coordinate over (dp, sharding), dp major.  The loss it returns
  is the mean of the ranks' losses (all-reduced), which is the global
  batch's mean where every rank's rows count alike (see ROADMAP §C for
  a loss that averages over a data-dependent count).
- **Dropout.** Data coordinate ``c`` draws from its own stream, seeded
  from ``(seed, c)``; coordinate 0's is the unsharded step's own, so a
  gang of one draws the masks ``CompiledTrainStep`` draws.
- **Gradients.** ``grad_buckets()`` is the reference's bucket plan (4
  MB buckets of the replicated parameters, one dtype a bucket, a giant
  leaf alone).  A bucket's gradients are all-reduced as one flat buffer
  over the ranks that split the batch; at stage 2 the members whose
  moments are sharded are reduce-scattered instead (packed with the
  sharded dim moved to the front, so a dim other than 0 shards as the
  reference shards it), then all-reduced over dp.  At stage 3 the
  sharded parameters' gradients are reduce-scattered the same way, in
  buckets of their own.  Sums are divided by the number of data
  coordinates.  No reduction overlaps the backward yet.
- **Update.** ``fused_update.cu`` (``Optimizer.apply_gradients_fused``)
  per leaf on this rank's part, packing off as in the reference.  At
  stage 1/2 a sharded leaf's updated slice is all-gathered back into
  the replicated parameter.
- **Clip.** ``ClipGradByGlobalNorm``: the f32 norm squared of this
  rank's shards (a replicated leaf counted by sharding rank 0 only),
  all-reduced over the sharding group, gives the kernel's clip scale.
- **Stage 3.** The sharded parameters live as this rank's parts; the
  model's parameters hold empty placeholders between steps.  They are
  all-gathered before the forward pass, freed after it (the tensors the
  backward saved of them are kept as references, through
  ``torch.autograd.graph.saved_tensors_hooks``), all-gathered again
  when the backward first needs each, and freed once its gradient
  exists.  A model that recomputes its forward in the backward
  (``config.recompute``) keeps them gathered through the backward.

``comm`` holds the last step's collective count and bytes (each
collective's input).  Step count, scheduler step, trace span and
``StepTimer`` fence are ``CompiledTrainStep``'s.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as _dist

from ..common.errors import enforce
from ..jit.train import CompiledTrainStep, _detached
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue, norm_scale
from ..observability import health as _health
from ..observability import tracing as _tracing
from ..ops.random import rng_guard
from ..runtime.device import resolve_device
from .checkpoint import ShardedArray
from .fleet import get_hybrid_communicate_group, get_strategy
from .sharding import ShardingPlan, shard_boxes, shard_slice

__all__ = ["ShardedTrainStep"]

_PACKED = object()


def _stream_seed(seed: int, coordinate: int) -> int:
    """The dropout stream's seed of data coordinate ``coordinate``:
    ``seed`` itself at coordinate 0."""
    return int(seed) + (int(coordinate) << 32)


class ShardedTrainStep(CompiledTrainStep):
    """``CompiledTrainStep`` over ``fleet.init``'s topology at ZeRO
    ``stage`` (None: the model's ``group_sharded_parallel`` stage, else
    the strategy's sharding stage, else 1).  ``device`` (None: the card)
    is where the model lives; without a card only ``device="cpu"``
    runs."""

    _program_name = "train.sharded_step"

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, stage: Optional[int] = None, seed: int = 0,
                 donate: bool = True, fused_step: bool = True,
                 grad_bucket_mb: float = 4.0, has_aux: bool = False,
                 grad_norm_tap: bool = False, device=None):
        dev = resolve_device(device)
        hcg = get_hybrid_communicate_group()
        enforce(hcg is not None, "fleet.init() before ShardedTrainStep")
        enforce(donate, "ShardedTrainStep updates its state in place "
                        "(donate=False is not ported: ROADMAP "
                        "'Multi-device')", error_cls=NotImplementedError)
        p0 = next(model.parameters())
        enforce(p0.device.type == dev.type,
                f"the model lives on {p0.device}, the step runs on {dev}")
        if stage is None:
            stage = getattr(model, "_sharding_stage", None)
            if stage is None:
                strat = get_strategy()
                stage = strat.sharding_configs.stage if (
                    strat and strat.sharding) else 1
        self.hcg = hcg
        self.plan = ShardingPlan.for_topology(model, hcg, stage)
        self.stage = int(stage)
        self._data_index, self._data_count = hcg.data_coordinate()
        self._sgroup = hcg.get_sharding_parallel_group()
        self._dpgroup = hcg.get_data_parallel_group()
        self._dgroup = hcg.get_data_sharding_group()
        super().__init__(model, loss_fn, optimizer, seed=seed, donate=True,
                         state_sharding_fn=self.plan.shard_state,
                         has_aux=has_aux, fused_step=fused_step,
                         grad_norm_tap=grad_norm_tap)
        self.generator.manual_seed(_stream_seed(seed, self._data_index))
        # packing flat buffers would mix leaves of different shardings:
        # the sharded path updates leaf by leaf, as the reference's does
        self._fused_pack_small = False
        self._bucket_bytes = int(grad_bucket_mb * 2 ** 20)
        self._bucket_plan: Optional[List[List[int]]] = None
        self._names = sorted(self._params)
        self.comm = {"collectives": 0, "bytes": 0}
        # stage 3: the sharded parameters, their gathered tensors while a
        # step uses them, and the placeholders the model holds otherwise
        self._sharded = [n for n in self._names
                         if self.plan.param_dim(n) is not None]
        self._full: Dict[str, torch.Tensor] = {}
        self._ptr_name: Dict[int, str] = {}
        cfg = getattr(model, "config", None)
        self._keep_gathered = bool(getattr(cfg, "recompute", False))
        self._placeholder = {}
        for n in self._sharded:
            p = self._params[n]
            self._placeholder[n] = torch.empty(0, dtype=p.dtype,
                                               device=p.device)
            p.data = self._placeholder[n]
            p.register_hook(lambda g, n=n: self._release(n))

    # -- topology facts --------------------------------------------------------
    def _slot_sharded(self, n: str) -> bool:
        return self.plan.slot_dim(n) is not None

    def _mode(self, n: str) -> str:
        """'rs': the gradient is reduce-scattered to this rank's part;
        'ar': all-reduced whole."""
        if self.plan.param_dim(n) is not None:
            return "rs"
        if self.stage >= 2 and self._slot_sharded(n):
            return "rs"
        return "ar"

    def _grad_dim(self, n: str) -> Optional[int]:
        d = self.plan.param_dim(n)
        return d if d is not None else self.plan.slot_dim(n)

    # -- collectives (counted) -------------------------------------------------
    def _count(self, t: torch.Tensor) -> None:
        self.comm["collectives"] += 1
        self.comm["bytes"] += t.numel() * t.element_size()

    def _all_reduce(self, t: torch.Tensor, group) -> None:
        if group.pg is not None:
            self._count(t)
            _dist.all_reduce(t, _dist.ReduceOp.SUM, group=group.pg)

    def _reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` (``n`` equal parts, n the sharding degree) summed over
        the sharding group; this rank's part."""
        g = self._sgroup
        out = torch.empty(flat.numel() // g.nranks, dtype=flat.dtype,
                          device=flat.device)
        self._count(flat)
        _dist.reduce_scatter_tensor(out, flat, _dist.ReduceOp.SUM,
                                    group=g.pg)
        return out

    def _all_gather(self, part: torch.Tensor, shape, dim: int
                    ) -> torch.Tensor:
        """The whole of a tensor of ``shape`` sharded on ``dim`` over the
        sharding group, from this rank's contiguous ``part``."""
        g = self._sgroup
        flat = torch.empty(g.nranks * part.numel(), dtype=part.dtype,
                           device=part.device)
        self._count(part)
        _dist.all_gather_into_tensor(flat, part.contiguous().view(-1),
                                     group=g.pg)
        buf = flat.view((g.nranks,) + tuple(part.shape))
        if dim == 0:
            return buf.view(shape)
        return buf.movedim(0, dim).reshape(shape)

    # -- the bucket plan ---------------------------------------------------------
    def _pack(self, idxs: List[int]) -> List[List[int]]:
        """The reference's packing of leaves ``idxs`` (indices into the
        sorted parameter names): in order while they share a dtype and
        the bucket stays within the budget; a leaf of the whole budget
        or more in a bucket of its own."""
        plan: List[List[int]] = []
        cur: List[int] = []
        cur_bytes, cur_dt = 0, None
        for i in idxs:
            p = self._params[self._names[i]]
            nbytes = self._numel(self._names[i]) * p.element_size()
            if nbytes >= self._bucket_bytes:
                plan.append([i])
                continue
            if cur and (cur_dt != p.dtype
                        or cur_bytes + nbytes > self._bucket_bytes):
                plan.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_dt = p.dtype
            cur_bytes += nbytes
        if cur:
            plan.append(cur)
        return plan

    def _numel(self, n: str) -> int:
        out = 1
        for d in self.plan.shapes[n]:
            out *= d
        return out

    def grad_buckets(self) -> List[List[int]]:
        """The static bucket plan (the reference's, index for index):
        buckets of indices into the sorted parameter names, over the
        parameters that are replicated (not sharded at stage 3)."""
        if self._bucket_plan is None:
            self._bucket_plan = self._pack(
                [i for i, n in enumerate(self._names)
                 if self.plan.param_dim(n) is None])
        return self._bucket_plan

    def _shard_buckets(self) -> List[List[int]]:
        """Stage 3's sharded parameters, packed by the same rule."""
        return self._pack([i for i, n in enumerate(self._names)
                           if self.plan.param_dim(n) is not None])

    # -- gradient synchronisation --------------------------------------------------
    def _sync_grads(self, grads: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's reduced gradients: whole for an 'ar' leaf, its part
        (contiguous, in the parameter's layout) for an 'rs' leaf; the
        mean over the data coordinates."""
        out: Dict[str, torch.Tensor] = {}
        count = self._data_count
        buckets = self.grad_buckets() + self._shard_buckets()
        with torch.no_grad():
            for bucket in buckets:
                names = [self._names[i] for i in bucket]
                ar = [n for n in names if self._mode(n) == "ar"]
                rs = [n for n in names if self._mode(n) == "rs"]
                if ar:
                    flat = torch.cat([grads[n].reshape(-1) for n in ar])
                    self._all_reduce(flat, self._dgroup)
                    flat.div_(count)
                    off = 0
                    for n in ar:
                        k = grads[n].numel()
                        out[n] = flat[off:off + k].view_as(grads[n])
                        off += k
                if rs:
                    out.update(self._scatter_bucket(rs, grads, count))
        return out

    def _scatter_bucket(self, names, grads, count):
        """Reduce-scatter ``names``' gradients as one buffer: row ``s`` of
        the send buffer holds part ``s`` of each (its sharded dim moved to
        the front); over dp, the parts are then all-reduced."""
        n = self._sgroup.nranks
        rows, moved = [], {}
        for name in names:
            d = self._grad_dim(name)
            g = grads[name].movedim(d, 0)
            moved[name] = (d, (g.shape[0] // n,) + tuple(g.shape[1:]))
            rows.append(g.reshape(n, -1))
        part = self._reduce_scatter(torch.cat(rows, dim=1).reshape(-1))
        if self._dpgroup.nranks > 1:
            self._all_reduce(part, self._dpgroup)
        part.div_(count)
        out, off = {}, 0
        for name in names:
            d, shape = moved[name]
            k = 1
            for s in shape:
                k *= s
            out[name] = part[off:off + k].view(shape).movedim(
                0, d).contiguous()
            off += k
        return out

    # -- stage 3: gather before use, free after ---------------------------------------
    def _gather(self, n: str) -> torch.Tensor:
        full = self._all_gather(self.state["params"][n], self.plan.shapes[n],
                                self.plan.param_dim(n))
        self._full[n] = full
        self._ptr_name[full.untyped_storage().data_ptr()] = n
        return full

    def _gather_all(self) -> None:
        with torch.no_grad():
            for n in self._sharded:
                self._params[n].data = self._gather(n)

    def _free_all(self) -> None:
        for n in self._sharded:
            self._params[n].data = self._placeholder[n]
        self._full.clear()

    def _release(self, n: str):
        """The backward made ``n``'s gradient: its gathered tensor is no
        longer needed."""
        self._full.pop(n, None)

    def _pack_saved(self, t: torch.Tensor):
        if self._ptr_name and isinstance(t, torch.Tensor) \
                and t.layout == torch.strided:
            n = self._ptr_name.get(t.untyped_storage().data_ptr())
            if n is not None and n in self._full and \
                    t.dtype == self._full[n].dtype:
                return (_PACKED, n, tuple(t.shape), tuple(t.stride()),
                        t.storage_offset())
        return t

    def _unpack_saved(self, packed):
        if isinstance(packed, tuple) and len(packed) == 5 \
                and packed[0] is _PACKED:
            _, n, size, stride, offset = packed
            full = self._full.get(n)
            if full is None:
                with torch.no_grad():
                    full = self._gather(n)
            return full.as_strided(size, stride, offset)
        return packed

    # -- the step --------------------------------------------------------------------
    def _local_batch(self, batch):
        """This rank's rows of the global batch (dim 0 of every tensor
        and array; scalars as they are)."""
        i, n = self._data_index, self._data_count
        if isinstance(batch, dict):
            return {k: self._local_batch(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._local_batch(v) for v in batch)
        t = torch.as_tensor(batch, device=self._device)
        if t.dim() == 0 or n == 1:
            return t
        enforce(t.shape[0] % n == 0,
                f"the global batch's {t.shape[0]} rows do not split over "
                f"{n} data-parallel ranks")
        return shard_slice(t, 0, i, n)

    def _forward_backward(self, batch):
        params = self._params
        staged = bool(self._sharded)
        if staged:
            self._gather_all()
        hooks = staged and not self._keep_gathered
        try:
            with torch.enable_grad(), rng_guard(self.generator):
                if hooks:
                    with torch.autograd.graph.saved_tensors_hooks(
                            self._pack_saved, self._unpack_saved):
                        out = self.loss_fn(self.model, self._batch(batch))
                    self._free_all()
                else:
                    out = self.loss_fn(self.model, self._batch(batch))
                loss, aux = out if self._has_aux else (out, None)
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True)
        finally:
            if staged:
                self._free_all()
                self._ptr_name.clear()
        full = {n: torch.zeros(self.plan.shapes[n], dtype=p.dtype,
                               device=p.device) if g is None else g
                for (n, p), g in zip(params.items(), grads)}
        return loss.detach(), _detached(aux), full

    def _mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        loss = loss.clone()
        self._all_reduce(loss, self._dgroup)
        return loss.div_(self._data_count)

    def grad_step(self, batch) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
        """Forward + backward on this rank's rows and the gradients'
        reduction: (the global mean loss, {name: this rank's reduced
        gradient, a part where it is sharded}); nothing is updated."""
        loss, _, grads = self._forward_backward(self._local_batch(batch))
        return self._mean_loss(loss), self._sync_grads(grads)

    def _grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The f32 global norm: this rank's parts' squares, a replicated
        leaf's counted by sharding rank 0 alone, summed over the
        sharding group."""
        first = self._sgroup.rank == 0
        total = None
        for n in self._names:
            if self._mode(n) == "rs" or first:
                s = grads[n].float().square().sum()
                total = s if total is None else total + s
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=self._device)
        self._all_reduce(total, self._sgroup)
        return torch.sqrt(total)

    def _update(self, grads: Dict[str, torch.Tensor],
                grad_norm: Optional[torch.Tensor] = None) -> None:
        opt = self.optimizer
        st = self.state
        clip = opt._grad_clip
        if grad_norm is None and isinstance(clip, ClipGradByGlobalNorm):
            grad_norm = self._grad_norm(grads)
        params: Dict[str, torch.Tensor] = {}
        upd_grads: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for n in self._names:
                d = self.plan.slot_dim(n)
                sliced = d is not None and self.plan.param_dim(n) is None
                params[n] = self.plan.local(st["params"][n].detach(), d) \
                    if sliced else st["params"][n]
                g = grads[n]
                if sliced and self._mode(n) == "ar":
                    g = self.plan.local(g, d)
                upd_grads[n] = g
        state = {"slots": st["opt"]["slots"], "step": st["opt"]["step"]}
        if self._fused_step and opt.uses_fused_kernel():
            _, new = opt.apply_gradients_fused(
                params, upd_grads, state, pack_small=False,
                grad_norm=grad_norm)
        else:
            new = self._update_per_leaf(params, upd_grads, state,
                                        grad_norm)
        st["opt"] = new
        with torch.no_grad():
            for n in self._names:
                d = self.plan.slot_dim(n)
                if d is not None and self.plan.param_dim(n) is None:
                    st["params"][n].copy_(self._all_gather(
                        params[n], self.plan.shapes[n], d))
        self._step_count += 1
        sched = opt._lr_scheduler
        if sched is not None:
            sched.step()

    def _update_per_leaf(self, params, grads, state, grad_norm):
        """The optimizer's per-leaf update on this rank's parts; a global
        norm clip takes the gang's norm (the grads are scaled first)."""
        opt = self.optimizer
        clip = opt._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            scale = norm_scale(grad_norm, clip.clip_norm)
            grads = {n: (g.float() * scale).to(g.dtype)
                     for n, g in grads.items()}
        elif clip is not None and not isinstance(clip, ClipGradByValue) \
                and any(self._mode(n) == "rs" or self._slot_sharded(n)
                        for n in self._names):
            raise NotImplementedError(
                f"{type(clip).__name__} over sharded gradients is not "
                f"ported (ROADMAP 'Multi-device')")
        keep = opt._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            opt._grad_clip = None
        try:
            new_p, new_state = opt.apply_gradients(params, grads, state)
        finally:
            opt._grad_clip = keep
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(new_p[n])
        return new_state

    def apply_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """The update from ``grad_step``'s reduced gradients."""
        self._update(grads)

    def __call__(self, batch):
        span = _tracing.span(self._program_name)
        span.set_attr("step", self._step_count)
        span.set_attr("sharded", True)
        with _health.goodput_region(
                "productive_step" if self._compiled_once else "compile"):
            if self._timer is not None:
                self._timer.start()
            self.comm = {"collectives": 0, "bytes": 0}
            loss, aux, grads = self._forward_backward(
                self._local_batch(batch))
            loss = self._mean_loss(loss)
            grads = self._sync_grads(grads)
            gnorm = None
            if self._grad_norm_tap or isinstance(self.optimizer._grad_clip,
                                                 ClipGradByGlobalNorm):
                gnorm = self._grad_norm(grads)
                if self._grad_norm_tap:
                    self.last_grad_norm = gnorm
            self._update(grads, grad_norm=gnorm)
            out = (loss, aux) if self._has_aux else loss
            if self._timer is not None:
                self._timer.stop(fence=(self.state, out))
        self._compiled_once = True
        span.end()
        return out

    def eval_step(self, eval_fn: Callable, batch):
        """``eval_fn(model, batch)`` with no grad (stage 3: the
        parameters gathered for it), on the batch as given."""
        if not self._sharded:
            return super().eval_step(eval_fn, batch)
        self._gather_all()
        try:
            return super().eval_step(eval_fn, batch)
        finally:
            self._free_all()
            self._ptr_name.clear()

    def full_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole (stage 3 gathers its parts: a collective
        every rank calls)."""
        with torch.no_grad():
            return {n: self._all_gather(self.state["params"][n],
                                        self.plan.shapes[n],
                                        self.plan.param_dim(n))
                    if self.plan.param_dim(n) is not None
                    else self.state["params"][n].detach()
                    for n in self._names}

    # -- checkpoints -------------------------------------------------------------------
    def _part(self, t: torch.Tensor, n: str, dim: Optional[int]):
        """A state leaf as a checkpoint leaf: a sharded one as this rank's
        ``ShardedArray`` part (written by dp rank 0 of its sharding
        coordinate)."""
        if dim is None:
            return t
        s, count = self._sgroup.rank, self._sgroup.nranks
        boxes = shard_boxes(self.plan.shapes[n], dim, count)
        return ShardedArray(t, self.plan.shapes[n], boxes[s], boxes,
                            write=self.hcg.get_data_parallel_rank() == 0)

    def _ckpt_tree(self, rng_rows: Optional[int] = None):
        """The resumable state with this rank's parts as ``ShardedArray``
        leaves: the keys are ``CompiledTrainStep``'s, so either trainer
        loads the other's checkpoint at any world size.  Besides data
        coordinate 0's generator state (``torch_rng_state``, the
        unsharded step's stream), ``torch_rng_states`` holds every
        coordinate's, one row each."""
        st = self.state
        params = {n: self._part(st["params"][n], n, self.plan.param_dim(n))
                  for n in self._names}
        slots = {n: {k: self._part(v, n, self.plan.slot_dim(n))
                     for k, v in st["opt"]["slots"][n].items()}
                 for n in self._names}
        rng = self.generator.get_state()
        rows = self._data_count if rng_rows is None else rng_rows
        tree = {"state": {"params": params,
                          "opt": {"slots": slots, "step": st["opt"]["step"]}},
                "torch_rng_state": rng.clone()}
        if self._data_index < rows:
            boxes = shard_boxes((rows, rng.numel()), 0, rows)
            tree["torch_rng_states"] = ShardedArray(
                rng.view(1, -1).clone(), (rows, rng.numel()),
                boxes[self._data_index], boxes)
        return tree

    def load_checkpoint(self, path: str):
        """Restore ``save_checkpoint``'s output, written at any world size
        (or by ``CompiledTrainStep``), onto this rank's parts.  Data
        coordinate ``c`` resumes its saved stream where the checkpoint
        has one, else (a coordinate the saving gang had not) reseeds it
        from ``(seed, c)``."""
        import json
        from . import checkpoint as dck
        meta = dck.get_checkpoint_metadata(path)
        saved = meta["arrays"].get("torch_rng_states")
        rows = saved["global_shape"][0] if saved else 0
        tree = self._ckpt_tree(rng_rows=rows if rows else None)
        if not rows or self._data_index >= rows:
            tree.pop("torch_rng_states", None)
        if self._data_index != 0:
            tree.pop("torch_rng_state")
        dck.load_state_dict(tree, path, metadata=meta)
        if "torch_rng_states" in tree:
            self.generator.set_state(tree["torch_rng_states"].local.view(-1))
        elif self._data_index == 0:
            self.generator.set_state(tree["torch_rng_state"])
        else:
            self.generator.manual_seed(_stream_seed(self.seed,
                                                   self._data_index))
        self._step_count = int(meta["literals"].get("step_count") or 0)
        sched = self.optimizer._lr_scheduler
        saved_sched = meta["literals"].get("lr_sched")
        if sched is not None and saved_sched:
            sched.set_state_dict(json.loads(saved_sched))
        extra = meta["literals"].get("extra")
        return json.loads(extra) if extra else None

    def sync_to_model(self):
        """Stage 3 keeps parts, not the model's parameters: nothing to
        copy (``full_params`` gathers them)."""
        if not self._sharded:
            super().sync_to_model()

    def sync_from_model(self):
        enforce(not self._sharded, "stage 3 keeps this rank's parts: "
                                   "load a checkpoint instead")
        super().sync_from_model()
