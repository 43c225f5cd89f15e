"""Recompute (activation checkpointing), counterpart of
``paddle_tpu/jit/recompute.py``.

``recompute(layer, *args, policy=...)`` runs the layer's forward without
keeping its activations and runs it again in the backward to rebuild
them.  The reference wraps the layer's pure function in
``jax.checkpoint`` with a policy that names what the backward may keep;
XLA then drops every recomputed operation whose result is not needed.
PyTorch has no such rule, so here what a policy keeps is *replayed*: a
site that computes a value a policy may keep goes through ``kept``
(or ``product`` for a projection), which on the first run stores the
result and in the recompute hands it back without running anything.
The site's own backward stays as it is:

- ``"core_attn"`` keeps ``attn_out`` (the o_proj output) and the flash
  forward's ``(out, lse)`` (``flash_out``, ``flash_lse``), so the
  recomputed backward never relaunches the flash forward kernel: it
  rebuilds the norms and the q/k/v projections, which the flash
  backward needs, and the MLP;
- ``"dots"`` keeps every projection's output (``product``); the
  matmul+rope kernel's output is a kernel output there, not a dot, as on
  the reference's TPU path, and is recomputed;
- ``None`` or ``"full"`` keeps nothing;
- every policy keeps ``dropout_seed``, the per-call seed of the
  in-kernel attention dropout (``nn/functional.py``), so a recomputed
  forward regenerates the first run's keep masks.

The mechanism is a ``torch.autograd.Function`` around the region whose
forward runs under ``no_grad`` and whose backward re-runs the region
with grad on and differentiates it with ``torch.autograd.grad``.  The
region's inputs and, for a module, its parameters are the Function's
inputs; a plain function gets gradients only for the tensors passed to
it.  A region that draws random numbers (plain dropout, the attention
seed) draws them from the dropout generator of ``ops/random.py``: the
Function records that generator and its state where the region starts,
and runs the recompute under it, set back to that state (restoring its
later state after), so the recompute draws what the first run drew,
wherever the backward runs, as the reference's ``jax.checkpoint``
replays its keys.  A region is differentiated once (no
``retain_graph``).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..common.errors import enforce
from ..ops import random as _random

__all__ = ["recompute", "kept", "product"]

_ALWAYS = frozenset({"dropout_seed"})
_POLICIES = {None: _ALWAYS, "full": _ALWAYS,
             "core_attn": _ALWAYS | {"attn_out", "flash_out", "flash_lse"},
             "dots": _ALWAYS | {"dot"}}

_local = threading.local()


def _resolve_policy(policy):
    """The names a policy keeps: None or "full" only the dropout seed,
    "core_attn" also the attention output and the flash forward's (out,
    lse), "dots" also the projections' outputs.  Anything else raises
    ValueError."""
    if (policy is None or isinstance(policy, str)) and policy in _POLICIES:
        return _POLICIES[policy]
    raise ValueError(f"unknown recompute policy {policy!r}")


class _Frame:
    """One recomputed region: the names its policy keeps and, in order,
    the values the first run produced under them."""

    def __init__(self, keep):
        self.keep = keep
        self.values = []
        self.replay = None        # an iterator over values in the recompute


def _frame():
    return getattr(_local, "frame", None)


@contextlib.contextmanager
def _in_frame(frame):
    prev = _frame()
    _local.frame = frame
    try:
        yield
    finally:
        _local.frame = prev


def _is_kept(names) -> bool:
    f = _frame()
    return f is not None and not f.keep.isdisjoint(names)


def kept(names, run):
    """``run()`` (a tensor or a tuple of tensors) -- or, inside a
    recomputed region whose policy keeps one of ``names``, on the first
    run ``run()`` remembered, and in the recompute the remembered value,
    without calling ``run``."""
    if not _is_kept(names):
        return run()
    f = _frame()
    if f.replay is not None:
        out = next(f.replay)
        return tuple(t.detach() for t in out) if isinstance(out, tuple) \
            else out.detach()
    out = run()
    f.values.append(out)
    return out


class _KeptProduct(torch.autograd.Function):
    """``x @ w`` through ``kept``: the recompute hands back the kept
    product and still carries the product's gradient."""

    @staticmethod
    def forward(ctx, x, w, names):
        ctx.save_for_backward(x, w)
        return kept(names, lambda: x @ w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw, None


def product(x, w, names=("dot",)):
    """The projection ``x @ w``; inside a recomputed region whose policy
    keeps one of ``names`` its output is kept and replayed."""
    if not _is_kept(names):
        return x @ w
    return _KeptProduct.apply(x, w, tuple(names))


def _outputs(out):
    """The region's outputs as a tuple, and whether it returned one
    tensor."""
    single = isinstance(out, torch.Tensor)
    outs = (out,) if single else tuple(out)
    enforce(all(isinstance(t, torch.Tensor) for t in outs),
            "recompute takes a region that returns a tensor or a tuple of "
            "tensors")
    return outs, single


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, keep, n_args, *tensors):
        frame = _Frame(keep)
        gen = _random.generator_for(tensors[0].device)
        ctx.rng = (gen, gen.get_state())
        with _in_frame(frame):
            outs, single = _outputs(run(*tensors[:n_args]))
        ctx.run, ctx.frame, ctx.single = run, frame, single
        ctx.save_for_backward(*tensors[:n_args])
        ctx.params = tensors[n_args:]        # the module's own Parameters
        return outs[0] if single else outs

    @staticmethod
    def backward(ctx, *grads):
        frame, ctx.frame = ctx.frame, None
        enforce(frame is not None,
                "a recomputed region is differentiated once")
        frame.replay = iter(frame.values)
        need = ctx.needs_input_grad[3:]
        args = [t.detach().requires_grad_(r)
                for t, r in zip(ctx.saved_tensors, need)]
        gen, state = ctx.rng
        later = gen.get_state()
        gen.set_state(state)
        try:
            with torch.enable_grad(), _in_frame(frame), \
                    _random.rng_guard(gen):
                outs, _ = _outputs(ctx.run(*args))
        finally:
            gen.set_state(later)
        # a gradient for each output that carries one
        live = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wrt = [t for t, r in zip(args + list(ctx.params), need) if r]
        grads = iter(torch.autograd.grad([o for o, _ in live], wrt,
                                         [g for _, g in live],
                                         allow_unused=True))
        return (None, None, None) + tuple(next(grads) if r else None
                                          for r in need)


def recompute(function, *args, policy=None, **kwargs):
    """``function(*args, **kwargs)`` -- a module or a plain function that
    returns a tensor or a tuple of tensors (a decoder layer's ``(x,
    aux_loss)``) -- with its activations recomputed in the backward, keeping what ``policy`` names (see the module docstring).
    Tensors may sit inside tuples, lists or dicts of the arguments.
    Without grad, or when nothing requires grad, it just runs."""
    keep = _resolve_policy(policy)
    params = [p for p in function.parameters() if p.requires_grad] \
        if isinstance(function, nn.Module) else []
    leaves, spec = tree_flatten((args, kwargs))
    where = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    tensors = [leaves[i] for i in where]
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in tensors + params):
        return function(*args, **kwargs)

    def run(*ts):
        vals = list(leaves)
        for i, t in zip(where, ts):
            vals[i] = t
        a, kw = tree_unflatten(vals, spec)
        return function(*a, **kw)

    return _Recompute.apply(run, keep, len(tensors), *tensors, *params)
