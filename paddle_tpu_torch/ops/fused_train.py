"""The reference's fused step regions (counterpart of
``paddle_tpu/ops/pallas/fused_train.py``), each a hand-written CUDA
kernel beside its plain PyTorch version:

1. the optimizer update with the global-norm clip folded in
   (``csrc/fused_update.cu``);
2. the residual add fused with RMSNorm or LayerNorm
   (``csrc/add_norm.cuh``, built as three libraries by dtype);
3. a q or k projection fused with the rotary embedding
   (``csrc/matmul_rope.cu``).

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs the plain version.  Each keeps a ``.launches`` count of
its kernel launches.

Update: ``_update_math`` is the single source of the optimizer
arithmetic, op for op the reference's: SGD, Momentum (plain or Nesterov)
and Adam with L2 decay or AdamW with decoupled decay, all in f32.
``fused_update_reference`` is the plain version of the kernel;
``fused_update_flat`` runs it.  Unlike the reference, whose arrays are
immutable, it updates the parameter and its slots in place: an 8B-wide
model cannot hold a second copy of its optimizer state.

Add + norm and matmul + rope are differentiable.  The add + norm
backward is a kernel too (``add_norm_bwd``), beside its plain version,
the reference's ``custom_vjp`` rule in closed form; matmul + rope's is
the reference math in plain PyTorch around cuBLAS.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from ..common.errors import enforce
from ..jit.recompute import product
from . import _build, _nn
from . import flops as _flops

__all__ = ["SLOT_KEYS", "fused_update_flat", "fused_update_reference",
           "update_flop_estimate", "add_rms_norm_reference",
           "add_layer_norm_reference", "add_rms_norm_raw",
           "add_layer_norm_raw", "add_rms_norm_backward_reference",
           "add_layer_norm_backward_reference", "add_rms_norm_backward_raw",
           "add_layer_norm_backward_raw", "matmul_rope_reference",
           "matmul_rope_raw", "qkv_rope_raw"]

SLOT_KEYS = {"sgd": (), "momentum": ("velocity",),
             "adam": ("moment1", "moment2")}

# analytic per-element FLOP counts (mul and add counted separately), the
# reference's figures for the update's share of a step's FLOPs
_UPDATE_FLOPS = {"sgd": 2, "momentum": 5, "adam": 16}
_CLIP_FLOPS = 4      # square+accumulate on the norm pass, scale+round fold

_SOURCE = "fused_update"
_KIND_CODE = {"sgd": 0, "momentum": 1, "adam": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# 1. fused clip + optimizer update
# ---------------------------------------------------------------------------

def update_flop_estimate(kind: str, n_elems: int, has_clip: bool) -> float:
    per = _UPDATE_FLOPS.get(kind, 6)
    if has_clip:
        per += _CLIP_FLOPS
    return float(per) * float(n_elems)


def _clip_fold_f32(gf, clip_scale, grad_dtype):
    """Fold the global-norm clip scale into the f32 grad, replaying the
    rounding of the unfused path (the clipped grad materialised in the
    grad's dtype, then cast to f32 for the update)."""
    return (gf * clip_scale).to(grad_dtype).float()


def _update_math(kind, hp, pf, gf, slots, lr, step_f):
    """The optimizer arithmetic on f32 operands; ``lr`` and ``step_f``
    are f32 tensors (0-dim), hyper-parameters Python floats."""
    wd = hp.get("weight_decay", 0.0)
    if wd and not hp.get("decoupled", False):
        gf = gf + wd * pf
    if kind == "sgd":
        return pf - lr * gf, {}
    if kind == "momentum":
        mu = hp["momentum"]
        v = mu * slots["velocity"] + gf
        if hp.get("nesterov", False):
            new_p = pf - lr * (gf + mu * v)
        else:
            new_p = pf - lr * v
        return new_p, {"velocity": v}
    if kind == "adam":
        b1, b2, eps = hp["beta1"], hp["beta2"], hp["epsilon"]
        m = b1 * slots["moment1"] + (1 - b1) * gf
        v = b2 * slots["moment2"] + (1 - b2) * torch.square(gf)
        bc1 = 1 - torch.pow(b1, step_f)
        bc2 = 1 - torch.pow(b2, step_f)
        mhat = m / bc1
        vhat = v / bc2
        new_p = pf - lr * mhat / (torch.sqrt(vhat) + eps)
        if wd and hp.get("decoupled", False):
            new_p = new_p - lr * wd * pf
        return new_p, {"moment1": m, "moment2": v}
    raise NotImplementedError(f"no fused update for optimizer kind {kind!r}")


def fused_update_reference(kind, p, g, slots, *, lr, step_f, clip_scale,
                           hyper):
    """Plain version of the kernel: returns (new_p in p's dtype, new
    slots f32) and leaves its inputs alone.  ``lr``, ``step_f`` and
    ``clip_scale`` (None: no clip) are f32 0-dim tensors."""
    gf = g.float()
    if clip_scale is not None:
        gf = _clip_fold_f32(gf, clip_scale, g.dtype)
    new_p, new_slots = _update_math(kind, hyper, p.float(), gf, slots, lr,
                                    step_f)
    return new_p.to(p.dtype), new_slots


def _kernel() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.fused_update
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int] + [ctypes.c_float] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_update_error_string.argtypes = [ctypes.c_int]
        lib.fused_update_error_string.restype = ctypes.c_char_p
    return lib


def fused_update_flat(kind: str, p: torch.Tensor, g: torch.Tensor,
                      slots: Dict[str, torch.Tensor], *,
                      scalars: torch.Tensor, has_clip: bool,
                      hyper: dict) -> None:
    """Clip-fold + update of one (param, grad, slots) triple of any
    shape, **in place** on ``p`` and ``slots``.

    ``scalars`` is an f32 tensor [lr, step, clip scale] on p's device
    (the clip scale is read only when ``has_clip``).  On CUDA tensors
    this launches the kernel of ``csrc/fused_update.cu``: p and g
    contiguous in float32/bfloat16/float16, slots contiguous f32, all
    16-byte aligned; anything else raises.  On CPU tensors it runs the
    plain version and copies the result in."""
    keys = SLOT_KEYS[kind]
    enforce(tuple(sorted(slots)) == tuple(sorted(keys)),
            f"{kind} takes slots {keys}, got {sorted(slots)}")
    enforce(g.shape == p.shape and all(slots[k].shape == p.shape
                                       for k in keys),
            "param, grad and slots must share one shape")
    if p.device.type == "cpu":
        new_p, new_slots = fused_update_reference(
            kind, p, g, slots, lr=scalars[0], step_f=scalars[1],
            clip_scale=scalars[2] if has_clip else None, hyper=hyper)
        with torch.no_grad():
            p.copy_(new_p)
            for k in keys:
                slots[k].copy_(new_slots[k])
        return
    enforce(p.dtype in _DTYPE_CODE and g.dtype in _DTYPE_CODE,
            f"the update kernel takes params and grads in "
            f"{list(_DTYPE_CODE)}")
    tensors = [p, g] + [slots[k] for k in keys]
    enforce(all(s.dtype == torch.float32 for s in tensors[2:]),
            "the update kernel takes f32 slots")
    enforce(all(t.device == p.device for t in tensors)
            and scalars.device == p.device
            and scalars.dtype == torch.float32 and scalars.numel() == 3,
            "update operands and the f32[3] scalars must share one CUDA "
            "device")
    enforce(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in tensors),
            "the update kernel needs contiguous, 16-byte aligned operands")
    s = [slots[k].data_ptr() for k in keys] + [None] * (2 - len(keys))
    hp = hyper
    b1, b2 = hp.get("beta1", 0.0), hp.get("beta2", 0.0)
    lib = _kernel()
    with torch.cuda.device(p.device):
        err = lib.fused_update(
            _KIND_CODE[kind], _DTYPE_CODE[p.dtype], _DTYPE_CODE[g.dtype],
            p.data_ptr(), g.data_ptr(), s[0], s[1], p.numel(),
            scalars.data_ptr(), int(has_clip),
            float(hp.get("weight_decay", 0.0)),
            int(bool(hp.get("decoupled", False))),
            float(hp.get("momentum", 0.0)),
            int(bool(hp.get("nesterov", False))),
            b1, 1 - b1, b2, 1 - b2, float(hp.get("epsilon", 0.0)),
            torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError("fused update launch failed: "
                           + lib.fused_update_error_string(err).decode())
    fused_update_flat.launches += 1


fused_update_flat.launches = 0


# ---------------------------------------------------------------------------
# 2. fused residual add + norm
# ---------------------------------------------------------------------------

_NORM_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NORM_HALF = (torch.bfloat16, torch.float16)
_NORM_MAX_H = 8192


def add_rms_norm_reference(x, residual, weight, epsilon=1e-6):
    """``h = residual + x; y = rms_norm(h, weight)`` -- op for op the
    unfused residual add followed by ``_nn.rms_norm``.  Returns (h, y)."""
    h = residual + x
    return h, _nn.rms_norm(h, weight, epsilon=epsilon)


def add_layer_norm_reference(x, residual, weight, bias, epsilon=1e-5):
    """``h = residual + x; y = layer_norm(h)`` over the last axis -- op
    for op ``_nn.layer_norm`` with a length-1 normalized shape.  Returns
    (h, y)."""
    h = residual + x
    return h, _nn.layer_norm(h, h.shape[-1], weight, bias, epsilon)


def _norm_backward_plain(h, weight, bias, dh, dy, epsilon, ln):
    """(dx, dw, db) of ``(h, y) = add_norm(x, r, w, b)`` from h: the VJP
    of the plain chain in closed form, keeping its roundings where they
    fall on a 16-bit tensor -- ``dy * w`` in the product's dtype, then
    rounded to h's (the gradient reaching the normalised value, which
    the forward rounded to h's dtype); the gradient reaching h rounded
    to h's dtype before ``dh`` is added; ``dw`` the row sum of ``dy *
    round(n)`` in dy's dtype.  Statistics and the rest in f32."""
    t = h.dtype
    hf = h.float()
    d = hf - hf.mean(-1, keepdim=True) if ln else hf
    rstd = torch.rsqrt(d.square().mean(-1, keepdim=True) + epsilon)
    n = (d * rstd).to(t)
    g = (dy if weight is None else dy * weight).to(t).float()
    k = -(g * d).sum(-1, keepdim=True) * rstd.pow(3) / h.shape[-1]
    gh = g * rstd + d * k
    if ln:
        gh = gh - gh.mean(-1, keepdim=True)
    dx = gh.to(t)
    if dh is not None:
        dx = dx + dh
    rows = tuple(range(dy.dim() - 1))
    dw = None if weight is None else (dy * n).sum(rows).to(weight.dtype)
    db = None if bias is None else dy.sum(rows).to(bias.dtype)
    return dx, dw, db


def add_rms_norm_backward_reference(h, weight, dh, dy, epsilon=1e-6):
    """Plain backward of :func:`add_rms_norm_raw` from its output h:
    returns ``(dx, dw, None)``, dx the gradient of both x and residual;
    ``dh`` (h's own gradient) may be None."""
    return _norm_backward_plain(h, weight, None, dh, dy, epsilon, False)


def add_layer_norm_backward_reference(h, weight, bias, dh, dy,
                                      epsilon=1e-5):
    """Plain backward of :func:`add_layer_norm_raw` from its output h:
    returns ``(dx, dw, db)`` (db None without a bias)."""
    return _norm_backward_plain(h, weight, bias, dh, dy, epsilon, True)


_norm_libs: Dict[tuple, ctypes.CDLL] = {}     # (narrow, h, w) -> library
_bwd_blocks: Dict[tuple, int] = {}
# the current stream's raw handle without building a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _norm_source(narrow, hdt, wdt) -> str:
    """The #9 library that holds the kernels of these dtypes: the header
    ``csrc/add_norm.cuh`` is built as three translation units, one a
    family of dtype combinations, in parallel."""
    if narrow != hdt:
        return "add_norm_mixed"
    if torch.float16 in (hdt, wdt):
        return "add_norm_half"
    return "add_norm"


def _norm_kernel(narrow, hdt, wdt) -> ctypes.CDLL:
    lib = _norm_libs.get((narrow, hdt, wdt))
    if lib is None:
        lib = _build.load(_norm_source(narrow, hdt, wdt))
        lib.add_norm.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.add_norm_bwd_blocks.argtypes = [ctypes.c_int] * 6 + [
            ctypes.c_longlong, ctypes.c_int]
        lib.add_norm_bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        for fn in (lib.add_norm, lib.add_norm_bwd_blocks, lib.add_norm_bwd):
            fn.restype = ctypes.c_int
        lib.add_norm_error_string.argtypes = [ctypes.c_int]
        lib.add_norm_error_string.restype = ctypes.c_char_p
        _norm_libs[(narrow, hdt, wdt)] = lib
    return lib


def _launch(x, launch):
    """Run ``launch(stream)`` on x's device and current stream; the
    device is switched only when it is not the current one."""
    idx = x.get_device()
    if idx == torch.cuda.current_device():
        return launch(_raw_stream(idx) if _raw_stream is not None else
                      torch.cuda.current_stream(idx).cuda_stream)
    with torch.cuda.device(idx):
        return launch(torch.cuda.current_stream(idx).cuda_stream)


@functools.lru_cache(maxsize=None)      # a lookup on every launch
def _norm_dtypes(xd, rd, wd):
    """The kernel's operand order and dtypes for x, the residual and the
    weight: ``(swap, narrow, h)`` -- the narrower operand's dtype (x's
    unless ``swap``: the residual is the narrower), h's (the promoted
    one) -- or None for dtypes the kernel does not take.  It takes x and
    the residual in one of float32, bfloat16 and float16, or one 16-bit
    and one float32 (the mixed mode); the weight in h's dtype or float32
    (an f32 h also takes a 16-bit weight), in the mixed mode float32 or
    the narrower operand's dtype."""
    if xd not in _NORM_DTYPE or rd not in _NORM_DTYPE or \
            wd not in _NORM_DTYPE:
        return None
    if xd == rd:
        return (False, xd, xd) if (wd in (xd, torch.float32)
                                   or xd == torch.float32) else None
    swap = xd == torch.float32
    narrow = rd if swap else xd
    if narrow not in _NORM_HALF or torch.float32 not in (xd, rd):
        return None
    return (swap, narrow, torch.float32) if wd in (narrow, torch.float32) \
        else None


def _add_norm_refuse(x, residual, weight, bias, ln):
    """Raise on what the kernel does not take (the checks, with their
    messages, behind one cheap test in the launch)."""
    kind = "add_layer_norm" if ln else "add_rms_norm"
    if weight is None:
        raise NotImplementedError(f"the {kind} kernel needs a weight")
    hdim = x.shape[-1]
    if _norm_dtypes(x.dtype, residual.dtype, weight.dtype) is None:
        raise NotImplementedError(
            f"the {kind} kernel takes x and the residual in one dtype of "
            f"float32, bfloat16 and float16 or one 16-bit over float32, "
            f"the weight in h's dtype or float32 (see _norm_dtypes), not "
            f"{x.dtype} / {residual.dtype} / {weight.dtype}")
    if not 0 < hdim <= _NORM_MAX_H:
        raise NotImplementedError(
            f"the {kind} kernel takes rows of up to {_NORM_MAX_H} "
            f"elements, not {hdim}")
    enforce(residual.shape == x.shape,
            f"{kind}: residual {tuple(residual.shape)} must match x "
            f"{tuple(x.shape)}")
    enforce(weight.shape == (hdim,) and (bias is None or (
        bias.shape == (hdim,) and bias.dtype == weight.dtype)),
            f"{kind}: weight and bias must be [{hdim}] in one dtype")
    ops = [t for t in (x, residual, weight, bias) if t is not None]
    enforce(x.device.type == "cuda" and all(t.device == x.device
                                            for t in ops),
            f"{kind} arguments must share one CUDA device")
    raise AssertionError(f"{kind}: operands the kernel takes were refused")


def _add_norm_launch(x, residual, weight, bias, epsilon, ln):
    """(h, y) from the kernel of ``csrc/add_norm.cuh``; raises on what it
    does not take."""
    hdim = x.shape[-1]
    dev = x.device
    combo = None if weight is None else _norm_dtypes(
        x.dtype, residual.dtype, weight.dtype)
    if not (combo is not None and 0 < hdim <= _NORM_MAX_H
            and dev.type == "cuda" and residual.shape == x.shape
            and residual.device == dev
            and weight.shape == (hdim,) and weight.device == dev
            and (bias is None or (bias.shape == (hdim,) and bias.device == dev
                                  and bias.dtype == weight.dtype))):
        _add_norm_refuse(x, residual, weight, bias, ln)
    swap, narrow, hdt = combo
    if swap:            # h = r + x is symmetric: the narrower goes first
        x, residual = residual, x
    x, residual, weight = x.contiguous(), residual.contiguous(), \
        weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    h = torch.empty_like(residual)
    y = torch.empty_like(residual,
                         dtype=torch.promote_types(hdt, weight.dtype))
    rows = x.numel() // hdim
    if rows == 0:
        return h, y
    bp = 0 if bias is None else bias.data_ptr()
    ptrs = (x.data_ptr(), residual.data_ptr(), weight.data_ptr(), bp,
            h.data_ptr(), y.data_ptr())
    vec = 1 if hdim % 8 or (ptrs[0] | ptrs[1] | ptrs[2] | bp | ptrs[4]
                            | ptrs[5]) & 15 else 8
    lib = _norm_kernel(narrow, hdt, weight.dtype)
    err = _launch(x, lambda s: lib.add_norm(
        int(ln), ptrs[0], ptrs[1], ptrs[2], bp or None, ptrs[4], ptrs[5],
        rows, hdim, epsilon, _NORM_DTYPE[narrow], _NORM_DTYPE[hdt],
        _NORM_DTYPE[weight.dtype], vec, s))
    if err:
        raise RuntimeError(("add_layer_norm" if ln else "add_rms_norm")
                           + " launch failed: "
                           + lib.add_norm_error_string(err).decode())
    (add_layer_norm_raw if ln else add_rms_norm_raw).launches += 1
    return h, y


def _add_norm_plain(x, residual, weight, bias, epsilon, ln):
    if ln:
        return add_layer_norm_reference(x, residual, weight, bias, epsilon)
    return add_rms_norm_reference(x, residual, weight, epsilon)


def _add_norm_bwd_launch(h, weight, bias, dh, dy, epsilon, ln, narrow):
    """(dx in h's dtype, dx in ``narrow``, dw, db) from the backward
    kernels of ``csrc/add_norm.cuh`` (``add_norm_bwd``, then
    ``add_norm_bwd_reduce`` summing the blocks' dw and db partials in a
    fixed order); raises on what they do not take.  h, weight and bias
    are the forward's, which checked them; ``narrow`` is the narrower
    operand's dtype (h's when both share it)."""
    kind = "add_layer_norm" if ln else "add_rms_norm"
    hdim = h.shape[-1]
    out_dt = torch.promote_types(h.dtype, weight.dtype)
    if not (dy.shape == h.shape and dy.dtype == out_dt
            and dy.device == h.device and (dh is None or (
                dh.shape == h.shape and dh.dtype == h.dtype
                and dh.device == h.device))):
        raise ValueError(
            f"{kind} backward: dy must be {tuple(h.shape)} {out_dt} and dh "
            f"{h.dtype} on {h.device}, not {tuple(dy.shape)} {dy.dtype} on "
            f"{dy.device} and {None if dh is None else (dh.dtype, dh.device)}")
    if _norm_dtypes(narrow, h.dtype, weight.dtype) is None:
        raise NotImplementedError(
            f"{kind} backward: no kernel for x {narrow} under h {h.dtype} "
            f"with a {weight.dtype} weight")
    dy = dy.contiguous()
    dh = None if dh is None else dh.contiguous()
    dx = torch.empty_like(h, dtype=narrow)
    dr = torch.empty_like(h) if narrow != h.dtype else None
    dw = torch.empty_like(weight)
    db = None if bias is None else torch.empty_like(bias)
    rows = h.numel() // hdim
    if rows == 0:
        return (dx if dr is None else dr), dx, dw.zero_(), \
            None if db is None else db.zero_()
    hp = 0 if dh is None else dh.data_ptr()
    rp = 0 if dr is None else dr.data_ptr()
    ptrs = (h.data_ptr(), dy.data_ptr(), weight.data_ptr(), dx.data_ptr())
    vec = 1 if hdim % 8 or (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | hp
                            | rp) & 15 else 8
    lib = _norm_kernel(narrow, h.dtype, weight.dtype)
    codes = (_NORM_DTYPE[narrow], _NORM_DTYPE[h.dtype],
             _NORM_DTYPE[weight.dtype])
    key = (h.get_device(), ln, db is not None, codes, vec, rows, hdim)
    blocks = _bwd_blocks.get(key)
    if blocks is None:
        blocks = _launch(h, lambda s: lib.add_norm_bwd_blocks(
            int(ln), int(db is not None), *codes, vec, rows, hdim))
        if blocks <= 0:
            raise RuntimeError(f"{kind} backward: no grid: "
                               + lib.add_norm_error_string(-blocks).decode())
        _bwd_blocks[key] = blocks
    part = torch.empty((1 if db is None else 2) * blocks * hdim,
                       dtype=torch.float32, device=h.device)
    err = _launch(h, lambda s: lib.add_norm_bwd(
        int(ln), ptrs[0], ptrs[1], hp or None, ptrs[2], ptrs[3], rp or None,
        part.data_ptr(), dw.data_ptr(),
        None if db is None else db.data_ptr(), rows, hdim, epsilon, *codes,
        vec, blocks, s))
    if err:
        raise RuntimeError(f"{kind} backward launch failed: "
                           + lib.add_norm_error_string(err).decode())
    (add_layer_norm_backward_raw if ln
     else add_rms_norm_backward_raw).launches += 1
    return (dx if dr is None else dr), dx, dw, db


def _add_norm_backward(h, weight, bias, dh, dy, epsilon, ln, narrow):
    """(dx in h's dtype, dx in ``narrow``, dw, db): the plain version on
    the CPU (dx rounded once to ``narrow``, the VJP of jnp's cast), the
    kernels on the card."""
    if h.device.type == "cpu":
        dx, dw, db = _norm_backward_plain(h, weight, bias, dh, dy, epsilon,
                                          ln)
        return dx, dx.to(narrow), dw, db
    return _add_norm_bwd_launch(h, weight, bias, dh, dy, epsilon, ln, narrow)


class _AddNorm(torch.autograd.Function):
    """The kernel (CUDA) or the plain version (CPU), forward and
    backward.  The backward reads the forward's output h (not x and the
    residual) with the weight and bias; h's gradient is None when h is
    unused, so none is read."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, epsilon, ln):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            h, y = _add_norm_plain(x, residual, weight, bias, epsilon, ln)
        else:
            h, y = _add_norm_launch(x, residual, weight, bias, epsilon, ln)
        ctx.save_for_backward(h, weight, bias)
        ctx.cfg = (epsilon, ln)
        ctx.dtypes = (x.dtype, residual.dtype)
        return h, y

    @staticmethod
    def backward(ctx, dh, dy):
        h, weight, bias = ctx.saved_tensors
        xd, rd = ctx.dtypes
        narrow = rd if xd == h.dtype else xd
        if dy is None:
            gh, dw, db = dh, None, None
            gn = dh.to(narrow)
        else:
            gh, gn, dw, db = _add_norm_backward(h, weight, bias, dh, dy,
                                                *ctx.cfg, narrow)
        need = ctx.needs_input_grad
        return ((gh if xd == h.dtype else gn) if need[0] else None,
                (gh if rd == h.dtype else gn) if need[1] else None,
                dw if need[2] else None, db if need[3] else None, None,
                None)


def _add_norm(x, residual, weight, bias, epsilon, ln):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, residual, weight, bias)):
        return _AddNorm.apply(x, residual, weight, bias, epsilon, ln)
    if x.device.type == "cpu":
        return _add_norm_plain(x, residual, weight, bias, epsilon, ln)
    return _add_norm_launch(x, residual, weight, bias, epsilon, ln)


def add_rms_norm_raw(x, residual, weight, epsilon=1e-6):
    """Fused residual add + RMSNorm: returns ``(h, y)`` with
    ``h = residual + x`` and ``y = rms_norm(h, weight)``, y in the
    promoted dtype of h and weight (h's: x's and the residual's).  On
    CUDA tensors one launch of the kernel of ``csrc/add_norm.cuh`` (x and
    the residual in one of float32, bfloat16 and float16 or one 16-bit
    over float32, rows of up to 8192, a weight; other inputs raise), and
    its backward one call of :func:`add_rms_norm_backward_raw`; on CPU
    tensors the plain versions."""
    return _add_norm(x, residual, weight, None, float(epsilon), False)


def add_layer_norm_raw(x, residual, weight, bias, epsilon=1e-5):
    """Fused residual add + last-axis LayerNorm: returns ``(h, y)``.
    Same dispatch as :func:`add_rms_norm_raw`; ``bias`` may be None."""
    return _add_norm(x, residual, weight, bias, float(epsilon), True)


def _backward_raw(h, weight, bias, dh, dy, epsilon, ln, x_dtype):
    narrow = h.dtype if x_dtype is None else x_dtype
    gh, gn, dw, db = _add_norm_backward(h, weight, bias, dh, dy,
                                        float(epsilon), ln, narrow)
    return (gh if narrow == h.dtype else (gn, gh)), dw, db


def add_rms_norm_backward_raw(h, weight, dh, dy, epsilon=1e-6,
                              x_dtype=None):
    """The backward of :func:`add_rms_norm_raw` from its output h:
    ``(dx, dw, None)``, dx the gradient of x and of the residual, ``dh``
    h's own gradient or None.  In the mixed mode (``x_dtype`` narrower
    than h's) dx is the pair (x's gradient in ``x_dtype``, the
    residual's in h's dtype).  On CUDA tensors one call of the backward
    kernels of ``csrc/add_norm.cuh`` (counted once); on CPU tensors
    :func:`add_rms_norm_backward_reference`."""
    return _backward_raw(h, weight, None, dh, dy, epsilon, False, x_dtype)


def add_layer_norm_backward_raw(h, weight, bias, dh, dy, epsilon=1e-5,
                                x_dtype=None):
    """The backward of :func:`add_layer_norm_raw`: ``(dx, dw, db)``, dx
    as :func:`add_rms_norm_backward_raw`'s."""
    return _backward_raw(h, weight, bias, dh, dy, epsilon, True, x_dtype)


add_rms_norm_raw.launches = 0
add_layer_norm_raw.launches = 0
add_rms_norm_backward_raw.launches = 0
add_layer_norm_backward_raw.launches = 0


# ---------------------------------------------------------------------------
# 3. fused matmul + rotary (the rotary -> QKV chain)
# ---------------------------------------------------------------------------

_MMR_SOURCE = "matmul_rope"
_MMR_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotate_half_interleaved(x):
    """GPT-J pairing over (even, odd) lanes: ``(x0, x1) -> (-x1, x0)``."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(
        x.shape)


def _interleaved_tables(cos, sin):
    """The cat(freqs, freqs) tables as the interleaved rope reads them:
    angle i for lanes 2i and 2i + 1 (the first half repeated)."""
    half = cos.shape[-1] // 2
    return (cos[..., :half].repeat_interleave(2, dim=-1),
            sin[..., :half].repeat_interleave(2, dim=-1))


def _rotate_half_t(x):
    """The transpose of ``_rotate_half``: its backward."""
    half = x.shape[-1] // 2
    return torch.cat([x[..., half:], -x[..., :half]], dim=-1)


def _product_f32_acc(x, w):
    """``x @ w`` summed in f32 and rounded once to x's dtype (the
    reference's ``preferred_element_type=f32``): cuBLAS accumulates in
    f32 on the card; on the CPU the operands are widened first."""
    if x.dtype != torch.float32 and x.device.type == "cpu":
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


def matmul_rope_reference(x, w, cos, sin, n_heads, head_dim,
                          interleaved=False):
    """``reshape(x @ w) -> rope`` for one projection: the product summed
    in f32 and rounded to x's dtype, then the rotary embedding in f32
    (the tables widened) and rounded again.  x ``[B, S, K]``, w ``[K,
    n_heads * head_dim]``, cos/sin ``[S, head_dim]`` in the cat(freqs,
    freqs) layout; returns ``[B, S, n_heads, head_dim]``.
    ``interleaved``: the GPT-J pairing (``models/llama.py``
    ``apply_rotary_pos_emb``)."""
    b, s = x.shape[0], x.shape[1]
    y = _product_f32_acc(x, w).reshape(b, s, n_heads, head_dim)
    if interleaved:
        cos, sin = _interleaved_tables(cos, sin)
    rot = _rotate_half_interleaved if interleaved else _rotate_half
    cosb, sinb = cos[None, :, None, :].float(), sin[None, :, None, :].float()
    yf = y.float()
    return (yf * cosb + rot(yf) * sinb).to(y.dtype)


def _mmr_kernel() -> ctypes.CDLL:
    lib = _build.load(_MMR_SOURCE)
    fn = lib.matmul_rope
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.matmul_rope_error_string.argtypes = [ctypes.c_int]
        lib.matmul_rope_error_string.restype = ctypes.c_char_p
    return lib


def _matmul_rope_launch(x, w, cos, sin, n_heads, head_dim):
    """``[B, S, n_heads, head_dim]`` from the kernel of
    ``csrc/matmul_rope.cu``; raises on what it does not take."""
    if x.dtype not in _MMR_DTYPE:
        raise NotImplementedError(
            f"the matmul_rope kernel takes float32 and bfloat16, not "
            f"{x.dtype}")
    if head_dim not in (64, 128):
        raise NotImplementedError(
            f"the matmul_rope kernel takes head_dim 64 and 128, not "
            f"{head_dim}")
    b, s, k = x.shape
    if x.dtype == torch.bfloat16 and k % 8:
        raise NotImplementedError(
            f"the bf16 matmul_rope kernel needs K % 8 == 0, not {k}")
    enforce(w.dtype == x.dtype and w.shape == (k, n_heads * head_dim),
            f"matmul_rope: w must be [{k}, {n_heads * head_dim}] in "
            f"{x.dtype}, not {tuple(w.shape)} {w.dtype}")
    enforce(x.device.type == "cuda" and all(
        t.device == x.device for t in (w, cos, sin)),
        "matmul_rope arguments must share one CUDA device")
    x2, w = x.reshape(b * s, k).contiguous(), w.contiguous()
    # the kernel reads f32 and bf16 tables as they are (bf16 widens
    # exactly in registers); another dtype is widened here
    if cos.dtype != sin.dtype or cos.dtype not in _MMR_DTYPE:
        cos, sin = cos.float(), sin.float()
    cos, sin = cos.contiguous(), sin.contiguous()
    enforce(all(t.data_ptr() % 16 == 0 for t in (x2, w, cos, sin)),
            "the matmul_rope kernel needs 16-byte aligned x, w and tables")
    out = torch.empty((b, s, n_heads, head_dim), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _mmr_kernel()
    with torch.cuda.device(x.device):
        err = lib.matmul_rope(
            x2.data_ptr(), w.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            out.data_ptr(), b * s, k, n_heads, head_dim, s,
            _MMR_DTYPE[x.dtype], _MMR_DTYPE[cos.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("matmul_rope launch failed: "
                           + lib.matmul_rope_error_string(err).decode())
    matmul_rope_raw.launches += 1
    _flops.report(lambda: 2 * b * s * k * n_heads * head_dim)
    return out


class _MatmulRope(torch.autograd.Function):
    """The kernel (CUDA) or the plain version (CPU) forward.  Backward,
    the reference's ``_mmr_bwd`` without recomputing the product: the
    inverse rotation of the cotangent in f32, rounded to x's dtype, then
    ``dx = dy @ w^T`` and ``dw = x^T @ dy``.  The tables are constants."""

    @staticmethod
    def forward(ctx, x, w, cos, sin, n_heads, head_dim):
        ctx.save_for_backward(x, w, cos, sin)
        if x.device.type == "cpu":
            return matmul_rope_reference(x, w, cos, sin, n_heads, head_dim)
        return _matmul_rope_launch(x, w, cos, sin, n_heads, head_dim)

    @staticmethod
    def backward(ctx, ct):
        x, w, cos, sin = ctx.saved_tensors
        gf = ct.float()
        cosb, sinb = cos[None, :, None, :].float(), sin[None, :, None, :].float()
        dy = (gf * cosb + _rotate_half_t(gf * sinb)).to(x.dtype)
        dy = dy.reshape(-1, w.shape[1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _product_f32_acc(dy, w.t()).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = _product_f32_acc(x.reshape(-1, x.shape[-1]).t(), dy)
        return dx, dw, None, None, None, None


def matmul_rope_raw(x, w, cos, sin, *, n_heads, head_dim,
                    interleaved=False):
    """One q/k projection with the rotary embedding applied to the
    product's output tile: ``[B, S, n_heads, head_dim]``.

    On CUDA tensors one launch of the kernel of ``csrc/matmul_rope.cu``
    (x ``[B, S, K]`` and w in float32 or bfloat16, head_dim 64 or 128,
    cos/sin ``[S, head_dim]``; other inputs raise): bfloat16 on the
    tensor cores (``matmul_rope_wgmma``: TMA-fed ``wgmma``), float32 on
    the FMA pipe (``matmul_rope_f32``), chosen by dtype alone; f32 and
    bf16 tables are read as they are.  On CPU tensors the plain
    version.  Differentiable in x and w.

    Interleaved (GPT-J) rope takes the plain version on any device, in
    autograd ops: the reference's ``_mmr_eligible`` sends it to its
    plain rope (``paddle_tpu/ops/pallas/fused_train.py:474-476``), and
    the port makes the same choice on the same knob.  It launches
    nothing and counts nothing."""
    enforce(x.dim() == 3 and cos.shape == (x.shape[1], head_dim)
            and sin.shape == cos.shape,
            f"matmul_rope takes x [B, S, K] and cos/sin [S, {head_dim}], "
            f"not {tuple(x.shape)} and {tuple(cos.shape)}")
    enforce(not (cos.requires_grad or sin.requires_grad),
            "matmul_rope's rope tables are constants")
    if interleaved:
        return matmul_rope_reference(x, w, cos, sin, n_heads, head_dim,
                                     interleaved=True)
    return _MatmulRope.apply(x, w, cos, sin, n_heads, head_dim)


matmul_rope_raw.launches = 0


def qkv_rope_raw(x, wq, wk, wv, cos, sin, *, n_heads, n_kv, head_dim,
                 interleaved=False):
    """The rotary -> QKV chain: q and k each through
    :func:`matmul_rope_raw` (the pre-rope q and k never reach device
    memory), v a plain projection (``torch.matmul``, outside any kernel
    as in the reference).  Returns (q, k, v), each ``[B, S, heads,
    head_dim]``."""
    q = matmul_rope_raw(x, wq, cos, sin, n_heads=n_heads,
                        head_dim=head_dim, interleaved=interleaved)
    k = matmul_rope_raw(x, wk, cos, sin, n_heads=n_kv, head_dim=head_dim,
                        interleaved=interleaved)
    b, s = x.shape[0], x.shape[1]
    return q, k, product(x, wv).view(b, s, n_kv, head_dim)
