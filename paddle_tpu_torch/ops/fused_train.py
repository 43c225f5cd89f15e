"""The reference's fused step regions (counterpart of
``paddle_tpu/ops/pallas/fused_train.py``), each a hand-written CUDA
kernel beside its plain PyTorch version:

1. the optimizer update with the global-norm clip folded in
   (``csrc/fused_update.cu``);
2. the residual add fused with RMSNorm or LayerNorm
   (``csrc/add_norm.cu``);
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

Add + norm and matmul + rope are differentiable: their backward is the
reference math in plain PyTorch, as the reference's ``custom_vjp``
rules are (it has no backward kernel for either).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..common.errors import enforce
from ..jit.recompute import product
from . import _build, _nn
from . import flops as _flops

__all__ = ["SLOT_KEYS", "fused_update_flat", "fused_update_reference",
           "update_flop_estimate", "add_rms_norm_reference",
           "add_layer_norm_reference", "add_rms_norm_raw",
           "add_layer_norm_raw", "matmul_rope_reference", "matmul_rope_raw",
           "qkv_rope_raw"]

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

_NORM_SOURCE = "add_norm"
_NORM_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
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


def _norm_kernel() -> ctypes.CDLL:
    lib = _build.load(_NORM_SOURCE)
    fn = lib.add_norm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.add_norm_error_string.argtypes = [ctypes.c_int]
        lib.add_norm_error_string.restype = ctypes.c_char_p
    return lib


def _add_norm_launch(x, residual, weight, bias, epsilon, ln):
    """(h, y) from the kernel of ``csrc/add_norm.cu``; raises on what it
    does not take."""
    kind = "add_layer_norm" if ln else "add_rms_norm"
    if weight is None:
        raise NotImplementedError(f"the {kind} kernel needs a weight")
    hdim = x.shape[-1]
    if x.dtype not in _NORM_DTYPE or weight.dtype not in _NORM_DTYPE:
        raise NotImplementedError(
            f"the {kind} kernel takes float32 and bfloat16, not "
            f"{x.dtype} / {weight.dtype}")
    if not 0 < hdim <= _NORM_MAX_H:
        raise NotImplementedError(
            f"the {kind} kernel takes rows of up to {_NORM_MAX_H} "
            f"elements, not {hdim}")
    enforce(residual.shape == x.shape and residual.dtype == x.dtype,
            f"{kind}: residual {tuple(residual.shape)} {residual.dtype} "
            f"must match x {tuple(x.shape)} {x.dtype}")
    enforce(weight.shape == (hdim,) and (bias is None or (
        bias.shape == (hdim,) and bias.dtype == weight.dtype)),
            f"{kind}: weight and bias must be [{hdim}] in one dtype")
    ops = [t for t in (x, residual, weight, bias) if t is not None]
    enforce(x.device.type == "cuda" and all(t.device == x.device
                                            for t in ops),
            f"{kind} arguments must share one CUDA device")
    x, residual, weight = (t.contiguous() for t in (x, residual, weight))
    bias = None if bias is None else bias.contiguous()
    h = torch.empty_like(x)
    y = torch.empty(x.shape, device=x.device,
                    dtype=torch.promote_types(x.dtype, weight.dtype))
    rows = x.numel() // hdim
    if rows == 0:
        return h, y
    operands = [x, residual, weight, h, y] + ([] if bias is None
                                              else [bias])
    vec = 8 if hdim % 8 == 0 and all(t.data_ptr() % 16 == 0
                                     for t in operands) else 1
    lib = _norm_kernel()
    with torch.cuda.device(x.device):
        err = lib.add_norm(
            int(ln), x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), h.data_ptr(),
            y.data_ptr(), rows, hdim, float(epsilon), _NORM_DTYPE[x.dtype],
            _NORM_DTYPE[weight.dtype], vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{kind} launch failed: "
                           + lib.add_norm_error_string(err).decode())
    (add_layer_norm_raw if ln else add_rms_norm_raw).launches += 1
    return h, y


def _add_norm_plain(x, residual, weight, bias, epsilon, ln):
    if ln:
        return add_layer_norm_reference(x, residual, weight, bias, epsilon)
    return add_rms_norm_reference(x, residual, weight, epsilon)


class _AddNorm(torch.autograd.Function):
    """The kernel (CUDA) or the plain version (CPU) forward; the
    backward differentiates the plain version from the saved inputs, as
    the reference's ``_add_rms_bwd`` / ``_add_ln_bwd`` do."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, epsilon, ln):
        ctx.save_for_backward(x, residual, weight, bias)
        ctx.cfg = (epsilon, ln)
        if x.device.type == "cpu":
            return _add_norm_plain(x, residual, weight, bias, epsilon, ln)
        return _add_norm_launch(x, residual, weight, bias, epsilon, ln)

    @staticmethod
    def backward(ctx, dh, dy):
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(r)
                   for t, r in zip(ctx.saved_tensors, need)]
            outs = _add_norm_plain(*ins, *ctx.cfg)
            wrt = [t for t, r in zip(ins, need) if r]
            grads = iter(torch.autograd.grad(outs, wrt, (dh, dy),
                                             allow_unused=True))
        return tuple(next(grads) if r else None for r in need) + (None,
                                                                 None)


def add_rms_norm_raw(x, residual, weight, epsilon=1e-6):
    """Fused residual add + RMSNorm: returns ``(h, y)`` with
    ``h = residual + x`` and ``y = rms_norm(h, weight)``, y in the
    promoted dtype of x and weight.  On CUDA tensors one launch of the
    kernel of ``csrc/add_norm.cu`` (float32/bfloat16, rows of up to 8192,
    a weight; other inputs raise); on CPU tensors the plain version."""
    return _AddNorm.apply(x, residual, weight, None, float(epsilon), False)


def add_layer_norm_raw(x, residual, weight, bias, epsilon=1e-5):
    """Fused residual add + last-axis LayerNorm: returns ``(h, y)``.
    Same dispatch as :func:`add_rms_norm_raw`; ``bias`` may be None."""
    return _AddNorm.apply(x, residual, weight, bias, float(epsilon), True)


add_rms_norm_raw.launches = 0
add_layer_norm_raw.launches = 0


# ---------------------------------------------------------------------------
# 3. fused matmul + rotary (the rotary -> QKV chain)
# ---------------------------------------------------------------------------

_MMR_SOURCE = "matmul_rope"
_MMR_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


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


def matmul_rope_reference(x, w, cos, sin, n_heads, head_dim):
    """``reshape(x @ w) -> rope`` for one projection: the product summed
    in f32 and rounded to x's dtype, then the rotary embedding in f32
    (the tables widened) and rounded again.  x ``[B, S, K]``, w ``[K,
    n_heads * head_dim]``, cos/sin ``[S, head_dim]`` in the cat(freqs,
    freqs) layout; returns ``[B, S, n_heads, head_dim]``."""
    b, s = x.shape[0], x.shape[1]
    y = _product_f32_acc(x, w).reshape(b, s, n_heads, head_dim)
    cosb, sinb = cos[None, :, None, :].float(), sin[None, :, None, :].float()
    yf = y.float()
    return (yf * cosb + _rotate_half(yf) * sinb).to(y.dtype)


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
    version.  Differentiable in x and w.  Interleaved (GPT-J)
    rope raises: the port's models refuse ``rope_interleaved``."""
    enforce(x.dim() == 3 and cos.shape == (x.shape[1], head_dim)
            and sin.shape == cos.shape,
            f"matmul_rope takes x [B, S, K] and cos/sin [S, {head_dim}], "
            f"not {tuple(x.shape)} and {tuple(cos.shape)}")
    enforce(not (cos.requires_grad or sin.requires_grad),
            "matmul_rope's rope tables are constants")
    if interleaved:
        raise NotImplementedError(
            "interleaved rope in matmul_rope is not ported yet (ROADMAP "
            "'Port: remaining modules')")
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
