"""FlashAttention-2 forward and backward (counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``).

``flash_attention_fwd`` keeps the reference kernel's semantics
(``_fwd``): q/k/v on the framework's ``[B, S, H, D]`` layout, GQA
(query head h reads kv head ``h // G``), an additive f32 mask broadcast
as ``[B|1, H|1, Sq|1, Sk]``, and causal masking with Q as the last Sq
positions (``off = Sk - Sq``).  It returns the output and the per-row
log-sum-exp ``[B, H, Sq]`` f32.

``flash_attention_bwd`` is the reference's ``_bwd_impl``: from the
saved output and log-sum-exp it returns dQ ``[B, Sq, H, D]`` and dK/dV
at KV-head granularity ``[B, Sk, KVH, D]``, through two kernels (dQ
over query tiles; dK/dV over key tiles, summing the query-head group).
``_FlashAttention`` ties the two into an autograd Function, the
counterpart of the reference's ``_attach_grad``.  Its forward output and
lse go through ``jit.recompute.kept`` under the names ``flash_out`` and
``flash_lse``: inside a layer recomputed under ``"core_attn"`` the
recompute gets the first run's pair back and never relaunches the
forward kernel (the reference's flash-aware remat, where XLA drops the
dead forward), while the backward kernels run as always.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) or
raises; on CPU tensors it runs the plain version beside it.  Dropout
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..common.errors import enforce
from ..jit.recompute import kept
from . import _build

__all__ = ["flash_attention_raw", "flash_attention_fwd",
           "flash_attention_fwd_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_bwd_operands",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv"]

_NEG_INF = -1e30
_SOURCE = "flash_attention_fwd"
_BWD_SOURCE = "flash_attention_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(q, k, v, causal, mask, dropout_p):
    """Shape rules shared by the kernel and its plain version; returns
    the mask as a 4-D f32 tensor (or None)."""
    if dropout_p:
        raise NotImplementedError(
            "attention dropout is not ported yet: the Llama training "
            "recipe runs without it (ROADMAP 'Port: the GPT-2 training "
            "path')")
    enforce(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            "q/k/v must be [B, S, H, D] with k and v alike")
    b, sq, h, d = q.shape
    _, sk, hk, dk = k.shape
    enforce(k.shape[0] == b and dk == d and h % hk == 0,
            f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if causal and sq > sk:
        raise NotImplementedError("causal flash attention needs sq <= sk")
    if mask is None:
        return None
    mask = mask.float()
    while mask.dim() < 4:
        mask = mask[None]
    mb, mh, msq, msk = mask.shape
    if (msk != sk or mb not in (1, b) or mh not in (1, h)
            or msq not in (1, sq)):
        raise NotImplementedError(
            f"flash mask shape {tuple(mask.shape)} not broadcastable to "
            f"[{b},{h},{sq},{sk}]")
    return mask


def flash_attention_fwd_reference(q, k, v, *, causal: bool = False,
                                  mask=None, dropout_p: float = 0.0):
    """Plain PyTorch version of the kernel: the same function in f32 in
    one pass (max, exp, sum) instead of tiles.  Returns (out [B, Sq, H,
    D] in q's dtype, lse [B, H, Sq] f32)."""
    mask = _check(q, k, v, causal, mask, dropout_p)
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(d))  # [B, H, Sq, D]
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    s = qf @ kf.transpose(-1, -2)                          # [B, H, Sq, Sk]
    if mask is not None:
        s = s + mask
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        visible = rows >= torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~visible, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = (p @ vf) / l
    return out.transpose(1, 2).to(q.dtype), (m + torch.log(l))[..., 0]


def _mask_strides(mask, b, h, sq, sk):
    """The mask with a contiguous last dim and its element strides over
    (batch, head, query row), 0 where it broadcasts; [0, 0, 0] for no
    mask."""
    if mask is None:
        return None, [0, 0, 0]
    if mask.stride(-1) != 1:
        mask = mask.contiguous()
    return mask, list(mask.expand(b, h, sq, sk).stride()[:3])


def _kernel() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, *, causal: bool = False, mask=None,
                        dropout_p: float = 0.0):
    """FlashAttention forward on ``[B, S, H, D]``: returns (out [B, Sq,
    H, D] in q's dtype, lse [B, H, Sq] f32).

    On CUDA tensors this launches the kernel of
    ``csrc/flash_attention_fwd.cu``: q/k/v in one dtype of
    float32/bfloat16/float16, D of 64 or 128, the last dim contiguous
    (batch, sequence and head strides are free); other shapes raise
    NotImplementedError.  On CPU tensors it runs the plain version."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal=causal,
                                             mask=mask, dropout_p=dropout_p)
    mask = _check(q, k, v, causal, mask, dropout_p)
    enforce(q.device.type == "cuda" and k.device == q.device
            and v.device == q.device
            and (mask is None or mask.device == q.device),
            "flash attention arguments must share one CUDA device")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if d not in (64, 128):
        raise NotImplementedError(
            f"flash kernel head_dim {d} (built for 64 and 128)")
    enforce(q.dtype in _DTYPE_CODE and k.dtype == q.dtype
            and v.dtype == q.dtype,
            f"the flash kernel takes q/k/v in one dtype of "
            f"{list(_DTYPE_CODE)}")
    esize = q.element_size()
    for x in (q, k, v):
        enforce(x.stride(-1) == 1, "flash kernel needs a contiguous "
                                   "last dim")
    for x in (k, v):
        enforce(x.data_ptr() % 16 == 0 and all(
            st * esize % 16 == 0 for st in x.stride()[:3]),
            "flash kernel needs 16-byte aligned K/V rows")
    mask, mstrides = _mask_strides(mask, b, h, sq, sk)
    strides = list(q.stride()[:3]) + list(k.stride()[:3]) + \
        list(v.stride()[:3]) + mstrides
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hk, sq, sk, d,
            (ctypes.c_longlong * 12)(*strides), int(causal),
            1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention launch failed: "
                           + lib.flash_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_reference(q, k, v, out, lse, do, *,
                                  causal: bool = False, mask=None):
    """Plain PyTorch version of the two backward kernels, in f32 over
    the whole score matrix: the softmax is rebuilt from the saved lse
    (``p = exp(s - lse)``), ``delta = rowsum(dO * O)`` and ``ds = p (dO
    V^T - delta)``.  Returns (dq [B, Sq, H, D], dk, dv [B, Sk, KVH, D]),
    each in its input's dtype; dK/dV sum the query-head group."""
    mask = _check(q, k, v, causal, mask, 0.0)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2) * scale                 # [B, H, Sq, D]
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    dof = do.float().transpose(1, 2)
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    p = qf @ kf.transpose(-1, -2)                          # scores
    if mask is not None:
        p.add_(mask)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        p.masked_fill_(rows < torch.arange(sk, device=q.device)[None, :],
                       _NEG_INF)
    p.sub_(lse[..., None]).exp_()
    ds = dof @ vf.transpose(-1, -2)
    ds.sub_(delta[..., None]).mul_(p)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf).view(b, hk, g, sk, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(b, hk, g, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _bwd_kernel() -> ctypes.CDLL:
    lib = _build.load(_BWD_SOURCE)
    if lib.flash_attention_bwd_dq.argtypes is None:
        common = [ctypes.c_void_p] * 7        # q, k, v, do, lse, delta, mask
        dims = [ctypes.c_int] * 6             # B, H, KVH, Sq, Sk, D
        tail = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]      # mask strides, causal, scale, dtype, stream
        lib.flash_attention_bwd_dq.argtypes = \
            common + [ctypes.c_void_p] + dims + tail
        lib.flash_attention_bwd_dkv.argtypes = \
            common + [ctypes.c_void_p] * 2 + dims + tail
        for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd_operands(q, k, v, out, lse, do, causal, mask):
    """Checks shared by the two backward launches; returns their
    operands: q, k, v and dout contiguous, lse, delta = rowsum(dO * O)
    [B, H, Sq] f32, the mask and its element strides."""
    mask = _check(q, k, v, causal, mask, 0.0)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in (64, 128):
        raise NotImplementedError(
            f"flash backward kernels head_dim {d} (built for 64 and 128)")
    enforce(q.dtype in _DTYPE_CODE and all(
        x.dtype == q.dtype for x in (k, v, out, do)),
        f"the flash backward kernels take q/k/v/out/dout in one dtype of "
        f"{list(_DTYPE_CODE)}")
    enforce(out.shape == q.shape and do.shape == q.shape,
            "out and dout must have q's shape")
    enforce(lse.shape == (b, h, sq) and lse.dtype == torch.float32,
            f"lse must be [B, H, Sq] = {[b, h, sq]} float32")
    dev = q.device
    enforce(dev.type == "cuda" and all(
        x.device == dev for x in (k, v, out, lse, do))
        and (mask is None or mask.device == dev),
        "flash backward arguments must share one CUDA device")
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    lse = lse.contiguous()
    # delta = rowsum(dO * O), outside the kernels as in the reference
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    mask, mstrides = _mask_strides(mask, b, h, sq, sk)
    return q, k, v, do, lse, delta, mask, mstrides


def _launch(fn, outs, q, k, v, do, lse, delta, mask, mstrides, causal):
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    lib = _bwd_kernel()
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if mask is None else mask.data_ptr(),
            *(o.data_ptr() for o in outs), b, h, hk, sq, sk, d,
            (ctypes.c_longlong * 3)(*mstrides), int(causal),
            1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.flash_bwd_error_string(err).decode())


def flash_attention_bwd_dq(q, k, v, do, lse, delta, mask, mstrides,
                           causal):
    """Launch of the dQ kernel on ``flash_attention_bwd_operands``: one
    block per (64-row query tile, head, batch), streaming K/V tiles up
    to the causal diagonal.  Returns dq [B, Sq, H, D]."""
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_dq", (dq,), q, k, v, do, lse, delta, mask,
            mstrides, causal)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, mask, mstrides,
                            causal):
    """Launch of the dK/dV kernel on ``flash_attention_bwd_operands``:
    one block per (64-key tile, kv head, batch), looping over the
    query-head group and the query tiles that see its keys.  Returns
    (dk, dv) [B, Sk, KVH, D], written once, without atomics."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd_dkv", (dk, dv), q, k, v, do, lse, delta,
            mask, mstrides, causal)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = False,
                        mask=None):
    """FlashAttention backward on ``[B, S, H, D]`` from the forward's
    output and lse: returns (dq [B, Sq, H, D], dk, dv [B, Sk, KVH, D]).

    On CUDA tensors this launches the dQ and the dK/dV kernels of
    ``csrc/flash_attention_bwd.cu`` (one dtype of float32/bfloat16/
    float16, D of 64 or 128; other shapes raise NotImplementedError).
    On CPU tensors it runs the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             causal=causal, mask=mask)
    args = flash_attention_bwd_operands(q, k, v, out, lse, do, causal,
                                        mask)
    dq = flash_attention_bwd_dq(*args, causal)
    dk, dv = flash_attention_bwd_dkv(*args, causal)
    return dq, dk, dv


def _flash_fwd_kept(q, k, v, causal, mask, dropout_p=0.0):
    """``flash_attention_fwd``'s (out, lse), kept and replayed by a
    recompute policy that keeps ``flash_out`` / ``flash_lse``."""
    return kept(("flash_out", "flash_lse"), lambda: flash_attention_fwd(
        q, k, v, causal=causal, mask=mask, dropout_p=dropout_p))


class _FlashAttention(torch.autograd.Function):
    """Flash forward with its backward kernels attached: saves (q, k, v,
    out, lse) and differentiates q, k and v.  The mask is an input, not
    a trained parameter, as in the reference's ``_attach_grad_masked``."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = _flash_fwd_kept(q, k, v, causal, mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask, ctx.causal = mask, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, mask=ctx.mask)
        return dq, dk, dv, None, None


def flash_attention_raw(q, k, v, causal: bool = False, mask=None,
                        dropout_p: float = 0.0):
    """``[B, S, H, D]`` entry: the output of ``flash_attention_fwd``,
    differentiable in q, k and v through ``_FlashAttention`` when grad
    mode is on and one of them requires grad.  A mask that requires
    grad (a trained bias) raises: its gradient kernel is not ported."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        if mask is not None and mask.requires_grad:
            raise NotImplementedError(
                "the gradient of a trained attention bias is not ported "
                "yet (ROADMAP 'Port: remaining kernels')")
        _check(q, k, v, causal, mask, dropout_p)
        return _FlashAttention.apply(q, k, v, mask, causal)
    return _flash_fwd_kept(q, k, v, causal, mask, dropout_p)[0]
