"""FlashAttention-2 forward (counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``, forward pass only).

``flash_attention_fwd`` keeps the reference kernel's semantics
(``_fwd``): q/k/v on the framework's ``[B, S, H, D]`` layout, GQA
(query head h reads kv head ``h // G``), an additive f32 mask broadcast
as ``[B|1, H|1, Sq|1, Sk]``, and causal masking with Q as the last Sq
positions (``off = Sk - Sq``).  It returns the output and the per-row
log-sum-exp ``[B, H, Sq]`` f32.

On CUDA tensors it launches the hand-written kernel of
``csrc/flash_attention_fwd.cu`` or raises; on CPU tensors it runs the
plain version beside it, ``flash_attention_fwd_reference``.  Dropout
belongs to the training slice and raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..common.errors import enforce
from . import _build

__all__ = ["flash_attention_raw", "flash_attention_fwd",
           "flash_attention_fwd_reference"]

_NEG_INF = -1e30
_SOURCE = "flash_attention_fwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(q, k, v, causal, mask, dropout_p):
    """Shape rules shared by the kernel and its plain version; returns
    the mask as a 4-D f32 tensor (or None)."""
    if dropout_p:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP 'Port: "
            "training/forward slice')")
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
    strides = list(q.stride()[:3]) + list(k.stride()[:3]) + \
        list(v.stride()[:3])
    if mask is not None:
        if mask.stride(-1) != 1:
            mask = mask.contiguous()
        strides += list(mask.expand(b, h, sq, sk).stride()[:3])
    else:
        strides += [0, 0, 0]
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


def flash_attention_raw(q, k, v, causal: bool = False, mask=None,
                        dropout_p: float = 0.0):
    """``[B, S, H, D]`` entry: the output of ``flash_attention_fwd``."""
    return flash_attention_fwd(q, k, v, causal=causal, mask=mask,
                               dropout_p=dropout_p)[0]
