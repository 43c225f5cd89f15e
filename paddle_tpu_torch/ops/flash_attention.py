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
``flash_attention_dbias`` is ``_bwd_dmask``: the gradient of a trained
additive bias ``[B|1, H|1, Sq, Sk]``, summed over the dims it
broadcasts.  ``_FlashAttention`` ties the forward and the two backward
kernels into an autograd Function (the reference's ``_attach_grad``),
``_FlashAttentionBias`` adds the bias gradient (``_attach_grad_bias``).
Their forward output and lse go through ``jit.recompute.kept`` under
the names ``flash_out`` and ``flash_lse``: inside a layer recomputed
under ``"core_attn"`` the recompute gets the first run's pair back and
never relaunches the forward kernel (the reference's flash-aware remat,
where XLA drops the dead forward), while the backward kernels run as
always.

Dropout (``dropout_p`` in [0, 1), a device int64 ``seed``) runs inside
the kernels, as the reference's: the forward drops attention
probabilities in the P·V product only (the lse stays undropped), and
the backward kernels regenerate the same keep bits to mask dP and the
probabilities dV takes.  The keep bit of an element is a pure function
of (seed, batch, query head, query row, key column), a counter-based
hash (``csrc/attention_dropout.cuh``, twin ``dropout_keep`` here), not
of any tile size, so every kernel and every plain version draws the same
mask.  No bit parity with the reference is possible: it seeds the TPU's
hardware PRNG per (b, h, q tile, k tile), and in interpret mode that
PRNG is stubbed to zeros.  The tests hold each kernel against its plain
version fed the same seed, and the keep rate against the binomial.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/flash_attention_dbias.cu``) or raises; on CPU tensors it runs the
plain version beside it.
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
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dbias", "flash_attention_dbias",
           "flash_attention_dbias_reference", "dropout_bits",
           "dropout_keep"]

_NEG_INF = -1e30
_SOURCE = "flash_attention_fwd"
_BWD_SOURCE = "flash_attention_bwd"
_DBIAS_SOURCE = "flash_attention_dbias"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_REMAINING = "ROADMAP 'Port: remaining kernels'"


# -- the dropout keep bit (twin of csrc/attention_dropout.cuh) ---------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32), by 16-bit halves
    of ``c`` so no product leaves the int64 range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix(x, v):
    return _fmix32(_mul32(x ^ v, 0x9E3779B1))


def _threshold(dropout_p: float) -> int:
    """The reference's keep rule: keep iff bits >= min(floor(p 2^32),
    2^32 - 1)."""
    return min(int(dropout_p * 4294967296.0), _M32)


def _index(x, dev):
    return torch.arange(x, device=dev) if isinstance(x, int) \
        else x.to(device=dev, dtype=torch.int64)


def dropout_bits(seed, batch, heads, rows, cols):
    """The kernels' 32-bit hash of each element, as int64 ``[len(batch),
    len(heads), len(rows), len(cols)]`` for the int64 index vectors given
    (or ``range(n)`` for an int ``n``), from the int64 scalar ``seed``
    tensor: ``mix(mix(mix(mix(mix(seed_lo, seed_hi), b), h), row),
    col)``.  It depends on no tile size: the bits of a block of rows
    equal that block of the whole."""
    dev = seed.device
    s = seed.to(torch.int64)
    x = _mix(s & _M32, (s >> 32) & _M32)
    x = _mix(x, _index(batch, dev).view(-1, 1, 1, 1))
    x = _mix(x, _index(heads, dev).view(1, -1, 1, 1))
    x = _mix(x, _index(rows, dev).view(1, 1, -1, 1))
    return _mix(x, _index(cols, dev).view(1, 1, 1, -1))


_KEEP_BLOCK = 1 << 24      # elements hashed at a time (int64 temporaries)


def dropout_keep(seed, dropout_p: float, batch, heads, rows, cols):
    """The kernels' keep mask, bit for bit: ``dropout_bits(...) >=
    min(floor(p 2^32), 2^32 - 1)``, a bool of the same shape, hashed a
    block of rows at a time so the int64 temporaries stay small."""
    dev = seed.device
    batch, heads, rows, cols = (_index(x, dev)
                                for x in (batch, heads, rows, cols))
    nb, nh, nr, nc = len(batch), len(heads), len(rows), len(cols)
    keep = torch.empty((nb, nh, nr, nc), dtype=torch.bool, device=dev)
    step = max(1, _KEEP_BLOCK // max(1, nb * nh * nc))
    thresh = _threshold(dropout_p)
    for r0 in range(0, nr, step):
        keep[:, :, r0:r0 + step] = dropout_bits(
            seed, batch, heads, rows[r0:r0 + step], cols) >= thresh
    return keep


def _dropped(x, keep, dropout_p):
    """``x / (1 - p)`` where kept, else 0 (f32, as the kernels)."""
    return torch.where(keep, x * (1.0 / (1.0 - dropout_p)),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _check(q, k, v, causal, mask, dropout_p):
    """Shape rules shared by the kernels and their plain versions (the
    reference's ``check_eligibility``); returns the mask as a 4-D f32
    tensor (or None).  ``dropout_p`` outside [0, 1) raises ValueError."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
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


def _keep_of(q, k, dropout_p, seed):
    """The whole ``[B, H, Sq, Sk]`` keep mask, or None without dropout."""
    if not dropout_p:
        return None
    enforce(seed is not None, "attention dropout needs a seed tensor")
    b, sq, h, _ = q.shape
    return dropout_keep(seed, dropout_p, b, h, sq, k.shape[1])


def _seed_args(seed, dropout_p, dev):
    """The kernels' dropout arguments: (seed pointer or None, threshold,
    1 / (1 - p))."""
    if not dropout_p:
        return None, 0, 1.0
    enforce(seed is not None and seed.device == dev
            and seed.dtype == torch.int64 and seed.numel() == 1,
            "attention dropout needs an int64 seed tensor on the device "
            "of q")
    return seed.data_ptr(), _threshold(dropout_p), 1.0 / (1.0 - dropout_p)


def flash_attention_fwd_reference(q, k, v, *, causal: bool = False,
                                  mask=None, dropout_p: float = 0.0,
                                  seed=None):
    """Plain PyTorch version of the kernel: the same function in f32 in
    one pass (max, exp, sum) instead of tiles, with the kernel's keep
    mask (``dropout_keep``) on the probabilities of the P·V product.
    Returns (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32, the
    undropped softmax's)."""
    mask = _check(q, k, v, causal, mask, dropout_p)
    keep = _keep_of(q, k, dropout_p, seed)
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
    if keep is not None:
        p = _dropped(p, keep, dropout_p)
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
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, *, causal: bool = False, mask=None,
                        dropout_p: float = 0.0, seed=None):
    """FlashAttention forward on ``[B, S, H, D]``: returns (out [B, Sq,
    H, D] in q's dtype, lse [B, H, Sq] f32).  With ``dropout_p`` > 0 the
    int64 scalar ``seed`` tensor picks the keep mask.

    On CUDA tensors this launches the kernel of
    ``csrc/flash_attention_fwd.cu``: q/k/v in one dtype of
    float32/bfloat16/float16, D of 64 or 128, the last dim contiguous
    (batch, sequence and head strides are free); other shapes raise
    NotImplementedError.  On CPU tensors it runs the plain version."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal=causal,
                                             mask=mask, dropout_p=dropout_p,
                                             seed=seed)
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
    drop = _seed_args(seed, dropout_p, q.device)
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
            1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype], *drop,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention launch failed: "
                           + lib.flash_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _probs_reference(q, k, v, lse, causal, mask):
    """The backward's rebuilt softmax ``p = exp(s - lse)`` [B, H, Sq, Sk]
    f32 and the f32 operands (q pre-scaled, k and v repeated over the
    query-head group) as ``[B, H, S, D]``."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(d))
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    p = qf @ kf.transpose(-1, -2)                          # scores
    if mask is not None:
        p.add_(mask)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        p.masked_fill_(rows < torch.arange(sk, device=q.device)[None, :],
                       _NEG_INF)
    p.sub_(lse[..., None]).exp_()
    return p, qf, kf, vf


def _ds_reference(p, out, do, vf, keep, dropout_p):
    """``ds = p (dP' - delta)`` with ``dP' = dO V^T`` masked and scaled
    by the keep mask, and ``delta = rowsum(dO * O)``; also ``dO`` as
    ``[B, H, Sq, D]`` f32."""
    dof = do.float().transpose(1, 2)
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    dp = dof @ vf.transpose(-1, -2)
    if keep is not None:
        dp = _dropped(dp, keep, dropout_p)
    return dp.sub_(delta[..., None]).mul_(p), dof


def flash_attention_bwd_reference(q, k, v, out, lse, do, *,
                                  causal: bool = False, mask=None,
                                  dropout_p: float = 0.0, seed=None):
    """Plain PyTorch version of the two backward kernels, in f32 over
    the whole score matrix: the softmax is rebuilt from the saved lse
    (``p = exp(s - lse)``), ``delta = rowsum(dO * O)``, ``ds = p (dP' -
    delta)`` with ``dP' = dO V^T`` dropped by the forward's keep mask,
    and dV takes the dropped probabilities.  Returns (dq [B, Sq, H, D],
    dk, dv [B, Sk, KVH, D]), each in its input's dtype; dK/dV sum the
    query-head group."""
    mask = _check(q, k, v, causal, mask, dropout_p)
    keep = _keep_of(q, k, dropout_p, seed)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    p, qf, kf, vf = _probs_reference(q, k, v, lse, causal, mask)
    ds, dof = _ds_reference(p, out, do, vf, keep, dropout_p)
    if keep is not None:
        p = _dropped(p, keep, dropout_p)
    dq = (ds @ kf) * (1.0 / math.sqrt(d))
    dk = (ds.transpose(-1, -2) @ qf).view(b, hk, g, sk, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(b, hk, g, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _bias4(q, bias):
    """The trained bias as ``[MB, MH, Sq, Sk]`` f32; a bias that
    broadcasts over Sq raises (the reference's ``_bwd_dmask`` rule)."""
    b4 = bias.float()
    while b4.dim() < 4:
        b4 = b4[None]
    if b4.shape[2] != q.shape[1]:
        raise NotImplementedError(
            "the bias-gradient kernel needs a bias over the full Sq (no "
            f"query broadcast) ({_REMAINING})")
    return b4


def _bias_grad_sum(ds, bias_shape4):
    """``ds`` [B, H, Sq, Sk] summed over the dims the bias broadcasts."""
    dims = [i for i in (0, 1) if bias_shape4[i] == 1 and ds.shape[i] > 1]
    return ds.sum(dims, keepdim=True) if dims else ds


def flash_attention_dbias_reference(q, k, v, out, lse, do, bias, *,
                                    causal: bool = False,
                                    dropout_p: float = 0.0, seed=None):
    """Plain PyTorch version of the bias-gradient kernel: ``ds = p (dP'
    - delta)`` as in ``flash_attention_bwd_reference``, summed over the
    batch and head dims the bias ``[B|1, H|1, Sq, Sk]`` broadcasts.
    Returns dbias in the bias's shape and dtype."""
    mask = _check(q, k, v, causal, bias, dropout_p)
    b4 = _bias4(q, mask)
    keep = _keep_of(q, k, dropout_p, seed)
    p, _, _, vf = _probs_reference(q, k, v, lse, causal, b4)
    ds, _ = _ds_reference(p, out, do, vf, keep, dropout_p)
    return _bias_grad_sum(ds, b4.shape).reshape(bias.shape).to(bias.dtype)


def _bwd_kernel() -> ctypes.CDLL:
    lib = _build.load(_BWD_SOURCE)
    if lib.flash_attention_bwd_dq.argtypes is None:
        common = [ctypes.c_void_p] * 7        # q, k, v, do, lse, delta, mask
        dims = [ctypes.c_int] * 6             # B, H, KVH, Sq, Sk, D
        tail = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
                ctypes.c_void_p]   # mask strides, causal, scale, dtype,
        #                            seed, thresh, inv_keep, stream
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
    """Checks shared by the backward launches; returns their operands:
    q, k, v and dout contiguous, lse, delta = rowsum(dO * O) [B, H, Sq]
    f32, the mask and its element strides."""
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


def _launch(fn, outs, q, k, v, do, lse, delta, mask, mstrides, causal,
            dropout_p, seed):
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
            *_seed_args(seed, dropout_p, q.device),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.flash_bwd_error_string(err).decode())


def flash_attention_bwd_dq(q, k, v, do, lse, delta, mask, mstrides,
                           causal, dropout_p: float = 0.0, seed=None):
    """Launch of the dQ kernel on ``flash_attention_bwd_operands``: one
    block per (64-row query tile, head, batch), streaming K/V tiles up
    to the causal diagonal.  Returns dq [B, Sq, H, D]."""
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_dq", (dq,), q, k, v, do, lse, delta, mask,
            mstrides, causal, dropout_p, seed)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, mask, mstrides,
                            causal, dropout_p: float = 0.0, seed=None):
    """Launch of the dK/dV kernel on ``flash_attention_bwd_operands``:
    one block per (64-key tile, kv head, batch), looping over the
    query-head group and the query tiles that see its keys.  Returns
    (dk, dv) [B, Sk, KVH, D], written once, without atomics."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd_dkv", (dk, dv), q, k, v, do, lse, delta,
            mask, mstrides, causal, dropout_p, seed)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _dbias_kernel() -> ctypes.CDLL:
    lib = _build.load(_DBIAS_SOURCE)
    fn = lib.flash_attention_dbias
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_dbias_error_string.argtypes = [ctypes.c_int]
        lib.flash_dbias_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd_dbias(q, k, v, do, lse, delta, bias, causal,
                              dropout_p: float = 0.0, seed=None):
    """Launch of the bias-gradient kernel on the operands of
    ``flash_attention_bwd_operands`` and the trained bias ``[B|1, H|1,
    Sq, Sk]``: one block per (64-key tile, 64-row query tile, bias batch
    x bias head), summing the broadcast dims in registers.  Returns
    dbias ``[MB, MH, Sq, Sk]`` f32, written once, without atomics."""
    b4 = _bias4(q, bias).contiguous()
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    mb, mh = b4.shape[:2]
    enforce(b4.device == q.device, "the bias must live on q's device")
    dbias = torch.empty_like(b4)
    lib = _dbias_kernel()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_dbias(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), b4.data_ptr(),
            dbias.data_ptr(), b, h, hk, sq, sk, d, mb, mh, int(causal),
            1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
            *_seed_args(seed, dropout_p, q.device),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention_dbias launch failed: "
                           + lib.flash_dbias_error_string(err).decode())
    flash_attention_bwd_dbias.launches += 1
    return dbias


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dbias.launches = 0


def _grads(q, k, v, out, lse, do, causal, mask, dropout_p, seed, *,
           dq=True, dkv=True, bias=None):
    """The gradients the caller asks for, as (dq, dk, dv, dbias), None
    for those it does not: on CUDA tensors only the kernels of those
    launch (dQ; dK/dV; the bias gradient when ``bias`` is given), on CPU
    tensors the plain versions run."""
    if q.device.type == "cpu":
        g = flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal, mask=mask,
            dropout_p=dropout_p, seed=seed) if dq or dkv else (None,) * 3
        db = None if bias is None else flash_attention_dbias_reference(
            q, k, v, out, lse, do, bias, causal=causal,
            dropout_p=dropout_p, seed=seed)
        return (g[0] if dq else None, g[1] if dkv else None,
                g[2] if dkv else None, db)
    ops = flash_attention_bwd_operands(q, k, v, out, lse, do, causal, mask)
    gq = flash_attention_bwd_dq(*ops, causal, dropout_p, seed) if dq \
        else None
    gk, gv = flash_attention_bwd_dkv(*ops, causal, dropout_p, seed) \
        if dkv else (None, None)
    db = None
    if bias is not None:
        db = flash_attention_bwd_dbias(*ops[:6], bias, causal, dropout_p,
                                       seed)
        db = db.reshape(bias.shape).to(bias.dtype)
    return gq, gk, gv, db


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = False,
                        mask=None, dropout_p: float = 0.0, seed=None):
    """FlashAttention backward on ``[B, S, H, D]`` from the forward's
    output and lse (and its dropout seed): returns (dq [B, Sq, H, D],
    dk, dv [B, Sk, KVH, D]).

    On CUDA tensors this launches the dQ and the dK/dV kernels of
    ``csrc/flash_attention_bwd.cu`` (one dtype of float32/bfloat16/
    float16, D of 64 or 128; other shapes raise NotImplementedError).
    On CPU tensors it runs the plain version."""
    return _grads(q, k, v, out, lse, do, causal, mask, dropout_p, seed)[:3]


def flash_attention_dbias(q, k, v, out, lse, do, bias, *,
                          causal: bool = False, dropout_p: float = 0.0,
                          seed=None):
    """The gradient of the trained bias ``[B|1, H|1, Sq, Sk]`` from the
    forward's output, lse and dropout seed, in the bias's shape and
    dtype: on CUDA tensors the kernel of ``csrc/flash_attention_dbias.cu``
    (D of 64 or 128), on CPU tensors its plain version."""
    return _grads(q, k, v, out, lse, do, causal, bias, dropout_p, seed,
                  dq=False, dkv=False, bias=bias)[3]


def _flash_fwd_kept(q, k, v, causal, mask, dropout_p, seed):
    """``flash_attention_fwd``'s (out, lse), kept and replayed by a
    recompute policy that keeps ``flash_out`` / ``flash_lse``."""
    return kept(("flash_out", "flash_lse"), lambda: flash_attention_fwd(
        q, k, v, causal=causal, mask=mask, dropout_p=dropout_p, seed=seed))


class _FlashAttention(torch.autograd.Function):
    """Flash forward with its backward kernels attached: saves (q, k, v,
    out, lse) and the dropout seed, and differentiates q, k and v, each
    backward kernel launching only for the inputs that need it.  The
    mask is an input, not a trained parameter, as in the reference's
    ``_attach_grad_masked``."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, dropout_p, seed):
        out, lse = _flash_fwd_kept(q, k, v, causal, mask, dropout_p, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, mask, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        nq, nk, nv = ctx.needs_input_grad[:3]
        dq, dk, dv, _ = _grads(q, k, v, out, lse, do, *ctx.cfg, dq=nq,
                               dkv=nk or nv)
        return dq, dk if nk else None, dv if nv else None, None, None, \
            None, None


class _FlashAttentionBias(torch.autograd.Function):
    """Flash forward with a TRAINED additive bias: returns dq, dk, dv and
    the bias gradient (the counterpart of ``_attach_grad_bias``), each
    kernel launching only for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, dropout_p, seed):
        out, lse = _flash_fwd_kept(q, k, v, causal, bias.detach(),
                                   dropout_p, seed)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.cfg = (causal, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bias = ctx.saved_tensors
        causal, dropout_p, seed = ctx.cfg
        nq, nk, nv, nb = ctx.needs_input_grad[:4]
        dq, dk, dv, db = _grads(q, k, v, out, lse, do, causal, bias,
                                dropout_p, seed, dq=nq, dkv=nk or nv,
                                bias=bias if nb else None)
        return dq, dk if nk else None, dv if nv else None, db, None, None, \
            None


def flash_attention_raw(q, k, v, causal: bool = False, mask=None,
                        dropout_p: float = 0.0, seed=None, mask_grad=None):
    """``[B, S, H, D]`` entry with the reference's rules
    (``flash_attention_raw`` / ``_ext`` and the trained-bias branch of
    ``F.scaled_dot_product_attention``):

    - ``mask`` is additive ``[B|1, H|1, Sq|1, Sk]`` or boolean (True =
      attend); a boolean mask is a constant even with ``mask_grad``;
    - ``mask_grad`` (default: ``mask.requires_grad``) marks a TRAINED
      bias: it gets its gradient through ``_FlashAttentionBias`` whether
      or not q, k and v need one.  A trained bias that broadcasts over
      Sq runs the plain version under autograd on CPU tensors and raises
      NotImplementedError on CUDA tensors (the reference falls back to
      its jnp path there);
    - ``dropout_p`` > 0 drops attention probabilities in the kernels,
      with the keep mask of the int64 scalar ``seed`` tensor.

    Otherwise the output of ``flash_attention_fwd``, differentiable in
    q, k and v through ``_FlashAttention`` when grad mode is on and one
    of them requires grad."""
    if mask is not None and mask.dtype == torch.bool:
        mask = torch.zeros(mask.shape, dtype=torch.float32,
                           device=mask.device).masked_fill_(~mask, _NEG_INF)
        mask_grad = False
    if mask_grad is None:
        mask_grad = mask is not None and mask.requires_grad
    m4 = _check(q, k, v, causal, mask, dropout_p)
    if dropout_p:
        enforce(seed is not None, "attention dropout needs a seed tensor")
    else:
        seed = None
    grad = torch.is_grad_enabled()
    if mask_grad and grad:
        if m4.shape[2] == q.shape[1]:
            return _FlashAttentionBias.apply(q, k, v, mask, causal,
                                             dropout_p, seed)
        if q.device.type != "cpu":
            raise NotImplementedError(
                "the gradient of a trained attention bias that broadcasts "
                f"over the query rows is not ported to the card "
                f"({_REMAINING})")
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, mask=mask, dropout_p=dropout_p,
            seed=seed)[0]
    if m4 is not None:
        m4 = m4.detach()
    if grad and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, m4, causal, dropout_p, seed)
    return _flash_fwd_kept(q, k, v, causal, m4, dropout_p, seed)[0]
