"""Grouped (per-expert) matmul, the MoE expert compute (counterpart of
``paddle_tpu/ops/pallas/grouped_matmul.py``).

Tokens are sorted by expert into a buffer padded so that every ``tm``-row
tile belongs to one expert (``make_dropless_plan`` /
``make_dropless_plan_rows``, integer-equal to the reference's); a
``tile_expert`` map then names the weight each tile multiplies.  Three
hand-written CUDA kernels (``csrc/grouped_matmul.cu``) do the work:

1. ``gmm_raw``: ``out[i] = lhs[i] @ w[e(i)]``, or ``@ w[e(i)]^T`` with
   ``transpose_w`` (the reference's ``_gmm_call``);
2. ``gmm_glu_raw``: ``silu(lhs @ wg[e]) * (lhs @ wu[e])`` in one pass,
   with ``save_pre`` also the two products (``_gmm_glu_call``);
3. ``gmm_dw_raw``: ``dw[e] = sum over e's rows of lhs^T @ dout``, zero
   for an expert with no rows (``_gmm_dw_call``).

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs the plain version beside it (``*_reference``: each tile
gathers its expert's weight and contracts in f32).  Each keeps a
``.launches`` count of its kernel launches.  Given the plan's
``counts``, the kernels treat a row past its expert's count as padding:
they read it as zero, and a tile with no routed row is written as zeros
without reading any weight.  The plan builds those rows as zeros, so
the kernels and the plain versions agree on every buffer the plan makes.

``grouped_matmul`` and ``glu_grouped`` are the autograd Functions (the
reference's ``custom_vjp`` rules restated: the backward's dX is the
transposed gmm, its dW the dW kernel); ``dropless_moe_ffn`` is the
dropless SwiGLU expert FFN over them.
"""
from __future__ import annotations

import ctypes

import torch

from ..common.errors import enforce
from . import _build

__all__ = ["make_dropless_plan", "make_dropless_plan_rows", "gmm_raw",
           "gmm_glu_raw", "gmm_dw_raw", "gmm_reference",
           "gmm_glu_reference", "gmm_dw_reference", "grouped_matmul",
           "glu_grouped", "dropless_moe_ffn"]

_SOURCE = "grouped_matmul"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# row tile granules of the kernels: bf16 blocks own 128 rows, f32 blocks 32
_TM_MULTIPLE = {torch.bfloat16: 128, torch.float32: 32}


# ---------------------------------------------------------------------------
# dropless layout: sorted by expert, tile-aligned
# ---------------------------------------------------------------------------

def make_dropless_plan_rows(row_expert, num_experts: int, tm: int):
    """The tile-aligned sorted layout of pre-routed rows: ``row_expert``
    [M] holds each row's expert, any id >= ``num_experts`` marking an
    invalid row, which gets the out-of-range ``dest`` ``m_pad``.  Returns
    ``(order, dest, valid_sorted, tile_expert, counts, m_pad)``:

    - ``order`` [M] int64, row ids sorted by expert (stable);
    - ``dest`` [M] int64, the padded-buffer row of sorted row i (each
      expert starts at a multiple of ``tm``);
    - ``valid_sorted`` [M] bool;
    - ``tile_expert`` [m_pad // tm] int32, the expert of each row tile;
    - ``counts`` [E] int32, rows routed to each expert;
    - ``m_pad`` (int) ``ceil(M / tm) * tm + E * tm``, fixed by the shapes.

    Everything stays on ``row_expert``'s device; nothing syncs the host.
    """
    e = num_experts
    m = row_expert.shape[0]
    dev = row_expert.device
    key = row_expert.long().clamp(0, e)                  # e == invalid
    order = torch.argsort(key, stable=True)
    sorted_e = key[order]
    valid_sorted = sorted_e < e
    counts = torch.zeros(e + 1, dtype=torch.long, device=dev).scatter_add_(
        0, key, torch.ones_like(key))[:e]
    padded = (counts + tm - 1) // tm * tm
    pad_start = torch.cumsum(padded, 0) - padded
    start = torch.cumsum(counts, 0) - counts
    safe_e = sorted_e.clamp(0, e - 1)
    rank = torch.arange(m, device=dev) - start[safe_e]
    m_pad = -(-m // tm) * tm + e * tm
    dest = torch.where(valid_sorted, pad_start[safe_e] + rank,
                       torch.full_like(rank, m_pad))
    tile_start = torch.arange(m_pad // tm, device=dev) * tm
    tile_expert = (torch.searchsorted(pad_start, tile_start, right=True)
                   - 1).clamp(0, e - 1)
    return (order, dest, valid_sorted, tile_expert.to(torch.int32),
            counts.to(torch.int32), m_pad)


def make_dropless_plan(expert_idx, num_experts: int, tm: int):
    """From router top-k ``expert_idx`` [T, k]: ``(order, dest,
    tile_expert, counts, m_pad)`` over the T*k slots (slot t*k + j is
    token t's j-th choice); see :func:`make_dropless_plan_rows`."""
    order, dest, _, tile_expert, counts, m_pad = make_dropless_plan_rows(
        expert_idx.reshape(-1), num_experts, tm)
    return order, dest, tile_expert, counts, m_pad


def _auto_tm(e: int, n_rows: int) -> int:
    """The reference's row-tile rule: 512 rows for up to 16 experts,
    else 256, halved (not below 128) while the per-expert padding bound
    ``e * tm`` exceeds the routed rows."""
    tm = 512 if e <= 16 else 256
    while tm > 128 and e * tm > n_rows:
        tm //= 2
    return max(tm, 128)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _tiles(x, n_tiles):
    """[M, C] -> [n_tiles, M // n_tiles, C] in f32."""
    return x.float().reshape(n_tiles, -1, x.shape[-1])


def _tile_products(lhs, w, tile_expert, transpose_w):
    """f32 [M, N]: each row tile against its expert's weight."""
    wt = w[tile_expert.long()].float()                   # [nt, K, N]|[nt, N, K]
    if transpose_w:
        wt = wt.transpose(1, 2)
    y = torch.bmm(_tiles(lhs, tile_expert.shape[0]), wt)
    return y.reshape(lhs.shape[0], -1)


def gmm_reference(lhs, w, tile_expert, *, transpose_w=False):
    """Plain version of #11: row tile i of ``lhs`` [M, K] against
    ``w[tile_expert[i]]`` ([E, K, N], or [E, N, K] contracted on its last
    axis with ``transpose_w``), in f32, rounded to lhs's dtype."""
    return _tile_products(lhs, w, tile_expert, transpose_w).to(lhs.dtype)


def gmm_glu_reference(lhs, wg, wu, tile_expert, *, save_pre=False):
    """Plain version of #12: ``(hs,)`` or ``(hs, hg, hu)`` with
    ``hg = lhs @ wg[e]``, ``hu = lhs @ wu[e]`` in f32 and
    ``hs = silu(hg) * hu`` in f32, each rounded to lhs's dtype."""
    g = _tile_products(lhs, wg, tile_expert, False)
    u = _tile_products(lhs, wu, tile_expert, False)
    hs = (torch.nn.functional.silu(g) * u).to(lhs.dtype)
    if not save_pre:
        return (hs,)
    return hs, g.to(lhs.dtype), u.to(lhs.dtype)


def gmm_dw_reference(lhs, dout, tile_expert, counts, num_experts):
    """Plain version of #13: ``dw[e] = sum over the tiles of e of
    lhs_tile^T @ dout_tile`` in f32, zero where ``counts[e] == 0``,
    rounded to lhs's dtype.  lhs [M, K], dout [M, N] -> [E, K, N]."""
    nt = tile_expert.shape[0]
    per_tile = torch.bmm(_tiles(lhs, nt).transpose(1, 2), _tiles(dout, nt))
    dw = torch.zeros((num_experts,) + per_tile.shape[1:],
                     dtype=torch.float32, device=lhs.device)
    dw.index_add_(0, tile_expert.long(), per_tile)
    dw = torch.where((counts > 0)[:, None, None], dw, torch.zeros_like(dw))
    return dw.to(lhs.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _kernel() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if lib.gmm.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.gmm.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.gmm_glu.argtypes = [p] * 8 + [i] * 7 + [p]
        lib.gmm_dw.argtypes = [p] * 4 + [i] * 6 + [p]
        for fn in (lib.gmm, lib.gmm_glu, lib.gmm_dw):
            fn.restype = ctypes.c_int
        lib.grouped_matmul_error_string.argtypes = [i]
        lib.grouped_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check(err, lib, what):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.grouped_matmul_error_string(err).decode())


def _tm_of(m, tile_expert):
    nt = tile_expert.shape[0]
    enforce(nt > 0 and m % nt == 0,
            f"{m} rows do not split into {nt} row tiles")
    return m // nt


def _cuda_operands(what, lhs, weights, tile_expert, counts):
    """Checks shared by the three launches; returns (tm, te, counts) as
    contiguous int32 device tensors (counts may be None)."""
    if lhs.dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"the {what} kernel takes float32 and bfloat16 rows, not "
            f"{lhs.dtype}")
    for w in weights:
        if w.dtype not in _DTYPE_CODE or (lhs.dtype == torch.bfloat16
                                          and w.dtype != torch.bfloat16):
            raise NotImplementedError(
                f"the {what} kernel takes {lhs.dtype} rows against "
                f"{'bfloat16' if lhs.dtype == torch.bfloat16 else 'float32 or bfloat16'}"
                f" weights, not {w.dtype}")
    tm = _tm_of(lhs.shape[0], tile_expert)
    gran = _TM_MULTIPLE[lhs.dtype]
    if tm % gran:
        raise NotImplementedError(
            f"the {what} kernel takes {lhs.dtype} row tiles of a multiple "
            f"of {gran} rows, not {tm}")
    ops = [lhs, *weights, tile_expert] + ([] if counts is None else [counts])
    enforce(lhs.device.type == "cuda" and all(t.device == lhs.device
                                              for t in ops),
            f"{what} arguments must share one CUDA device")
    te = tile_expert.to(torch.int32).contiguous()
    cnt = None if counts is None else counts.to(torch.int32).contiguous()
    return tm, te, cnt


def _aligned(*ts):
    enforce(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts),
            "the grouped matmul kernels need contiguous, 16-byte aligned "
            "operands")


def _launch_gmm(lhs, w, tile_expert, transpose_w, counts):
    tm, te, cnt = _cuda_operands("gmm", lhs, [w], tile_expert, counts)
    m, k = lhs.shape
    e = w.shape[0]
    n = w.shape[1] if transpose_w else w.shape[2]
    enforce(w.dim() == 3 and (w.shape[2] if transpose_w else w.shape[1])
            == k, f"gmm: w {tuple(w.shape)} does not contract lhs "
                  f"{tuple(lhs.shape)} (transpose_w={transpose_w})")
    if k % 8 or n % 8:
        raise NotImplementedError(
            f"the gmm kernel takes K and N in multiples of 8, not {k}, {n}")
    lhs, w = lhs.contiguous(), w.contiguous()
    _aligned(lhs, w)
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(lhs.device):
        err = lib.gmm(lhs.data_ptr(), w.data_ptr(), te.data_ptr(),
                      None if cnt is None else cnt.data_ptr(),
                      out.data_ptr(), m, k, n, e, tm, int(transpose_w),
                      _DTYPE_CODE[lhs.dtype], _DTYPE_CODE[w.dtype],
                      torch.cuda.current_stream(lhs.device).cuda_stream)
    _check(err, lib, "gmm")
    gmm_raw.launches += 1
    return out


def _launch_glu(lhs, wg, wu, tile_expert, save_pre, counts):
    tm, te, cnt = _cuda_operands("gmm_glu", lhs, [wg, wu], tile_expert,
                                 counts)
    m, k = lhs.shape
    e, _, n = wg.shape
    enforce(wg.shape == wu.shape and wg.shape[1] == k
            and wg.dtype == wu.dtype,
            f"gmm_glu: wg {tuple(wg.shape)} and wu {tuple(wu.shape)} must "
            f"be one [E, {k}, N] shape and dtype")
    if k % 8 or n % 8:
        raise NotImplementedError(
            f"the gmm_glu kernel takes K and N in multiples of 8, not "
            f"{k}, {n}")
    lhs, wg, wu = lhs.contiguous(), wg.contiguous(), wu.contiguous()
    _aligned(lhs, wg, wu)
    outs = [torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
            for _ in range(3 if save_pre else 1)]
    if m == 0:
        return tuple(outs)
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    lib = _kernel()
    with torch.cuda.device(lhs.device):
        err = lib.gmm_glu(lhs.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                          te.data_ptr(),
                          None if cnt is None else cnt.data_ptr(), *ptrs,
                          m, k, n, e, tm, _DTYPE_CODE[lhs.dtype],
                          _DTYPE_CODE[wg.dtype],
                          torch.cuda.current_stream(lhs.device).cuda_stream)
    _check(err, lib, "gmm_glu")
    gmm_glu_raw.launches += 1
    return tuple(outs)


def _launch_dw(lhs, dout, tile_expert, counts, num_experts):
    tm, _, cnt = _cuda_operands("gmm_dw", lhs, [], tile_expert, counts)
    m, k = lhs.shape
    n = dout.shape[1]
    enforce(dout.shape[0] == m and dout.dtype == lhs.dtype
            and counts.shape == (num_experts,),
            f"gmm_dw: dout {tuple(dout.shape)} {dout.dtype} must have "
            f"lhs's {m} rows and dtype {lhs.dtype}, and counts one entry "
            f"an expert")
    if k % 8 or n % 8:
        raise NotImplementedError(
            f"the gmm_dw kernel takes K and N in multiples of 8, not {k}, "
            f"{n}")
    lhs, dout = lhs.contiguous(), dout.contiguous()
    _aligned(lhs, dout)
    dw = torch.empty((num_experts, k, n), dtype=lhs.dtype,
                     device=lhs.device)
    lib = _kernel()
    with torch.cuda.device(lhs.device):
        err = lib.gmm_dw(lhs.data_ptr(), dout.data_ptr(), cnt.data_ptr(),
                         dw.data_ptr(), m, k, n, num_experts, tm,
                         _DTYPE_CODE[lhs.dtype],
                         torch.cuda.current_stream(lhs.device).cuda_stream)
    _check(err, lib, "gmm_dw")
    gmm_dw_raw.launches += 1
    return dw


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def gmm_raw(lhs, w, tile_expert, *, transpose_w=False, counts=None):
    """Grouped matmul #11: ``lhs`` [M, K] row tile i against
    ``w[tile_expert[i]]`` -> [M, N] in lhs's dtype.  ``w`` is [E, K, N],
    or [E, N, K] contracted on its last axis with ``transpose_w``.  With
    the plan's ``counts`` [E] the kernel skips padding rows and dead
    tiles (see the module docstring).

    On CUDA tensors one launch of the kernel of ``csrc/grouped_matmul.cu``
    (bf16 rows and weights on the tensor cores; f32 rows against f32 or
    bf16 weights on the FMA pipe; K and N multiples of 8, row tiles a
    multiple of 128 (bf16) or 32 (f32) rows; other inputs raise); on CPU
    tensors :func:`gmm_reference`."""
    enforce(lhs.dim() == 2 and w.dim() == 3,
            f"gmm takes lhs [M, K] and w [E, ., .], not "
            f"{tuple(lhs.shape)} and {tuple(w.shape)}")
    if lhs.device.type == "cpu":
        return gmm_reference(lhs, w, tile_expert, transpose_w=transpose_w)
    return _launch_gmm(lhs, w, tile_expert, transpose_w, counts)


def gmm_glu_raw(lhs, wg, wu, tile_expert, *, save_pre=False, counts=None):
    """Fused gate/up grouped matmul #12: ``(hs,)``, or with ``save_pre``
    ``(hs, hg, hu)``, each [M, F] in lhs's dtype, for ``wg``/``wu``
    [E, K, F].  Dispatch and ``counts`` as :func:`gmm_raw`; on CPU
    tensors :func:`gmm_glu_reference`."""
    enforce(lhs.dim() == 2 and wg.dim() == 3,
            f"gmm_glu takes lhs [M, K] and wg/wu [E, K, F], not "
            f"{tuple(lhs.shape)} and {tuple(wg.shape)}")
    if lhs.device.type == "cpu":
        return gmm_glu_reference(lhs, wg, wu, tile_expert, save_pre=save_pre)
    return _launch_glu(lhs, wg, wu, tile_expert, save_pre, counts)


def gmm_dw_raw(lhs, dout, tile_expert, counts, num_experts):
    """Per-expert weight gradient #13: ``dw[e] = lhs_e^T @ dout_e`` over
    the rows of expert e, [E, K, N] in lhs's dtype; an expert with no
    rows gets zeros.  lhs [M, K] and dout [M, N] in one dtype.  On CUDA
    tensors one launch of the kernel of ``csrc/grouped_matmul.cu`` (rows
    past an expert's count are not read); on CPU tensors
    :func:`gmm_dw_reference`."""
    enforce(lhs.dim() == 2 and dout.dim() == 2,
            f"gmm_dw takes lhs [M, K] and dout [M, N], not "
            f"{tuple(lhs.shape)} and {tuple(dout.shape)}")
    if lhs.device.type == "cpu":
        return gmm_dw_reference(lhs, dout, tile_expert, counts, num_experts)
    return _launch_dw(lhs, dout, tile_expert, counts, num_experts)


gmm_raw.launches = 0
gmm_glu_raw.launches = 0
gmm_dw_raw.launches = 0


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------

class _GroupedMatmul(torch.autograd.Function):
    """#11 forward; backward the reference's ``_grouped_matmul_bwd``:
    dX by the transposed gmm, dW by the dW kernel."""

    @staticmethod
    def forward(ctx, lhs, w, tile_expert, counts):
        ctx.save_for_backward(lhs, w, tile_expert, counts)
        return gmm_raw(lhs, w, tile_expert, counts=counts)

    @staticmethod
    def backward(ctx, dout):
        lhs, w, tile_expert, counts = ctx.saved_tensors
        dout = dout.contiguous()
        dlhs = dw = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm_raw(dout, w, tile_expert, transpose_w=True,
                           counts=counts).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            dw = gmm_dw_raw(lhs, dout, tile_expert, counts,
                            w.shape[0]).to(w.dtype)
        return dlhs, dw, None, None


class _GluGrouped(torch.autograd.Function):
    """#12 forward (``save_pre`` when a gradient will be taken);
    backward the reference's ``_glu_grouped_bwd``: the SwiGLU
    derivative in f32 from the saved pre-activations, dX by two
    transposed gmms, dW by two dW launches."""

    @staticmethod
    def forward(ctx, lhs, wg, wu, tile_expert, counts, save_pre):
        if not save_pre:
            return gmm_glu_raw(lhs, wg, wu, tile_expert, counts=counts)[0]
        hs, hg, hu = gmm_glu_raw(lhs, wg, wu, tile_expert, save_pre=True,
                                 counts=counts)
        ctx.save_for_backward(lhs, wg, wu, tile_expert, counts, hg, hu)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        lhs, wg, wu, tile_expert, counts, hg, hu = ctx.saved_tensors
        g = hg.float()
        sg = torch.sigmoid(g)
        dhs_f = dhs.float()
        dhg = (dhs_f * hu.float() * (sg * (1 + g * (1 - sg)))).to(lhs.dtype)
        dhu = (dhs_f * (g * sg)).to(lhs.dtype)
        del g, sg, dhs_f
        need = ctx.needs_input_grad
        dlhs = dwg = dwu = None
        if need[0]:
            dlhs = gmm_raw(dhg, wg, tile_expert, transpose_w=True,
                           counts=counts)
            dlhs = (dlhs + gmm_raw(dhu, wu, tile_expert, transpose_w=True,
                                   counts=counts)).to(lhs.dtype)
        e = wg.shape[0]
        if need[1]:
            dwg = gmm_dw_raw(lhs, dhg, tile_expert, counts, e).to(wg.dtype)
        if need[2]:
            dwu = gmm_dw_raw(lhs, dhu, tile_expert, counts, e).to(wu.dtype)
        return dlhs, dwg, dwu, None, None, None


def grouped_matmul(lhs, w, tile_expert, counts):
    """Differentiable #11 (``gmm_raw`` with the plan's counts)."""
    return _GroupedMatmul.apply(lhs, w, tile_expert, counts)


def glu_grouped(lhs, wg, wu, tile_expert, counts):
    """Differentiable #12: ``silu(lhs @ wg[e]) * (lhs @ wu[e])``.  The
    pre-activations are written out only when a gradient will be
    taken."""
    save_pre = torch.is_grad_enabled() and any(
        t.requires_grad for t in (lhs, wg, wu))
    return _GluGrouped.apply(lhs, wg, wu, tile_expert, counts, save_pre)


def dropless_moe_ffn(x, gate_vals, expert_idx, wg, wu, wd, *, tm=None):
    """Dropless MoE FFN: route x [T, H] through per-expert SwiGLU
    experts (wg/wu [E, H, F], wd [E, F, H]) with top-k combine weights
    ``gate_vals`` [T, k] (f32) and choices ``expert_idx`` [T, k]: the
    fused gate/up kernel and the down gmm on the sorted tile-aligned
    layout, then the combine in f32.  ``tm=None`` takes the reference's
    row tile (:func:`_auto_tm`).  Returns [T, H] in x's dtype."""
    t, h = x.shape
    k = expert_idx.shape[1]
    e = wg.shape[0]
    if tm is None:
        tm = _auto_tm(e, t * k)
    order, dest, tile_expert, counts, m_pad = make_dropless_plan(
        expert_idx, e, tm)
    xs = x.new_zeros((m_pad, h)).index_copy(0, dest, x[order // k])
    hs = glu_grouped(xs, wg, wu, tile_expert, counts)
    ys = grouped_matmul(hs, wd, tile_expert, counts)
    y = ys.new_zeros((t * k, h)).index_copy(0, order, ys[dest])
    out = torch.einsum("tk,tkh->th", gate_vals.float(),
                       y.view(t, k, h).float())
    return out.to(x.dtype)
