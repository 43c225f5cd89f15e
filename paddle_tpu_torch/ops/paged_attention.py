"""Ragged paged attention for the serving engine's unified step.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py`` (the
ragged mixed mode and ``paged_write_rows``).  The KV cache lives in
fixed-size pages ``[KVH, n_pages, P, D]`` per layer; a page table per
sequence maps its logical pages to physical ones, so sequences of any
length share one pool.

One call serves a whole mixed prefill + decode batch.  The flat token
batch carries per-descriptor scalars ``(q_start, q_len, kv_len)``: a
decode slot contributes one row (``q_len == 1``), a prefill chunk up to
``P`` rows, all landing inside one page (callers chunk prompts at page
boundaries, so ``kv_len % P + q_len <= P``).  ``q_len == 0`` marks an
unused descriptor.

``ragged_paged_append_attend`` is the kernel wrapper: on a CUDA tensor
it launches the hand-written kernel of ``csrc/ragged_paged_attention.cu``
(or raises); on a CPU tensor it runs the plain version beside it,
``ragged_paged_append_attend_reference``, which takes the same
arguments.  Both update the pools in place.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..common.errors import enforce
from . import _build

__all__ = ["paged_write_rows", "ragged_paged_append_attend",
           "ragged_paged_append_attend_reference"]

_NEG_INF = -1e30
_SOURCE = "ragged_paged_attention"
# kernel element types (the C interface's dtype codes)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def paged_write_rows(k_pages, v_pages, k_new, v_new, positions,
                     row_tables):
    """Per-row pool append, in place: flat row i lands at logical
    position ``positions[i]`` of its own sequence (page
    ``row_tables[i, pos // P]``, slot ``pos % P``).  Rows that hit the
    same slot (padding rows all point at pad page 0, position 0) keep the
    last row's values, as the reference's chained updates do.

    k_pages/v_pages [KVH, n_pages, P, D]; k_new/v_new [T, KVH, D];
    positions [T]; row_tables [T, maxp].  Returns (k_pages, v_pages)."""
    P = k_pages.shape[2]
    t = k_new.shape[0]
    if t == 0:
        return k_pages, v_pages
    dev = k_pages.device
    pos = positions.to(device=dev, dtype=torch.long)
    tables = row_tables.to(device=dev, dtype=torch.long)
    rows = torch.arange(t, device=dev)
    pages = tables[rows, pos // P]
    slots = pos % P
    _, inverse = torch.unique(pages * P + slots, return_inverse=True)
    last = torch.full((int(inverse.max()) + 1,), -1, dtype=torch.long,
                      device=dev).scatter_reduce(0, inverse, rows, "amax")
    k_pages[:, pages[last], slots[last]] = \
        k_new[last].transpose(0, 1).to(k_pages.dtype)
    v_pages[:, pages[last], slots[last]] = \
        v_new[last].transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def _rows_of_descriptors(q_start, q_len, kv_len):
    """(descriptor, offset, flat row, position) of every live row."""
    dev = q_start.device
    ql = q_len.to(torch.long)
    desc = torch.repeat_interleave(
        torch.arange(ql.shape[0], device=dev), ql)
    first = torch.cumsum(ql, 0) - ql
    off = torch.arange(desc.shape[0], device=dev) - first[desc]
    rows = q_start.to(torch.long)[desc] + off
    pos = kv_len.to(torch.long)[desc] + off
    return desc, off, rows, pos


def ragged_paged_append_attend_reference(q, k_pages, v_pages, k_new,
                                         v_new, q_start, q_len, kv_len,
                                         page_tables):
    """Plain PyTorch version of the ragged kernel, same arguments and
    result: append every live row's K/V at its position, then attend
    each row over its sequence's pages under ``kv_pos <= kv_len + row``,
    in f32.  Pools are updated in place.  Returns out [S, P, H, D] in
    q's dtype, zero wherever a descriptor row has no query."""
    t, h, d = q.shape
    kvh, _, P, _ = k_pages.shape
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros((q_start.shape[0], P, h, d), dtype=q.dtype,
                      device=q.device)
    desc, off, rows, pos = _rows_of_descriptors(q_start, q_len, kv_len)
    n = desc.shape[0]
    if n == 0:
        return out
    tables = page_tables.to(torch.long)[desc]              # [R, maxp]
    paged_write_rows(k_pages, v_pages, k_new[rows], v_new[rows], pos,
                     tables)
    npg = int(pos.max()) // P + 1                          # pages in view
    kg = k_pages[:, tables[:, :npg]].reshape(kvh, n, npg * P, d).float()
    vg = v_pages[:, tables[:, :npg]].reshape(kvh, n, npg * P, d).float()
    qg = q[rows].reshape(n, kvh, g, d).float() * scale
    s = torch.einsum("rkgd,krsd->rkgs", qg, kg)
    kpos = torch.arange(npg * P, device=q.device)
    visible = kpos[None, :] <= pos[:, None]                 # [R, S]
    s = s.masked_fill(~visible[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("rkgs,krsd->rkgd", p, vg).reshape(n, h, d)
    out[desc, off] = o.to(q.dtype)
    return out


def _kernel() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.ragged_paged_append_attend
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ragged_error_string.argtypes = [ctypes.c_int]
        lib.ragged_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pages, v_pages, k_new, v_new, q_start, q_len, kv_len,
           page_tables):
    t, h, d = q.shape
    kvh, _, _, dk = k_pages.shape
    s_max = q_start.shape[0]
    enforce(dk == d and v_pages.shape == k_pages.shape,
            f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not "
            f"match q {tuple(q.shape)}")
    enforce(h % kvh == 0, f"{h} query heads over {kvh} kv heads")
    enforce(tuple(k_new.shape) == (t, kvh, d)
            and tuple(v_new.shape) == (t, kvh, d),
            f"k_new/v_new must be [{t}, {kvh}, {d}]")
    enforce(q_len.shape == (s_max,) and kv_len.shape == (s_max,)
            and page_tables.dim() == 2 and page_tables.shape[0] == s_max,
            "descriptors must be [S] with page_tables [S, maxp]")
    devs = {x.device for x in (q, k_pages, v_pages, k_new, v_new, q_start,
                               q_len, kv_len, page_tables)}
    enforce(len(devs) == 1, f"arguments on several devices: {devs}")


def ragged_paged_append_attend(q, k_pages, v_pages, k_new, v_new,
                               q_start, q_len, kv_len, page_tables):
    """Ragged mixed prefill + decode step: append every descriptor's new
    K/V rows into its page, then attend each of its query rows over the
    sequence's pages.

    q:            [T, H, D] flat query rows (decode slots and prefill
                  chunks back to back).
    k_new/v_new:  [T, KVH, D] rows to append, same flat layout.
    k_pages/v_pages: [KVH, n_pages, P, D] one layer's pools.  **Updated
                  in place**: the new rows are written into them.
    q_start/q_len/kv_len: [S] int32 descriptors; descriptor s covers flat
                  rows [q_start, q_start + q_len) at positions kv_len ..
                  kv_len + q_len - 1, all inside page kv_len // P.
    page_tables:  [S, maxp] int32 per-descriptor page tables.

    Returns out [S, P, H, D] in q's dtype: descriptor s's row j is
    ``out[s, j]``; rows j >= q_len, and all rows of a ``q_len == 0``
    descriptor, are zero.

    On CUDA tensors this launches the kernel of
    ``csrc/ragged_paged_attention.cu`` (q, pools and new rows in one
    dtype of float32/bfloat16/float16, D of 64 or 128) and raises on
    anything it does not take; on CPU tensors it runs the plain
    version."""
    _check(q, k_pages, v_pages, k_new, v_new, q_start, q_len, kv_len,
           page_tables)
    t, h, d = q.shape
    kvh, n_pages, P, _ = k_pages.shape
    if q.device.type == "cpu":
        return ragged_paged_append_attend_reference(
            q, k_pages, v_pages, k_new, v_new, q_start, q_len, kv_len,
            page_tables)
    enforce(q.device.type == "cuda", f"unsupported device {q.device}")
    enforce(q.dtype in _DTYPE_CODE and all(
        x.dtype == q.dtype for x in (k_pages, v_pages, k_new, v_new)),
        f"the ragged kernel takes q, pools and new rows in one dtype of "
        f"{list(_DTYPE_CODE)}; got {q.dtype}, {k_pages.dtype}, "
        f"{k_new.dtype}")
    if d not in (64, 128):
        raise NotImplementedError(
            f"ragged kernel head_dim {d} (built for 64 and 128)")
    enforce(all(x.dtype == torch.int32 for x in (q_start, q_len, kv_len,
                                                  page_tables)),
            "descriptors and page tables must be int32")
    for x in (q, k_pages, v_pages, k_new, v_new, q_start, q_len, kv_len,
              page_tables):
        enforce(x.is_contiguous(), "the ragged kernel takes contiguous "
                                   "tensors")
    enforce(all(x.data_ptr() % 16 == 0
                for x in (k_pages, v_pages, k_new, v_new)),
            "pools and new rows must be 16-byte aligned")
    s_max, maxp = page_tables.shape
    out = torch.empty((s_max, P, h, d), dtype=q.dtype, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.ragged_paged_append_attend(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), q_start.data_ptr(),
            q_len.data_ptr(), kv_len.data_ptr(), page_tables.data_ptr(),
            out.data_ptr(), s_max, h, kvh, n_pages, P, d, maxp,
            1.0 / math.sqrt(d),
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("ragged paged attention launch failed: "
                           + lib.ragged_error_string(err).decode())
    ragged_paged_append_attend.launches += 1
    return out


ragged_paged_append_attend.launches = 0
