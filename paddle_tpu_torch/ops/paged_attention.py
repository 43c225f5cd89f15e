"""Paged attention for the serving engine: the ragged unified step
(kernel #1), the split path's fused decode append + attend (#7) and
read-only decode attention (#6).

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``.  The KV
cache lives in
fixed-size pages ``[KVH, n_pages, P, D]`` per layer; a page table per
sequence maps its logical pages to physical ones, so sequences of any
length share one pool.

One call serves a whole mixed prefill + decode batch.  The flat token
batch carries per-descriptor scalars ``(q_start, q_len, kv_len)``: a
decode slot contributes one row (``q_len == 1``), a prefill chunk up to
``P`` rows, all landing inside one page (callers chunk prompts at page
boundaries, so ``kv_len % P + q_len <= P``).  ``q_len == 0`` marks an
unused descriptor.

The split path decodes one token a sequence: ``paged_decode_append_
attend`` appends each row's K/V at its length and attends over the
sequence, ``paged_attention`` attends without appending
(``PagedKVCache.attend``).

Int8 pools: with ``k_scales``/``v_scales`` [KVH, n_pages, P] f32 the
pools hold int8 codes and one absmax scale per token row
(``quantization/ops.py``); new rows arrive in the model's dtype and are
quantized on the way in, pages are dequantized as they are read.

Each wrapper (``ragged_paged_append_attend``, ``paged_decode_append_
attend``, ``paged_attention``) launches its hand-written kernel on CUDA
tensors (``csrc/ragged_paged_attention.cu``, ``csrc/paged_decode_
attention.cu``) or raises, counting launches in ``.launches``; on CPU
tensors it runs the plain version beside it (``*_reference``, the same
arguments).  Pools are updated in place.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..common.errors import enforce
from ..quantization.ops import quantize_rows
from . import _build

__all__ = ["paged_write", "paged_write_quant", "paged_write_rows",
           "paged_write_rows_quant", "paged_attention",
           "paged_attention_reference", "paged_decode_append_attend",
           "paged_decode_append_attend_reference",
           "ragged_paged_append_attend",
           "ragged_paged_append_attend_reference"]

_NEG_INF = -1e30
_SOURCE = "ragged_paged_attention"
# kernel element types (the C interface's dtype codes)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _last_writers(pages, slots, P):
    """Indices of the rows whose write lands last in each distinct
    (page, slot): rows that hit the same slot (padding rows all point at
    pad page 0) keep the last row's values, as the reference's chained
    updates do."""
    rows = torch.arange(pages.shape[0], device=pages.device)
    _, inverse = torch.unique(pages * P + slots, return_inverse=True)
    return torch.full((int(inverse.max()) + 1,), -1, dtype=torch.long,
                      device=pages.device).scatter_reduce(
                          0, inverse, rows, "amax")


def _row_targets(P, positions, row_tables, dev):
    """(page, slot) of every row's logical position."""
    pos = positions.to(device=dev, dtype=torch.long)
    tables = row_tables.to(device=dev, dtype=torch.long)
    rows = torch.arange(pos.shape[0], device=dev)
    return tables[rows, pos // P], pos % P


def paged_write_rows(k_pages, v_pages, k_new, v_new, positions,
                     row_tables):
    """Per-row pool append, in place: flat row i lands at logical
    position ``positions[i]`` of its own sequence (page
    ``row_tables[i, pos // P]``, slot ``pos % P``); rows that hit the
    same slot keep the last row's values.

    k_pages/v_pages [KVH, n_pages, P, D]; k_new/v_new [T, KVH, D];
    positions [T]; row_tables [T, maxp].  Returns (k_pages, v_pages)."""
    if k_new.shape[0] == 0:
        return k_pages, v_pages
    pages, slots = _row_targets(k_pages.shape[2], positions, row_tables,
                                k_pages.device)
    last = _last_writers(pages, slots, k_pages.shape[2])
    k_pages[:, pages[last], slots[last]] = \
        k_new[last].transpose(0, 1).to(k_pages.dtype)
    v_pages[:, pages[last], slots[last]] = \
        v_new[last].transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def paged_write_rows_quant(k_pages, v_pages, k_scales, v_scales, k_new,
                           v_new, positions, row_tables):
    """Int8 :func:`paged_write_rows`: each new row is quantized per token
    (absmax over D, ``quantization.ops.quantize_rows``) on the way in,
    its codes written into the int8 pools and its scale into the scale
    pools [KVH, n_pages, P] f32, in place.  Returns the four pools."""
    if k_new.shape[0] == 0:
        return k_pages, v_pages, k_scales, v_scales
    pages, slots = _row_targets(k_pages.shape[2], positions, row_tables,
                                k_pages.device)
    last = _last_writers(pages, slots, k_pages.shape[2])
    for pool, spool, x in ((k_pages, k_scales, k_new),
                           (v_pages, v_scales, v_new)):
        codes, scale = quantize_rows(x[last])       # [R, KVH, D], [R, KVH]
        pool[:, pages[last], slots[last]] = codes.transpose(0, 1)
        spool[:, pages[last], slots[last]] = scale.transpose(0, 1)
    return k_pages, v_pages, k_scales, v_scales


def paged_write(k_pages, v_pages, k_new, v_new, page_table, seq_lens):
    """Append one token per sequence, in place: row b of k_new/v_new
    [B, KVH, D] lands at position ``seq_lens[b]`` (page
    ``page_table[b, pos // P]``).  The caller bumps seq_lens."""
    return paged_write_rows(k_pages, v_pages, k_new, v_new, seq_lens,
                            page_table)


def paged_write_quant(k_pages, v_pages, k_scales, v_scales, k_new, v_new,
                      page_table, seq_lens):
    """Int8 :func:`paged_write`: quantize each new row per token on the
    way in, pools and scale pools updated in place."""
    return paged_write_rows_quant(k_pages, v_pages, k_scales, v_scales,
                                  k_new, v_new, seq_lens, page_table)


def _gather_pages(pages, scales, tables):
    """The pages of each row's table as [R, KVH, maxp * P, D] in f32,
    dequantized with the per-token scales when ``scales`` is given."""
    kvh, _, P, d = pages.shape
    r, maxp = tables.shape
    g = pages[:, tables].float()                  # [KVH, R, maxp, P, D]
    if scales is not None:
        g = g * scales[:, tables][..., None]
    return g.reshape(kvh, r, maxp * P, d).transpose(0, 1)


def _attend_rows(q, kg, vg, visible):
    """q [R, H, D] against gathered kg/vg [R, KVH, S, D] f32 under
    ``visible`` [R, S]: softmax attention in f32, masked keys at -1e30,
    as the reference.  Returns [R, H, D] f32."""
    r, h, d = q.shape
    kvh = kg.shape[1]
    qg = q.reshape(r, kvh, h // kvh, d).float()
    s = torch.einsum("rkgd,rksd->rkgs", qg, kg) / math.sqrt(d)
    s = s.masked_fill(~visible[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("rkgs,rksd->rkgd", p, vg).reshape(r, h, d)


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens,
                              k_scales=None, v_scales=None):
    """Plain PyTorch version of kernel #6, same arguments and result:
    each row's query attends over its sequence's first ``seq_lens[b]``
    cached tokens (int8 pools dequantized with their per-token scales),
    in f32.  A row with ``seq_lens[b] == 0`` gets zeros, as the kernel
    writes.  Returns [B, H, D] in q's dtype."""
    P = k_pages.shape[2]
    tables = page_table.to(torch.long)
    kg = _gather_pages(k_pages, k_scales, tables)
    vg = _gather_pages(v_pages, v_scales, tables)
    lens = seq_lens.to(device=q.device, dtype=torch.long)
    kpos = torch.arange(tables.shape[1] * P, device=q.device)
    o = _attend_rows(q, kg, vg, kpos[None, :] < lens[:, None])
    return torch.where((lens > 0)[:, None, None], o, 0.0).to(q.dtype)


def paged_decode_append_attend_reference(q, k_pages, v_pages, k_new,
                                         v_new, page_table, seq_lens,
                                         k_scales=None, v_scales=None):
    """Plain PyTorch version of kernel #7, same arguments and result:
    append row b of k_new/v_new at position ``seq_lens[b]`` (quantized
    per token when the pools are int8), then attend over
    ``seq_lens[b] + 1`` tokens.  Pools updated in place; returns
    [B, H, D] in q's dtype."""
    if k_scales is not None:
        paged_write_quant(k_pages, v_pages, k_scales, v_scales, k_new,
                          v_new, page_table, seq_lens)
    else:
        paged_write(k_pages, v_pages, k_new, v_new, page_table, seq_lens)
    return paged_attention_reference(q, k_pages, v_pages, page_table,
                                     seq_lens + 1, k_scales, v_scales)


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
                                         page_tables, k_scales=None,
                                         v_scales=None):
    """Plain PyTorch version of the ragged kernel, same arguments and
    result: append every live row's K/V at its position (quantized per
    token into int8 pools when ``k_scales``/``v_scales`` [KVH, n_pages,
    P] f32 are given), then attend each row over its sequence's pages
    under ``kv_pos <= kv_len + row``, in f32.  Pools are updated in
    place.  Returns out [S, P, H, D] in q's dtype, zero wherever a
    descriptor row has no query."""
    t, h, d = q.shape
    P = k_pages.shape[2]
    out = torch.zeros((q_start.shape[0], P, h, d), dtype=q.dtype,
                      device=q.device)
    desc, off, rows, pos = _rows_of_descriptors(q_start, q_len, kv_len)
    if desc.shape[0] == 0:
        return out
    tables = page_tables.to(torch.long)[desc]              # [R, maxp]
    if k_scales is not None:
        paged_write_rows_quant(k_pages, v_pages, k_scales, v_scales,
                               k_new[rows], v_new[rows], pos, tables)
    else:
        paged_write_rows(k_pages, v_pages, k_new[rows], v_new[rows], pos,
                         tables)
    npg = int(pos.max()) // P + 1                          # pages in view
    kg = _gather_pages(k_pages, k_scales, tables[:, :npg])
    vg = _gather_pages(v_pages, v_scales, tables[:, :npg])
    kpos = torch.arange(npg * P, device=q.device)
    o = _attend_rows(q[rows], kg, vg, kpos[None, :] <= pos[:, None])
    out[desc, off] = o.to(q.dtype)
    return out


def _kernel(source: str, fn_name: str, n_ptr: int, n_int: int,
            n_tail: int) -> ctypes.CDLL:
    """The library of ``csrc/<source>.cu`` with ``fn_name``'s argument
    types set: n_ptr pointers, n_int ints, the float softmax scale, then
    n_tail ints and the stream."""
    lib = _build.load(source)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_float] + [ctypes.c_int] * n_tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _raise_on(err, lib, source, what):
    if err:
        raise RuntimeError(f"{what} launch failed: " + getattr(
            lib, f"{source}_error_string")(err).decode())


def _pool_mode(q, k_pages, v_pages, new_rows, k_scales, v_scales, what):
    """Checks the kernels' dtype rule and returns the int8 flag: q (and
    the new rows) in one dtype of ``_DTYPE_CODE``; float pools in that
    dtype, or int8 pools with f32 per-token scale pools [KVH, n_pages,
    P]."""
    int8 = k_scales is not None
    enforce(q.dtype in _DTYPE_CODE and all(
        x.dtype == q.dtype for x in new_rows),
        f"the {what} kernel takes q and the new rows in one dtype of "
        f"{list(_DTYPE_CODE)}; got {q.dtype}, "
        f"{[x.dtype for x in new_rows]}")
    pool_dtype = torch.int8 if int8 else q.dtype
    enforce(k_pages.dtype == pool_dtype and v_pages.dtype == pool_dtype,
            f"the {what} kernel takes {'int8' if int8 else q.dtype} pools "
            f"here, not {k_pages.dtype}/{v_pages.dtype} (float pools in "
            f"q's dtype, or int8 pools with scale pools)")
    if int8:
        kvh, n_pages, P, _ = k_pages.shape
        enforce(all(x.dtype == torch.float32
                    and tuple(x.shape) == (kvh, n_pages, P)
                    for x in (k_scales, v_scales)),
                f"scale pools must be f32 [{kvh}, {n_pages}, {P}]")
    return int8


def _both_or_neither(k_scales, v_scales):
    enforce((k_scales is None) == (v_scales is None),
            "pass both k_scales and v_scales, or neither")


def _cuda_checks(what, d, tensors, ints, aligned):
    if d not in (64, 128):
        raise NotImplementedError(
            f"{what} kernel head_dim {d} (built for 64 and 128)")
    enforce(all(x.dtype == torch.int32 for x in ints),
            "lengths, descriptors and page tables must be int32")
    for x in tensors:
        enforce(x.is_contiguous(), f"the {what} kernel takes contiguous "
                                   f"tensors")
    enforce(all(x.data_ptr() % 16 == 0 for x in aligned),
            "pools and new rows must be 16-byte aligned")


def _ptr(x):
    return 0 if x is None else x.data_ptr()


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
                               q_start, q_len, kv_len, page_tables,
                               k_scales=None, v_scales=None):
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
    k_scales/v_scales: optional [KVH, n_pages, P] f32: the pools are int8
                  and each new row is quantized per token on the way in
                  (its codes and scale written), in place.

    Returns out [S, P, H, D] in q's dtype: descriptor s's row j is
    ``out[s, j]``; rows j >= q_len, and all rows of a ``q_len == 0``
    descriptor, are zero.

    On CUDA tensors this launches the kernel of
    ``csrc/ragged_paged_attention.cu`` (q and new rows in one dtype of
    float32/bfloat16/float16, pools in that dtype or int8, D of 64 or
    128) and raises on anything it does not take; on CPU tensors it runs
    the plain version."""
    _check(q, k_pages, v_pages, k_new, v_new, q_start, q_len, kv_len,
           page_tables)
    _both_or_neither(k_scales, v_scales)
    t, h, d = q.shape
    kvh, n_pages, P, _ = k_pages.shape
    if q.device.type == "cpu":
        return ragged_paged_append_attend_reference(
            q, k_pages, v_pages, k_new, v_new, q_start, q_len, kv_len,
            page_tables, k_scales, v_scales)
    enforce(q.device.type == "cuda", f"unsupported device {q.device}")
    int8 = _pool_mode(q, k_pages, v_pages, (k_new, v_new), k_scales,
                      v_scales, "ragged")
    scales = (k_scales, v_scales) if int8 else ()
    _cuda_checks("ragged", d, (q, k_pages, v_pages, k_new, v_new, q_start,
                               q_len, kv_len, page_tables, *scales),
                 (q_start, q_len, kv_len, page_tables),
                 (k_pages, v_pages, k_new, v_new))
    s_max, maxp = page_tables.shape
    out = torch.empty((s_max, P, h, d), dtype=q.dtype, device=q.device)
    src = "ragged_paged_attention"
    lib = _kernel(src, "ragged_paged_append_attend", 12, 7, 2)
    with torch.cuda.device(q.device):
        err = lib.ragged_paged_append_attend(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), _ptr(k_scales),
            _ptr(v_scales), q_start.data_ptr(), q_len.data_ptr(),
            kv_len.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
            s_max, h, kvh, n_pages, P, d, maxp, 1.0 / math.sqrt(d),
            _DTYPE_CODE[q.dtype], int(int8),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, src, "ragged paged attention")
    ragged_paged_append_attend.launches += 1
    return out


ragged_paged_append_attend.launches = 0


def _decode_launch(what, q, k_pages, v_pages, k_new, v_new, page_table,
                   seq_lens, k_scales, v_scales):
    """Shape checks of kernels #6 and #7 and, on CUDA tensors, their
    launch (``k_new is None``: #6).  Returns the output, or None on CPU
    tensors (the caller runs the plain version)."""
    b, h, d = q.shape
    kvh, n_pages, P, dk = k_pages.shape
    enforce(dk == d and v_pages.shape == k_pages.shape,
            f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not "
            f"match q {tuple(q.shape)}")
    enforce(h % kvh == 0, f"{h} query heads over {kvh} kv heads")
    new_rows = () if k_new is None else (k_new, v_new)
    enforce(all(tuple(x.shape) == (b, kvh, d) for x in new_rows),
            f"k_new/v_new must be [{b}, {kvh}, {d}]")
    enforce(seq_lens.shape == (b,) and page_table.dim() == 2
            and page_table.shape[0] == b,
            "seq_lens must be [B] with page_table [B, maxp]")
    _both_or_neither(k_scales, v_scales)
    scales = () if k_scales is None else (k_scales, v_scales)
    devs = {x.device for x in (q, k_pages, v_pages, page_table, seq_lens,
                               *new_rows, *scales)}
    enforce(len(devs) == 1, f"arguments on several devices: {devs}")
    if q.device.type == "cpu":
        return None
    enforce(q.device.type == "cuda", f"unsupported device {q.device}")
    int8 = _pool_mode(q, k_pages, v_pages, new_rows, k_scales, v_scales,
                      what)
    if (h // kvh) not in (1, 2, 4, 8):
        raise NotImplementedError(
            f"{what} kernel GQA group {h // kvh} (built for 1, 2, 4, 8)")
    _cuda_checks(what, d, (q, k_pages, v_pages, page_table, seq_lens,
                           *new_rows, *scales), (page_table, seq_lens),
                 (k_pages, v_pages, *new_rows))
    out = torch.empty_like(q)
    src = "paged_decode_attention"
    lib = _kernel(src, "paged_decode_attention", 10, 7, 3)
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention(
            q.data_ptr(), _ptr(k_new), _ptr(v_new), k_pages.data_ptr(),
            v_pages.data_ptr(), _ptr(k_scales), _ptr(v_scales),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            b, h, kvh, n_pages, P, d, page_table.shape[1],
            1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype], int(int8),
            int(k_new is not None),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, src, what)
    return out


def paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                    k_scales=None, v_scales=None):
    """Kernel #6, read-only single-token paged attention: row b's query
    heads ``q[b]`` [H, D] attend over the first ``seq_lens[b]`` tokens of
    its sequence's pages; a row with ``seq_lens[b] == 0`` gets zeros.

    q [B, H, D]; k_pages/v_pages [KVH, n_pages, P, D], float in q's
    dtype or int8 with ``k_scales``/``v_scales`` [KVH, n_pages, P] f32
    per-token scales; page_table [B, maxp] and seq_lens [B] int32.
    Returns [B, H, D] in q's dtype.

    On CUDA tensors one launch of the kernel of
    ``csrc/paged_decode_attention.cu`` (D 64 or 128, GQA group 1, 2, 4
    or 8; anything else raises); on CPU tensors the plain version."""
    out = _decode_launch("paged attention", q, k_pages, v_pages, None,
                         None, page_table, seq_lens, k_scales, v_scales)
    if out is None:
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         seq_lens, k_scales, v_scales)
    paged_attention.launches += 1
    return out


def paged_decode_append_attend(q, k_pages, v_pages, k_new, v_new,
                               page_table, seq_lens, k_scales=None,
                               v_scales=None):
    """Kernel #7, the split path's decode step: row b appends its new
    K/V (k_new/v_new [B, KVH, D], in q's dtype) at position
    ``seq_lens[b]`` of its sequence, quantized per token into int8 pools
    (codes and scale) when the scale pools are given, then attends its
    query heads over ``seq_lens[b] + 1`` tokens.  The pools are
    **updated in place**; the caller bumps seq_lens.  Other arguments
    and the dispatch as :func:`paged_attention`.  Returns [B, H, D]."""
    out = _decode_launch("paged decode append+attend", q, k_pages,
                         v_pages, k_new, v_new, page_table, seq_lens,
                         k_scales, v_scales)
    if out is None:
        return paged_decode_append_attend_reference(
            q, k_pages, v_pages, k_new, v_new, page_table, seq_lens,
            k_scales, v_scales)
    paged_decode_append_attend.launches += 1
    return out


paged_attention.launches = 0
paged_decode_append_attend.launches = 0
