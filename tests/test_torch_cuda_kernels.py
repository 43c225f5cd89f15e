"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; every test skips on a machine without a CUDA device.
This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Small shapes cover what the full-width check in ``chip_smoke.py`` does
not (the paged decode kernels #6 and #7 and the int8 pools of #1 too): f32 and f16 as well as bf16, head_dim 64, page sizes below and
above the 64-key tile, ragged tile edges, unused descriptors, causal
attention with Sq < Sk, broadcast masks and GQA.  Tolerances: f32 1e-4
(sums in another order), f16/bf16 one output rounding.  Int8 pools:
the codes and scales a kernel writes equal its plain version's bit for
bit (the same IEEE operations), and float pools are equal after an
append.  The flash
backward kernels' gradients are held relative to the largest gradient
element: f32 1e-5, f16 2e-3, bf16 1e-2 (one output rounding).  The
update kernel must equal its plain version bit for bit in the f32 slots
(the same f32 operations in the same order, no contraction) and within
one ulp of the parameter's dtype (Adam's powf may differ in its last
bit).  The add+norm kernel's h must equal r + x, and its y, like the
matmul+rope kernel's output, is held relative to the largest element:
f32 1e-5 (row statistics and products summed in another order), bf16
2^-7 (one bf16 step at the largest element's binade: a sum in another
order can cross a rounding edge).  For y the dtype that counts is h's:
the normalised value is rounded to it before the scale, so a bf16 h
gives an f32 y bf16 steps too.
"""
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_train as ft
from paddle_tpu_torch.ops import grouped_matmul as gm
from paddle_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.float16: 4e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("P,D,G", [(8, 64, 4), (128, 128, 4), (96, 128, 1)])
def test_ragged_kernel_matches_plain(dev, dtype, P, D, G):
    gen = torch.Generator(device=dev).manual_seed(0)
    kvh, maxp = 2, 6
    h = kvh * G
    n_pages = 4 * maxp + 1
    # (kv_len, q_len): decode rows, a chunk that fills a page from its
    # start, a chunk ending a page, and a split prompt
    descs = [(0, 1), (3 * P - 1, 1), (P, P), (P // 2, P - P // 2),
             (2 * P - 3, 3), (2 * P, 2)]
    S = T = sum(ql for _, ql in descs) + 3
    q_start = torch.zeros(S, dtype=torch.int32)
    q_len = torch.zeros(S, dtype=torch.int32)
    kv_len = torch.zeros(S, dtype=torch.int32)
    tables = torch.zeros((S, maxp), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev).cpu() + 1
    row, used = 0, 0
    for d, (kl, ql) in enumerate(descs):
        q_start[d], q_len[d], kv_len[d] = row, ql, kl
        # the split prompt's first descriptor holds its pages for both
        npg = -(-(kl + ql + (2 if d == 4 else 0)) // P)
        if d == 5:
            tables[d] = tables[4]
        else:
            tables[d, :npg] = perm[used:used + npg]
            used += npg
        row += ql

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, kn, vn = rnd(T, h, D), rnd(T, kvh, D), rnd(T, kvh, D)
    pools = rnd(kvh, n_pages, P, D), rnd(kvh, n_pages, P, D)
    desc = [x.to(dev) for x in (q_start, q_len, kv_len, tables)]
    kp_k, vp_k = (p.clone() for p in pools)
    kp_p, vp_p = (p.clone() for p in pools)
    before = pa.ragged_paged_append_attend.launches
    got = pa.ragged_paged_append_attend(q, kp_k, vp_k, kn, vn, *desc)
    want = pa.ragged_paged_append_attend_reference(q, kp_p, vp_p, kn, vn,
                                                   *desc)
    torch.cuda.synchronize()
    assert pa.ragged_paged_append_attend.launches == before + 1
    assert torch.equal(kp_k, kp_p) and torch.equal(vp_k, vp_p)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert not got[len(descs):].any()


def _int8_pools(gen, dev, kvh, n_pages, P, D):
    """Random int8 pools and scale pools (codes * scale within about 1)."""
    codes = [torch.randint(-127, 128, (kvh, n_pages, P, D), generator=gen,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand((kvh, n_pages, P), generator=gen, device=dev)
              * 0.008 + 1e-4 for _ in range(2)]
    return codes, scales


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("P,D,G", [(8, 64, 4), (128, 128, 4), (96, 128, 1)])
def test_ragged_kernel_int8_matches_plain(dev, dtype, P, D, G):
    """#1's int8 mode: the appended rows' codes and scales equal the
    plain version's (bit for bit), outputs within one rounding."""
    gen = torch.Generator(device=dev).manual_seed(5)
    kvh, maxp = 2, 6
    h = kvh * G
    n_pages = 2 * maxp + 1
    descs = [(0, 1), (3 * P - 1, 1), (P, P), (2 * P - 3, 3)]
    S = T = sum(ql for _, ql in descs) + 2
    q_start = torch.zeros(S, dtype=torch.int32)
    q_len = torch.zeros(S, dtype=torch.int32)
    kv_len = torch.zeros(S, dtype=torch.int32)
    tables = torch.zeros((S, maxp), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev).cpu() + 1
    row, used = 0, 0
    for d, (kl, ql) in enumerate(descs):
        q_start[d], q_len[d], kv_len[d] = row, ql, kl
        npg = -(-(kl + ql) // P)
        tables[d, :npg] = perm[used:used + npg]
        used, row = used + npg, row + ql
    q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((T, h, D), (T, kvh, D), (T, kvh, D)))
    (kc, vc), (ks, vs) = _int8_pools(gen, dev, kvh, n_pages, P, D)
    desc = [x.to(dev) for x in (q_start, q_len, kv_len, tables)]
    mine = [x.clone() for x in (kc, vc, ks, vs)]
    plain = [x.clone() for x in (kc, vc, ks, vs)]
    before = pa.ragged_paged_append_attend.launches
    got = pa.ragged_paged_append_attend(q, mine[0], mine[1], kn, vn, *desc,
                                        mine[2], mine[3])
    want = pa.ragged_paged_append_attend_reference(
        q, plain[0], plain[1], kn, vn, *desc, plain[2], plain[3])
    torch.cuda.synchronize()
    assert pa.ragged_paged_append_attend.launches == before + 1
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert not got[len(descs):].any()


def _decode_case(gen, dev, dtype, int8, P, D, G, append):
    """Rows of lengths 0 (a live row with its own table), 1, P - 1, P
    (the append opens a new page) and 3P + 5, and a pad row (length 0,
    table 0: page 0).  Returns (args, plain_args) with separate pools."""
    kvh, maxp = 2, 5
    h = kvh * G
    n_pages = 6 * maxp
    lens = torch.tensor([0, 1, P - 1, P, 3 * P + 5, 0], dtype=torch.int32)
    b = lens.shape[0]
    tables = torch.zeros((b, maxp), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev).cpu() + 1
    for i in range(b - 1):
        tables[i] = perm[i * maxp:(i + 1) * maxp]
    q = torch.randn((b, h, D), generator=gen, device=dev).to(dtype)
    new = [torch.randn((b, kvh, D), generator=gen, device=dev).to(dtype)
           for _ in range(2)] if append else []
    if int8:
        pools, scales = _int8_pools(gen, dev, kvh, n_pages, P, D)
    else:
        pools = [torch.randn((kvh, n_pages, P, D), generator=gen,
                             device=dev).to(dtype) for _ in range(2)]
        scales = [None, None]
    tail = [tables.to(dev), lens.to(dev)]

    def args(copy):
        ps = [x.clone() if copy and x is not None else x
              for x in pools + scales]
        return [q, ps[0], ps[1], *new, *tail, ps[2], ps[3]]
    return args(True), args(True)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("P,D,G", [(8, 64, 4), (128, 128, 4), (96, 128, 1),
                                   (16, 128, 8), (32, 64, 2)])
def test_paged_decode_append_kernel_matches_plain(dev, dtype, int8, P, D,
                                                  G):
    """#7: pools (and int8 codes and scales) equal the plain version's
    after the append, outputs within one rounding."""
    gen = torch.Generator(device=dev).manual_seed(6)
    mine, plain = _decode_case(gen, dev, dtype, int8, P, D, G, True)
    before = pa.paged_decode_append_attend.launches
    got = pa.paged_decode_append_attend(*mine)
    want = pa.paged_decode_append_attend_reference(*plain)
    torch.cuda.synchronize()
    assert pa.paged_decode_append_attend.launches == before + 1
    for a, b in zip(mine[1:3] + mine[-2:], plain[1:3] + plain[-2:]):
        if a is not None:
            assert torch.equal(a[:, 1:], b[:, 1:])     # page 0: pad row
    torch.testing.assert_close(got.float()[:-1], want.float()[:-1], rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("P,D,G", [(8, 64, 4), (128, 128, 4), (96, 128, 1),
                                   (16, 128, 8), (32, 64, 2)])
def test_paged_attention_kernel_matches_plain(dev, dtype, int8, P, D, G):
    """#6: outputs within one rounding; rows of length 0 get zeros."""
    gen = torch.Generator(device=dev).manual_seed(7)
    mine, plain = _decode_case(gen, dev, dtype, int8, P, D, G, False)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*mine)
    want = pa.paged_attention_reference(*plain)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert not got[0].any() and not got[-1].any()


def test_paged_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(2, 12, 128, device=dev, dtype=torch.bfloat16)
    pools = torch.zeros(4, 3, 8, 128, device=dev, dtype=torch.bfloat16)
    table = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    lens = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="GQA group 3"):
        pa.paged_attention(q, pools, pools, table, lens)
    with pytest.raises(ValueError, match="pools"):
        pa.paged_attention(q[:, :8], pools.float(), pools.float(), table,
                           lens)
    with pytest.raises(ValueError, match="both"):
        pa.paged_attention(q[:, :8], pools.to(torch.int8),
                           pools.to(torch.int8), table, lens,
                           torch.zeros(4, 3, 8, device=dev), None)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,mshape", [
    (1, 128, 2048, 32, 8, 128, False, (1, 1, 128, 2048)),
    (2, 40, 100, 4, 4, 64, True, None),
    (1, 70, 70, 8, 2, 128, True, (1, 8, 1, 70)),
    (2, 65, 130, 6, 3, 64, False, (2, 1, 65, 130)),
])
def test_flash_kernel_matches_plain(dev, dtype, b, sq, sk, h, kvh, d,
                                    causal, mshape):
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q = rnd(b, sq, h, d)
    # k/v as strided views of a [B, KVH, Sk, D] buffer, like the engine's
    kv = rnd(2, b, kvh, sk, d)
    k, v = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    mask = None
    if mshape is not None:
        mask = torch.randn(mshape, generator=gen, device=dev)
        # hide the last keys: no row is left without a visible key (a
        # fully hidden row averages whatever keys its tiles visit)
        mask[..., -(sk // 4):] = -1e30
    got, lse = fa.flash_attention_fwd(q, k, v, causal=causal, mask=mask)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v,
                                                      causal=causal,
                                                      mask=mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


GRAD_TOL = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,mshape", [
    (2, 40, 100, 4, 4, 64, True, None),
    (1, 130, 130, 8, 2, 128, True, None),
    (1, 70, 70, 8, 2, 128, True, (1, 8, 1, 70)),
    (2, 65, 130, 8, 2, 64, False, (2, 1, 65, 130)),
    (1, 64, 192, 4, 1, 128, False, None),
])
def test_flash_bwd_kernels_match_plain(dev, dtype, b, sq, sk, h, kvh, d,
                                       causal, mshape):
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v, do = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d), \
        rnd(b, sq, h, d)
    mask = None
    if mshape is not None:
        mask = torch.randn(mshape, generator=gen, device=dev)
        mask[..., -(sk // 4):] = -1e30
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, mask=mask)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 mask=mask)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=causal, mask=mask)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("kind,hyper", [
    ("sgd", {"weight_decay": 0.01, "decoupled": False}),
    ("momentum", {"weight_decay": 0.01, "decoupled": False,
                  "momentum": 0.9, "nesterov": True}),
    ("adam", {"weight_decay": 0.01, "decoupled": False, "beta1": 0.9,
              "beta2": 0.999, "epsilon": 1e-8}),
    ("adam", {"weight_decay": 0.1, "decoupled": True, "beta1": 0.9,
              "beta2": 0.95, "epsilon": 1e-8}),
], ids=["sgd", "nesterov", "adam_l2", "adamw"])
def test_update_kernel_matches_plain(dev, kind, hyper, clip, pdtype):
    gen = torch.Generator(device=dev).manual_seed(3)
    n = 1_000_003                      # a ragged tail past the 8-wide loads
    p = torch.randn(n, generator=gen, device=dev).to(pdtype)
    g = (torch.randn(n, generator=gen, device=dev) * 0.1).to(pdtype)
    slots = {k: torch.rand(n, generator=gen, device=dev) * 1e-3
             for k in ft.SLOT_KEYS[kind]}
    scal = torch.tensor([1e-3, 7.0, 0.37], device=dev)
    want_p, want_s = ft.fused_update_reference(
        kind, p, g, slots, lr=scal[0], step_f=scal[1],
        clip_scale=scal[2] if clip else None, hyper=hyper)
    before = ft.fused_update_flat.launches
    ft.fused_update_flat(kind, p, g, slots, scalars=scal, has_clip=clip,
                         hyper=hyper)
    torch.cuda.synchronize()
    assert ft.fused_update_flat.launches == before + 1
    for k in slots:
        assert torch.equal(slots[k], want_s[k]), k
    ulp = torch.finfo(pdtype).eps * want_p.float().abs().clamp(min=1e-30)
    assert ((p.float() - want_p.float()).abs() <= ulp).all()


REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("hdim", [64, 100, 4096, 8192])
@pytest.mark.parametrize("xdt,wdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)],
    ids=str)
@pytest.mark.parametrize("body", ["rms", "ln", "ln_bias"])
def test_add_norm_kernel_matches_plain(dev, body, xdt, wdt, hdim):
    """Both bodies, with and without bias, every dtype pair; H 100 takes
    the one-element path, the others the 16-byte one."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x, r = (torch.randn(2, 19, hdim, generator=gen, device=dev).to(xdt)
            for _ in range(2))
    w = (1 + 0.2 * torch.randn(hdim, generator=gen, device=dev)).to(wdt)
    b = (0.2 * torch.randn(hdim, generator=gen, device=dev)).to(wdt)
    if body == "rms":
        fn, plain, args = ft.add_rms_norm_raw, ft.add_rms_norm_reference, \
            (x, r, w, 1e-5)
    else:
        fn, plain = ft.add_layer_norm_raw, ft.add_layer_norm_reference
        args = (x, r, w, b if body == "ln_bias" else None, 1e-5)
    before = fn.launches
    h, y = fn(*args)
    want_h, want_y = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(h, want_h)
    assert y.dtype == want_y.dtype == torch.promote_types(xdt, wdt)
    # the normalised value is rounded to h's dtype before the scale
    assert _rel(y, want_y) <= REL_TOL[xdt], _rel(y, want_y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,s,k,heads,d", [
    (1, 96, 256, 8, 128),      # fewer rows than one 128-row tile
    (2, 96, 200, 32, 128),     # tiles across the batch boundary; K % 32
    (2, 130, 256, 8, 64),
    (1, 257, 64, 32, 64)])
def test_matmul_rope_kernel_matches_plain(dev, dtype, b, s, k, heads, d):
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(b, s, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(k, heads * d, generator=gen, device=dev)
         / k ** 0.5).to(dtype)
    ang = torch.rand(s, d // 2, generator=gen, device=dev) * 50
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
    before = ft.matmul_rope_raw.launches
    got = ft.matmul_rope_raw(x, w, cos, sin, n_heads=heads, head_dim=d)
    want = ft.matmul_rope_reference(x, w, cos, sin, heads, d)
    torch.cuda.synchronize()
    assert ft.matmul_rope_raw.launches == before + 1
    assert got.shape == (b, s, heads, d) and got.dtype == dtype
    assert _rel(got, want) <= REL_TOL[dtype], _rel(got, want)
    # the backward (plain PyTorch) against autograd of the plain version
    ct = torch.randn(got.shape, generator=gen, device=dev).to(dtype)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    g = torch.autograd.grad(ft.matmul_rope_raw(
        xs, ws, cos, sin, n_heads=heads, head_dim=d), (xs, ws), ct)
    g_want = torch.autograd.grad(ft.matmul_rope_reference(
        xs, ws, cos, sin, heads, d), (xs, ws), ct)
    for a, e in zip(g, g_want):
        assert _rel(a, e) <= REL_TOL[dtype], _rel(a, e)


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def _plan_rows(dev, gen, dtype, *, t, k, e, h, tm, empty=2):
    """Routes of t tokens to k of e experts (expert ``empty`` gets none),
    their plan, and random rows scattered into the padded buffer."""
    idx = torch.randint(0, e, (t, k), generator=gen, device=dev)
    idx = torch.where(idx == empty, (idx + 1) % e, idx)
    order, dest, te, counts, m_pad = gm.make_dropless_plan(idx, e, tm)
    rows = torch.randn(t * k, h, generator=gen, device=dev).to(dtype)
    xs = torch.zeros(m_pad, h, device=dev, dtype=dtype).index_copy(
        0, dest, rows)
    return xs, te, counts


GMM_CASES = [  # (rows dtype, weight dtype, tm)
    (torch.bfloat16, torch.bfloat16, 128), (torch.bfloat16, torch.bfloat16, 256),
    (torch.float32, torch.float32, 128), (torch.float32, torch.bfloat16, 128),
    (torch.float32, torch.bfloat16, 32)]


@pytest.mark.parametrize("adt,wdt,tm", GMM_CASES, ids=str)
@pytest.mark.parametrize("transpose_w", [False, True], ids=["nn", "nt"])
def test_gmm_kernel_matches_plain(dev, adt, wdt, tm, transpose_w):
    gen = torch.Generator(device=dev).manual_seed(7)
    e, kdim, n = 6, 264, 200
    xs, te, counts = _plan_rows(dev, gen, adt, t=300, k=3, e=e, h=kdim,
                                tm=tm)
    shape = (e, n, kdim) if transpose_w else (e, kdim, n)
    w = (torch.randn(shape, generator=gen, device=dev) / kdim ** 0.5).to(wdt)
    want = gm.gmm_reference(xs, w, te, transpose_w=transpose_w)
    before = gm.gmm_raw.launches
    for cnt in (counts, None):       # the padding skip changes nothing here
        got = gm.gmm_raw(xs, w, te, transpose_w=transpose_w, counts=cnt)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == adt
        assert _rel_l2(got, want) <= REL_TOL[adt], _rel_l2(got, want)
    assert gm.gmm_raw.launches == before + 2


@pytest.mark.parametrize("adt,wdt,tm", GMM_CASES, ids=str)
@pytest.mark.parametrize("save_pre", [False, True], ids=["hs", "save_pre"])
def test_gmm_glu_kernel_matches_plain(dev, adt, wdt, tm, save_pre):
    gen = torch.Generator(device=dev).manual_seed(8)
    e, h, f = 6, 256, 136
    xs, te, counts = _plan_rows(dev, gen, adt, t=300, k=3, e=e, h=h, tm=tm)
    wg, wu = ((torch.randn(e, h, f, generator=gen, device=dev)
               / h ** 0.5).to(wdt) for _ in range(2))
    want = gm.gmm_glu_reference(xs, wg, wu, te, save_pre=save_pre)
    before = gm.gmm_glu_raw.launches
    got = gm.gmm_glu_raw(xs, wg, wu, te, save_pre=save_pre, counts=counts)
    torch.cuda.synchronize()
    assert gm.gmm_glu_raw.launches == before + 1
    assert len(got) == len(want) == (3 if save_pre else 1)
    for a, b in zip(got, want):
        assert a.dtype == adt and _rel_l2(a, b) <= REL_TOL[adt], \
            _rel_l2(a, b)


@pytest.mark.parametrize("dtype,tm", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 256),
                                      (torch.float32, 128)], ids=str)
def test_gmm_dw_kernel_matches_plain(dev, dtype, tm):
    gen = torch.Generator(device=dev).manual_seed(9)
    e, kdim, n = 6, 264, 200
    xs, te, counts = _plan_rows(dev, gen, dtype, t=300, k=3, e=e, h=kdim,
                                tm=tm)
    dout = torch.randn(xs.shape[0], n, generator=gen, device=dev).to(dtype)
    dout = torch.where(xs[:, :1] != 0, dout, torch.zeros_like(dout))
    want = gm.gmm_dw_reference(xs, dout, te, counts, e)
    before = gm.gmm_dw_raw.launches
    got = gm.gmm_dw_raw(xs, dout, te, counts, e)
    torch.cuda.synchronize()
    assert gm.gmm_dw_raw.launches == before + 1
    assert got.shape == (e, kdim, n) and got.dtype == dtype
    assert int(counts[2]) == 0 and torch.equal(got[2], torch.zeros_like(got[2]))
    assert _rel_l2(got, want) <= REL_TOL[dtype], _rel_l2(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_dropless_moe_ffn_on_the_kernels_matches_plain(dev, dtype):
    """Values and gradients of the dropless FFN (the kernels and their
    autograd Functions) against the same FFN on the CPU (the plain
    versions), from the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(10)
    t, k, e, h, f = 160, 4, 8, 128, 96
    x = torch.randn(t, h, generator=gen, device=dev).to(dtype)
    gv = torch.rand(t, k, generator=gen, device=dev)
    idx = torch.randint(0, e, (t, k), generator=gen, device=dev)
    ws = [(torch.randn(s, generator=gen, device=dev) / s[1] ** 0.5).to(dtype)
          for s in ((e, h, f), (e, h, f), (e, f, h))]
    ct = torch.randn(t, h, generator=gen, device=dev).to(dtype)
    res = []
    for d in (dev, torch.device("cpu")):
        xi = x.to(d).requires_grad_()
        wi = [w.to(d).requires_grad_() for w in ws]
        out = gm.dropless_moe_ffn(xi, gv.to(d), idx.to(d), *wi)
        grads = torch.autograd.grad(out, [xi, *wi], ct.to(d))
        res.append([out.cpu(), *(g.cpu() for g in grads)])
    for a, b in zip(*res):
        assert _rel_l2(a, b) <= (1e-5 if dtype == torch.float32
                                 else 2 * REL_TOL[dtype]), _rel_l2(a, b)


def test_grouped_matmul_refuses_what_the_kernels_do_not_take(dev):
    te = torch.zeros(2, dtype=torch.int32, device=dev)
    w = torch.zeros(1, 64, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        gm.gmm_raw(torch.zeros(128, 64, device=dev, dtype=torch.bfloat16),
                   w, te)
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        gm.gmm_raw(torch.zeros(256, 64, device=dev, dtype=torch.float16),
                   w.half(), te)
    with pytest.raises(NotImplementedError, match="bfloat16 weights"):
        gm.gmm_raw(torch.zeros(256, 64, device=dev, dtype=torch.bfloat16),
                   w.float(), te)
    with pytest.raises(NotImplementedError, match="multiples of 8"):
        gm.gmm_raw(torch.zeros(256, 60, device=dev, dtype=torch.bfloat16),
                   w[:, :60], te)


def test_fused_regions_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 64, device=dev, dtype=torch.float16)
    w = torch.ones(64, device=dev)
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        ft.add_rms_norm_raw(x, x, w)
    big = torch.zeros(2, 8200, device=dev)
    with pytest.raises(NotImplementedError, match="up to 8192"):
        ft.add_layer_norm_raw(big, big, torch.ones(8200, device=dev), None)
    with pytest.raises(NotImplementedError, match="needs a weight"):
        ft.add_rms_norm_raw(x.float(), x.float(), None)
    x = torch.zeros(1, 8, 96, device=dev, dtype=torch.bfloat16)
    cos = torch.zeros(8, 96, device=dev)
    with pytest.raises(NotImplementedError, match="head_dim 64 and 128"):
        ft.matmul_rope_raw(x, torch.zeros(96, 96, device=dev,
                                          dtype=torch.bfloat16), cos, cos,
                           n_heads=1, head_dim=96)
    cos = torch.zeros(8, 64, device=dev)
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        ft.matmul_rope_raw(x.half(), torch.zeros(96, 64, device=dev).half(),
                           cos, cos, n_heads=1, head_dim=64)
    with pytest.raises(NotImplementedError, match="K % 8"):
        ft.matmul_rope_raw(x[..., :90], torch.zeros(
            90, 64, device=dev, dtype=torch.bfloat16), cos, cos, n_heads=1,
            head_dim=64)
    with pytest.raises(NotImplementedError, match="interleaved"):
        ft.matmul_rope_raw(x, torch.zeros(96, 64, device=dev,
                                          dtype=torch.bfloat16), cos, cos,
                           n_heads=1, head_dim=64, interleaved=True)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention_fwd(q.float(), q, q)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention_bwd(q, q, q, q, lse, q.float())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, q, lse.double(), q)
    p = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    scal = torch.ones(3, device=dev)
    bf16_slots = {"moment1": p.clone(), "moment2": p.clone()}
    with pytest.raises(ValueError, match="f32 slots"):
        ft.fused_update_flat("adam", p, p, bf16_slots, scalars=scal,
                             has_clip=False, hyper=hyper)
    slots = {k: torch.zeros(64, device=dev) for k in bf16_slots}
    with pytest.raises(ValueError, match="aligned"):
        ft.fused_update_flat("adam", p[1:33], p[:32],
                             {k: s[:32] for k, s in slots.items()},
                             scalars=scal, has_clip=False, hyper=hyper)


def test_engine_refuses_float_pools_of_another_dtype(dev):
    """The kernels take one float dtype: on the card, pools in another
    float dtype than the weights raise (int8 pools are taken)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    m = LlamaForCausalLM(llama_tiny_config(), device=dev)
    with pytest.raises(NotImplementedError, match="the rest of serving"):
        LLMEngine(m, max_len=64, page_size=8, kv_dtype="bfloat16")
    eng = LLMEngine(m, max_len=64, page_size=8, kv_dtype="int8")
    assert eng.cache.k_pages.dtype == torch.int8


def test_plain_paths_refuse_cuda_tensors(dev):
    """The settings that would run plain PyTorch instead of a kernel
    raise on the card: ``use_flash_attention=False``,
    ``fused_step=False`` and the per-leaf ``apply_gradients``."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    cfg = llama_tiny_config()
    cfg.fuse_norm_rope = False
    cfg.use_flash_attention = False
    m = LlamaForCausalLM(cfg, device=dev)
    with pytest.raises(NotImplementedError, match="flash kernels"):
        m(torch.zeros(1, 8, dtype=torch.long, device=dev))
    opt = optim.AdamW(learning_rate=1e-3, parameters=m.parameters())
    with pytest.raises(NotImplementedError, match="fused_step=False"):
        CompiledTrainStep(m, lambda mm, b: mm(b["x"]), opt, fused_step=False)
    params = dict(m.named_parameters())
    with pytest.raises(NotImplementedError, match="CPU tensors only"):
        opt.apply_gradients(params, params, opt.init_state(params))


# -- attention dropout (#2-#4 dropout mode) and the bias gradient (#5) -----

def _attn_inputs(dev, dtype, b, sq, sk, h, kvh, d, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d), \
        rnd(b, sq, h, d)


def _assert_grads_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,s,h,kvh", [(2, 130, 4, 4), (1, 100, 8, 2)],
                         ids=["group1", "group4"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_flash_dropout_kernels_match_plain(dev, dtype, d, b, s, h, kvh, p):
    """#2, #3 and #4 in dropout mode against their plain versions fed the
    same seed tensor: the same keep bits, so the f32 and bf16 tolerances
    of the undropped kernels."""
    q, k, v, do = _attn_inputs(dev, dtype, b, s, s, h, kvh, d)
    seed = torch.tensor(1234, dtype=torch.int64, device=dev)
    kw = dict(causal=True, dropout_p=p, seed=seed)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(
                n + 1 for n in before)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_flash_forward_keep_bits_equal_the_plain_mask(dev, p):
    """The forward kernel's keep mask, read through V = I (each output
    row is the row's dropped probabilities over l), equals
    ``dropout_keep`` bit for bit, and keeps about 1 - p."""
    b, s, h, d = 2, 64, 3, 64
    q, k, _, _ = _attn_inputs(dev, torch.float32, b, s, s, h, h, d)
    eye = torch.eye(s, device=dev)[None, :, None, :].expand(b, s, h, d)
    seed = torch.tensor(77, dtype=torch.int64, device=dev)
    out, _ = fa.flash_attention_fwd(q, k, eye.contiguous(), dropout_p=p,
                                    seed=seed)
    got = out.transpose(1, 2) > 0                        # [B, H, Sq, Sk]
    want = fa.dropout_keep(seed, p, b, h, s, s)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    n = want.numel()
    rate = want.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5


@pytest.mark.parametrize("mshape", [(1, 4, 70, 70), (2, 1, 70, 70),
                                    (1, 1, 70, 70), (2, 4, 70, 70)],
                         ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_dbias_kernel_matches_plain(dev, mshape, causal, p):
    """#5 against its plain version: f32, D 64, GQA group 2, each bias
    shape, causal and not, with and without dropout (1e-5 of the largest
    element: f32 sums in another order)."""
    q, k, v, do = _attn_inputs(dev, torch.float32, 2, 70, 70, 4, 2, 64)
    gen = torch.Generator(device=dev).manual_seed(4)
    bias = torch.randn(mshape, generator=gen, device=dev) * 0.5
    seed = torch.tensor(99, dtype=torch.int64, device=dev)
    kw = dict(causal=causal, dropout_p=p, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, mask=bias, **kw)
    before = fa.flash_attention_bwd_dbias.launches
    got = fa.flash_attention_dbias(q, k, v, out, lse, do, bias, **kw)
    want = fa.flash_attention_dbias_reference(q, k, v, out, lse, do, bias,
                                              **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dbias.launches == before + 1
    _assert_grads_close([got], [want], torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", [64, 128])
def test_dbias_kernel_matches_plain_half_types(dev, dtype, d):
    q, k, v, do = _attn_inputs(dev, dtype, 2, 96, 96, 8, 2, d)
    gen = torch.Generator(device=dev).manual_seed(5)
    bias = (torch.randn(1, 8, 96, 96, generator=gen, device=dev) *
            0.5).to(dtype)
    seed = torch.tensor(5, dtype=torch.int64, device=dev)
    kw = dict(causal=True, dropout_p=0.1, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, mask=bias, **kw)
    got = fa.flash_attention_dbias(q, k, v, out, lse, do, bias, **kw)
    want = fa.flash_attention_dbias_reference(q, k, v, out, lse, do, bias,
                                              **kw)
    torch.cuda.synchronize()
    _assert_grads_close([got], [want], dtype)


@pytest.mark.parametrize("need", ["none", "q", "kv"])
def test_trained_bias_gets_its_gradient_on_the_card(dev, need):
    """A trained bias routes to the bias path whether or not q, k and v
    need a gradient (ROADMAP §C 1), and only the kernels of the
    gradients asked for launch."""
    from paddle_tpu_torch.nn import functional as F
    q, k, v, do = _attn_inputs(dev, torch.float32, 1, 8, 8, 2, 2, 64)
    if need == "q":
        q.requires_grad_()
    elif need == "kv":
        k.requires_grad_()
        v.requires_grad_()
    bias = torch.zeros(1, 2, 8, 8, device=dev, requires_grad=True)
    counts = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dbias.launches)
    F.scaled_dot_product_attention(q, k, v, attn_mask=bias).backward(do)
    added = [n - c for n, c in zip((fa.flash_attention_bwd_dq.launches,
                                    fa.flash_attention_bwd_dkv.launches,
                                    fa.flash_attention_bwd_dbias.launches),
                                   counts)]
    assert added == [int(need == "q"), int(need == "kv"), 1]
    cpu = [x.detach().cpu() for x in (q, k, v, do)]
    b_cpu = torch.zeros(1, 2, 8, 8, requires_grad=True)
    F.scaled_dot_product_attention(*cpu[:3], attn_mask=b_cpu).backward(
        cpu[3])
    torch.testing.assert_close(bias.grad.cpu(), b_cpu.grad, rtol=0,
                               atol=1e-5)


def test_dropout_and_bias_refusals(dev):
    from paddle_tpu_torch.nn import functional as F
    q, k, v, _ = _attn_inputs(dev, torch.float32, 1, 8, 8, 2, 2, 64)
    with pytest.raises(ValueError, match="dropout_p"):
        F.scaled_dot_product_attention(q, k, v, dropout_p=1.0)
    with pytest.raises(ValueError, match="dropout_p"):
        fa.flash_attention_fwd(q, k, v, dropout_p=1.0,
                               seed=torch.zeros((), dtype=torch.int64,
                                                device=dev))
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention_fwd(q, k, v, dropout_p=0.1)
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention_fwd(q, k, v, dropout_p=0.1,
                               seed=torch.zeros((), dtype=torch.int64))
    bias = torch.zeros(1, 2, 1, 8, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="remaining kernels"):
        F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
