"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; every test skips on a machine without a CUDA device.
This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Small shapes cover what the full-width check in ``chip_smoke.py`` does
not (the paged decode kernels #6 and #7, the int8 pools of #1 and every
mixed pair of float q and pool dtypes too; pools equal bit for bit
after an append, outputs within the coarser dtype's tolerance): f32 and
f16 as well as bf16, head_dim 64, page sizes below and
above the 64-key tile, ragged tile edges, unused descriptors, causal
attention with Sq < Sk, broadcast masks and GQA.  Tolerances: f32 1e-4
(sums in another order), f16/bf16 one output rounding.  Int8 pools:
the codes and scales a kernel writes equal its plain version's bit for
bit (the same IEEE operations), and float pools are equal after an
append.  The flash
backward kernels' gradients are held relative to the largest gradient
element: f32 1e-5, f16 2e-3, bf16 1e-2 (one output rounding).  The
16-bit flash forward and dK/dV kernels (tensor cores) are held to the
same tolerances at their edges: GQA groups 1/2/4/8, ragged tiles,
causal offsets, each mask broadcast, strided views, 1024 keys.  The
update kernel must equal its plain version bit for bit in the f32 slots
(the same f32 operations in the same order, no contraction) and within
one ulp of the parameter's dtype (Adam's powf may differ in its last
bit).  The 16-bit dQ kernel is held to the flash backward tolerances
over the same edges, in dropout mode too, and must give the same bits
on two launches.  The add+norm kernel's h must equal r + x, and its y,
like the matmul+rope kernel's output (M and K off its tiles, odd head
counts, tables of either dtype; a bf16 call must launch nothing but
#10), is held relative to the largest element:
f32 1e-5 (row statistics and products summed in another order), bf16
2^-7 (one bf16 step at the largest element's binade: a sum in another
order can cross a rounding edge).  For y the dtype that counts is h's:
the normalised value is rounded to it before the scale, so a bf16 h
gives an f32 y bf16 steps too.  Its backward kernel's dx, dw and db are
held to the plain backward by relative L2 (f32 1e-5, 16-bit 2^-7) at
every width layout, with and without h's own gradient, and dw and db
must give the same bits on two launches; through autograd a CUDA
tensor never reaches the plain backward.  The bf16 grouped matmul #11 (both
transpose_w) and its dW #13 (tensor cores, TMA-fed) are held to 2^-7
relative L2 at Qwen1.5-MoE's training widths cut in rows (spread and
hot-expert routes, an empty expert whose dW must be exactly zero), at a
ragged K and N (264 x 200) whose K edge falls inside a 64-deep slice
(the next expert's weights, all inf, must never be read), with padding
rows full of NaN (#11 must give zero rows there, #13 must leave its
sums untouched), and must give the same bits on two launches and launch
nothing but their wgmma kernels; so must the bf16 fused gate/up #12
(``glu_wgmma``) at those widths, its padding rows zero and every product
within 2^-7.  The ragged kernel #1 is held in every mode (16-bit q over
its own pools on ``mma.sync``, f32 q or pools, the mixed pairs and int8
pools on 3xTF32) at key lengths on and just past the edges of its key
spans, at GQA groups 1, 4 and 8, D 64 and 128 and pages of 16 and 128
keys: outputs within the coarser dtype's tolerance, pools bit-equal,
the rows without a query exactly zero over memory that held NaN, the
same bits on two launches, and nothing launched but its append and its
route's attention kernel.  The span-split #7 and #6 are held in every
mode (16-bit, f32, int8 and mixed pools) at GQA groups 1, 4 and 8 at
lengths 0, 1, span - 1, span, span + 1, an append that opens a new page
and the table's last slot: outputs within the coarser dtype's
tolerance, pools bit-equal, the same bits on two launches, one kernel a
call.  #4's f32 route (3xTF32 at D 64, the FMA pipe at 128) is held to
1e-5 of the largest gradient element with dropout 0, 0.1 and 0.5,
causal or not, masks, GQA 2 and ragged lengths, gives the same bits on
two launches and launches ``flash_bwd_dkv_3xtf32`` alone.  So is #3's
f32 route (3xTF32 at D 64, the FMA pipe at 128), also at Sk > Sq under
causal masking, on rows whose every key is hidden and at GQA 4, with
``flash_bwd_dq_3xtf32`` alone on its launch; and #5's f32 route at D 64
(``flash_dbias_3xtf32``) at every bias broadcast, GQA 1 and 4 and
ragged tiles, the same bits on two launches and alone on its launch,
while f32 at D 128 stays on ``flash_dbias``.  The model zoo's shapes:
#2-#4 at GQA groups 3 and 5 (ERNIE-4.5), at 16-bit D 64 under a
``[B, 1, 1, S]`` padding bias with and without dropout (BERT; the padded
keys' dK and dV exactly zero), #10 at hidden 1536 and 2560, and #11-#13
at 64 experts with H 2560 and F 1536, each within the tolerances above;
interleaved rope takes #10's plain version and launches nothing.  The
encoder-decoder Transformer's shapes: #2-#4 in bf16 and f16 under its
additive masks with -inf entries (the subsequent mask plus key padding,
key padding alone), with Sq != Sk (cross attention) and at one-token
decoding from one key and from 33, within the tolerances above; q, k
and v of two dtypes promoted to their common one (f32 out, within
1e-4); #9 in float16 and in its mixed mode (a 16-bit x over an f32
residual, either operand first, an f32 or 16-bit weight, at every width
layout): h equal to r + x, y within 1e-5, the narrow operand's gradient
within one rounding of its dtype and the f32 ones within 1e-5, through
autograd one launch each way with each gradient in its operand's dtype.
The per-leaf update is a supported route on the card (a
``fused_step=False`` step launches no update kernel).  ``hapi.Model.fit``
on a small bf16 BERT launches #2-#4, #9 and #8 each step (exact counts)
and hands the network its batches on the card; the token-file reader
runs natively.
"""
import ctypes

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


def _decode_case(gen, dev, dtype, int8, P, D, G, append, pool_dtype=None):
    """Rows of lengths 0 (a live row with its own table), 1, P - 1, P
    (the append opens a new page) and 3P + 5, and a pad row (length 0,
    table 0: page 0); float pools in ``pool_dtype`` (q's by default).
    Returns (args, plain_args) with separate pools."""
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
                             device=dev).to(pool_dtype or dtype)
                 for _ in range(2)]
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


# (q dtype, pool dtype): every mixed pair of float types
MIXED = [(a, b) for a in TOL for b in TOL if a != b]


@pytest.mark.parametrize("qdt,pdt", MIXED, ids=str)
@pytest.mark.parametrize("P,D,G", [(8, 64, 4), (128, 128, 4), (96, 128, 1),
                                   (16, 128, 8)])
def test_paged_decode_kernels_mixed_pools_match_plain(dev, qdt, pdt, P, D,
                                                      G):
    """#7 and #6 over pools of another float dtype than q: pools equal
    the plain version's bit for bit after #7's append (the rows cast to
    the pool dtype), outputs in q's dtype within the tolerance of the
    coarser of the two dtypes."""
    gen = torch.Generator(device=dev).manual_seed(8)
    tol = max(TOL[qdt], TOL[pdt])
    mine, plain = _decode_case(gen, dev, qdt, False, P, D, G, True, pdt)
    before = pa.paged_decode_append_attend.launches
    got = pa.paged_decode_append_attend(*mine)
    want = pa.paged_decode_append_attend_reference(*plain)
    torch.cuda.synchronize()
    assert pa.paged_decode_append_attend.launches == before + 1
    assert got.dtype == qdt and mine[1].dtype == pdt
    for a, b in zip(mine[1:3], plain[1:3]):
        assert torch.equal(a[:, 1:], b[:, 1:])         # page 0: pad row
    torch.testing.assert_close(got.float()[:-1], want.float()[:-1], rtol=0,
                               atol=tol)
    args = [mine[0], mine[1], mine[2], *mine[5:]]      # #6 on the same pools
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("qdt,pdt", MIXED, ids=str)
@pytest.mark.parametrize("P,D,G", [(8, 64, 4), (128, 128, 4), (96, 128, 1)])
def test_ragged_kernel_mixed_pools_match_plain(dev, qdt, pdt, P, D, G):
    """#1 over pools of another float dtype than q: decode rows, a chunk
    filling a page, a chunk ending a page; the pools equal the plain
    version's bit for bit, outputs in q's dtype within the coarser
    dtype's tolerance."""
    gen = torch.Generator(device=dev).manual_seed(9)
    kvh, maxp = 2, 6
    h = kvh * G
    n_pages = 4 * maxp + 1
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
    q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(qdt)
                 for shape in ((T, h, D), (T, kvh, D), (T, kvh, D)))
    pools = [torch.randn((kvh, n_pages, P, D), generator=gen,
                         device=dev).to(pdt) for _ in range(2)]
    desc = [x.to(dev) for x in (q_start, q_len, kv_len, tables)]
    mine = [p.clone() for p in pools]
    plain = [p.clone() for p in pools]
    before = pa.ragged_paged_append_attend.launches
    got = pa.ragged_paged_append_attend(q, mine[0], mine[1], kn, vn, *desc)
    want = pa.ragged_paged_append_attend_reference(q, plain[0], plain[1], kn,
                                                   vn, *desc)
    torch.cuda.synchronize()
    assert pa.ragged_paged_append_attend.launches == before + 1
    assert got.dtype == qdt
    assert all(torch.equal(a, b) for a, b in zip(mine, plain))
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=max(TOL[qdt], TOL[pdt]))
    assert not got[len(descs):].any()


# The redesigned #1 (append + plan, a persistent attention grid over 64-row
# blocks and key splits, merging its splits, with the zeros beside it):
# every mode at key lengths on and just past a split edge.
RAGGED_MODES = [  # (q dtype, pool dtype or "int8")
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, "int8"),
    (torch.float32, "int8")]


def _ragged_edge_case(dev, gen, qdt, pdt, P, D, G, maxp=6, kvh=2):
    """Descriptors whose key ranges (kv_len + q_len) are 1, P - 1, P,
    P + 1, 2P and maxp P, and on and just past the edges of the kernel's
    key spans (64-key multiples, about 128 keys a span: 64, 128, 192,
    256, 384, 768 and one past each) as decode rows, a q_len = P chunk
    from position 0 and from P, a prompt split over two descriptors
    inside one page, and an unused descriptor; the pools (float or int8
    with scales) and the descriptor tensors."""
    h = kvh * G
    edges = [n + e for n in (64, 128, 192, 256, 384, 768) for e in (0, 1)]
    lens = sorted({n for n in [1, P - 1, P, P + 1, 2 * P, maxp * P] + edges
                   if 1 <= n <= maxp * P})
    descs = [(n - 1, 1) for n in lens] + [(0, P), (P, P),
                                          (P, P // 2), (P + P // 2, P // 2)]
    S = len(descs) + 1
    T = sum(ql for _, ql in descs)
    q_start = torch.zeros(S, dtype=torch.int32)
    q_len = torch.zeros(S, dtype=torch.int32)
    kv_len = torch.zeros(S, dtype=torch.int32)
    tables = torch.zeros((S, maxp), dtype=torch.int32)
    need = sum(-(-(kl + ql) // P) for kl, ql in descs[:-1])
    n_pages = need + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev).cpu() + 1
    row, used = 0, 0
    for d, (kl, ql) in enumerate(descs):
        q_start[d], q_len[d], kv_len[d] = row, ql, kl
        if d == len(descs) - 1:          # the split prompt's second half
            tables[d] = tables[d - 1]
        else:
            npg = -(-(kl + ql) // P)
            tables[d, :npg] = perm[used:used + npg]
            used += npg
        row += ql

    def rnd(*shape, dtype=qdt):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, kn, vn = rnd(T, h, D), rnd(T, kvh, D), rnd(T, kvh, D)
    if pdt == "int8":
        codes, scales = _int8_pools(gen, dev, kvh, n_pages, P, D)
        pools = codes + scales
    else:
        pools = [rnd(kvh, n_pages, P, D, dtype=pdt) for _ in range(2)]
    desc = [x.to(dev) for x in (q_start, q_len, kv_len, tables)]
    return q, kn, vn, pools, desc, len(descs)


def _ragged_call(fn, q, kn, vn, pools, desc):
    return fn(q, pools[0], pools[1], kn, vn, *desc, *pools[2:])


@pytest.mark.parametrize("qdt,pdt", RAGGED_MODES, ids=str)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("P,D", [(128, 128), (128, 64), (16, 128)])
def test_ragged_kernel_matches_plain_at_split_edges(dev, qdt, pdt, P, D, G):
    """Outputs within the coarser dtype's tolerance, pools (codes and
    scales) equal bit for bit, and every row without a query exactly
    zero though the output's memory held NaN before the call."""
    gen = torch.Generator(device=dev).manual_seed(31)
    q, kn, vn, pools, desc, live = _ragged_edge_case(dev, gen, qdt, pdt, P,
                                                     D, G)
    mine = [p.clone() for p in pools]
    plain = [p.clone() for p in pools]
    junk = torch.full((desc[0].shape[0], P, q.shape[1], D), float("nan"),
                      dtype=qdt, device=dev)
    junk_ptr = junk.data_ptr()
    del junk                       # the caching allocator hands it to out
    before = pa.ragged_paged_append_attend.launches
    got = _ragged_call(pa.ragged_paged_append_attend, q, kn, vn, mine, desc)
    want = _ragged_call(pa.ragged_paged_append_attend_reference, q, kn, vn,
                        plain, desc)
    torch.cuda.synchronize()
    assert got.data_ptr() == junk_ptr
    assert pa.ragged_paged_append_attend.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(mine, plain))
    tol = max(TOL[qdt], TOL.get(pdt, 0.0))
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    ql = desc[1].cpu()
    for s in range(got.shape[0]):
        assert not got[s, int(ql[s]):].any(), s


@pytest.mark.parametrize("qdt,pdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, "int8")], ids=str)
def test_ragged_kernel_is_bit_identical_on_two_launches(dev, qdt, pdt):
    gen = torch.Generator(device=dev).manual_seed(32)
    q, kn, vn, pools, desc, _ = _ragged_edge_case(dev, gen, qdt, pdt, 128,
                                                  128, 4)
    a = _ragged_call(pa.ragged_paged_append_attend, q, kn, vn, pools, desc)
    b = _ragged_call(pa.ragged_paged_append_attend, q, kn, vn, pools, desc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("qdt,pdt,design", [
    (torch.bfloat16, torch.bfloat16, "ragged_attend_mma"),
    (torch.float32, torch.bfloat16, "ragged_attend_3xtf32"),
    (torch.bfloat16, "int8", "ragged_attend_3xtf32")], ids=str)
def test_ragged_launch_is_the_new_kernels_alone(dev, qdt, pdt, design):
    """A call launches the append and its route's attention kernel (which
    merges its key splits), and nothing else."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(33)
    q, kn, vn, pools, desc, _ = _ragged_edge_case(dev, gen, qdt, pdt, 128,
                                                  128, 4)
    _ragged_call(pa.ragged_paged_append_attend, q, kn, vn, pools, desc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _ragged_call(pa.ragged_paged_append_attend, q, kn, vn, pools, desc)
        torch.cuda.synchronize()
    names = {ev.key.split("(")[0] for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert len(names) == 2, names
    assert sum("ragged_append<" in n for n in names) == 1, names
    assert sum(f"{design}<" in n for n in names) == 1, names


@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.bfloat16, None), (torch.float32, None), (torch.float32, "int8")],
    ids=["bf16", "f32", "int8"])
def test_swap_round_trip_is_exact_on_card_pools(dev, dtype, kv_dtype):
    """A slot's pages (and int8 scale rows) swap out through pinned host
    memory and back into other device pages byte for byte, and through
    an export/import into a second cache."""
    from paddle_tpu_torch.inference.paged_cache import PagedKVCache
    geom = dict(n_pages=12, page_size=16, n_kv_heads=2, head_dim=64,
                max_seqs=3, max_len=64, num_layers=2, dtype=dtype,
                kv_dtype=kv_dtype, swap_pool_pages=8, device=dev)
    cache = PagedKVCache(**geom)
    gen = torch.Generator(device=dev).manual_seed(10)
    slot = cache.allocate(40)
    for _ in range(37):
        k, v = (torch.randn((2, 1, 2, 64), generator=gen, device=dev)
                for _ in range(2))
        cache.append([slot], k, v)
    pages = list(cache._pages[slot][:3])
    want = [p[:, :, pages].clone() for p in cache._pools() if p is not None]
    handle = cache.swap_out(slot)
    hog = cache.allocate(16)                       # the old pages move on
    for p in cache._pools():
        if p is not None:
            p.normal_(generator=gen) if p.is_floating_point() else p.zero_()
    back = cache.swap_in(handle, 40)
    got = [p[:, :, cache._pages[back][:3]] for p in cache._pools()
           if p is not None]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cache.set_len(back, 37)
    other = PagedKVCache(**geom)
    moved = other.swap_in(other.import_swap(cache.export_swap(
        cache.swap_out(back))), 40)
    got = [p[:, :, other._pages[moved][:3]] for p in other._pools()
           if p is not None]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cache.release(hog)


def test_paged_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(2, 12, 128, device=dev, dtype=torch.bfloat16)
    pools = torch.zeros(4, 3, 8, 128, device=dev, dtype=torch.bfloat16)
    table = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    lens = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="GQA group 3"):
        pa.paged_attention(q, pools, pools, table, lens)
    with pytest.raises(ValueError, match="pools"):
        pa.paged_attention(q[:, :8], pools.double(), pools.double(), table,
                           lens)
    with pytest.raises(ValueError, match="both"):
        pa.paged_attention(q[:, :8], pools.to(torch.int8),
                           pools.to(torch.int8), table, lens,
                           torch.zeros(4, 3, 8, device=dev), None)
    odd = torch.zeros(4, 3, 6, 128, device=dev, dtype=torch.int8)
    scales = torch.zeros(4, 3, 6, device=dev)
    with pytest.raises(NotImplementedError, match="page size 6"):
        pa.paged_attention(q[:, :8], odd, odd, table, lens, scales, scales)


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


# The 16-bit routes of #2 and #4 (the wgmma kernels) at their edges:
# GQA groups 1/2/4/8, D 64 and 128, Sq and Sk off the 64/128 tiles,
# causal with off = Sk - Sq > 0, each broadcast mask shape, strided q
# and K/V views, 1024 keys (the copy ring cycles), and enough blocks for
# the forward's 128-row tiles (B H ceil(Sq / 128) >= the SM count) as
# well as its 64-row ones.  A mask marked "+rows" also hides every key of
# some rows, which the plain version weighs alike (each scores -1e30).
# With causal those rows lie in the last 64-row tile: a row above it sees
# only the keys its tile reaches (a key past them scores -inf, as the
# reference kernel skips the blocks past its tile's diagonal).
WGMMA_CASES = [
    # b, sq, sk, h, kvh, d, causal, mask shape (None: no mask)
    (1, 65, 65, 8, 8, 64, True, None),
    (2, 130, 200, 8, 4, 128, True, None),
    (1, 200, 200, 8, 2, 128, False, "b1qk"),
    (2, 65, 130, 8, 1, 64, False, "1h1k"),
    (1, 130, 1024, 4, 1, 128, True, "11qk"),
    (1, 200, 1024, 16, 2, 64, False, None),
    (2, 520, 520, 32, 4, 128, True, None),
    (1, 1000, 1000, 32, 8, 64, False, "11qk"),
    (1, 130, 200, 8, 2, 128, False, "11qk+rows"),
    (2, 200, 260, 8, 4, 64, True, "b1qk+rows"),
    (1, 300, 300, 64, 8, 128, True, "11qk+rows"),
]


def _wgmma_inputs(dev, dtype, b, sq, sk, h, kvh, d, causal, mshape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # q a strided view (two extra heads a row), k/v views of a [B, KVH,
    # Sk, D] buffer, like the engine's gathered pages
    q = rnd(b, sq, h + 2, d)[:, :, :h]
    kv = rnd(2, b, kvh, sk, d)
    k, v = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    mask = None
    if mshape is not None:
        kind, _, rows = mshape.partition("+")
        shape = {"b1qk": (b, 1, sq, sk), "1h1k": (1, h, 1, sk),
                 "11qk": (1, 1, sq, sk)}[kind]
        mask = torch.randn(shape, generator=gen, device=dev)
        mask[..., -(sk // 4):] = -1e30
        if rows:
            first = 64 * ((sq - 1) // 64) if causal else 0
            mask[..., first::3, :] = -1e30
            mask[..., -1, :] = -1e30
    return q, k, v, rnd(b, sq, h, d), mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,mshape", WGMMA_CASES)
def test_flash_wgmma_forward_matches_plain(dev, dtype, b, sq, sk, h, kvh, d,
                                           causal, mshape):
    q, k, v, _, mask = _wgmma_inputs(dev, dtype, b, sq, sk, h, kvh, d,
                                     causal, mshape, 6)
    got, lse = fa.flash_attention_fwd(q, k, v, causal=causal, mask=mask)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v,
                                                      causal=causal,
                                                      mask=mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,mshape", WGMMA_CASES)
def test_flash_wgmma_dkv_matches_plain(dev, dtype, b, sq, sk, h, kvh, d,
                                       causal, mshape):
    q, k, v, do, mask = _wgmma_inputs(dev, dtype, b, sq, sk, h, kvh, d,
                                      causal, mshape, 7)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, mask=mask)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, causal,
                                          mask)
    got = fa.flash_attention_bwd_dkv(*ops, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=causal, mask=mask)[1:]
    torch.cuda.synchronize()
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,mshape", WGMMA_CASES)
def test_flash_wgmma_dq_matches_plain(dev, dtype, b, sq, sk, h, kvh, d,
                                      causal, mshape):
    q, k, v, do, mask = _wgmma_inputs(dev, dtype, b, sq, sk, h, kvh, d,
                                      causal, mshape, 8)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, mask=mask)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, causal,
                                          mask)
    before = fa.flash_attention_bwd_dq.launches
    got = fa.flash_attention_bwd_dq(*ops, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=causal, mask=mask)[0]
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dq.launches == before + 1
    _assert_grads_close((got,), (want,), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,s,h,kvh,mshape", [
    (2, 130, 4, 4, None), (1, 200, 8, 2, (1, 1, 200, 200)),
    (1, 300, 16, 2, None)], ids=["group1", "group4-mask", "group8"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_flash_wgmma_dq_dropout_matches_plain(dev, dtype, d, b, s, h, kvh,
                                              mshape, p):
    """The 16-bit dQ kernel in dropout mode against the plain backward fed
    the same seed tensor: the same keep bits, so the undropped
    tolerances."""
    q, k, v, do = _attn_inputs(dev, dtype, b, s, s, h, kvh, d)
    mask = None
    if mshape is not None:
        gen = torch.Generator(device=dev).manual_seed(9)
        mask = torch.randn(mshape, generator=gen, device=dev)
        mask[..., -(s // 4):] = -1e30
    seed = torch.tensor(4321, dtype=torch.int64, device=dev)
    kw = dict(causal=True, mask=mask, dropout_p=p, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, mask)
    got = fa.flash_attention_bwd_dq(*ops, True, p, seed)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)[0]
    torch.cuda.synchronize()
    _assert_grads_close((got,), (want,), dtype)


def test_flash_wgmma_dq_is_bit_identical_on_two_launches(dev):
    """#3 writes each dQ row once, without atomics: two launches give the
    same bits."""
    q, k, v, do = _attn_inputs(dev, torch.bfloat16, 2, 700, 700, 16, 4,
                               128)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    first = fa.flash_attention_bwd_dq(*ops, True)
    second = fa.flash_attention_bwd_dq(*ops, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_wgmma_dkv_is_bit_identical_on_two_launches(dev):
    """#4 writes each kv head's dK/dV once, without atomics: two launches
    give the same bits."""
    q, k, v, do = _attn_inputs(dev, torch.bfloat16, 2, 700, 700, 16, 4,
                               128)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    first = fa.flash_attention_bwd_dkv(*ops, True)
    second = fa.flash_attention_bwd_dkv(*ops, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_forward_refuses_misaligned_q(dev):
    """The forward copies q in 16-byte chunks: a q row off a 16-byte
    boundary is refused, as misaligned K/V rows are."""
    buf = torch.zeros(1, 8, 2, 72, device=dev, dtype=torch.bfloat16)
    q = buf[..., 1:65]
    k = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(k, q, k)


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


REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


NORM_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
              (torch.float16, torch.float16), (torch.float16, torch.float32)]
# H 64 and 768 take a warp a row, 4096 a warpgroup, 8192 the block, 100
# the one-element path
NORM_WIDTHS = [64, 100, 768, 4096, 8192]


@pytest.mark.parametrize("hdim", NORM_WIDTHS)
@pytest.mark.parametrize("xdt,wdt", NORM_PAIRS, ids=str)
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


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp(min=1e-30)).item()


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh", "no_dh"])
@pytest.mark.parametrize("hdim", NORM_WIDTHS)
@pytest.mark.parametrize("xdt,wdt", NORM_PAIRS, ids=str)
@pytest.mark.parametrize("body", ["rms", "ln", "ln_bias"])
def test_add_norm_backward_kernel_matches_plain(dev, body, xdt, wdt, hdim,
                                                with_dh):
    """The backward kernel (``add_norm_bwd`` + ``add_norm_bwd_reduce``)
    against the plain backward on the forward kernel's h: dx, dw and db
    within relative L2 1e-5 (f32: sums in another order) or 2^-7 (a
    16-bit h or y: one rounding edge crossed), one launch counted a
    call, dw and db the same bits on a second call (no float atomics)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x, r, dh = (torch.randn(2, 19, hdim, generator=gen, device=dev).to(xdt)
                for _ in range(3))
    w = (1 + 0.2 * torch.randn(hdim, generator=gen, device=dev)).to(wdt)
    b = (0.2 * torch.randn(hdim, generator=gen, device=dev)).to(wdt) \
        if body == "ln_bias" else None
    dy = torch.randn(2, 19, hdim, generator=gen, device=dev).to(
        torch.promote_types(xdt, wdt))
    dh = dh if with_dh else None
    if body == "rms":
        h, _ = ft.add_rms_norm_raw(x, r, w, 1e-5)
        fn, plain = ft.add_rms_norm_backward_raw, \
            ft.add_rms_norm_backward_reference
        args = (h, w, dh, dy, 1e-5)
    else:
        h, _ = ft.add_layer_norm_raw(x, r, w, b, 1e-5)
        fn, plain = ft.add_layer_norm_backward_raw, \
            ft.add_layer_norm_backward_reference
        args = (h, w, b, dh, dy, 1e-5)
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    tol = 1e-5 if xdt == wdt == torch.float32 else \
        2.0 ** -10 if torch.float16 in (xdt, wdt) else 2.0 ** -7
    assert got[0].dtype == xdt and got[1].dtype == wdt
    for name, g, wnt in zip(("dx", "dw", "db"), got, want):
        if wnt is None:
            assert g is None
            continue
        assert _rel_l2(g, wnt) <= tol, (name, _rel_l2(g, wnt))
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert b is None or torch.equal(got[2], again[2])


@pytest.mark.parametrize("body", ["rms", "ln_bias"])
def test_add_norm_autograd_launches_the_backward_kernel(dev, body):
    """Through autograd, a call launches one forward and one backward; x
    and the residual, both leaves, get equal grads in their own storage;
    a CUDA tensor never reaches the plain backward."""
    gen = torch.Generator(device=dev).manual_seed(8)
    x, r = (torch.randn(4, 64, 768, generator=gen, device=dev,
                        dtype=torch.bfloat16).requires_grad_()
            for _ in range(2))
    w = torch.ones(768, device=dev, dtype=torch.bfloat16,
                   requires_grad=True)
    b = torch.zeros(768, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    fwd, bwd = ((ft.add_rms_norm_raw, ft.add_rms_norm_backward_raw)
                if body == "rms" else
                (ft.add_layer_norm_raw, ft.add_layer_norm_backward_raw))
    counts = (fwd.launches, bwd.launches)
    plain = ft._norm_backward_plain

    def refuse(*args):
        raise AssertionError("the plain backward ran on the card")

    ft._norm_backward_plain = refuse
    try:
        h, y = fwd(x, r, w, 1e-5) if body == "rms" else \
            fwd(x, r, w, b, 1e-5)
        (h.float().sum() + (y.float() ** 2).sum()).backward()
    finally:
        ft._norm_backward_plain = plain
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (counts[0] + 1, counts[1] + 1)
    assert torch.equal(x.grad, r.grad)
    assert x.grad.data_ptr() != r.grad.data_ptr()
    assert w.grad is not None and (body == "rms" or b.grad is not None)


# the mixed mode: a 16-bit x over an f32 residual (amp O1's post-norm
# block), with an f32 weight or one in x's dtype, either operand first
MIXED = [(torch.bfloat16, torch.float32), (torch.float16, torch.float32),
         (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16)]


@pytest.mark.parametrize("x_first", [True, False], ids=["x16", "r16"])
@pytest.mark.parametrize("hdim", [64, 100, 512, 768, 4096])
@pytest.mark.parametrize("xdt,wdt", MIXED, ids=str)
@pytest.mark.parametrize("body", ["rms", "ln", "ln_bias"])
def test_add_norm_mixed_mode_matches_plain(dev, body, xdt, wdt, hdim,
                                           x_first):
    """#9 with x and the residual in two dtypes: h (f32) equal to r + x,
    y within 1e-5 (h is f32, so y is f32 rounded once: 16-bit weights
    give an f32 y too), and its backward: the narrow operand's gradient
    within one rounding of its dtype (2^-7 bf16, 2^-10 f16, relative
    L2), the f32 one's and dw, db within 1e-5 (f32 weights) or 2^-7."""
    gen = torch.Generator(device=dev).manual_seed(11)
    narrow = torch.randn(2, 19, hdim, generator=gen, device=dev).to(xdt)
    wide = torch.randn(2, 19, hdim, generator=gen, device=dev)
    x, r = (narrow, wide) if x_first else (wide, narrow)
    w = (1 + 0.2 * torch.randn(hdim, generator=gen, device=dev)).to(wdt)
    b = (0.2 * torch.randn(hdim, generator=gen, device=dev)).to(wdt) \
        if body == "ln_bias" else None
    dy = torch.randn(2, 19, hdim, generator=gen, device=dev)
    if body == "rms":
        fwd, bwd = ft.add_rms_norm_raw, ft.add_rms_norm_backward_raw
        plain, plain_bwd = ft.add_rms_norm_reference, \
            ft.add_rms_norm_backward_reference
        fargs, wb = (w, 1e-5), (w,)
    else:
        fwd, bwd = ft.add_layer_norm_raw, ft.add_layer_norm_backward_raw
        plain, plain_bwd = ft.add_layer_norm_reference, \
            ft.add_layer_norm_backward_reference
        fargs, wb = (w, b, 1e-5), (w, b)
    counts = (fwd.launches, bwd.launches)
    h, y = fwd(x, r, *fargs)
    want_h, want_y = plain(x, r, *fargs)
    (dn, dr), dw, db = bwd(h, *wb, None, dy, 1e-5, x_dtype=xdt)
    want_d, want_dw, want_db = plain_bwd(want_h, *wb, None, dy, 1e-5)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (counts[0] + 1, counts[1] + 1)
    assert h.dtype == y.dtype == torch.float32 and torch.equal(h, want_h)
    assert _rel(y, want_y) <= 1e-5
    assert dn.dtype == xdt and dr.dtype == torch.float32
    tol_w = 1e-5 if wdt == torch.float32 else REL_TOL[wdt]
    assert _rel_l2(dr, want_d) <= 1e-5
    assert _rel_l2(dn, want_d.to(xdt)) <= REL_TOL[xdt]
    assert _rel_l2(dw, want_dw) <= tol_w
    assert db is None or _rel_l2(db, want_db) <= tol_w


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16], ids=str)
def test_add_norm_mixed_mode_autograd(dev, xdt):
    """Through autograd in the mixed mode: one forward and one backward
    launch; x's gradient in x's dtype, the residual's in f32, the same
    values rounded once; the plain backward never runs."""
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(32, 120, 512, generator=gen, device=dev).to(
        xdt).requires_grad_()
    r = torch.randn(32, 120, 512, generator=gen, device=dev,
                    requires_grad=True)
    w = torch.ones(512, device=dev, requires_grad=True)
    b = torch.zeros(512, device=dev, requires_grad=True)
    counts = (ft.add_layer_norm_raw.launches,
              ft.add_layer_norm_backward_raw.launches)
    plain = ft._norm_backward_plain

    def refuse(*args):
        raise AssertionError("the plain backward ran on the card")

    ft._norm_backward_plain = refuse
    try:
        _, y = ft.add_layer_norm_raw(x, r, w, b, 1e-5)
        (y ** 2).sum().backward()
    finally:
        ft._norm_backward_plain = plain
    torch.cuda.synchronize()
    assert (ft.add_layer_norm_raw.launches,
            ft.add_layer_norm_backward_raw.launches) == (counts[0] + 1,
                                                          counts[1] + 1)
    assert x.grad.dtype == xdt and r.grad.dtype == torch.float32
    assert torch.equal(x.grad, r.grad.to(xdt))


# -- #2-#4 at the encoder-decoder Transformer's shapes ----------------------

def _neg_inf_mask(dev, b, sq, sk, causal, seed):
    """The decoder's additive masks: -inf above the diagonal (causal)
    and on each row's trailing padded keys (0-31 of them, fewer than
    Sk: every row keeps a key)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    m = torch.zeros(b, 1, sq if causal else 1, sk)
    for i in range(b):
        n = int(torch.randint(0, min(32, sk), (1,), generator=gen))
        if n:
            m[i, ..., sk - n:] = float("-inf")
    if causal:
        m = m + torch.full((sq, sk), float("-inf")).triu(1)
    return m.to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("b,sq,sk,causal", [
    (4, 120, 120, True),          # target self attention
    (4, 120, 128, False),         # cross attention over the memory
    (8, 1, 1, False),             # the first decode step
    (8, 1, 33, False),            # a later one
], ids=["self", "cross", "decode1", "decode33"])
def test_flash_kernels_at_decoder_shapes_match_plain(dev, dtype, b, sq, sk,
                                                     causal):
    """#2-#4 at the Transformer's shapes (8 heads of 64): an additive
    mask with -inf entries (the subsequent mask plus key padding, or key
    padding alone), Sq != Sk, and one-token decoding from one key: out
    within one output rounding, gradients within the flash backward
    tolerances of the largest gradient element."""
    q, k, v, do = _attn_inputs(dev, dtype, b, sq, sk, 8, 8, 64, seed=13)
    mask = _neg_inf_mask(dev, b, sq, sk, causal, 13)
    tol = 2e-3 if dtype == torch.float16 else 1e-2
    counts = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, mask=mask)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, mask=mask)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, mask=mask)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, mask=mask)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(
                c + 1 for c in counts)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-3
    # relative to the largest gradient element of the three: from one key
    # (Sk 1) dq and dk are zero in exact arithmetic, rounding noise alone
    scale = max(w.float().abs().max().item() for w in ref)
    for g, w in zip(got, ref):
        assert torch.isfinite(g).all()
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


def test_flash_attention_promotes_mixed_dtypes(dev):
    """An amp O2 decoder's bf16 queries against its f32 cache: the entry
    casts q to f32 (the operands' common dtype), the f32 route runs, the
    output is f32, as the reference's jnp attention promotes."""
    q, k, v, _ = _attn_inputs(dev, torch.float32, 2, 1, 9, 8, 8, 64,
                              seed=14)
    q16 = q.bfloat16()
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_raw(q16, k, v)
    want = fa.flash_attention_fwd_reference(q16.float(), k, v)[0]
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert out.dtype == torch.float32
    assert (out - want).abs().max().item() <= 1e-4


def _rope_case(dev, dtype, b, s, k, heads, d, table_dtype=None):
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(b, s, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(k, heads * d, generator=gen, device=dev)
         / k ** 0.5).to(dtype)
    ang = torch.rand(s, d // 2, generator=gen, device=dev) * 50
    ang = torch.cat([ang, ang], dim=-1)
    tdt = table_dtype or dtype
    return gen, x, w, ang.cos().to(tdt), ang.sin().to(tdt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,s,k,heads,d", [
    (1, 96, 256, 8, 128),      # fewer rows than one 128-row tile
    (2, 96, 200, 32, 128),     # tiles across the batch boundary; K % 64
    (2, 130, 256, 8, 64),
    (1, 257, 64, 32, 64),
    (3, 50, 200, 3, 64),       # M 150 off the tile, K 200, odd heads at D 64
    (2, 100, 1000, 4, 128),    # K 1000: the 4-stage ring wraps 4 times
    (1, 129, 520, 5, 64),      # one row past a tile, K 520 (9 slices)
    (1, 300, 72, 2, 128)])     # K 72: the second slice mostly past K
def test_matmul_rope_kernel_matches_plain(dev, dtype, b, s, k, heads, d):
    gen, x, w, cos, sin = _rope_case(dev, dtype, b, s, k, heads, d)
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


@pytest.mark.parametrize("dtype,table_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)],
    ids=str)
@pytest.mark.parametrize("d", [64, 128])
def test_matmul_rope_kernel_reads_tables_as_they_are(dev, dtype,
                                                     table_dtype, d):
    """Tables of the other dtype than x: the kernel widens them in
    registers, exactly as the plain version's ``.float()`` does."""
    _, x, w, cos, sin = _rope_case(dev, dtype, 2, 150, 256, 4, d,
                                   table_dtype)
    got = ft.matmul_rope_raw(x, w, cos, sin, n_heads=4, head_dim=d)
    want = ft.matmul_rope_reference(x, w, cos, sin, 4, d)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel(got, want) <= REL_TOL[dtype], _rel(got, want)


def test_matmul_rope_bf16_launch_is_the_kernel_alone(dev):
    """A bf16 call with bf16 tables launches #10 and nothing else: no
    cast of x, W or the tables before it."""
    from torch.profiler import ProfilerActivity, profile
    _, x, w, cos, sin = _rope_case(dev, torch.bfloat16, 1, 256, 512, 8, 128)

    def run():
        return ft.matmul_rope_raw(x, w, cos, sin, n_heads=8, head_dim=128)

    run()                                    # the build and first launch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("matmul_rope_wgmma" in n for n in names), names


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


# The bf16 routes of #11 and #13 (gmm_wgmma, dw_wgmma: TMA ring + wgmma)
# at Qwen1.5-MoE's training widths (H 2048, F 1408, 60 experts, tm 256),
# cut in rows: 1024 tokens x top-4 spread over the experts, or 4096
# tokens x top-1 with 7/8 of them on one hot expert; expert 2 empty.
MOE_H, MOE_F, MOE_E, MOE_TM = 2048, 1408, 60, 256


def _moe_rows(dev, gen, *, hot):
    """The plan of the routes above over MOE_E experts and its padded
    buffer's row mask [m_pad, 1]."""
    t, k = (4096, 1) if hot else (1024, 4)
    scores = torch.rand(t, MOE_E, generator=gen, device=dev)
    scores[:, 2] = -1.0
    if hot:
        scores[: 7 * t // 8, 1] = 2.0
    idx = scores.topk(k, dim=-1).indices
    order, dest, te, counts, m_pad = gm.make_dropless_plan(idx, MOE_E,
                                                           MOE_TM)
    live = torch.zeros(m_pad, 1, dtype=torch.bool, device=dev)
    live[dest] = True
    return te, counts, live


def _moe_stack(gen, dev, *shape):
    return (torch.randn(shape, generator=gen, device=dev)
            / shape[1] ** 0.5).to(torch.bfloat16)


def _moe_buffer(gen, dev, live, n, padding=0.0):
    """[m_pad, n] bf16 rows: random on the routed rows, ``padding`` on
    the others."""
    x = torch.randn(live.shape[0], n, generator=gen, device=dev)
    return torch.where(live, x, torch.full_like(x, padding)).to(
        torch.bfloat16)


@pytest.mark.parametrize("hot", [False, True], ids=["spread", "hot"])
@pytest.mark.parametrize("case", ["gate", "down", "down_dx", "gate_dx"])
def test_gmm_wgmma_at_the_moe_training_widths(dev, case, hot):
    """#11 forward (gate and down) and transpose_w (the down and gate
    dX) against the plain version, relative L2 2^-7."""
    gen = torch.Generator(device=dev).manual_seed(21)
    te, counts, live = _moe_rows(dev, gen, hot=hot)
    wg = _moe_stack(gen, dev, MOE_E, MOE_H, MOE_F)
    wd = _moe_stack(gen, dev, MOE_E, MOE_F, MOE_H)
    w, k, transpose_w = {"gate": (wg, MOE_H, False),
                         "down": (wd, MOE_F, False),
                         "down_dx": (wd, MOE_H, True),
                         "gate_dx": (wg, MOE_F, True)}[case]
    lhs = _moe_buffer(gen, dev, live, k)
    want = gm.gmm_reference(lhs, w, te, transpose_w=transpose_w)
    got = gm.gmm_raw(lhs, w, te, transpose_w=transpose_w, counts=counts)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel_l2(got, want) <= REL_TOL[torch.bfloat16], _rel_l2(got, want)
    assert not got[~live[:, 0]].any()


@pytest.mark.parametrize("hot", [False, True], ids=["spread", "hot"])
@pytest.mark.parametrize("case", ["gate_dw", "down_dw"])
def test_gmm_dw_wgmma_at_the_moe_training_widths(dev, case, hot):
    """#13 for the gate and down weights against the plain version,
    relative L2 2^-7; the empty expert's gradient exactly zero."""
    gen = torch.Generator(device=dev).manual_seed(22)
    te, counts, live = _moe_rows(dev, gen, hot=hot)
    k, n = (MOE_H, MOE_F) if case == "gate_dw" else (MOE_F, MOE_H)
    lhs, dout = (_moe_buffer(gen, dev, live, c) for c in (k, n))
    want = gm.gmm_dw_reference(lhs, dout, te, counts, MOE_E)
    got = gm.gmm_dw_raw(lhs, dout, te, counts, MOE_E)
    torch.cuda.synchronize()
    assert got.shape == (MOE_E, k, n) and got.dtype == torch.bfloat16
    assert int(counts[2]) == 0 and torch.equal(got[2],
                                               torch.zeros_like(got[2]))
    assert _rel_l2(got, want) <= REL_TOL[torch.bfloat16], _rel_l2(got, want)


@pytest.mark.parametrize("transpose_w", [False, True], ids=["nn", "nt"])
def test_gmm_wgmma_gives_padding_rows_zeros(dev, transpose_w):
    """Padding rows full of NaN: #11 gives them zero rows and every other
    row as the plain version fed the buffer with the padding zeroed."""
    gen = torch.Generator(device=dev).manual_seed(23)
    e, kdim, n = 6, 264, 200
    xs, te, counts = _plan_rows(dev, gen, torch.bfloat16, t=300, k=3, e=e,
                                h=kdim, tm=256)
    live = gm.routed_rows(te, counts, xs.shape[0])[:, None]
    dirty = torch.where(live, xs, torch.full_like(xs, float("nan")))
    shape = (e, n, kdim) if transpose_w else (e, kdim, n)
    w = (torch.randn(shape, generator=gen, device=dev) / kdim ** 0.5).to(
        torch.bfloat16)
    want = gm.gmm_reference(xs, w, te, transpose_w=transpose_w)
    got = gm.gmm_raw(dirty, w, te, transpose_w=transpose_w, counts=counts)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got[~live[:, 0]].any()
    assert _rel_l2(got, want) <= REL_TOL[torch.bfloat16], _rel_l2(got, want)


def test_gmm_dw_wgmma_never_reads_padding_rows(dev):
    """Padding rows of lhs and dout full of NaN (the last slice of each
    expert overruns its count into them): #13's sums are those of the
    plain version fed the same buffers with the padding zeroed."""
    gen = torch.Generator(device=dev).manual_seed(24)
    e, kdim, n = 6, 264, 200
    xs, te, counts = _plan_rows(dev, gen, torch.bfloat16, t=300, k=3, e=e,
                                h=kdim, tm=256)
    live = gm.routed_rows(te, counts, xs.shape[0])[:, None]
    dout = torch.randn(xs.shape[0], n, generator=gen, device=dev).to(
        torch.bfloat16) * live
    want = gm.gmm_dw_reference(xs, dout, te, counts, e)
    nan = float("nan")
    got = gm.gmm_dw_raw(torch.where(live, xs, torch.full_like(xs, nan)),
                        torch.where(live, dout, torch.full_like(dout, nan)),
                        te, counts, e)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert _rel_l2(got, want) <= REL_TOL[torch.bfloat16], _rel_l2(got, want)


def test_gmm_wgmma_reads_no_other_experts_weights(dev):
    """K 264 ends inside a 64-deep slice: the weights are read through a
    3-D map whose edge is each expert's own, so expert 1's last slice
    zero-fills past row 264 and never reaches expert 2's weights (all
    inf here, and no row is routed to it)."""
    gen = torch.Generator(device=dev).manual_seed(25)
    e, kdim, n = 6, 264, 200
    xs, te, counts = _plan_rows(dev, gen, torch.bfloat16, t=300, k=3, e=e,
                                h=kdim, tm=128)
    for transpose_w in (False, True):
        shape = (e, n, kdim) if transpose_w else (e, kdim, n)
        w = (torch.randn(shape, generator=gen, device=dev)
             / kdim ** 0.5).to(torch.bfloat16)
        w[2] = float("inf")
        want = gm.gmm_reference(xs, w, te, transpose_w=transpose_w)
        got = gm.gmm_raw(xs, w, te, transpose_w=transpose_w, counts=counts)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), transpose_w
        assert _rel_l2(got, want) <= REL_TOL[torch.bfloat16], \
            (transpose_w, _rel_l2(got, want))


@pytest.mark.parametrize("kernel", ["gmm", "gmm_t", "gmm_dw"])
def test_grouped_wgmma_is_bit_identical_on_two_launches(dev, kernel):
    gen = torch.Generator(device=dev).manual_seed(26)
    te, counts, live = _moe_rows(dev, gen, hot=True)
    lhs = _moe_buffer(gen, dev, live, MOE_F)
    if kernel == "gmm_dw":
        dout = _moe_buffer(gen, dev, live, MOE_H)
        run = lambda: gm.gmm_dw_raw(lhs, dout, te, counts, MOE_E)  # noqa: E731
    else:
        t = kernel == "gmm_t"
        w = _moe_stack(gen, dev, MOE_E, MOE_H, MOE_F) if t \
            else _moe_stack(gen, dev, MOE_E, MOE_F, MOE_H)
        run = lambda: gm.gmm_raw(lhs, w, te, transpose_w=t,  # noqa: E731
                                 counts=counts)
    a, b = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_grouped_bf16_launches_are_the_wgmma_kernels_alone(dev):
    """A bf16 #11 call (either transpose_w) and a bf16 #13 call each
    launch their wgmma kernel and nothing else."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(27)
    xs, te, counts = _plan_rows(dev, gen, torch.bfloat16, t=300, k=3, e=6,
                                h=256, tm=128)
    w = (torch.randn(6, 256, 256, generator=gen, device=dev) / 16).to(
        torch.bfloat16)
    for want, run in (
            ("gmm_wgmma", lambda: gm.gmm_raw(xs, w, te, counts=counts)),
            ("gmm_wgmma", lambda: gm.gmm_raw(xs, w, te, transpose_w=True,
                                             counts=counts)),
            ("dw_wgmma", lambda: gm.gmm_dw_raw(xs, xs, te, counts, 6))):
        run()                                # the build and first launch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        assert names and all(want in nm for nm in names), names


# The bf16 #12 (glu_wgmma: TMA ring + wgmma, 128 x 128 of both products)
# at Qwen1.5-MoE's training widths cut in rows, and at its edges.


@pytest.mark.parametrize("save_pre", [False, True], ids=["hs", "save_pre"])
@pytest.mark.parametrize("hot", [False, True], ids=["spread", "hot"])
def test_gmm_glu_wgmma_at_the_moe_training_widths(dev, hot, save_pre):
    """#12 against the plain version, relative L2 2^-7 on hs (and hg,
    hu); the empty expert's and padding rows exactly zero."""
    gen = torch.Generator(device=dev).manual_seed(41)
    te, counts, live = _moe_rows(dev, gen, hot=hot)
    wg = _moe_stack(gen, dev, MOE_E, MOE_H, MOE_F)
    wu = _moe_stack(gen, dev, MOE_E, MOE_H, MOE_F)
    lhs = _moe_buffer(gen, dev, live, MOE_H)
    want = gm.gmm_glu_reference(lhs, wg, wu, te, save_pre=save_pre)
    got = gm.gmm_glu_raw(lhs, wg, wu, te, save_pre=save_pre, counts=counts)
    torch.cuda.synchronize()
    assert int(counts[2]) == 0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert _rel_l2(a, b) <= REL_TOL[torch.bfloat16], _rel_l2(a, b)
        assert not a[~live[:, 0]].any()


def test_gmm_glu_wgmma_gives_padding_rows_zeros(dev):
    """Padding rows full of NaN: hs, hg and hu get zero rows there and
    every other row as the plain version fed the buffer with the padding
    zeroed."""
    gen = torch.Generator(device=dev).manual_seed(42)
    e, kdim, n = 6, 264, 200
    xs, te, counts = _plan_rows(dev, gen, torch.bfloat16, t=300, k=3, e=e,
                                h=kdim, tm=256)
    live = gm.routed_rows(te, counts, xs.shape[0])[:, None]
    dirty = torch.where(live, xs, torch.full_like(xs, float("nan")))
    wg, wu = ((torch.randn(e, kdim, n, generator=gen, device=dev)
               / kdim ** 0.5).to(torch.bfloat16) for _ in range(2))
    want = gm.gmm_glu_reference(xs, wg, wu, te, save_pre=True)
    got = gm.gmm_glu_raw(dirty, wg, wu, te, save_pre=True, counts=counts)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert not a[~live[:, 0]].any()
        assert _rel_l2(a, b) <= REL_TOL[torch.bfloat16], _rel_l2(a, b)


def test_gmm_glu_wgmma_reads_no_other_experts_weights(dev):
    """K 264 ends inside a 64-deep slice and N 200 inside a 64-column box:
    the weights are read through 3-D maps whose edges are each expert's
    own, so no block reaches expert 2's weights (all inf, no row routed
    to it)."""
    gen = torch.Generator(device=dev).manual_seed(43)
    e, kdim, n = 6, 264, 200
    xs, te, counts = _plan_rows(dev, gen, torch.bfloat16, t=300, k=3, e=e,
                                h=kdim, tm=128)
    wg, wu = ((torch.randn(e, kdim, n, generator=gen, device=dev)
               / kdim ** 0.5).to(torch.bfloat16) for _ in range(2))
    wg[2] = float("inf")
    wu[2] = float("inf")
    want = gm.gmm_glu_reference(xs, wg, wu, te, save_pre=True)
    got = gm.gmm_glu_raw(xs, wg, wu, te, save_pre=True, counts=counts)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) <= REL_TOL[torch.bfloat16], _rel_l2(a, b)


def test_gmm_glu_wgmma_is_bit_identical_on_two_launches(dev):
    gen = torch.Generator(device=dev).manual_seed(44)
    te, counts, live = _moe_rows(dev, gen, hot=True)
    wg = _moe_stack(gen, dev, MOE_E, MOE_H, MOE_F)
    wu = _moe_stack(gen, dev, MOE_E, MOE_H, MOE_F)
    lhs = _moe_buffer(gen, dev, live, MOE_H)
    a = gm.gmm_glu_raw(lhs, wg, wu, te, save_pre=True, counts=counts)
    b = gm.gmm_glu_raw(lhs, wg, wu, te, save_pre=True, counts=counts)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gmm_glu_bf16_launch_is_the_wgmma_kernel_alone(dev):
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(45)
    xs, te, counts = _plan_rows(dev, gen, torch.bfloat16, t=300, k=3, e=6,
                                h=256, tm=128)
    w = (torch.randn(6, 256, 256, generator=gen, device=dev) / 16).to(
        torch.bfloat16)
    gm.gmm_glu_raw(xs, w, w, te, counts=counts)   # the build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for save_pre in (False, True):
            gm.gmm_glu_raw(xs, w, w, te, save_pre=save_pre, counts=counts)
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("glu_wgmma" in nm for nm in names), names


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
    # float16 and a 16-bit x over an f32 residual are #9's modes; two
    # 16-bit dtypes, or a weight in the other 16-bit dtype, are not
    with pytest.raises(NotImplementedError, match="one 16-bit over float32"):
        ft.add_rms_norm_raw(x, x.bfloat16(), w)
    with pytest.raises(NotImplementedError, match="one 16-bit over float32"):
        ft.add_rms_norm_raw(x.bfloat16(), x.bfloat16(), w.half())
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
    # interleaved rope takes the plain version on the knob, as the
    # reference's kernel declines it: no launch
    before = ft.matmul_rope_raw.launches
    w = torch.randn(96, 64, device=dev).to(torch.bfloat16)
    got = ft.matmul_rope_raw(x + 1, w, cos, cos, n_heads=1, head_dim=64,
                             interleaved=True)
    want = ft.matmul_rope_reference(x + 1, w, cos, cos, 1, 64,
                                    interleaved=True)
    assert ft.matmul_rope_raw.launches == before
    assert torch.equal(got, want)


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
    """Float pools of another dtype than the weights serve on the card
    (the kernels' mixed-dtype mode; f32 by default, as the reference's),
    int8 pools too; a pool dtype no kernel takes (float64) is refused."""
    import dataclasses

    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    # head_dim 64 (the kernels take 64 and 128), GQA group 2
    cfg = dataclasses.replace(llama_tiny_config(), hidden_size=128,
                              num_attention_heads=2, num_key_value_heads=1)
    m = LlamaForCausalLM(cfg, device=dev)
    with pytest.raises(ValueError, match="pool dtype"):
        LLMEngine(m, max_len=64, page_size=8, dtype=torch.float64)
    for kw, pools in (({"kv_dtype": "bfloat16"}, torch.bfloat16),
                      ({"dtype": torch.float16}, torch.float16),
                      ({"kv_dtype": "int8"}, torch.int8)):
        eng = LLMEngine(m, max_len=64, page_size=8, **kw)
        assert eng.cache.k_pages.dtype == pools
        eng.begin_request("a", [1, 2, 3], max_new_tokens=3)
        while eng.has_work():
            eng.step()
        assert len(eng.result("a")) == 3
    mb = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    eng = LLMEngine(mb, max_len=64, page_size=8, unified_step=False)
    assert eng.cache.k_pages.dtype == torch.float32
    eng.add_request("b", [4, 5, 6], max_new_tokens=3)
    while eng.has_work():
        eng.step()
    assert len(eng.result("b")) == 3


def test_plain_paths_refuse_cuda_tensors(dev):
    """``use_flash_attention=False`` (plain PyTorch attention) raises on
    the card.  ``fused_step=False`` and the per-leaf ``apply_gradients``
    are the reference's own update path, chosen as the reference chooses
    it, so they run on the card: a ``fused_step=False`` step updates the
    parameters without launching the update kernel, and the per-leaf
    step returns new parameters and state on the card."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.jit.train import CompiledTrainStep
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.ops import fused_train as ft
    cfg = llama_tiny_config()
    cfg.fuse_norm_rope = False
    cfg.use_flash_attention = False
    m = LlamaForCausalLM(cfg, device=dev)
    with pytest.raises(NotImplementedError, match="flash kernels"):
        m(torch.zeros(1, 8, dtype=torch.long, device=dev))
    # the flash kernels take head_dim 64 or 128: two heads of 64
    cfg.use_flash_attention = True
    cfg.hidden_size, cfg.num_attention_heads = 128, 2
    cfg.num_key_value_heads = 1
    m = LlamaForCausalLM(cfg, device=dev)
    opt = optim.AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = CompiledTrainStep(m, lambda mm, b: mm(b["x"], labels=b["x"]),
                             opt, fused_step=False)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    launches = ft.fused_update_flat.launches
    loss = step({"x": torch.randint(0, cfg.vocab_size, (1, 8), device=dev)})
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and ft.fused_update_flat.launches == launches
    assert any(not torch.equal(before[n], p)
               for n, p in m.named_parameters())
    params = {n: p.detach() for n, p in m.named_parameters()}
    new_p, st = opt.apply_gradients(params, params, opt.init_state(params))
    assert all(new_p[n].device == p.device and new_p[n].shape == p.shape
               and torch.isfinite(new_p[n]).all() for n, p in params.items())
    assert st["step"].is_cuda and int(st["step"]) == 1


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_flash_forward_keep_bits_equal_the_plain_mask(dev, p, dtype):
    """The forward kernel's keep mask, read through V = I (each output
    row is the row's dropped probabilities over l), equals
    ``dropout_keep`` bit for bit, and keeps about 1 - p: on the FMA
    kernel (f32) and on the fragment-indexed bits of the wgmma kernel
    (bf16, f16)."""
    b, s, h, d = 2, 64, 3, 64
    q, k, _, _ = _attn_inputs(dev, dtype, b, s, s, h, h, d)
    eye = torch.eye(s, device=dev, dtype=dtype)[None, :, None, :].expand(
        b, s, h, d)
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


# -- #11's f32-row route (gmm_rows_stream) and #2's f32 route
# (flash_fwd_3xtf32) ---------------------------------------------------------

F32_GMM_CASES = [c for c in GMM_CASES if c[0] == torch.float32]


def _serving_plan(dev, gen, slots, tm=128, empty=(2,)):
    """The serving path's plan of ``slots`` routed rows (top-4 of random
    router scores over MOE_E experts; the experts in ``empty`` get none)
    at row tile ``tm``: (te, counts, routed-row mask [m_pad, 1])."""
    t = slots // 4
    scores = torch.rand(t, MOE_E, generator=gen, device=dev)
    scores[:, list(empty)] = -1.0
    idx = scores.topk(4, dim=-1).indices
    _, dest, te, counts, m_pad = gm.make_dropless_plan(idx, MOE_E, tm)
    live = torch.zeros(m_pad, 1, dtype=torch.bool, device=dev)
    live[dest] = True
    return te, counts, live


@pytest.mark.parametrize("adt,wdt,tm", F32_GMM_CASES, ids=str)
def test_gmm_rows_stream_matches_plain(dev, adt, wdt, tm):
    """Every f32 entry of GMM_CASES on the streaming kernel, with and
    without counts, 1e-5 relative L2; rows past the counts exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(31)
    e, kdim, n = 6, 264, 200
    xs, te, counts = _plan_rows(dev, gen, adt, t=300, k=3, e=e, h=kdim,
                                tm=tm)
    w = (torch.randn(e, kdim, n, generator=gen, device=dev)
         / kdim ** 0.5).to(wdt)
    want = gm.gmm_reference(xs, w, te)
    live = gm.routed_rows(te, counts, xs.shape[0])
    for cnt in (counts, None):
        got = gm.gmm_raw(xs, w, te, counts=cnt)
        torch.cuda.synchronize()
        assert _rel_l2(got, want) <= REL_TOL[adt], _rel_l2(got, want)
    assert not gm.gmm_raw(xs, w, te, counts=counts)[~live].any()


@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("slots", [32, 544], ids=["decode", "mixed"])
@pytest.mark.parametrize("proj", ["gate", "down"])
def test_gmm_rows_stream_at_the_serving_widths(dev, proj, slots, wdt):
    """Qwen1.5-MoE's serving FFN (60 experts, H 2048, F 1408, tm 128) at
    a decode step (32 slots) and a mixed step (544): f32 rows against the
    gate [60, 2048, 1408] or down [60, 1408, 2048] stack, 1e-5 relative
    L2; padding rows and dead tiles exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(32)
    te, counts, live = _serving_plan(dev, gen, slots)
    k, n = (MOE_H, MOE_F) if proj == "gate" else (MOE_F, MOE_H)
    w = (torch.randn(MOE_E, k, n, generator=gen, device=dev)
         / k ** 0.5).to(wdt)
    xs = torch.randn(live.shape[0], k, generator=gen, device=dev) * live
    want = gm.gmm_reference(xs, w, te)
    got = gm.gmm_raw(xs, w, te, counts=counts)
    torch.cuda.synchronize()
    assert _rel_l2(got, want) <= REL_TOL[torch.float32], _rel_l2(got, want)
    assert torch.equal(got[~live[:, 0]],
                       torch.zeros_like(got[~live[:, 0]]))


def test_gmm_rows_stream_reads_no_padding_and_no_unrouted_weights(dev):
    """NaN in every padding row of lhs and inf in the weights of the
    experts without rows (2, and 3 after it): the streaming kernel reads
    neither, so its output is finite, its padding rows 0 and the rest
    the plain version's on the clean buffer."""
    gen = torch.Generator(device=dev).manual_seed(33)
    te, counts, live = _serving_plan(dev, gen, 544, empty=(2, 3))
    w = (torch.randn(MOE_E, MOE_H, MOE_F, generator=gen, device=dev)
         / MOE_H ** 0.5).to(torch.bfloat16)
    xs = torch.randn(live.shape[0], MOE_H, generator=gen, device=dev) * live
    want = gm.gmm_reference(xs, w, te)
    w[2:4] = float("inf")
    dirty = torch.where(live, xs, torch.full_like(xs, float("nan")))
    got = gm.gmm_raw(dirty, w, te, counts=counts)
    torch.cuda.synchronize()
    assert int(counts[2]) == int(counts[3]) == 0
    assert torch.isfinite(got).all()
    assert not got[~live[:, 0]].any()
    assert _rel_l2(got, want) <= REL_TOL[torch.float32], _rel_l2(got, want)


def test_gmm_rows_stream_is_bit_identical_and_alone(dev):
    """Two launches give the same bits; a call launches the streaming
    kernel and nothing else, and counts one launch."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(34)
    te, counts, live = _serving_plan(dev, gen, 544)
    w = _moe_stack(gen, dev, MOE_E, MOE_F, MOE_H)
    xs = torch.randn(live.shape[0], MOE_F, generator=gen, device=dev) * live
    before = gm.gmm_raw.launches
    a = gm.gmm_raw(xs, w, te, counts=counts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        b = gm.gmm_raw(xs, w, te, counts=counts)
        torch.cuda.synchronize()
    assert gm.gmm_raw.launches == before + 2
    assert torch.equal(a, b)
    names = [ev.key for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("gmm_rows_stream" in nm for nm in names), names


# the f32 forward at the geometries of the 16-bit route's cases, at the
# split path's prefill chunk (q [1, 128, 32, 128] against 1024 keys of 8
# kv heads under a -1e30-striped position mask: 32 blocks of 128 rows at
# D 128, so the keys split), and causal with few blocks, whose first row
# tile reaches fewer key tiles than there are splits (empty splits)
TF32_CASES = WGMMA_CASES + [
    (1, 128, 1024, 32, 8, 128, False, "11qk"),
    (1, 128, 1024, 32, 8, 64, False, "11qk+rows"),
    (1, 130, 130, 4, 2, 64, True, None),
    (1, 200, 600, 2, 1, 128, True, "11qk+rows"),
]


def _f32_splits(b, sq, sk, h, d, dropout=False):
    n = ctypes.c_int()
    fa._kernel().flash_attention_fwd_workspace(b, h, sq, sk, d,
                                               int(dropout), ctypes.byref(n))
    return n.value


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,mshape", TF32_CASES)
def test_flash_3xtf32_forward_matches_plain(dev, b, sq, sk, h, kvh, d,
                                            causal, mshape):
    """The f32 route against the plain version: 1e-5 relative L2, 1e-4
    absolute, lse within 1e-3; one launch counted a call, key splits or
    not."""
    q, k, v, _, mask = _wgmma_inputs(dev, torch.float32, b, sq, sk, h, kvh,
                                     d, causal, mshape, 7)
    before = fa.flash_attention_fwd.launches
    got, lse = fa.flash_attention_fwd(q, k, v, causal=causal, mask=mask)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v,
                                                      causal=causal,
                                                      mask=mask)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


def test_flash_3xtf32_splits_where_blocks_are_few(dev):
    """The prefill chunk and the few-block causal case take key splits;
    GPT-2's training attention, whose blocks fill the card, takes none."""
    assert _f32_splits(1, 128, 1024, 32, 128) > 1
    assert _f32_splits(1, 130, 130, 4, 64) > 1
    assert _f32_splits(8, 1024, 1024, 12, 64, dropout=True) == 1


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_flash_3xtf32_dropout_with_key_splits(dev, p):
    """Dropout on the split route (few blocks, 600 keys): the plain
    version's keep bits, f32 tolerances."""
    q, k, v, _ = _attn_inputs(dev, torch.float32, 1, 300, 600, 2, 1, 64)
    assert _f32_splits(1, 300, 600, 2, 64, dropout=True) > 1
    seed = torch.tensor(4321, dtype=torch.int64, device=dev)
    kw = dict(causal=True, dropout_p=p, seed=seed)
    got, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


def test_flash_3xtf32_launches_its_kernels_alone(dev):
    """An f32 call launches flash_fwd_3xtf32 (and, with key splits, its
    merge kernel) and nothing else."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, _, mask = _wgmma_inputs(dev, torch.float32, 1, 128, 1024, 32,
                                     8, 128, False, "11qk", 8)
    for split in (True, False):
        # 8 sequences of 64 keys: 512 blocks, no split
        kv = (k, v) if split else (k[:, :64].expand(8, -1, -1, -1),
                                   v[:, :64].expand(8, -1, -1, -1))
        mk = mask if split else mask[..., :64].contiguous()
        qq = q if split else q.expand(8, -1, -1, -1)
        fa.flash_attention_fwd(qq, *kv, mask=mk)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_attention_fwd(qq, *kv, mask=mk)
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        assert names and all("flash_fwd_3xtf32" in nm for nm in names), names
        assert any("merge" in nm for nm in names) == split, names


# The span-split #7 and #6 (a block a span of keys of a (row, kv head),
# the last span to finish merging the row): every mode at lengths on
# and around the edges of the kernel's spans.
SPLIT_MODES = [  # (q dtype, pool dtype or "int8")
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float16, torch.float16), (torch.bfloat16, "int8"),
    (torch.float32, "int8"), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32)]


def _split_edge_case(gen, dev, qdt, pdt, P, D, G, kvh=2):
    """Rows of seq_lens 0 (its own table), 1, span - 1, span, span + 1,
    P (#7's append opens the row's second page) and maxp P - 1 (#7
    appends the table's last slot), span the kernel's for these pools,
    each row its own pages; float or int8 pools (with scales).  Returns
    (q, new rows, pools, tables, lens)."""
    span = pa.decode_span(D, torch.int8 if pdt == "int8" else pdt)
    maxp = -(-3 * span // P) + 1
    lens = [0, 1, span - 1, span, span + 1, P, maxp * P - 1]
    b, n_pages = len(lens), len(lens) * maxp + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(b, maxp).to(torch.int32).contiguous()

    def rnd(*shape, dtype=qdt):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, new = rnd(b, kvh * G, D), [rnd(b, kvh, D) for _ in range(2)]
    if pdt == "int8":
        codes, scales = _int8_pools(gen, dev, kvh, n_pages, P, D)
        pools = codes + scales
    else:
        pools = [rnd(kvh, n_pages, P, D, dtype=pdt) for _ in range(2)] + [
            None, None]
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, new, pools, tables, lens


@pytest.mark.parametrize("qdt,pdt", SPLIT_MODES, ids=str)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("P,D", [(128, 128), (16, 64)])
@pytest.mark.parametrize("append", [True, False], ids=["n7", "n6"])
def test_paged_decode_split_matches_plain_at_span_edges(dev, qdt, pdt, P, D,
                                                        G, append):
    """#7 (append) and #6 at lengths on and around the span edges: outputs
    within the coarser dtype's tolerance, the pools (codes and scales)
    equal the plain version's bit for bit, #6's row of length 0 zero."""
    gen = torch.Generator(device=dev).manual_seed(41)
    q, new, pools, tables, lens = _split_edge_case(gen, dev, qdt, pdt, P, D,
                                                   G)
    mine = [None if p is None else p.clone() for p in pools]
    plain = [None if p is None else p.clone() for p in pools]
    fn, ref = ((pa.paged_decode_append_attend,
                pa.paged_decode_append_attend_reference) if append else
               (pa.paged_attention, pa.paged_attention_reference))
    new = new if append else []
    before = fn.launches
    got = fn(q, mine[0], mine[1], *new, tables, lens, mine[2], mine[3])
    want = ref(q, plain[0], plain[1], *new, tables, lens, plain[2], plain[3])
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert all(a is None or torch.equal(a, b) for a, b in zip(mine, plain))
    tol = max(TOL[qdt], TOL.get(pdt, 0.0))
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    if not append:
        assert not got[0].any()


def test_paged_decode_split_is_bit_identical_on_two_launches(dev):
    """The merge runs in span order in whichever block finishes a row
    last: two launches on equal pools give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(42)
    q, new, pools, tables, lens = _split_edge_case(
        gen, dev, torch.bfloat16, torch.bfloat16, 128, 128, 4)
    outs = []
    for _ in range(2):
        ps = [None if p is None else p.clone() for p in pools]
        outs.append(pa.paged_decode_append_attend(
            q, ps[0], ps[1], *new, tables, lens, ps[2], ps[3]))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("pdt", [torch.bfloat16, "int8"], ids=str)
def test_paged_decode_launch_is_the_split_kernel_alone(dev, pdt):
    """A #7 call launches the span-split kernel and nothing else (its
    merge counters are zero from the call before)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(43)
    q, new, pools, tables, lens = _split_edge_case(
        gen, dev, torch.bfloat16, pdt, 128, 128, 4)

    def call():
        return pa.paged_decode_append_attend(q, pools[0], pools[1], *new,
                                             tables, lens, pools[2],
                                             pools[3])
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {ev.key.split("(")[0] for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert len(names) == 1 and "paged_decode_split<" in names.pop(), names


# #4's f32 route: 3xTF32 on wgmma at D 64 (``flash_bwd_dkv_3xtf32``), the
# FMA pipe at D 128; both held to the f32 gradient tolerance.
DKV_F32_CASES = [
    # b, sq, sk, h, kvh, d, causal, mask shape, dropout p
    (2, 130, 130, 4, 4, 64, True, None, 0.1),
    (1, 100, 130, 8, 4, 64, True, None, 0.5),
    (2, 130, 100, 4, 2, 64, False, (2, 1, 130, 100), 0.1),
    (1, 100, 130, 8, 4, 64, True, (1, 8, 1, 130), 0.0),
    (1, 1024, 1024, 4, 4, 64, True, None, 0.1),
    (1, 100, 130, 8, 4, 128, True, None, 0.1),
    (1, 130, 100, 4, 2, 128, False, (1, 4, 1, 100), 0.5),
]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,mshape,p", DKV_F32_CASES)
def test_flash_dkv_f32_matches_plain(dev, b, sq, sk, h, kvh, d, causal,
                                     mshape, p):
    """dK and dV against the plain backward fed the same seed: within
    1e-5 of the largest element (3xTF32 leaves out lo lo', about 2^-22 of
    a product)."""
    q, k, v, do = _attn_inputs(dev, torch.float32, b, sq, sk, h, kvh, d)
    mask = None
    if mshape is not None:
        gen = torch.Generator(device=dev).manual_seed(10)
        mask = torch.randn(mshape, generator=gen, device=dev)
        mask[..., -(sk // 4):] = -1e30
    seed = torch.tensor(777, dtype=torch.int64, device=dev)
    kw = dict(causal=causal, mask=mask, dropout_p=p,
              seed=seed if p else None)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, causal,
                                          mask)
    got = fa.flash_attention_bwd_dkv(*ops, causal, p, kw["seed"])
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)[1:]
    torch.cuda.synchronize()
    _assert_grads_close(got, want, torch.float32)


def test_flash_dkv_3xtf32_is_bit_identical_and_alone(dev):
    """The 3xTF32 dK/dV writes each kv head's rows once, without atomics:
    two launches give the same bits, and a D 64 f32 call launches
    ``flash_bwd_dkv_3xtf32`` and nothing else."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do = _attn_inputs(dev, torch.float32, 2, 700, 700, 8, 4, 64)
    seed = torch.tensor(778, dtype=torch.int64, device=dev)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                      seed=seed)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    first = fa.flash_attention_bwd_dkv(*ops, True, 0.1, seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = fa.flash_attention_bwd_dkv(*ops, True, 0.1, seed)
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    names = {ev.key.split("(")[0] for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert names == {"void ptt::flash_bwd_dkv_3xtf32<64, true>"}, names


# #3's f32 route: 3xTF32 on wgmma at D 64 (``flash_bwd_dq_3xtf32``), the
# FMA pipe at D 128; both held to the f32 gradient tolerance.  "+rows"
# also hides every key of some rows, which the plain version weighs
# alike: with causal masking those rows lie in the last 64 rows (a row
# above them sees only the keys its 64-row tile reaches).
DQ_F32_CASES = [
    # b, sq, sk, h, kvh, d, causal, mask, dropout p
    (2, 130, 130, 4, 4, 64, True, None, 0.1),
    (1, 100, 230, 8, 4, 64, True, None, 0.0),
    (1, 100, 230, 8, 2, 64, True, None, 0.5),
    (2, 130, 100, 8, 2, 64, False, "b1qk", 0.1),
    (1, 100, 130, 8, 4, 64, True, "1h1k", 0.0),
    (1, 200, 260, 8, 2, 64, True, "11qk+rows", 0.1),
    (1, 130, 200, 4, 1, 64, False, "11qk+rows", 0.0),
    (1, 1024, 1024, 4, 4, 64, True, None, 0.1),
    (1, 100, 130, 8, 4, 128, True, None, 0.1),
    (1, 130, 100, 4, 2, 128, False, "1h1k", 0.5),
]


def _f32_mask(dev, b, sq, sk, h, causal, mshape):
    if mshape is None:
        return None
    gen = torch.Generator(device=dev).manual_seed(12)
    kind, _, rows = mshape.partition("+")
    shape = {"b1qk": (b, 1, sq, sk), "1h1k": (1, h, 1, sk),
             "11qk": (1, 1, sq, sk)}[kind]
    mask = torch.randn(shape, generator=gen, device=dev)
    mask[..., -(sk // 4):] = -1e30
    if rows:
        first = 64 * ((sq - 1) // 64) if causal else 0
        mask[..., first::3, :] = -1e30
        mask[..., -1, :] = -1e30
    return mask


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,mshape,p", DQ_F32_CASES)
def test_flash_dq_f32_matches_plain(dev, b, sq, sk, h, kvh, d, causal,
                                    mshape, p):
    """dQ against the plain backward fed the same seed: within 1e-5 of the
    largest element (3xTF32 leaves out lo lo', about 2^-22 of a
    product), at ragged Sq / Sk, Sk > Sq under causal masking, fully
    hidden rows, GQA groups 1, 2 and 4 and dropout 0, 0.1 and 0.5."""
    q, k, v, do = _attn_inputs(dev, torch.float32, b, sq, sk, h, kvh, d)
    mask = _f32_mask(dev, b, sq, sk, h, causal, mshape)
    seed = torch.tensor(779, dtype=torch.int64, device=dev)
    kw = dict(causal=causal, mask=mask, dropout_p=p,
              seed=seed if p else None)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, causal,
                                          mask)
    got = fa.flash_attention_bwd_dq(*ops, causal, p, kw["seed"])
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)[0]
    torch.cuda.synchronize()
    _assert_grads_close([got], [want], torch.float32)


def _traced_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {ev.key.split("(")[0] for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA}


def test_flash_dq_3xtf32_is_bit_identical_and_alone(dev):
    """The 3xTF32 dQ writes each row once, without atomics: two launches
    give the same bits, and a D 64 f32 call launches
    ``flash_bwd_dq_3xtf32`` and nothing else."""
    q, k, v, do = _attn_inputs(dev, torch.float32, 2, 700, 700, 8, 4, 64)
    seed = torch.tensor(780, dtype=torch.int64, device=dev)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                      seed=seed)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, None)
    first = fa.flash_attention_bwd_dq(*ops, True, 0.1, seed)
    torch.cuda.synchronize()
    second, names = _traced_names(
        lambda: fa.flash_attention_bwd_dq(*ops, True, 0.1, seed))
    assert torch.equal(first, second)
    assert names == {"void ptt::flash_bwd_dq_3xtf32<64, true>"}, names


# #5's f32 route at D 64: 3xTF32 on wgmma (``flash_dbias_3xtf32``); D 128
# stays on the FMA pipe
@pytest.mark.parametrize("mshape,kvh", [((1, 8, 130, 100), 8),
                                        ((2, 1, 130, 100), 2),
                                        ((1, 1, 130, 100), 8),
                                        ((2, 8, 130, 100), 2),
                                        ((1, 8, 130, 100), 2)], ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_dbias_f32_matches_plain_at_ragged_tiles(dev, mshape, kvh, causal,
                                                 p):
    """#5 f32 D 64 against its plain version at Sq 130 and Sk 100 (off
    the 64 tiles, Sk < Sq only without causal masking) with every bias
    broadcast and GQA groups 1 and 4: 1e-5 of the largest element."""
    sq, sk = (130, 100) if not causal else (100, 130)
    mshape = mshape[:2] + (sq, sk)
    q, k, v, do = _attn_inputs(dev, torch.float32, 2, sq, sk, 8, kvh, 64)
    gen = torch.Generator(device=dev).manual_seed(13)
    bias = torch.randn(mshape, generator=gen, device=dev) * 0.5
    seed = torch.tensor(781, dtype=torch.int64, device=dev)
    kw = dict(causal=causal, dropout_p=p, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, mask=bias, **kw)
    got = fa.flash_attention_dbias(q, k, v, out, lse, do, bias, **kw)
    want = fa.flash_attention_dbias_reference(q, k, v, out, lse, do, bias,
                                              **kw)
    torch.cuda.synchronize()
    _assert_grads_close([got], [want], torch.float32)


def test_dbias_f32_d128_stays_on_its_kernel(dev):
    """f32 at D 128 still runs ``flash_dbias`` (FMA pipe), within 1e-5."""
    q, k, v, do = _attn_inputs(dev, torch.float32, 2, 96, 96, 4, 2, 128)
    gen = torch.Generator(device=dev).manual_seed(14)
    bias = torch.randn(1, 4, 96, 96, generator=gen, device=dev) * 0.5
    seed = torch.tensor(782, dtype=torch.int64, device=dev)
    kw = dict(causal=True, dropout_p=0.1, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, mask=bias, **kw)
    got, names = _traced_names(lambda: fa.flash_attention_dbias(
        q, k, v, out, lse, do, bias, **kw))
    want = fa.flash_attention_dbias_reference(q, k, v, out, lse, do, bias,
                                              **kw)
    _assert_grads_close([got], [want], torch.float32)
    assert "void ptt::flash_dbias<float, 128, true>" in names, names


def test_dbias_3xtf32_is_bit_identical_and_alone(dev):
    """The 3xTF32 dbias sums the broadcast (b, h) in a fixed order and
    writes each element once: two launches give the same bits, and the
    launch is ``flash_dbias_3xtf32`` alone."""
    q, k, v, do = _attn_inputs(dev, torch.float32, 4, 300, 300, 8, 2, 64)
    gen = torch.Generator(device=dev).manual_seed(15)
    bias = torch.randn(1, 8, 300, 300, generator=gen, device=dev) * 0.5
    seed = torch.tensor(783, dtype=torch.int64, device=dev)
    kw = dict(causal=True, dropout_p=0.1, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, mask=bias, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, True, bias)
    first = fa.flash_attention_bwd_dbias(*ops[:6], bias, True, 0.1, seed)
    torch.cuda.synchronize()
    second, names = _traced_names(lambda: fa.flash_attention_bwd_dbias(
        *ops[:6], bias, True, 0.1, seed))
    assert torch.equal(first, second)
    assert names == {"void ptt::flash_dbias_3xtf32<64, true>"}, names


# -- the model zoo's shapes: ERNIE's GQA groups 3 and 5, BERT's padding
# mask over heads and rows with 16-bit dropout at D 64, ERNIE's #10
# widths and the 64-expert grouped matmuls ---------------------------------

ZOO_FLASH = [
    # b, sq, sk, h, kvh, d, causal: ERNIE (12 / 4 and 20 / 4 heads of 128)
    (2, 300, 300, 12, 4, 128, True), (1, 520, 520, 20, 4, 128, True),
    (2, 200, 200, 12, 4, 64, True), (1, 130, 260, 15, 3, 64, True),
    (2, 257, 257, 10, 2, 128, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", ZOO_FLASH)
def test_flash_kernels_at_groups_3_and_5_match_plain(dev, dtype, b, sq, sk,
                                                     h, kvh, d, causal):
    """#2, #3 and #4 (dK/dV summed over groups of 3 and 5 query heads)
    against the plain versions."""
    q, k, v, do = _attn_inputs(dev, dtype, b, sq, sk, h, kvh, d, seed=21)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v,
                                                          causal=causal)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, causal,
                                          None)
    dq = fa.flash_attention_bwd_dq(*ops, causal)
    dk, dv = fa.flash_attention_bwd_dkv(*ops, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    _assert_grads_close((dq, dk, dv), want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,s,h", [(4, 200, 12), (2, 512, 12), (3, 130, 4)])
def test_flash_kernels_padding_mask_dropout_match_plain(dev, dtype, p, b, s,
                                                        h):
    """BERT's attention: D 64, a ``[B, 1, 1, S]`` bias of 0 / -1e30 that
    pads a quarter of each row's keys (broadcast over heads and query
    rows), attention dropout from one seed: #2, #3 and #4 against the
    plain versions fed the same seed."""
    q, k, v, do = _attn_inputs(dev, dtype, b, s, s, h, h, 64, seed=22)
    keep = torch.ones(b, s, device=dev)
    for i in range(b):
        keep[i, s - (s // 4) - 7 * i:] = 0.0
    mask = ((keep - 1.0) * 1e30)[:, None, None, :]
    seed = torch.tensor(991, dtype=torch.int64, device=dev) if p else None
    kw = dict(causal=False, mask=mask, dropout_p=p, seed=seed)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    ops = fa.flash_attention_bwd_operands(q, k, v, out, lse, do, False,
                                          mask)
    dq = fa.flash_attention_bwd_dq(*ops, False, p, seed)
    dk, dv = fa.flash_attention_bwd_dkv(*ops, False, p, seed)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    _assert_grads_close((dq, dk, dv), want, dtype)
    # padded keys get no gradient
    assert dk[keep == 0].abs().max().item() == 0.0
    assert dv[keep == 0].abs().max().item() == 0.0


@pytest.mark.parametrize("b,s,k,heads", [
    (1, 512, 1536, 12),     # ERNIE q: hidden 1536, 12 heads of 128
    (1, 512, 1536, 4),      # ERNIE k: 4 KV heads (N 512)
    (1, 384, 2560, 20),     # ERNIE-A3B q: hidden 2560, 20 heads
    (2, 200, 2560, 4)])     # ERNIE-A3B k, rows off the tile
def test_matmul_rope_kernel_at_ernie_widths_matches_plain(dev, b, s, k,
                                                          heads):
    _, x, w, cos, sin = _rope_case(dev, torch.bfloat16, b, s, k, heads, 128)
    before = ft.matmul_rope_raw.launches
    got = ft.matmul_rope_raw(x, w, cos, sin, n_heads=heads, head_dim=128)
    want = ft.matmul_rope_reference(x, w, cos, sin, heads, 128)
    torch.cuda.synchronize()
    assert ft.matmul_rope_raw.launches == before + 1
    assert _rel(got, want) <= REL_TOL[torch.bfloat16], _rel(got, want)


@pytest.mark.parametrize("tm", [128, 256])
def test_grouped_kernels_at_64_experts_match_plain(dev, tm):
    """ERNIE-A3B's expert FFN, cut in rows: 64 experts top-6 at H 2560,
    F 1536 in bf16 (every expert a whole tile or more of padding):
    #12, #11 (both transpose_w) and #13 against the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(23)
    e, h, f = 64, 2560, 1536
    xs, te, counts = _plan_rows(dev, gen, torch.bfloat16, t=512, k=6, e=e,
                                h=h, tm=tm)
    wg, wu = ((torch.randn(e, h, f, generator=gen, device=dev)
               / h ** 0.5).to(torch.bfloat16) for _ in range(2))
    wd = (torch.randn(e, f, h, generator=gen, device=dev)
          / f ** 0.5).to(torch.bfloat16)
    (hs,) = gm.gmm_glu_raw(xs, wg, wu, te, counts=counts)
    (want_hs,) = gm.gmm_glu_reference(xs, wg, wu, te)
    out = gm.gmm_raw(hs, wd, te, counts=counts)
    want_out = gm.gmm_reference(hs, wd, te)
    dx = gm.gmm_raw(out, wd, te, transpose_w=True, counts=counts)
    want_dx = gm.gmm_reference(out, wd, te, transpose_w=True)
    dw = gm.gmm_dw_raw(hs, out, te, counts, e)
    want_dw = gm.gmm_dw_reference(hs, out, te, counts, e)
    torch.cuda.synchronize()
    for got, want in ((hs, want_hs), (out, want_out), (dx, want_dx),
                      (dw, want_dw)):
        assert _rel_l2(got, want) <= REL_TOL[torch.bfloat16], \
            _rel_l2(got, want)
    # the expert with no rows gets exactly zero dW
    assert dw[2].abs().max().item() == 0.0


def _fit_counters():
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "add_layer_norm": ft.add_layer_norm_raw,
            "add_layer_norm_bwd": ft.add_layer_norm_backward_raw,
            "fused_update": ft.fused_update_flat}


def test_model_fit_launches_the_kernels_and_keeps_batches_on_card(dev):
    """``hapi.Model.fit`` on a 2-layer BERT (2 heads of 64, bf16 O2, a
    quarter of each row padded, dropout 0.1): every step launches #2-#4
    once a layer, #9's LayerNorm forward and backward twice a layer and
    the update #8; the network sees its batches on the card."""
    import numpy as np

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    from paddle_tpu_torch.nn import CrossEntropyLoss

    cfg = BertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=128)
    seen = []

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cls = BertForSequenceClassification(
                cfg, num_classes=3, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))

        def forward(self, ids, mask):
            seen.append((ids.device, mask.device))
            return self.cls(ids, attention_mask=mask)

    class PerStep(Callback):
        def __init__(self):
            super().__init__()
            self.deltas = []

        def on_train_batch_begin(self, step, logs=None):
            self.before = {n: f.launches for n, f in _fit_counters().items()}

        def on_train_batch_end(self, step, logs=None):
            self.deltas.append({n: f.launches - self.before[n]
                                for n, f in _fit_counters().items()})

    net = amp.decorate(Net(), level="O2", dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, (16, 128)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 96:] = 0
    ids[mask == 0] = 0
    labels = (ids[:, 0] % 3).astype(np.int64)
    model = Model(net)
    model.prepare(optimizer.AdamW(1e-4, parameters=net.parameters()),
                  CrossEntropyLoss(), Accuracy())
    per = PerStep()
    model.fit(TensorDataset([ids, mask, labels]), batch_size=4, epochs=1,
              verbose=0, callbacks=[per])
    params = list(net.parameters())
    big = sum(p.numel() * p.element_size() >= 1 << 20 for p in params)
    small = {p.dtype for p in params
             if p.numel() * p.element_size() < 1 << 20}
    want = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
            "flash_attention_bwd_dkv": 2, "add_layer_norm": 4,
            "add_layer_norm_bwd": 4, "fused_update": big + len(small)}
    assert len(per.deltas) == 4
    for i, d in enumerate(per.deltas):
        # the first step also prices a forward and backward (step_flops)
        extra = 2 if i == 0 else 1
        assert d == {n: c * (1 if n == "fused_update" else extra)
                     for n, c in want.items()}, (i, d)
    assert seen and all(a.type == "cuda" and b.type == "cuda"
                        for a, b in seen)
    assert all(p.device.type == "cuda" for p in net.parameters())
    # the last item of a sample is its label, dropped by predict
    pred = model.predict(TensorDataset([ids[:8], mask[:8], labels[:8]]),
                         batch_size=4, stack_outputs=True)[0]
    assert pred.shape == (8, 3) and np.isfinite(pred).all()


def test_token_file_loader_is_native(dev, tmp_path):
    import numpy as np

    from paddle_tpu_torch.io import TokenFileLoader
    arr = np.arange(64 * 10, dtype=np.int32)
    path = tmp_path / "tokens.bin"
    arr.tofile(path)
    loader = TokenFileLoader(str(path), seq_len=64, batch_size=2,
                             shuffle_seed=3)
    assert loader.is_native and len(loader) == 5
    seen = np.sort(np.concatenate([b.ravel() for b in loader]))
    np.testing.assert_array_equal(seen, arr)
    loader.close()
