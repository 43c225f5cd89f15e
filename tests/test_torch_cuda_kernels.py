"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; every test skips on a machine without a CUDA device.
This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Small shapes cover what the full-width check in ``chip_smoke.py`` does
not: f32 and f16 as well as bf16, head_dim 64, page sizes below and
above the 64-key tile, ragged tile edges, unused descriptors, causal
attention with Sq < Sk, broadcast masks and GQA.  Tolerances: f32 1e-4
(sums in another order), f16/bf16 one output rounding.
"""
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
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


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention_fwd(q.float(), q, q)
