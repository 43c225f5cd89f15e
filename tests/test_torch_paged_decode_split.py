"""The split decode kernel's arithmetic (#7 and #6 spread over blocks by
key span, merged in span order), as its plain mirror
``paged_decode_split_reference``, against the reference's decode
attention and the port's plain versions, on the CPU.

The same numpy inputs go through ``paddle_tpu/ops/pallas/
paged_attention.py``'s references (its CPU path) and the mirror, at the
spans the kernel takes (``decode_span``: 128 keys, 64 for f32 pools at D
128): row lengths 1, span - 1, span, span + 1, an append that opens a
new page, and maxp P - 1, in f32 and int8 pools, GQA groups 1, 2 and 4.
Outputs within 2e-6 (f32 sums in another order, the merge's rescaling):
the mirror takes the key's int8 scale on the score and the value's on
the probability, as the kernel does, where the reference dequantizes the
pages first.  A row of length 0 gets zeros from the mirror, as #6 writes
(the reference's dense oracle averages the masked keys instead).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as R

from paddle_tpu_torch.ops import paged_attention as pa

KVH, P = 2, 16
TOL = 2e-6


def _case(seed, g, d, int8):
    """Rows of seq_lens 0, 1, span - 1, span, span + 1, P (#7's append
    opens the second page) and maxp P - 2 (#7 attends maxp P - 1 keys),
    each row its own pages."""
    rng = np.random.default_rng(seed)
    span = pa.decode_span(d, torch.int8 if int8 else torch.float32)
    maxp = -(-3 * span // P) + 1
    lens = np.asarray([0, 1, span - 1, span, span + 1, P, maxp * P - 2],
                      np.int32)
    b = lens.shape[0]
    n_pages = b * maxp + 1
    tables = (rng.permutation(n_pages - 1) + 1).reshape(b, maxp).astype(
        np.int32)
    q = rng.standard_normal((b, KVH * g, d)).astype(np.float32)
    new = [rng.standard_normal((b, KVH, d)).astype(np.float32)
           for _ in range(2)]
    shape = (KVH, n_pages, P, d)
    if int8:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random(shape[:3]) * 0.01 + 1e-3).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
        scales = [None, None]
    return q, new, pools, scales, tables, lens


def _jax_scales(scales):
    return [None if s is None else jnp.asarray(s[:, :, None, :])
            for s in scales]


def _torch(*arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_split_mirror_of_6_matches_reference(d, g, int8):
    q, _, pools, scales, tables, lens = _case(0, g, d, int8)
    want = np.asarray(R.paged_attention_reference(
        jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(tables),
        jnp.asarray(lens), *_jax_scales(scales)))
    args = _torch(q, *pools, tables, lens, *scales)
    got = pa.paged_decode_split_reference(*args).numpy()
    plain = pa.paged_attention_reference(*args).numpy()
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=0, atol=TOL)
    assert not got[~live].any()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_split_mirror_of_7_matches_reference(d, g, int8):
    """#7: the reference appends each row at seq_lens[b] (cast or
    quantized) and attends seq_lens[b] + 1 keys; the mirror attends the
    pools the port's plain append wrote, which equal the reference's."""
    q, new, pools, scales, tables, lens = _case(1, g, d, int8)
    ref = R.paged_decode_append_attend_reference(
        jnp.asarray(q), *map(jnp.asarray, pools), *map(jnp.asarray, new),
        jnp.asarray(tables), jnp.asarray(lens), *_jax_scales(scales))
    mine = _torch(*pools, *scales)
    t = _torch(q, *new, tables, lens)
    plain = pa.paged_decode_append_attend_reference(
        t[0], mine[0], mine[1], t[1], t[2], t[3], t[4], mine[2], mine[3])
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(mine[1].numpy(), np.asarray(ref[2]))
    got = pa.paged_decode_split_reference(t[0], mine[0], mine[1], t[3],
                                          t[4] + 1, mine[2], mine[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("d,dtype,span", [
    (64, torch.float32, 128), (128, torch.float32, 64),
    (64, torch.bfloat16, 128), (128, torch.bfloat16, 128),
    (64, torch.int8, 128), (128, torch.int8, 128)], ids=str)
def test_decode_span_is_the_kernels(d, dtype, span):
    """The kernel's ``Geo::SPAN``: 256 threads, a key row over its
    16-byte chunks, at most 8 keys a lane group, 128 keys aimed at."""
    assert pa.decode_span(d, dtype) == span
