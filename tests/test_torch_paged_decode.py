"""The split decode path's kernels (#6, #7) and the int8 pools of #1,
plain versions against the reference's, on the CPU.

The same numpy inputs go through ``paddle_tpu/ops/pallas/
paged_attention.py``'s references (its CPU path) and the port's plain
versions (the kernels' counterparts on CPU tensors): float pools and
int8 pools with per-token scales, GQA groups 1 and 2, a live row of
length 0 and an append that opens a new page.  Outputs within 1e-5
relative L2 (f32 sums in another order); pools after an append equal
(int8: the codes and scales bit for bit).  A row with nothing to attend
gets zeros from #6, as its TPU kernel writes (the reference's dense
oracle averages the masked keys there instead).  The reference keeps a
layer's scales as [KVH, n_pages, 1, P]; the port as [KVH, n_pages, P].
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as R

from paddle_tpu_torch.ops import paged_attention as pa

KVH, D, P, MAXP, N_PAGES = 2, 16, 8, 4, 20
LENS = [0, 3, P, 2 * P + 5]          # P: the append opens page 1


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _case(seed, g, int8):
    rng = np.random.default_rng(seed)
    b = len(LENS)
    tables = (rng.permutation(N_PAGES - 1)[:b * MAXP] + 1).reshape(
        b, MAXP).astype(np.int32)
    q = rng.standard_normal((b, KVH * g, D)).astype(np.float32)
    new = [rng.standard_normal((b, KVH, D)).astype(np.float32)
           for _ in range(2)]
    shape = (KVH, N_PAGES, P, D)
    if int8:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random(shape[:3]) * 0.02 + 1e-3).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
        scales = [None, None]
    return q, new, pools, scales, tables, np.asarray(LENS, np.int32)


def _jax_scales(scales):
    return [None if s is None else jnp.asarray(s[:, :, None, :])
            for s in scales]


def _torch(*arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_attention_plain_matches_reference(g, int8):
    q, _, pools, scales, tables, lens = _case(0, g, int8)
    want = np.asarray(R.paged_attention_reference(
        jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(tables),
        jnp.asarray(lens), *_jax_scales(scales)))
    got = pa.paged_attention(*_torch(q, *pools, tables, lens, *scales))
    live = lens > 0
    assert _rel(got.numpy()[live], want[live]) <= 1e-5
    assert not got[~torch.tensor(live)].any()


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_decode_append_plain_matches_reference(g, int8):
    q, new, pools, scales, tables, lens = _case(1, g, int8)
    ref = R.paged_decode_append_attend_reference(
        jnp.asarray(q), *map(jnp.asarray, pools), *map(jnp.asarray, new),
        jnp.asarray(tables), jnp.asarray(lens), *_jax_scales(scales))
    mine = _torch(*pools, *scales)
    got = pa.paged_decode_append_attend(
        torch.tensor(q), mine[0], mine[1], *_torch(*new, tables, lens),
        mine[2], mine[3])
    assert _rel(got.numpy(), np.asarray(ref[0])) <= 1e-5
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(mine[1].numpy(), np.asarray(ref[2]))
    if int8:
        for m, r in zip(mine[2:], ref[3:]):
            np.testing.assert_array_equal(m.numpy(), np.asarray(r)[:, :, 0])
    # the row of length P wrote slot 0 of its second page
    row = 2
    np.testing.assert_array_equal(
        mine[0][:, tables[row, 1], 0].numpy(),
        np.asarray(ref[1])[:, tables[row, 1], 0])


def test_paged_write_quant_matches_reference():
    """Rows 3 and 4 hit the same slot of the pad page: the last wins."""
    rng = np.random.default_rng(2)
    b = 5
    pools = [np.zeros((KVH, N_PAGES, P, D), np.int8) for _ in range(2)]
    scales = [np.zeros((KVH, N_PAGES, P), np.float32) for _ in range(2)]
    new = [(rng.standard_normal((b, KVH, D)) * 2).astype(np.float32)
           for _ in range(2)]
    new[0][1, 0] = 0.0                               # an all-zero row
    tables = np.zeros((b, MAXP), np.int32)
    tables[:3] = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
    lens = np.asarray([0, 9, 31, 0, 0], np.int32)
    ref = R.paged_write_quant(*map(jnp.asarray, pools),
                              *_jax_scales(scales), *map(jnp.asarray, new),
                              jnp.asarray(tables), jnp.asarray(lens))
    mine = _torch(*pools, *scales)
    pa.paged_write_quant(*mine, *_torch(*new, tables, lens))
    for m, r in zip(mine, ref):
        r = np.asarray(r)
        np.testing.assert_array_equal(m.numpy(), r[:, :, 0] if r.ndim == 4
                                      and m.dim() == 3 else r)


def test_paged_write_rows_quant_matches_reference():
    rng = np.random.default_rng(3)
    t = 7
    pools = [rng.integers(-127, 128, (KVH, N_PAGES, P, D)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.random((KVH, N_PAGES, P)).astype(np.float32)
              for _ in range(2)]
    new = [rng.standard_normal((t, KVH, D)).astype(np.float32)
           for _ in range(2)]
    positions = np.asarray([0, 7, 8, 9, 17, 0, 0], np.int32)
    tables = np.zeros((t, MAXP), np.int32)
    tables[:5] = [1, 2, 3, 4]
    ref = R.paged_write_rows_quant(
        *map(jnp.asarray, pools), *_jax_scales(scales),
        *map(jnp.asarray, new), jnp.asarray(positions), jnp.asarray(tables))
    mine = _torch(*pools, *scales)
    pa.paged_write_rows_quant(*mine, *_torch(*new, positions, tables))
    for i, (m, r) in enumerate(zip(mine, ref)):
        r = np.asarray(r)
        np.testing.assert_array_equal(m.numpy(), r[:, :, 0] if i >= 2 else r)


@pytest.mark.parametrize("g", [1, 2])
def test_ragged_int8_plain_matches_reference(g):
    """#1 with int8 pools: descriptors (decode rows, a whole-page chunk,
    a chunk inside a page) against the reference's per-row form."""
    rng = np.random.default_rng(4)
    descs = [(0, 1), (5, 1), (P, P), (2 * P + 1, 3)]     # (kv_len, q_len)
    s = t = sum(ql for _, ql in descs) + 2
    q_start, q_len, kv_len = (np.zeros(s, np.int32) for _ in range(3))
    tables = np.zeros((s, MAXP), np.int32)
    positions = np.zeros(t, np.int32)
    row_tables = np.zeros((t, MAXP), np.int32)
    desc_rows = []
    row = 0
    for d, (kl, ql) in enumerate(descs):
        q_start[d], q_len[d], kv_len[d] = row, ql, kl
        tables[d] = np.arange(1, MAXP + 1) + d * MAXP
        positions[row:row + ql] = np.arange(kl, kl + ql)
        row_tables[row:row + ql] = tables[d]
        desc_rows += [(d, j) for j in range(ql)]
        row += ql
    q = rng.standard_normal((t, KVH * g, D)).astype(np.float32)
    new = [rng.standard_normal((t, KVH, D)).astype(np.float32)
           for _ in range(2)]
    pools = [rng.integers(-127, 128, (KVH, N_PAGES, P, D)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.random((KVH, N_PAGES, P)) * 0.02).astype(np.float32)
              for _ in range(2)]
    # the reference's pad rows (past the live ones) write into pad page 0
    ref = R.ragged_paged_append_attend_reference(
        jnp.asarray(q), *map(jnp.asarray, pools), *map(jnp.asarray, new),
        jnp.asarray(positions), jnp.asarray(row_tables),
        *_jax_scales(scales))
    mine = _torch(*pools, *scales)
    out = pa.ragged_paged_append_attend(
        torch.tensor(q), mine[0], mine[1], *_torch(*new, q_start, q_len,
                                                   kv_len, tables),
        mine[2], mine[3])
    n = len(desc_rows)
    d_idx, off = (torch.tensor(x) for x in zip(*desc_rows))
    assert _rel(out[d_idx, off].numpy(), np.asarray(ref[0])[:n]) <= 1e-5
    for i, (m, r) in enumerate(zip(mine, ref[1:])):
        r = np.asarray(r)[:, 1:]                     # page 0: pad rows
        np.testing.assert_array_equal(m.numpy()[:, 1:],
                                      r[:, :, 0] if i >= 2 else r)
