"""The port's ragged paged attention (plain version) against the
reference's jnp oracle, and ``paged_write_rows`` against the
reference's, on the CPU.

One flat batch mixes two decode rows, a sub-page prefill chunk, one
prompt split across two descriptors of the same call, and unused
descriptors.  The reference takes the per-row form (positions and a
table per row); the port takes the descriptor form and its rows are
gathered back through (desc_of_row, off_of_row).  Outputs agree within
1e-5 (f32 sums in another order); the pools are bit-equal on every page
but pad page 0, which only the reference writes (its padding rows land
there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as ref

from paddle_tpu_torch.ops import paged_attention as port

KVH, H, D, P, N_PAGES, MAXP = 2, 4, 16, 8, 16, 4
# (kv_len, q_len, page table) per live descriptor, in flat-row order
DESCS = [
    (13, 1, [3, 5, 0, 0]),          # decode row, second page
    (5, 1, [7, 0, 0, 0]),           # decode row, first page
    (2, 3, [9, 0, 0, 0]),           # sub-page chunk
    (0, 8, [10, 11, 0, 0]),         # one prompt split over two
    (8, 3, [10, 11, 0, 0]),         #   descriptors of one call
]
T = 20                              # flat rows (= descriptors)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    live = sum(ql for _, ql, _ in DESCS)
    q_start = np.zeros(T, np.int32)
    q_len = np.zeros(T, np.int32)
    kv_len = np.zeros(T, np.int32)
    tables = np.zeros((T, MAXP), np.int32)
    positions = np.zeros(T, np.int32)
    row_tables = np.zeros((T, MAXP), np.int32)
    desc_of_row = np.arange(T, dtype=np.int32)
    off_of_row = np.zeros(T, np.int32)
    row = 0
    for d, (kl, ql, tbl) in enumerate(DESCS):
        q_start[d], q_len[d], kv_len[d], tables[d] = row, ql, kl, tbl
        positions[row:row + ql] = np.arange(kl, kl + ql)
        row_tables[row:row + ql] = tbl
        desc_of_row[row:row + ql] = d
        off_of_row[row:row + ql] = np.arange(ql)
        row += ql
    f = np.float32
    return dict(
        q=rng.standard_normal((T, H, D)).astype(f),
        k_new=rng.standard_normal((T, KVH, D)).astype(f),
        v_new=rng.standard_normal((T, KVH, D)).astype(f),
        k_pages=rng.standard_normal((KVH, N_PAGES, P, D)).astype(f),
        v_pages=rng.standard_normal((KVH, N_PAGES, P, D)).astype(f),
        q_start=q_start, q_len=q_len, kv_len=kv_len, tables=tables,
        positions=positions, row_tables=row_tables,
        desc_of_row=desc_of_row, off_of_row=off_of_row, live=live)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_call(b, fn):
    kp, vp = _t(b["k_pages"]), _t(b["v_pages"])
    out = fn(_t(b["q"]), kp, vp, _t(b["k_new"]), _t(b["v_new"]),
             _t(b["q_start"]), _t(b["q_len"]), _t(b["kv_len"]),
             _t(b["tables"]))
    return out, kp, vp


@pytest.mark.parametrize("fn", [
    port.ragged_paged_append_attend,
    port.ragged_paged_append_attend_reference,
], ids=["wrapper", "plain"])
def test_ragged_matches_reference_oracle(fn):
    b = _batch()
    want, kp_want, vp_want = ref.ragged_paged_append_attend_reference(
        jnp.asarray(b["q"]), jnp.asarray(b["k_pages"]),
        jnp.asarray(b["v_pages"]), jnp.asarray(b["k_new"]),
        jnp.asarray(b["v_new"]), jnp.asarray(b["positions"]),
        jnp.asarray(b["row_tables"]))
    blocks, kp, vp = _port_call(b, fn)
    assert blocks.shape == (T, P, H, D)
    got = blocks[_t(b["desc_of_row"]).long(), _t(b["off_of_row"]).long()]
    live = b["live"]
    np.testing.assert_allclose(got[:live].numpy(), np.asarray(want)[:live],
                               rtol=1e-5, atol=1e-5)
    # padding rows gather their q_len == 0 descriptor's zero block
    assert not got[live:].any()
    np.testing.assert_array_equal(kp[:, 1:].numpy(),
                                  np.asarray(kp_want)[:, 1:])
    np.testing.assert_array_equal(vp[:, 1:].numpy(),
                                  np.asarray(vp_want)[:, 1:])
    # the port writes only live rows: pad page 0 is untouched
    np.testing.assert_array_equal(kp[:, 0].numpy(), b["k_pages"][:, 0])


def test_ragged_zeroes_rows_without_query():
    b = _batch(1)
    blocks, _, _ = _port_call(b, port.ragged_paged_append_attend)
    for d, (_, ql, _) in enumerate(DESCS):
        assert blocks[d, :ql].abs().sum() > 0
        assert not blocks[d, ql:].any()
    assert not blocks[len(DESCS):].any()


def test_ragged_split_prompt_sees_its_first_chunk():
    """The second descriptor of the split prompt attends over the first
    descriptor's rows written in the same call: its output equals that
    of the same rows run alone after the first chunk was appended."""
    b = _batch(2)
    blocks, _, _ = _port_call(b, port.ragged_paged_append_attend)
    one = dict(b)
    for key in ("q_start", "q_len", "kv_len"):
        one[key] = np.zeros_like(b[key])
    one["q_start"][0], one["q_len"][0], one["kv_len"][0] = 0, 8, 0
    one["tables"] = np.zeros_like(b["tables"])
    one["tables"][0] = DESCS[3][2]
    one["q"], one["k_new"], one["v_new"] = (
        np.roll(b[k], -5, axis=0) for k in ("q", "k_new", "v_new"))
    _, kp, vp = _port_call(one, port.ragged_paged_append_attend)
    two = dict(one, k_pages=kp.numpy(), v_pages=vp.numpy())
    two["q_start"] = np.zeros_like(b["q_start"])
    two["q_len"] = np.zeros_like(b["q_len"])
    two["kv_len"] = np.zeros_like(b["kv_len"])
    two["q_start"][0], two["q_len"][0], two["kv_len"][0] = 8, 3, 8
    alone, _, _ = _port_call(two, port.ragged_paged_append_attend)
    torch.testing.assert_close(blocks[4, :3], alone[0, :3])


def test_paged_write_rows_bit_equal_reference():
    """Including pad page 0, which all padding rows (position 0, zero
    table) hit — the last of them wins in both."""
    b = _batch(3)
    want_k, want_v = ref.paged_write_rows(
        jnp.asarray(b["k_pages"]), jnp.asarray(b["v_pages"]),
        jnp.asarray(b["k_new"]), jnp.asarray(b["v_new"]),
        jnp.asarray(b["positions"]), jnp.asarray(b["row_tables"]))
    kp, vp = _t(b["k_pages"]), _t(b["v_pages"])
    port.paged_write_rows(kp, vp, _t(b["k_new"]), _t(b["v_new"]),
                          _t(b["positions"]), _t(b["row_tables"]))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(want_v))
