"""The port's grouped matmuls (``ops/grouped_matmul.py``) against the
reference's (``paddle_tpu/ops/pallas/grouped_matmul.py``) on the CPU.

The dropless plans must be integer-equal to the reference's.  The
kernels' plain versions are held against the reference's Pallas kernels
#11 (``_gmm_call``, both ``transpose_w``), #12 (``_gmm_glu_call``, with
and without ``save_pre``) and #13 (``_gmm_dw_call``) run in interpret
mode on the same numpy inputs, and the autograd Functions and the
dropless FFN against the reference's ``custom_vjp`` rules.  Tolerance:
1e-5 relative L2 in f32, from sums taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import grouped_matmul as G

from paddle_tpu_torch.ops import grouped_matmul as gm

TOL = 1e-5


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _routes(rng, m, e, kind):
    if kind == "uniform":
        return rng.integers(0, e, m)
    if kind == "skewed":                     # most rows on expert 1
        r = rng.integers(0, e, m)
        r[rng.random(m) < 0.7] = 1
        return r
    if kind == "empty":                      # expert 2 gets nothing
        r = rng.integers(0, e, m)
        return np.where(r == 2, 3, r)
    # invalid rows: ids >= e mark padding
    r = rng.integers(0, e + 3, m)
    r[:5] = e
    return r


@pytest.mark.parametrize("tm", [8, 128])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "empty", "invalid"])
def test_plans_equal_the_reference(tm, kind):
    rng = np.random.default_rng(1)
    e, m = 6, 150
    re = _routes(rng, m, e, kind).astype(np.int32)
    want = G.make_dropless_plan_rows(jnp.asarray(re), e, tm)
    got = gm.make_dropless_plan_rows(torch.tensor(re), e, tm)
    for name, w, g in zip(("order", "dest", "valid_sorted", "tile_expert",
                           "counts"), want[:5], got[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[5] == want[5]
    idx = rng.integers(0, e, (m // 3, 3)).astype(np.int32)
    for w, g in zip(G.make_dropless_plan(jnp.asarray(idx), e, tm),
                    gm.make_dropless_plan(torch.tensor(idx), e, tm)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("e,n_rows", [(8, 64), (8, 10000), (60, 544),
                                      (60, 65536), (64, 24576)])
def test_auto_tm_equals_the_reference(e, n_rows):
    assert gm._auto_tm(e, n_rows) == G._auto_tm(e, n_rows)


def _buffer(seed, *, t=40, k=2, e=5, h=32, tm=8):
    """A plan over random routes (expert 2 empty) and its padded f32 row
    buffer, as numpy."""
    rng = np.random.default_rng(seed)
    idx = _routes(rng, t * k, e, "empty").reshape(t, k).astype(np.int32)
    order, dest, te, counts, m_pad = gm.make_dropless_plan(
        torch.tensor(idx), e, tm)
    xs = np.zeros((m_pad, h), np.float32)
    xs[dest.numpy()] = rng.standard_normal((t * k, h))
    return rng, xs, te.numpy(), counts.numpy()


@pytest.mark.parametrize("transpose_w", [False, True], ids=["nn", "nt"])
def test_plain_gmm_matches_the_pallas_kernel(transpose_w):
    rng, xs, te, _ = _buffer(0)
    e, k, n = 5, xs.shape[1], 24
    w = rng.standard_normal((e, n, k) if transpose_w else (e, k, n)) \
        .astype(np.float32)
    want = G._gmm_call(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(te),
                       transpose_w=transpose_w, tm=8, tc=k, tj=n,
                       interpret=True)
    got = gm.gmm_raw(torch.tensor(xs), torch.tensor(w), torch.tensor(te),
                     transpose_w=transpose_w)
    assert got.dtype == torch.float32
    assert _rel_l2(got, want) <= TOL


@pytest.mark.parametrize("save_pre", [False, True], ids=["hs", "save_pre"])
def test_plain_glu_matches_the_pallas_kernel(save_pre):
    rng, xs, te, _ = _buffer(1)
    e, h, f = 5, xs.shape[1], 16
    wg, wu = (rng.standard_normal((e, h, f)).astype(np.float32)
              for _ in range(2))
    want = G._gmm_glu_call(jnp.asarray(xs), jnp.asarray(wg), jnp.asarray(wu),
                           jnp.asarray(te), tm=8, tc=h, tj=f,
                           save_pre=save_pre, interpret=True)
    got = gm.gmm_glu_raw(torch.tensor(xs), torch.tensor(wg),
                         torch.tensor(wu), torch.tensor(te),
                         save_pre=save_pre)
    assert len(got) == len(want) == (3 if save_pre else 1)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= TOL


def test_plain_dw_matches_the_pallas_kernel():
    rng, xs, te, counts = _buffer(2)
    e, n = 5, 24
    dout = rng.standard_normal((xs.shape[0], n)).astype(np.float32)
    want = G._gmm_dw_call(jnp.asarray(xs), jnp.asarray(dout),
                          jnp.asarray(te), jnp.asarray(counts), e, tm=8,
                          tk=xs.shape[1], tn=n, interpret=True)
    got = gm.gmm_dw_raw(torch.tensor(xs), torch.tensor(dout),
                        torch.tensor(te), torch.tensor(counts), e)
    assert counts[2] == 0 and not got[2].any()
    assert _rel_l2(got, want) <= TOL


def test_autograd_functions_match_the_custom_vjps():
    rng, xs, te, counts = _buffer(3)
    e, h, f = 5, xs.shape[1], 16
    wg, wu = (rng.standard_normal((e, h, f)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((e, f, h)).astype(np.float32)
    ct = rng.standard_normal((xs.shape[0], h)).astype(np.float32)
    cfg_glu, cfg_gmm = (8, h, f, True), (8, f, h, True)

    def ref(xs, wg, wu, wd):
        hs = G.glu_grouped(xs, wg, wu, jnp.asarray(te), jnp.asarray(counts),
                           cfg_glu)
        return G.grouped_matmul(hs, wd, jnp.asarray(te),
                                jnp.asarray(counts), cfg_gmm)

    want, vjp = jax.vjp(jax.jit(ref), *map(jnp.asarray, (xs, wg, wu, wd)))
    want_grads = vjp(jnp.asarray(ct))
    ins = [torch.tensor(a, requires_grad=True) for a in (xs, wg, wu, wd)]
    tt, tc = torch.tensor(te), torch.tensor(counts)
    hs = gm.glu_grouped(ins[0], ins[1], ins[2], tt, tc)
    out = gm.grouped_matmul(hs, ins[3], tt, tc)
    grads = torch.autograd.grad(out, ins, torch.tensor(ct))
    assert _rel_l2(out.detach(), want) <= TOL
    for name, g, w in zip(("x", "wg", "wu", "wd"), grads, want_grads):
        assert _rel_l2(g, w) <= TOL, name


def test_dropless_moe_ffn_matches_the_reference():
    """At the reference's own row tile (``_auto_tm``: 128 here)."""
    rng = np.random.default_rng(4)
    t, k, e, h, f = 24, 2, 6, 32, 16
    x = rng.standard_normal((t, h)).astype(np.float32)
    gv = rng.random((t, k)).astype(np.float32)
    idx = _routes(rng, t * k, e, "skewed").reshape(t, k).astype(np.int32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((e, h, f), (e, h, f), (e, f, h))]
    ct = rng.standard_normal((t, h)).astype(np.float32)

    def ref(x, gv, *ws):
        return G.dropless_moe_ffn(x, gv, jnp.asarray(idx), *ws,
                                  interpret=True)

    want, vjp = jax.vjp(jax.jit(ref), *map(jnp.asarray, (x, gv, *ws)))
    want_grads = vjp(jnp.asarray(ct))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, gv, *ws)]
    out = gm.dropless_moe_ffn(ins[0], ins[1], torch.tensor(idx), *ins[2:])
    grads = torch.autograd.grad(out, ins, torch.tensor(ct))
    assert _rel_l2(out.detach(), want) <= TOL
    for name, g, w in zip(("x", "gate_vals", "wg", "wu", "wd"), grads,
                          want_grads):
        assert _rel_l2(g, w) <= TOL, name


def test_glu_keeps_no_pre_activations_without_grad():
    """The forward writes hg and hu only when a gradient will be taken
    (the recompute's first run takes none)."""
    _, xs, te, counts = _buffer(5)
    w = torch.ones(5, xs.shape[1], 8, requires_grad=True)
    calls = []
    orig = gm.gmm_glu_raw

    def spy(*a, **kw):
        calls.append(kw.get("save_pre", False))
        return orig(*a, **kw)

    gm.gmm_glu_raw = spy
    try:
        with torch.no_grad():
            gm.glu_grouped(torch.tensor(xs), w, w, torch.tensor(te),
                           torch.tensor(counts))
        gm.glu_grouped(torch.tensor(xs), w, w, torch.tensor(te),
                       torch.tensor(counts))
    finally:
        gm.gmm_glu_raw = orig
    assert calls == [False, True]


def test_wrappers_refuse_bad_shapes():
    te = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="lhs"):
        gm.gmm_raw(torch.zeros(16), torch.zeros(1, 4, 4), te)
    with pytest.raises(ValueError, match="lhs"):
        gm.gmm_dw_raw(torch.zeros(16, 4, 1), torch.zeros(16, 4), te,
                      torch.zeros(1, dtype=torch.int32), 1)
