"""What the 16-bit tensor-core routes of #3 (dQ), #10 (matmul+rope), #11
(grouped matmul) and #13 (its per-expert dW) are held to, checked on the
CPU.

- The port's plain backward (the yardstick of the wgmma dQ kernel on the
  card) against the reference's Pallas backward ``_bwd_impl`` in
  interpret mode, on masks that hide every key of some rows: such a row
  has lse -1e30 and weighs each of its keys alike (p = 1), the case the
  kernel's "subtraction first" edge path reproduces.  Tolerance 2e-5
  absolute on gradients of order 1 (f32 sums in another order).
- ``chip_smoke.py``'s route gate: a traced bf16 training step passes
  only if every traced kernel of each named family is a wgmma one (for
  the MoE step, the grouped matmul, fused gate/up and dW families too);
  a traced serve only if #1's attention kernels are its route's
  (``mma.sync`` for bf16 over bf16 pools, 3xTF32 for f32 q over bf16
  pools) and not the FMA-pipe ``ragged_attend`` they replaced; the f32
  routes (#2, #4, #3 and #5 on 3xTF32, #11's streaming rows, the split
  decode) only if no traced kernel is the one they replaced.
- The plain dW (the yardstick of the wgmma dW kernel on the card)
  against the reference's ``_gmm_dw_call`` in interpret mode: rows past
  an expert's count are never read, whatever they hold, and the plan's
  own buffers and backward keep those rows zero.  Tolerance 1e-5
  relative L2 (f32 sums in another order).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.ops import flash_attention as port
from paddle_tpu_torch.ops import grouped_matmul as gm

TOL = 2e-5
ROOT = Path(__file__).resolve().parent.parent


def _hidden_rows_case(causal, seed=11):
    """q [1, 64, 4, 64] against k/v [1, 64, 2, 64] (GQA 2) and a mask
    [1, 1, 64, 64] hiding every key of some rows: every fifth row and the
    last without causal masking; with it, every third row of the last
    32-row tile (a row above it would see only its tile's keys)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.standard_normal((1, 64, 4, 64)).astype(f)
    k = rng.standard_normal((1, 64, 2, 64)).astype(f)
    v = rng.standard_normal((1, 64, 2, 64)).astype(f)
    do = rng.standard_normal((1, 64, 4, 64)).astype(f)
    mask = rng.standard_normal((1, 1, 64, 64)).astype(f)
    mask[..., -16:] = -1e30
    if causal:
        mask[..., 32::3, :] = -1e30
    else:
        mask[..., ::5, :] = -1e30
        mask[..., -1, :] = -1e30
    return q, k, v, do, mask


@pytest.mark.parametrize("causal", [False, True], ids=["mask", "causal"])
def test_plain_backward_matches_reference_on_hidden_rows(causal):
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("this jax has no pltpu.force_tpu_interpret_mode "
                    "(kernel-vs-reference parity needs TPU-capable jax)")
    from paddle_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd
    q, k, v, do, mask = _hidden_rows_case(causal)
    tr = [jnp.asarray(np.swapaxes(x, 1, 2)) for x in (q, k, v, do)]
    jm = jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        out, lse = _fwd(*tr[:3], causal=causal, bq=32, bk=32, mask=jm)
        want = _bwd_impl(*tr[:3], out, lse, tr[3], causal=causal, bq=32,
                         bk=32, mask=jm)
    lse_np = np.asarray(lse)[..., 0]
    assert (lse_np <= -1e29).any(), "no row has every key hidden"
    t = torch.from_numpy
    got = port.flash_attention_bwd_reference(
        t(q), t(k), t(v), t(np.swapaxes(np.asarray(out), 1, 2).copy()),
        t(lse_np.copy()), t(do), causal=causal, mask=t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(),
                                   np.swapaxes(np.asarray(w), 1, 2),
                                   rtol=0, atol=TOL)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WGMMA_STEP = {
    "void ptt::flash_fwd_wgmma<__nv_bfloat16, 128, 2, false>": 22.2,
    "void ptt::flash_bwd_dq_wgmma<__nv_bfloat16, 128, false>": 31.1,
    "void ptt::flash_bwd_dkv_wgmma<__nv_bfloat16, 128, false>": 41.1,
    "void ptt::matmul_rope_wgmma<128, __nv_bfloat16>": 20.1}


def test_route_gate_passes_a_step_on_the_tensor_cores():
    cs = _chip_smoke()
    assert [cs.kernel_family(n) for n in WGMMA_STEP] == [
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "matmul_rope"]
    cs.check_tensor_core_route({"routed_kernel_ms": WGMMA_STEP},
                               "train_fused",
                               cs.FLASH_FAMILIES + ("matmul_rope",))


@pytest.mark.parametrize("swap", [
    ("void ptt::flash_bwd_dq_wgmma<__nv_bfloat16, 128, false>",
     "void ptt::flash_bwd_dq<__nv_bfloat16, 128, false>"),
    ("void ptt::matmul_rope_wgmma<128, __nv_bfloat16>",
     "void ptt::matmul_rope_bf16<128>"),
    ("void ptt::flash_bwd_dq_wgmma<__nv_bfloat16, 128, false>", None)],
    ids=["fma_dq", "mma_sync_rope", "no_dq"])
def test_route_gate_refuses_a_step_off_the_tensor_cores(swap):
    cs = _chip_smoke()
    old, new = swap
    prof = {n: ms for n, ms in WGMMA_STEP.items() if n != old}
    if new is not None:
        prof[new] = WGMMA_STEP[old]
    with pytest.raises(cs.SmokeFailure, match="tensor-core route"):
        cs.check_tensor_core_route({"routed_kernel_ms": prof},
                                   "train_fused",
                                   cs.FLASH_FAMILIES + ("matmul_rope",))


MOE_STEP = {
    "void ptt::flash_fwd_wgmma<__nv_bfloat16, 128, 1, false>": 8.4,
    "void ptt::flash_bwd_dq_wgmma<__nv_bfloat16, 128, false>": 4.6,
    "void ptt::flash_bwd_dkv_wgmma<__nv_bfloat16, 128, false>": 8.1,
    "void ptt::gmm_wgmma<false>": 22.0,
    "void ptt::gmm_wgmma<true>": 33.0,
    "void ptt::dw_wgmma": 32.0,
    "void ptt::glu_wgmma": 18.0}


def test_route_gate_passes_a_moe_step_on_the_tensor_cores():
    cs = _chip_smoke()
    assert [cs.kernel_family(n) for n in MOE_STEP] == [
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "grouped_matmul",
        "grouped_matmul", "grouped_matmul_dw", "grouped_matmul_glu"]
    cs.check_tensor_core_route({"routed_kernel_ms": MOE_STEP}, "train_moe",
                               cs.FLASH_FAMILIES + cs.GROUPED_FAMILIES)


@pytest.mark.parametrize("swap", [
    ("void ptt::gmm_wgmma<false>", "void ptt::gmm_bf16<false>"),
    ("void ptt::gmm_wgmma<true>", "void ptt::gmm_t_f32<__nv_bfloat16>"),
    ("void ptt::dw_wgmma", "void ptt::dw_bf16"),
    ("void ptt::dw_wgmma", "void ptt::dw_f32"),
    ("void ptt::dw_wgmma", None),
    ("void ptt::glu_wgmma", "void ptt::glu_bf16"),
    ("void ptt::glu_wgmma", None)],
    ids=["mma_sync_gmm", "fma_gmm_t", "mma_sync_dw", "fma_dw", "no_dw",
         "mma_sync_glu", "no_glu"])
def test_route_gate_refuses_a_moe_step_off_the_tensor_cores(swap):
    cs = _chip_smoke()
    old, new = swap
    prof = {n: ms for n, ms in MOE_STEP.items() if n != old}
    if new is not None:
        prof[new] = MOE_STEP[old]
    with pytest.raises(cs.SmokeFailure, match="tensor-core route"):
        cs.check_tensor_core_route({"routed_kernel_ms": prof}, "train_moe",
                                   cs.FLASH_FAMILIES + cs.GROUPED_FAMILIES)


def _dw_buffers(fill, seed=5, *, t=40, k=2, e=5, h=32, n=24, tm=8):
    """A plan over random routes (expert 2 empty; the dead tail maps to
    expert 4), lhs [m_pad, h] and dout [m_pad, n] random on the routed
    rows and ``fill`` (random or NaN) on every other row, the same with
    those rows zero, and the plan's tile_expert and counts (numpy)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, e, (t, k))
    idx = np.where(idx == 2, 3, idx).astype(np.int32)
    _, _, te, counts, m_pad = gm.make_dropless_plan(torch.tensor(idx), e, tm)
    keep = gm.routed_rows(te, counts, m_pad).numpy()[:, None]
    bufs = []
    for c in (h, n):
        x = rng.standard_normal((m_pad, c)).astype(np.float32)
        pad = np.full_like(x, np.nan) if fill == "nan" else \
            rng.standard_normal(x.shape).astype(np.float32)
        bufs.append((np.where(keep, x, pad), np.where(keep, x, 0)))
    return bufs, te.numpy(), counts.numpy()


@pytest.mark.parametrize("fill", ["random", "nan"])
def test_plain_dw_never_reads_rows_past_the_counts(fill):
    """#13's plain version on buffers whose padding rows and dead tail
    hold ``fill``: the reference's ``_gmm_dw_call`` (interpret mode) on
    the same buffers with those rows zero, and bit for bit the plain
    version on the zeroed buffers."""
    from paddle_tpu.ops.pallas.grouped_matmul import _gmm_dw_call
    ((xs, xs0), (dout, dout0)), te, counts = _dw_buffers(fill)
    e = counts.shape[0]
    assert counts[2] == 0 and (np.delete(counts, 2) > 0).all()
    want = _gmm_dw_call(jnp.asarray(xs0), jnp.asarray(dout0),
                        jnp.asarray(te), jnp.asarray(counts), e, tm=8,
                        tk=xs.shape[1], tn=dout.shape[1], interpret=True)
    t = torch.from_numpy
    got = gm.gmm_dw_raw(t(xs), t(dout), t(te), t(counts), e)
    clean = gm.gmm_dw_raw(t(xs0), t(dout0), t(te), t(counts), e)
    assert torch.equal(got, clean)
    assert not got[2].any()
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= 1e-5, err


def test_plan_and_backward_keep_padding_rows_zero(monkeypatch):
    """Through the dropless FFN's backward, every buffer that reaches
    #13 (lhs and dout of the gate, up and down dW) is zero on the rows
    past their expert's count and on the dead tail: the plan builds them
    so and the backward keeps them so."""
    rng = np.random.default_rng(6)
    t, k, e, h, f = 24, 2, 5, 16, 8
    x = torch.tensor(rng.standard_normal((t, h)), dtype=torch.float32,
                     requires_grad=True)
    gv = torch.tensor(rng.random((t, k)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, e, (t, k)), dtype=torch.int32)
    ws = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                       requires_grad=True)
          for s in ((e, h, f), (e, h, f), (e, f, h))]
    seen = []
    real = gm.gmm_dw_raw

    def spy(lhs, dout, tile_expert, counts, num_experts):
        seen.append((lhs, dout, tile_expert, counts))
        return real(lhs, dout, tile_expert, counts, num_experts)

    monkeypatch.setattr(gm, "gmm_dw_raw", spy)
    out = gm.dropless_moe_ffn(x, gv, idx, *ws, tm=8)
    out.sum().backward()
    assert len(seen) == 3
    for lhs, dout, te, counts in seen:
        pad = ~gm.routed_rows(te, counts, lhs.shape[0])
        assert pad.any()
        assert not lhs[pad].any() and not dout[pad].any()


# the redesigned f32 routes: #2's f32 forward (3xTF32 on
# wgmma, with its key-split merge) on the GPT-2 step and the split
# path's int8 prefill, #11's f32 rows (the streaming kernel) in MoE
# serving
F32_ROUTES = {
    "train_gpt2_profile": ("flash_fwd", "3xtf32", [
        "void ptt::flash_fwd_3xtf32<64, true>"]),
    "serve_split_int8_profile": ("flash_fwd", "3xtf32", [
        "void ptt::flash_fwd_3xtf32<128, false>",
        "void ptt::flash_fwd_3xtf32_merge<128>"]),
    "serve_moe_profile": ("grouped_matmul", "stream", [
        "void ptt::gmm_rows_stream<__nv_bfloat16>"]),
}
OLD_F32 = {"train_gpt2_profile": "void ptt::flash_fwd<float, 64, true>",
           "serve_split_int8_profile": "void ptt::flash_fwd<float, 128, "
                                       "false>",
           "serve_moe_profile": "void ptt::gmm_rows_f32<__nv_bfloat16>"}


@pytest.mark.parametrize("phase", list(F32_ROUTES))
@pytest.mark.parametrize("old", [False, True], ids=["new", "old_kernel"])
def test_route_gate_holds_the_f32_routes_to_their_designs(phase, old):
    """The design labels read from traced names, and the gate on them:
    the redesigned f32 kernels pass, a trace that still shows the kernel
    they replaced fails."""
    cs = _chip_smoke()
    fam, design, names = F32_ROUTES[phase]
    assert {cs.design_of(n) for n in names} == {design}
    assert {cs.kernel_family(n) for n in names} == {fam}
    assert cs.design_of(OLD_F32[phase]) == "fma"
    prof = {n: 1.0 for n in names}
    if old:
        prof[OLD_F32[phase]] = 1.0
        with pytest.raises(cs.SmokeFailure, match=f"{design} route"):
            cs.check_tensor_core_route({"routed_kernel_ms": prof}, phase,
                                       (fam,), design=design)
    else:
        cs.check_tensor_core_route({"routed_kernel_ms": prof}, phase,
                                   (fam,), design=design)


# the routes redesigned after those: #4's f32 dK/dV (3xTF32 on wgmma) on
# the GPT-2 step, and #7 spread over blocks by key span on the split
# path's serves (float and int8 pools)
SPAN_AND_DKV_ROUTES = {
    # phase: (family, design, new kernel names, the name it replaced)
    "train_gpt2_profile": ("flash_bwd_dkv", "3xtf32", [
        "void ptt::flash_bwd_dkv_3xtf32<64, true>"],
        "void ptt::flash_bwd_dkv<float, 64, true>"),
    "serve_split_profile": ("paged_decode", "split", [
        "void ptt::pd::paged_decode_split<__nv_bfloat16, __nv_bfloat16, "
        "128, 4>"],
        "void ptt::paged_decode<__nv_bfloat16, __nv_bfloat16, 128, 4>"),
    "serve_split_int8_profile": ("paged_decode", "split", [
        "void ptt::pd::paged_decode_split<__nv_bfloat16, signed char, "
        "128, 4>"],
        "void ptt::paged_decode<__nv_bfloat16, signed char, 128, 4>"),
}


@pytest.mark.parametrize("phase", list(SPAN_AND_DKV_ROUTES))
@pytest.mark.parametrize("old", [False, True], ids=["new", "old_kernel"])
def test_route_gate_holds_the_split_decode_and_f32_dkv(phase, old):
    """The design labels read from the redesigned #7 and f32 #4 kernels'
    traced names, and the gate on them: the new kernels pass, a trace
    that still shows the kernel they replaced fails."""
    cs = _chip_smoke()
    fam, design, names, replaced = SPAN_AND_DKV_ROUTES[phase]
    assert fam in cs.ROUTED_FAMILIES
    assert {cs.design_of(n) for n in names} == {design}
    assert {cs.kernel_family(n) for n in names} == {fam}
    assert cs.kernel_family(replaced) == fam
    assert cs.design_of(replaced) == "fma"
    prof = {n: 1.0 for n in names}
    if old:
        prof[replaced] = 1.0
        with pytest.raises(cs.SmokeFailure, match=f"{design} route"):
            cs.check_tensor_core_route({"routed_kernel_ms": prof}, phase,
                                       (fam,), design=design)
    else:
        cs.check_tensor_core_route({"routed_kernel_ms": prof}, phase,
                                   (fam,), design=design)


# #3's f32 dQ and #5's f32 bias gradient (3xTF32 on wgmma): the GPT-2
# step's dQ and the encoder layer's dbias
DQ_DBIAS_ROUTES = {
    # family: (phase, new kernel names, the name it replaced)
    "flash_bwd_dq": ("train_gpt2_profile", [
        "void ptt::flash_bwd_dq_3xtf32<64, true>"],
        "void ptt::flash_bwd_dq<float, 64, true>"),
    "flash_dbias": ("encoder_bias_profile", [
        "void ptt::flash_dbias_3xtf32<64, true>"],
        "void ptt::flash_dbias<float, 64, true>"),
}


@pytest.mark.parametrize("fam", list(DQ_DBIAS_ROUTES))
@pytest.mark.parametrize("old", [False, True], ids=["new", "old_kernel"])
def test_route_gate_holds_the_f32_dq_and_dbias(fam, old):
    """The design labels read from the 3xTF32 dQ and dbias kernels'
    traced names, and the gate on them: the new kernels pass, a trace
    that still shows the FMA-pipe kernel they replaced fails."""
    cs = _chip_smoke()
    phase, names, replaced = DQ_DBIAS_ROUTES[fam]
    assert fam in cs.ROUTED_FAMILIES
    assert {cs.design_of(n) for n in names} == {"3xtf32"}
    assert {cs.kernel_family(n) for n in names} == {fam}
    assert cs.kernel_family(replaced) == fam
    assert cs.design_of(replaced) == "fma"
    prof = {n: 1.0 for n in names}
    if old:
        prof[replaced] = 1.0
        with pytest.raises(cs.SmokeFailure, match="3xtf32 route"):
            cs.check_tensor_core_route({"routed_kernel_ms": prof}, phase,
                                       (fam,), design="3xtf32")
    else:
        cs.check_tensor_core_route({"routed_kernel_ms": prof}, phase,
                                   (fam,), design="3xtf32")


# #1's routes in the traced serves: the bf16 serves (Llama-3-8B at group
# 4, Qwen1.5-MoE at group 1) on mma.sync, the f32-weight serve over bf16
# pools on 3xTF32; each with its append
RAGGED_ROUTES = {
    "profile": ("mma", [
        "void ptt::rg::ragged_append<__nv_bfloat16, __nv_bfloat16, 128>",
        "void ptt::rg::ragged_attend_mma<__nv_bfloat16, 128>"]),
    "serve_f32w_bf16kv_profile": ("3xtf32", [
        "void ptt::rg::ragged_append<float, __nv_bfloat16, 128>",
        "void ptt::rg::ragged_attend_3xtf32<float, __nv_bfloat16, 128>"]),
}
OLD_RAGGED = {
    "profile": "void ptt::ragged_attend<__nv_bfloat16, 128, __nv_bfloat16>",
    "serve_f32w_bf16kv_profile":
        "void ptt::ragged_attend<float, 128, __nv_bfloat16>"}


@pytest.mark.parametrize("phase", list(RAGGED_ROUTES))
@pytest.mark.parametrize("case", ["new", "old_kernel", "other_route"])
def test_route_gate_holds_the_ragged_kernel_to_its_route(phase, case):
    """The families and design labels read from #1's traced names, and
    the gate on them: the redesigned kernels pass; a trace that still
    shows the FMA-pipe ``ragged_attend`` they replaced, or the other
    route's attention kernel, fails."""
    cs = _chip_smoke()
    design, names = RAGGED_ROUTES[phase]
    assert [cs.kernel_family(n) for n in names] == [
        "ragged_append", "ragged_attend"]
    assert cs.design_of(names[1]) == design
    assert set(cs.RAGGED_FAMILIES) <= set(cs.ROUTED_FAMILIES)
    old = OLD_RAGGED[phase]
    assert cs.kernel_family(old) == "ragged_attend"
    assert cs.design_of(old) == "fma"
    prof = {n: 1.0 for n in names}
    if case == "new":
        cs.check_tensor_core_route({"routed_kernel_ms": prof}, phase,
                                   ("ragged_attend",), design=design)
        return
    other = [n for p, (_, ns) in RAGGED_ROUTES.items() if p != phase
             for n in ns][1]
    prof[old if case == "old_kernel" else other] = 1.0
    with pytest.raises(cs.SmokeFailure, match=f"{design} route"):
        cs.check_tensor_core_route({"routed_kernel_ms": prof}, phase,
                                   ("ragged_attend",), design=design)


def test_ragged_trace_sums_the_append_and_attention(monkeypatch):
    """``traced_kernel`` over #1's families: ``device_ms`` is the append
    and attention kernels' time a call, ``design`` the attention
    kernel's label."""
    cs = _chip_smoke()
    names = RAGGED_ROUTES["profile"][1]
    ms = dict(zip(names, (0.3, 4.5)))

    def fake_profiled(torch_mod, fn):
        fn()
        fams, counts = {}, {}
        for n, t in ms.items():
            f = cs.kernel_family(n)
            fams[f] = fams.get(f, 0.0) + t
            counts[f] = counts.get(f, 0) + 3
        return None, {"routed_kernel_ms": dict(ms),
                      "kernel_ms_by_family": fams,
                      "kernel_count_by_family": counts,
                      "top_kernels": []}

    monkeypatch.setattr(cs, "profiled", fake_profiled)
    got = cs.traced_kernel(torch, lambda: None, cs.RAGGED_FAMILIES)
    assert got["design"] == "mma" and got["trace_retries"] == 0
    assert got["device_ms"] == pytest.approx((0.3 + 4.5) / 3)


@pytest.mark.parametrize("short", [0, 1, 3, 4])
def test_trace_is_taken_again_while_the_profiler_drops_events(
        monkeypatch, short):
    """``traced_kernel`` takes a trace whose kernel count is not a
    multiple of its calls again, up to ``TRACE_RETRIES`` times, and fails
    when the last one is short too."""
    cs = _chip_smoke()
    name = "void ptt::glu_wgmma"
    traces = []

    def fake_profiled(torch_mod, fn):
        fn()
        n = 2 if len(traces) < short else 3      # 3 calls, 1 kernel each
        traces.append(n)
        return None, {"routed_kernel_ms": {name: 1.0 * n},
                      "kernel_ms_by_family": {"grouped_matmul_glu": 1.0 * n},
                      "kernel_count_by_family": {"grouped_matmul_glu": n},
                      "top_kernels": []}

    monkeypatch.setattr(cs, "profiled", fake_profiled)
    if short > cs.TRACE_RETRIES:
        with pytest.raises(cs.SmokeFailure, match="lost events"):
            cs.traced_kernel(torch, lambda: None, "grouped_matmul_glu")
        return
    got = cs.traced_kernel(torch, lambda: None, "grouped_matmul_glu")
    assert got["trace_retries"] == short and got["design"] == "wgmma"
    assert got["device_ms"] == pytest.approx(1.0)
