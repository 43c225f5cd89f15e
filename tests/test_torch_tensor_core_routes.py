"""What the 16-bit tensor-core routes of #3 (dQ) and #10 (matmul+rope)
are held to, checked on the CPU.

- The port's plain backward (the yardstick of the wgmma dQ kernel on the
  card) against the reference's Pallas backward ``_bwd_impl`` in
  interpret mode, on masks that hide every key of some rows: such a row
  has lse -1e30 and weighs each of its keys alike (p = 1), the case the
  kernel's "subtraction first" edge path reproduces.  Tolerance 2e-5
  absolute on gradients of order 1 (f32 sums in another order).
- ``chip_smoke.py``'s route gate: a traced bf16 training step passes
  only if every traced kernel of each named family is a wgmma one.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.ops import flash_attention as port

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
