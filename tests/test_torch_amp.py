"""amp O1 (``amp.auto_cast``), ``GradScaler`` and #9's mixed-dtype mode
against the reference's (``paddle_tpu.amp``).

- Op by op: under ``auto_cast`` O1 (bf16 and f16) every white- and
  black-listed op the port has (``Linear`` / ``F.linear``, ``conv2d``,
  ``scaled_dot_product_attention``, ``cross_entropy``, ``nll_loss``,
  ``binary_cross_entropy``) and an unlisted one (``l1_loss``) return the
  reference's dtype; custom lists too (a name on both lists counts as
  white, as in the reference).
- A tiny post-norm ``Transformer`` (E 32, 2 heads, 2 + 2 layers) under
  O1 bf16 on both sides, weights carried in: the output within 1e-2
  relative L2 and the parameter gradients (through ``jax.vjp``) within
  8e-2.  The products take the same bf16 operands on both sides; the
  roundings differ where the reference rounds the attention
  probabilities and dP = dO V^T to bf16 (the port's plain attention
  keeps them f32 and rounds dq, dk, dv once).  At this seed the output
  sits 0.5 % from the f32 model's on both sides and the gradients 5-13 %
  (bf16 rounds every block's output and its gradient); the two sides
  are at most 6 % apart, nearer each other than either is to f32.
- #9's plain version in the mixed mode (bf16 or f16 x over an f32
  residual): h and y f32, x's gradient in x's dtype and the residual's
  in f32, each within 1e-6 of the reference's ``jax.vjp`` (one rounding
  of the same f32 value).
- ``GradScaler`` over the eager SGD on a scripted sequence with inf
  injected at steps 1, 2 and 5: scale, good and bad counts, which steps
  were skipped (parameters bit-equal across each), the parameters
  (1e-6) and the state dict, and its round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.jit.train import traced_forward
from paddle_tpu.ops.pallas import fused_train as ref_ft

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common import Linear
from paddle_tpu_torch.nn.transformer import Transformer
from paddle_tpu_torch.ops import fused_train as ft

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _rel_l2(want, got):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.linalg.norm(want - got) / np.linalg.norm(want))


def _ref_t(a, dt=None):
    t = paddle.to_tensor(a)
    return t if dt is None else t.astype(dt)


def _ops(rng):
    """name -> (reference call, port call) on the same numpy inputs."""
    x = rng.standard_normal((2, 8)).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    img = rng.standard_normal((1, 2, 5, 5)).astype(np.float32)
    ker = rng.standard_normal((3, 2, 3, 3)).astype(np.float32)
    q = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    logits = rng.standard_normal((4, 6)).astype(np.float32)
    lab = rng.integers(0, 6, 4).astype(np.int64)
    prob = rng.uniform(0.1, 0.9, (4, 3)).astype(np.float32)
    t = torch.from_numpy
    half = {"torch": torch.bfloat16, "ref": "bfloat16"}
    lin = Linear(8, 4, device="cpu")
    ref_lin = paddle.nn.Linear(8, 4)
    load_raw_state_dict(lin, {k: np.asarray(v) for k, v in
                              ref_lin.raw_state_dict().items()})
    return {
        "Linear": (lambda: ref_lin(_ref_t(x)), lambda: lin(t(x))),
        "linear": (lambda: RF.linear(_ref_t(x), _ref_t(w)),
                   lambda: F.linear(t(x), t(w))),
        "conv2d": (lambda: RF.conv2d(_ref_t(img), _ref_t(ker)),
                   lambda: F.conv2d(t(img), t(ker))),
        "scaled_dot_product_attention": (
            lambda: RF.scaled_dot_product_attention(
                _ref_t(q), _ref_t(q), _ref_t(q)),
            lambda: F.scaled_dot_product_attention(t(q), t(q), t(q))),
        "cross_entropy": (
            lambda: RF.cross_entropy(_ref_t(logits, half["ref"]),
                                     _ref_t(lab)),
            lambda: F.cross_entropy(t(logits).to(half["torch"]), t(lab))),
        "nll_loss": (
            lambda: RF.nll_loss(_ref_t(logits, half["ref"]), _ref_t(lab)),
            lambda: F.nll_loss(t(logits).to(half["torch"]), t(lab))),
        "binary_cross_entropy": (
            lambda: RF.binary_cross_entropy(_ref_t(prob, half["ref"]),
                                            _ref_t(prob, half["ref"])),
            lambda: F.binary_cross_entropy(t(prob).to(half["torch"]),
                                           t(prob).to(half["torch"]))),
        "l1_loss": (lambda: RF.l1_loss(_ref_t(x), _ref_t(x)),
                    lambda: F.l1_loss(t(x), t(x))),
        "kl_div": (lambda: RF.kl_div(_ref_t(prob, half["ref"]),
                                     _ref_t(prob, half["ref"])),
                   lambda: F.kl_div(t(prob).to(half["torch"]),
                                    t(prob).to(half["torch"]))),
    }


def _dtype_name(out):
    out = out[0] if isinstance(out, tuple) else out
    return str(out.dtype).replace("torch.", "").replace("paddle.", "")


LISTS = {"defaults": ({}, {}),
         "custom": ({"custom_white_list": {"l1_loss"},
                     "custom_black_list": {"kl_div", "linear"}},
                    {"custom_white_list": {"l1_loss"},
                     "custom_black_list": {"kl_div", "linear"}})}


@pytest.mark.parametrize("lists", list(LISTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_o1_op_dtypes_equal_the_reference(dtype, lists):
    ops = _ops(np.random.default_rng(0))
    kw = LISTS[lists][0]
    got, want = {}, {}
    for name, (ref_call, port_call) in ops.items():
        with paddle.amp.auto_cast(level="O1", dtype=dtype, **kw):
            want[name] = _dtype_name(ref_call())
        with amp.auto_cast(level="O1", dtype=dtype, **kw):
            got[name] = _dtype_name(port_call())
    assert got == want
    assert got["linear"] == dtype and got["cross_entropy"] == "float32"
    if lists == "custom":
        assert got["l1_loss"] == dtype and got["kl_div"] == "float32"
    with amp.auto_cast(enable=False):
        assert amp.amp_state() is None
    assert amp.white_list() == paddle.amp.white_list()
    assert amp.black_list() == paddle.amp.black_list()


E, H, F_, B, S, T = 32, 2, 64, 2, 7, 6


def _run(m, b):
    return m(b["src"], b["tgt"], None, b["tgt_mask"])


def test_o1_transformer_outputs_and_gradients_match_reference():
    paddle.seed(0)
    ref = paddle.nn.Transformer(E, H, 2, 2, F_, dropout=0.0)
    port = Transformer(E, H, 2, 2, F_, dropout=0.0, device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    rng = np.random.default_rng(0)
    mask = np.asarray(paddle.nn.Transformer.generate_square_subsequent_mask(
        T).value)
    batch = {"src": rng.standard_normal((B, S, E)).astype(np.float32),
             "tgt": rng.standard_normal((B, T, E)).astype(np.float32),
             "tgt_mask": mask}
    ct = rng.standard_normal((B, T, E)).astype(np.float32)

    @jax.jit
    def outs_and_grads(params, b, cot):
        def fwd(p):
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                return traced_forward(ref, _run, p, b, jax.random.key(0))
        out, vjp = jax.vjp(fwd, params)
        return out, vjp(cot.astype(out.dtype))[0]

    want, want_g = outs_and_grads(ref.raw_state_dict(), batch, ct)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        out = _run(port, {k: torch.from_numpy(v.copy())
                          for k, v in batch.items()})
    assert str(out.dtype) == "torch." + str(want.dtype)
    assert _rel_l2(want, out.detach().float().numpy()) <= 1e-2
    params = dict(port.named_parameters())
    grads = torch.autograd.grad(
        (out.float() * torch.from_numpy(ct)).sum(), list(params.values()))
    scale = max(np.linalg.norm(np.asarray(w, np.float32))
                for w in want_g.values())
    for (n, p), g in zip(params.items(), grads):
        assert p.dtype == torch.float32 and g.dtype == torch.float32, n
        if n.endswith("k_proj.bias"):       # zero in exact arithmetic
            assert g.norm().item() <= 8e-2 * scale, n
        else:
            assert _rel_l2(want_g[n], g.numpy()) <= 8e-2, n


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_add_norm_mixed_mode_plain_version_matches_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(
        np.float32)).to(tdt)
    r = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 32)).astype(np.float32)
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    (jh, jy), vjp = jax.vjp(
        lambda a, c, ww, bb: ref_ft.add_layer_norm_reference(a, c, ww, bb,
                                                             1e-5),
        jx, jnp.asarray(r), jnp.asarray(w), jnp.asarray(b))
    jdx, jdr, jdw, jdb = vjp((jnp.zeros_like(jh), jnp.asarray(dy)))
    tx = x.clone().requires_grad_()
    tr, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (r, w, b))
    h, y = ft.add_layer_norm_raw(tx, tr, tw, tb)
    assert h.dtype == y.dtype == torch.float32
    y.backward(torch.from_numpy(dy))
    assert tx.grad.dtype == tdt and tr.grad.dtype == torch.float32
    for want, got in ((jh, h), (jy, y), (jdx, tx.grad), (jdr, tr.grad),
                      (jdw, tw.grad), (jdb, tb.grad)):
        assert _rel_l2(want, got.detach().float().numpy()) <= 1e-6


INF_STEPS = {1, 2, 5}


def _scaler_kw():
    return dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
                decr_every_n_nan_or_inf=2)


def test_grad_scaler_decisions_equal_the_reference():
    rng = np.random.default_rng(2)
    paddle.seed(0)
    ref_m = paddle.nn.Linear(6, 3)
    port_m = Linear(6, 3, device="cpu")
    load_raw_state_dict(port_m, {k: np.asarray(v) for k, v in
                                 ref_m.raw_state_dict().items()})
    ref_opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=ref_m.parameters())
    port_opt = optimizer.SGD(learning_rate=0.1,
                             parameters=port_m.parameters())
    ref_s = paddle.amp.GradScaler(**_scaler_kw())
    port_s = amp.GradScaler(**_scaler_kw())
    trace_ref, trace_port = [], []
    for step in range(8):
        x = rng.standard_normal((4, 6)).astype(np.float32)
        boost = float("inf") if step in INF_STEPS else 1.0
        before = {n: p.detach().clone() for n, p in
                  port_m.named_parameters()}
        loss = (ref_m(paddle.to_tensor(x)) ** 2).mean() * boost
        ref_s.scale(loss).backward()
        ref_s.step(ref_opt)
        ref_opt.clear_grad()
        loss = (port_m(torch.from_numpy(x)) ** 2).mean() * boost
        port_s.scale(loss).backward()
        port_s.step(port_opt)
        port_opt.clear_grad()
        skipped = all(torch.equal(before[n], p) for n, p in
                      port_m.named_parameters())
        assert skipped == (step in INF_STEPS), step
        trace_ref.append(ref_s.state_dict())
        trace_port.append(port_s.state_dict())
        for n, p in port_m.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(ref_m.raw_state_dict()[n]),
                rtol=1e-6, atol=1e-6)
    assert trace_port == trace_ref
    assert [t["scale"] for t in trace_port] != [2.0 ** 10] * 8
    fresh = amp.GradScaler()
    fresh.load_state_dict(port_s.state_dict())
    assert fresh.state_dict() == port_s.state_dict() == ref_s.state_dict()
    assert fresh.get_loss_scaling() == ref_s.get_loss_scaling()
