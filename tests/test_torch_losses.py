"""The port's losses (``ops/_nn.py``, exported by ``nn.functional``) and
loss layers (``nn/loss.py``) against the reference's.

One parametrised test over the functions the reference's 20 loss layers
call, ``label_smooth``, ``softmax_with_cross_entropy``,
``cross_entropy``'s options (``weight``, ``ignore_index``,
``soft_label``, ``axis``, ``use_softmax``, ``label_smoothing``, the
smoothing with ignored rows included) and ``fused_linear_cross_entropy``
with a bias, at each reduction where the function has one: the same
numpy inputs through ``paddle_tpu.ops._nn``'s function (``jax.vjp``) and
the port's (autograd), the value and the gradient of every float input
within 1e-5 relative (f32 sums in another order).  A second parametrised
test builds each of the 20 layers on both sides (the reference's
``AdaptiveLogSoftmaxWithLoss`` parameters carried in by
``load_raw_state_dict``) and holds their outputs within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import _nn as ref_nn

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.nn import functional as F

N, C = 6, 5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    lab = rng.integers(0, C, N).astype(np.int64)
    lab_ig = lab.copy()
    lab_ig[[1, 4]] = -100
    sign = np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(np.float32)
    prob = rng.uniform(0.05, 0.95, (N, C)).astype(np.float32)
    soft = rng.random((N, C)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    return {
        "x": f(N, C), "y": f(N, C), "z": f(N, C), "v": f(N), "w": f(N),
        "lab": lab, "lab_ig": lab_ig, "sign": sign, "prob": prob,
        "soft": soft, "bin": (rng.random((N, C)) < 0.5).astype(np.float32),
        "cw": rng.uniform(0.5, 2.0, C).astype(np.float32),
        "x3": f(2, C, 3), "lab3": rng.integers(0, C, (2, 3)),
        "pos": rng.uniform(0.1, 3.0, (N, C)).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, (N, C)).astype(np.float32),
        "logp": np.log(soft), "hid": f(N, 4), "wv": f(4, C),
        "bias": f(C),
        "ctc": f(7, 2, C), "ctc_lab": rng.integers(1, C, (2, 3)),
        "ctc_in": np.array([7, 5]), "ctc_len": np.array([3, 2]),
    }


def _case(fn, floats, ints=(), **kw):
    """A function of the float inputs ``floats`` and the integer inputs
    ``ints`` (names in ``_data``), with keyword arguments ``kw``."""
    return fn, floats, ints, kw


CE = "cross_entropy"
CASES = {
    "ce_mean": _case(CE, ["x"], ["lab"]),
    "ce_sum_ignore": _case(CE, ["x"], ["lab_ig"], reduction="sum"),
    "ce_none_smooth_ignore": _case(CE, ["x"], ["lab_ig"], reduction="none",
                                   label_smoothing=0.1),
    "ce_mean_smooth_ignore": _case(CE, ["x"], ["lab_ig"],
                                   label_smoothing=0.2),
    "ce_weight_ignore": _case(CE, ["x", "cw"], ["lab_ig"], grad_of=["x"],
                              arg_names={"cw": "weight"}),
    "ce_weight_sum": _case(CE, ["x", "cw"], ["lab"], reduction="sum",
                           grad_of=["x"], arg_names={"cw": "weight"}),
    "ce_soft": _case(CE, ["x", "soft"], soft_label=True),
    "ce_probs": _case(CE, ["prob"], ["lab"], use_softmax=False),
    "ce_axis1": _case(CE, ["x3"], ["lab3"], axis=1),
    "ce_trailing_label": _case(CE, ["x"], ["lab_col"]),
    "fused_bias_mean": _case("fused_linear_cross_entropy",
                             ["hid", "wv", "bias"], ["lab_ig"],
                             chunk_size=4, arg_names={"bias": "bias"}),
    "fused_bias_none": _case("fused_linear_cross_entropy",
                             ["hid", "wv", "bias"], ["lab"],
                             reduction="none", chunk_size=4,
                             arg_names={"bias": "bias"}),
    "nll_mean": _case("nll_loss", ["logp"], ["lab_ig"]),
    "nll_none": _case("nll_loss", ["logp"], ["lab"], reduction="none"),
    "bce": _case("binary_cross_entropy", ["prob", "bin"], grad_of=["prob"]),
    "bce_weight_sum": _case("binary_cross_entropy", ["prob", "bin", "soft"],
                            reduction="sum", grad_of=["prob"]),
    "bce_logits": _case("binary_cross_entropy_with_logits", ["x", "bin"],
                        grad_of=["x"]),
    "bce_logits_pos": _case("binary_cross_entropy_with_logits",
                            ["x", "bin", "soft", "pos"], grad_of=["x"],
                            arg_names={"soft": "weight",
                                       "pos": "pos_weight"}),
    "mse": _case("mse_loss", ["x", "y"]),
    "l1_none": _case("l1_loss", ["x", "y"], reduction="none"),
    "smooth_l1": _case("smooth_l1_loss", ["x", "y"], delta=0.5),
    "kl_div": _case("kl_div", ["logp", "probn"]),
    "kl_div_batchmean_log": _case("kl_div", ["logp", "logp2"],
                                  reduction="batchmean", log_target=True),
    "hinge_embedding": _case("hinge_embedding_loss", ["x", "sign_nc"],
                             grad_of=["x"], margin=0.5),
    "cosine_embedding": _case("cosine_embedding_loss", ["x", "y", "sign"],
                              grad_of=["x", "y"], margin=0.1),
    "margin_ranking": _case("margin_ranking_loss", ["v", "w", "sign"],
                            grad_of=["v", "w"], margin=0.2),
    "triplet": _case("triplet_margin_loss", ["x", "y", "z"]),
    "triplet_swap_p1": _case("triplet_margin_loss", ["x", "y", "z"], p=1.0,
                             swap=True, reduction="sum"),
    "triplet_distance": _case("triplet_margin_with_distance_loss",
                              ["x", "y", "z"], swap=True),
    "soft_margin": _case("soft_margin_loss", ["x", "sign_nc"],
                         grad_of=["x"]),
    "multi_label_soft_margin": _case("multi_label_soft_margin_loss",
                                     ["x", "bin", "cw"], grad_of=["x"],
                                     arg_names={"cw": "weight"}),
    "poisson_log": _case("poisson_nll_loss", ["x", "pos"], grad_of=["x"]),
    "poisson_full": _case("poisson_nll_loss", ["prob", "pos"],
                          grad_of=["prob"], log_input=False, full=True),
    "gaussian_full": _case("gaussian_nll_loss", ["x", "y", "var"],
                           full=True),
    "ctc_mean": _case("ctc_loss", ["ctc"], ["ctc_lab", "ctc_in", "ctc_len"]),
    "ctc_sum": _case("ctc_loss", ["ctc"], ["ctc_lab", "ctc_in", "ctc_len"],
                     reduction="sum"),
    "multi_margin": _case("multi_margin_loss", ["x"], ["lab"]),
    "multi_margin_p2_weight": _case("multi_margin_loss", ["x", "cw"],
                                    ["lab"], grad_of=["x"], p=2,
                                    margin=0.5, arg_names={"cw": "weight"}),
    "label_smooth": _case("label_smooth", ["soft"], epsilon=0.2),
    "softmax_with_ce": _case("softmax_with_cross_entropy", ["x"],
                             ["lab_ig_col"]),
    "softmax_with_ce_soft": _case("softmax_with_cross_entropy",
                                  ["x", "soft"], soft_label=True),
}


def _inputs(names, data):
    out = []
    for n in names:
        if n == "lab_col":
            out.append(data["lab"][:, None])
        elif n == "lab_ig_col":
            out.append(data["lab_ig"][:, None])
        elif n == "sign_nc":
            out.append(np.broadcast_to(data["sign"][:, None],
                                       (N, C)).copy())
        elif n in ("probn", "logp2"):
            p = (data["prob"] / data["prob"].sum(-1, keepdims=True))
            out.append((np.log(p) if n == "logp2" else p).astype(np.float32))
        else:
            out.append(data[n])
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("name", list(CASES))
def test_loss_functions_match_reference(name):
    fn, floats, ints, kw = CASES[name]
    kw = dict(kw)
    grad_of = kw.pop("grad_of", floats)
    arg_names = kw.pop("arg_names", {})
    data = _data()
    fv, iv = _inputs(floats, data), _inputs(ints, data)
    pos = [n for n in floats if n not in arg_names]
    if fn == "ctc_loss":
        kw.update(blank=0)

    def split(vals):
        d = dict(zip(floats, vals))
        return [d[n] for n in pos], {arg_names[n]: d[n] for n in arg_names}

    def ref(*vals):
        a, k = split(vals)
        return getattr(ref_nn, fn)(*a, *[jnp.asarray(i) for i in iv],
                                   **k, **kw)

    diff = [floats.index(n) for n in grad_of]
    want, vjp = jax.vjp(jax.jit(ref), *[jnp.asarray(v) for v in fv])
    tv = [torch.tensor(v, requires_grad=i in diff) for i, v in enumerate(fv)]
    a, k = split(tv)
    got = getattr(F, fn)(*a, *[torch.as_tensor(i) for i in iv], **k, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) <= 1e-5
    cot = np.random.default_rng(1).random(want.shape).astype(np.float32)
    want_g = vjp(jnp.asarray(cot))
    got_g = torch.autograd.grad(got, [tv[i] for i in diff],
                                torch.from_numpy(cot))
    for i, g in zip(diff, got_g):
        assert _rel(g.numpy(), want_g[i]) <= 1e-5, floats[i]


def test_adaptive_log_softmax_function_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, 8)).astype(np.float32)
    lab = np.array([0, 3, 5, 6, 9, 11])
    head = rng.standard_normal((8, 7)).astype(np.float32)
    hb = rng.standard_normal(7).astype(np.float32)
    tails = [(rng.standard_normal((8, 2)).astype(np.float32),
              rng.standard_normal((2, 3)).astype(np.float32)),
             (rng.standard_normal((8, 1)).astype(np.float32),
              rng.standard_normal((1, 4)).astype(np.float32))]
    flat = [x, head, hb] + [a for t in tails for a in t]

    def ref(x_, h_, b_, p0, w0, p1, w1):
        return ref_nn.adaptive_log_softmax_with_loss(
            x_, jnp.asarray(lab), h_, [(p0, w0), (p1, w1)], [5, 8],
            head_bias=b_)

    want, vjp = jax.vjp(ref, *[jnp.asarray(a) for a in flat])
    tv = [torch.tensor(a, requires_grad=True) for a in flat]
    got = F.adaptive_log_softmax_with_loss(
        tv[0], torch.from_numpy(lab), tv[1], [(tv[3], tv[4]),
                                              (tv[5], tv[6])], [5, 8],
        head_bias=tv[2])
    for g, w in zip(got, want):
        assert _rel(g.detach().numpy(), w) <= 1e-5
    cot = (np.random.default_rng(4).random(N).astype(np.float32),
           np.float32(0.7))
    want_g = vjp(tuple(jnp.asarray(c) for c in cot))
    got_g = torch.autograd.grad(got, tv, [torch.from_numpy(cot[0]),
                                          torch.tensor(cot[1])])
    for g, w in zip(got_g, want_g):
        assert _rel(g.numpy(), w) <= 1e-5


def _layer_case(name):
    """(reference layer, port layer, inputs) of the loss layer ``name``."""
    d = _data(5)
    t = paddle.to_tensor
    lab, lab_ig, sign = d["lab"], d["lab_ig"], d["sign"]
    sign_nc = np.broadcast_to(sign[:, None], (N, C)).copy()
    mk = {
        "CrossEntropyLoss": (dict(label_smoothing=0.1), [d["x"], lab_ig]),
        "MSELoss": ({}, [d["x"], d["y"]]),
        "L1Loss": (dict(reduction="sum"), [d["x"], d["y"]]),
        "NLLLoss": ({}, [d["logp"], lab_ig]),
        "BCELoss": ({}, [d["prob"], d["bin"]]),
        "BCEWithLogitsLoss": ({}, [d["x"], d["bin"]]),
        "KLDivLoss": (dict(reduction="batchmean"), [d["logp"], d["prob"]]),
        "SmoothL1Loss": (dict(delta=0.3), [d["x"], d["y"]]),
        "MarginRankingLoss": (dict(margin=0.1), [d["v"], d["w"], sign]),
        "CosineEmbeddingLoss": (dict(margin=0.2), [d["x"], d["y"], sign]),
        "TripletMarginLoss": (dict(swap=True), [d["x"], d["y"], d["z"]]),
        "TripletMarginWithDistanceLoss": ({}, [d["x"], d["y"], d["z"]]),
        "MultiLabelSoftMarginLoss": ({}, [d["x"], d["bin"]]),
        "HingeEmbeddingLoss": ({}, [d["x"], sign_nc]),
        "SoftMarginLoss": ({}, [d["x"], sign_nc]),
        "MultiMarginLoss": (dict(p=2), [d["x"], lab]),
        "PoissonNLLLoss": (dict(full=True), [d["x"], d["pos"]]),
        "GaussianNLLLoss": ({}, [d["x"], d["y"], d["var"]]),
        "CTCLoss": ({}, [d["ctc"], d["ctc_lab"], d["ctc_in"],
                         d["ctc_len"]]),
    }
    if name == "AdaptiveLogSoftmaxWithLoss":
        paddle.seed(0)
        ref = paddle.nn.AdaptiveLogSoftmaxWithLoss(C, 12, [4, 8],
                                                   head_bias=True)
        port = pnn.AdaptiveLogSoftmaxWithLoss(C, 12, [4, 8], head_bias=True,
                                              device="cpu")
        load_raw_state_dict(port, {k: np.asarray(v) for k, v in
                                   ref.raw_state_dict().items()})
        return ref, port, [d["x"], np.array([0, 3, 4, 7, 8, 11])]
    kw, inputs = mk[name]
    return (getattr(paddle.nn, name)(**kw), getattr(pnn, name)(**kw),
            inputs)


LAYERS = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
          "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
          "MarginRankingLoss", "CosineEmbeddingLoss", "TripletMarginLoss",
          "TripletMarginWithDistanceLoss", "MultiLabelSoftMarginLoss",
          "HingeEmbeddingLoss", "SoftMarginLoss", "MultiMarginLoss",
          "PoissonNLLLoss", "GaussianNLLLoss", "CTCLoss",
          "AdaptiveLogSoftmaxWithLoss"]


@pytest.mark.parametrize("name", LAYERS)
def test_loss_layers_match_reference(name):
    assert sorted(LAYERS) == sorted(pnn.loss.__all__)
    ref, port, inputs = _layer_case(name)
    want = ref(*[paddle.to_tensor(a) for a in inputs])
    got = port(*[torch.as_tensor(a) for a in inputs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        assert _rel(g.detach().numpy(), np.asarray(w.value)) <= 1e-5
