"""The port's BERT against the reference: ``BertForSequenceClassification``
and ``BertForMaskedLM`` on ``bert_tiny_config()`` (2 post-norm encoder
layers, 4 heads of 16), f32 on the CPU, with a padding mask.

The reference is built after ``paddle.seed(0)`` and its
``raw_state_dict()`` carried into the port (its ``decoder_bias`` and
biases set nonzero first).  A batch of 2 x 16 ids whose second row is
padded after 11 tokens goes through both with ``attention_mask`` (1 =
attend), which each turns into the additive ``[B, 1, 1, S]`` bias of 0
/ -1e30.  Tolerances: logits within 1e-5 relative L2 (f32 sums in
another order), the loss within 1e-5 relative, every gradient within
1e-4 relative L2 (the reference's through its jitted ``grad_step``);
the key biases' gradients, zero in exact arithmetic, within 1e-6 of it.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import CompiledTrainStep as RefStep
from paddle_tpu.models import bert as ref_bert

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.jit.train import CompiledTrainStep
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models.from_jax import load_raw_state_dict

HEADS = {"cls": ("BertForSequenceClassification", (2,)),   # 2 classes
         "mlm": ("BertForMaskedLM", (2, 16))}


def _batch(head):
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 256, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    ids[1, 11:] = 0
    if head == "cls":
        labels = np.array([0, 1], np.int32)
    else:
        labels = np.where(rng.random((2, 16)) < 0.5, ids, -100)
        labels = np.where(mask == 1, labels, -100).astype(np.int32)
    return {"input_ids": ids, "mask": mask, "labels": labels}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _loss(m, b):
    return m(b["input_ids"], attention_mask=b["mask"], labels=b["labels"])


def _logits(m, b):
    return m(b["input_ids"], attention_mask=b["mask"])


@pytest.fixture(scope="module", params=sorted(HEADS))
def runs(request):
    head = request.param
    cls_name, _ = HEADS[head]
    paddle.seed(0)
    ref = getattr(ref_bert, cls_name)(ref_bert.bert_tiny_config())
    state = {k: np.asarray(v) for k, v in ref.raw_state_dict().items()}
    rng = np.random.default_rng(5)
    for k in state:
        if k.endswith("bias"):           # zeros at init: make them count
            state[k] = (0.05 * rng.standard_normal(state[k].shape)
                        ).astype(np.float32)
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    port = getattr(bert, cls_name)(bert.bert_tiny_config(), device="cpu")
    load_raw_state_dict(port, state)
    rstep = RefStep(ref, _loss, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=ref.parameters()))
    pstep = CompiledTrainStep(port, _loss, optim.AdamW(
        learning_rate=1e-3, parameters=port.parameters()))
    b = _batch(head)
    want = (np.asarray(rstep.eval_step(_logits, b)),) + rstep.grad_step(b)
    with torch.no_grad():
        logits = _logits(port, {k: torch.tensor(v) for k, v in b.items()})
    return head, (want, (logits.numpy(),) + pstep.grad_step(b))


def test_logits_match_reference(runs):
    head, ((want, _, _), (got, _, _)) = runs
    assert got.shape == HEADS[head][1] + ((256,) if head == "mlm" else (2,))
    assert _rel_l2(want, got) <= 1e-5


def test_loss_and_gradients_match_reference(runs):
    _, ((_, loss, grads), (_, ploss, pgrads)) = runs
    assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert set(pgrads) == set(grads)
    for n, g in pgrads.items():
        if n.endswith("k_proj.bias"):
            # a key bias adds one constant to a query's every score, so
            # the softmax's gradient is zero: both sides give rounding
            # noise (about 1e-10) that no relative error can compare
            assert np.abs(np.asarray(grads[n])).max() <= 1e-6
            assert g.abs().max() <= 1e-6, n
            continue
        assert _rel_l2(np.asarray(grads[n]), g.numpy()) <= 1e-4, n


def test_padding_bias_and_masked_keys():
    """The bias is 0 / -1e30 over ``[B, 1, 1, S]``, and a padded key
    changes no logit of the valid rows."""
    m = torch.tensor([[1, 1, 0], [1, 0, 0]])
    bias = bert.padding_bias(m)
    assert bias.shape == (2, 1, 1, 3) and bias.dtype == torch.float32
    assert torch.equal(bias[:, 0, 0], torch.tensor(
        [[0.0, 0.0, -1e30], [0.0, -1e30, -1e30]]))
    model = bert.BertModel(bert.bert_tiny_config(), device="cpu")
    ids = torch.tensor([[5, 6, 7, 8, 9, 0, 0, 0]])
    mask = torch.tensor([[1, 1, 1, 1, 1, 0, 0, 0]])
    with torch.no_grad():
        a, _ = model(ids, attention_mask=mask)
        b, _ = model(torch.tensor([[5, 6, 7, 8, 9, 3, 2, 1]]),
                     attention_mask=mask)
    assert torch.allclose(a[:, :5], b[:, :5], atol=1e-6)
