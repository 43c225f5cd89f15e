"""The port's ``metric`` against the reference's: ``Accuracy`` (top-k
from torch on the predictions' tensor, labels as ids, [N, 1] ids or
one-hot, over several updates), ``Precision``, ``Recall`` and ``Auc``
fed the same numpy batches; every value within 1e-6 of the reference's,
and the names equal."""
import numpy as np
import pytest
import torch

import paddle_tpu.metric as ref_metric

import paddle_tpu_torch.metric as metric


def _batches(n_batches=3, n=24, classes=7, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, classes)).astype(np.float32),
             rng.integers(0, classes, n).astype(np.int64))
            for _ in range(n_batches)]


def _label(kind, y, classes):
    if kind == "ids":
        return y
    if kind == "column":
        return y[:, None]
    return np.eye(classes, dtype=np.float32)[y]


@pytest.mark.parametrize("topk", [1, (1, 3), (2, 5)])
@pytest.mark.parametrize("label", ["ids", "column", "one_hot"])
def test_accuracy_matches_reference(topk, label):
    ref, port = ref_metric.Accuracy(topk=topk), metric.Accuracy(topk=topk)
    assert port.name() == ref.name()
    for pred, y in _batches():
        lab = _label(label, y, pred.shape[-1])
        want = ref.update(ref.compute(pred, lab))
        hits = port.compute(torch.from_numpy(pred), torch.from_numpy(lab))
        assert isinstance(hits, torch.Tensor) and hits.dtype == torch.float32
        np.testing.assert_array_equal(hits.numpy(), ref.compute(pred, lab))
        got = port.update(hits.numpy())
        np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(port.accumulate(), ref.accumulate(),
                               atol=1e-6)
    port.reset()
    assert port.count == 0 and port.accumulate() == (
        0.0 if isinstance(topk, int) else [0.0] * len(topk))


def test_accuracy_sequence_predictions():
    """[B, S, C] predictions count every position, as the reference."""
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((2, 5, 6)).astype(np.float32)
    y = rng.integers(0, 6, (2, 5)).astype(np.int64)
    ref, port = ref_metric.Accuracy(topk=(1, 2)), metric.Accuracy(topk=(1, 2))
    want = ref.update(ref.compute(pred, y))
    got = port.update(port.compute(torch.from_numpy(pred),
                                   torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert port.count == ref.count == 10


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_reference(name):
    rng = np.random.default_rng(2)
    ref, port = getattr(ref_metric, name)(), getattr(metric, name)()
    assert port.name() == ref.name()
    for _ in range(3):
        if name == "Auc":
            p = rng.random((40, 2)).astype(np.float32)
            p /= p.sum(-1, keepdims=True)
        else:
            p = rng.random((40, 1)).astype(np.float32)
        y = rng.integers(0, 2, (40, 1)).astype(np.int64)
        ref.update(p, y)
        # the port's update takes host arrays and the CPU tensors alike
        port.update(torch.from_numpy(p), y)
    assert abs(port.accumulate() - ref.accumulate()) <= 1e-6
    assert 0.0 < port.accumulate() < 1.0
    port.reset()
    assert port.accumulate() == 0.0


def test_metric_base_protocol():
    class Mean(metric.Metric):
        def name(self):
            return "mean"

        def update(self, x):
            self.v = float(np.mean(x))
            return self.v

        def accumulate(self):
            return self.v

        def reset(self):
            self.v = 0.0

    m = Mean()
    args = (torch.ones(3), 2)
    assert m.compute(*args) == args
    with pytest.raises(TypeError):
        metric.Metric()
