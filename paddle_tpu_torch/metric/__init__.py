"""paddle.metric: streaming metrics (counterpart of
``paddle_tpu/metric/__init__.py``).

``Metric`` with update/accumulate/reset/name, ``Accuracy``,
``Precision``, ``Recall`` and ``Auc``: the objects hapi ``Model.fit``
threads through its callbacks.  ``Accuracy.compute`` runs in torch on
the predictions' device (top-k, then a compare: only the [N, k] hits
cross to the host); ``update`` and ``accumulate`` run in numpy on the
host, as in the reference.
"""
from __future__ import annotations

import abc
from typing import List, Sequence, Union

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def name(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def reset(self):
        ...

    def compute(self, *args):
        """Optional pre-processing hook (runs on the predictions'
        tensors, on their device).  Default: identity."""
        return args


class Accuracy(Metric):
    """Top-k accuracy (paddle.metric.Accuracy)."""

    def __init__(self, topk: Union[int, Sequence[int]] = (1,),
                 name: str = None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """[..., maxk] f32 hits: the top-``maxk`` classes of ``pred``,
        best first, against ``label`` (class ids, [N, 1] ids or
        one-hot), on ``pred``'s device."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        idx = torch.topk(pred, self.maxk, dim=-1, sorted=True).indices
        if label.ndim == pred.ndim:             # one-hot / [N,1] labels
            if label.shape[-1] == pred.shape[-1]:
                label = torch.argmax(label, dim=-1)
            else:
                label = label[..., 0]
        return (idx == label[..., None]).to(torch.float32)

    def update(self, correct):
        correct = _to_np(correct)
        # samples = every leading dim (sequence-shaped preds count each
        # position, matching the paddle metric's prod(shape[:-1]))
        num = int(np.prod(correct.shape[:-1])) if correct.ndim else 1
        batch = []
        for i, k in enumerate(self.topk):
            hit = float(correct[..., :k].sum())
            self.total[i] += hit
            batch.append(hit / max(num, 1))
        self.count += num
        # paddle returns the CURRENT batch accuracy from update()
        return batch[0] if len(batch) == 1 else batch

    def accumulate(self):
        res = [t / max(self.count, 1) for t in self.total]
        return res[0] if len(res) == 1 else res

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision (paddle.metric.Precision: pred > 0.5)."""

    def __init__(self, name: str = "precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_to_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _to_np(labels).reshape(-1).astype(np.int64)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def reset(self):
        self.tp = 0
        self.fp = 0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall (paddle.metric.Recall)."""

    def __init__(self, name: str = "recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_to_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _to_np(labels).reshape(-1).astype(np.int64)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def reset(self):
        self.tp = 0
        self.fn = 0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC-AUC via fixed-bucket histogram (paddle.metric.Auc ROC mode)."""

    def __init__(self, curve: str = "ROC", num_thresholds: int = 4095,
                 name: str = "auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        if preds.ndim == 2:                      # [N, 2] softmax scores
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = _to_np(labels).reshape(-1).astype(np.int64)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64),
                      0, self.num_thresholds)
        np.add.at(self._stat_pos, idx, labels == 1)
        np.add.at(self._stat_neg, idx, labels == 0)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over descending thresholds
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return float(area / (tot_pos * tot_neg))

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def name(self):
        return self._name
