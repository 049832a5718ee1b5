"""Validation metrics (counterpart of
``zoo_tpu/pipeline/api/keras/metrics.py``).

Each metric is a batch function ``batch_eval(y_true, y_pred) ->
(value_sum, count)`` of device tensors, so ``evaluate`` sums both over
the batches on the device and divides once at the end
(:meth:`Metric.finalize`), exactly as the JAX package aggregates them.
"""

from __future__ import annotations

from typing import Union

import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import model_file_part


def _count(n, like: torch.Tensor) -> torch.Tensor:
    """``n`` as an f32 scalar on ``like``'s device."""
    return torch.tensor(float(n), dtype=torch.float32, device=like.device)


@model_file_part
class Metric:
    name = "metric"

    def batch_eval(self, y_true, y_pred):
        """Return (sum, count) contributions for this batch."""
        raise NotImplementedError

    def finalize(self, total, count):
        return total / torch.clamp(torch.as_tensor(count), min=1)


class Accuracy(Metric):
    """Classification accuracy: binary (a scalar probability per sample,
    thresholded at 0.5) or categorical (argmax, the first maximum on
    ties; labels sparse or one-hot)."""

    name = "accuracy"

    def batch_eval(self, y_true, y_pred):
        if y_pred.ndim <= 1 or y_pred.shape[-1] == 1:
            pred = y_pred.reshape(y_pred.shape[0], -1)[:, 0] > 0.5
            true = y_true.reshape(y_true.shape[0], -1)[:, 0] > 0.5
        else:
            pred = torch.argmax(y_pred, dim=-1)
            true = (torch.argmax(y_true, dim=-1)
                    if y_true.ndim == y_pred.ndim else
                    y_true.reshape(pred.shape).to(torch.int32))
        correct = torch.sum((pred == true).float())
        return correct, _count(pred.shape[0], correct)


class SparseCategoricalAccuracy(Accuracy):
    name = "sparse_categorical_accuracy"


class Top5Accuracy(Metric):
    name = "top5_accuracy"

    def batch_eval(self, y_true, y_pred):
        # the last five of a stable ascending sort, as jnp.argsort
        top5 = torch.argsort(y_pred, dim=-1, stable=True)[:, -5:]
        true = (torch.argmax(y_true, dim=-1) if y_true.ndim == y_pred.ndim
                else y_true.to(torch.int64).reshape(-1))
        hit = torch.any(top5 == true[:, None], dim=-1)
        return torch.sum(hit.float()), _count(y_pred.shape[0], y_pred)


class MAE(Metric):
    name = "mae"

    def batch_eval(self, y_true, y_pred):
        return (torch.sum(torch.abs(y_pred - y_true)),
                _count(y_true.numel(), y_pred))


class MSE(Metric):
    name = "mse"

    def batch_eval(self, y_true, y_pred):
        return (torch.sum((y_pred - y_true) ** 2),
                _count(y_true.numel(), y_pred))


class BinaryCrossEntropyMetric(Metric):
    name = "binary_crossentropy"

    def batch_eval(self, y_true, y_pred):
        eps = 1e-7
        p = torch.clamp(y_pred, eps, 1 - eps)
        ll = y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p)
        return -torch.sum(ll), _count(y_true.numel(), y_pred)


class AUC(Metric):
    """Riemann-sum AUC over fixed thresholds: the thresholded confusion
    counts add exactly across batches."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200):
        self.num_thresholds = int(num_thresholds)

    def batch_eval(self, y_true, y_pred):
        t = torch.linspace(0.0, 1.0, self.num_thresholds,
                           device=y_pred.device)
        p = y_pred.reshape(-1)
        y = y_true.reshape(-1)
        pred_pos = p[None, :] >= t[:, None]          # (T, N)
        tp = torch.sum(pred_pos & (y[None, :] > 0.5), dim=1).float()
        fp = torch.sum(pred_pos & (y[None, :] <= 0.5), dim=1).float()
        pos = torch.sum(y > 0.5).float()
        neg = torch.sum(y <= 0.5).float()
        # carry the confusion-matrix rows; finalize integrates
        rows = torch.stack([tp, fp, pos.expand_as(tp), neg.expand_as(fp)])
        return rows, _count(1, y_pred)

    def finalize(self, total, count):
        tp, fp, pos, neg = total[0], total[1], total[2], total[3]
        tpr = tp / torch.clamp(pos, min=1.0)
        fpr = fp / torch.clamp(neg, min=1.0)
        # integrate TPR over FPR (thresholds descend in fpr ordering)
        order = torch.argsort(fpr, stable=True)
        return torch.trapezoid(tpr[order], fpr[order])


_ALIASES = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "top5accuracy": Top5Accuracy,
    "top5_accuracy": Top5Accuracy,
    "mae": MAE,
    "mse": MSE,
    "auc": AUC,
    "binary_crossentropy": BinaryCrossEntropyMetric,
}


def get_metric(identifier: Union[str, Metric]) -> Metric:
    if isinstance(identifier, Metric):
        return identifier
    key = identifier.lower()
    if key not in _ALIASES:
        raise ValueError(f"unknown metric: {identifier}")
    return _ALIASES[key]()


Top1Accuracy = Accuracy
