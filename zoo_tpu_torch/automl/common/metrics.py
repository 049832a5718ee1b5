"""``Evaluator``, the metric dispatch of AutoML user code (counterpart
of ``zoo_tpu/automl/common/metrics.py``), over the forecasters' metric
table."""

from __future__ import annotations

import numpy as np

from zoo_tpu_torch.chronos.forecaster.base import _EVAL_FNS as _METRICS


class Evaluator:
    @staticmethod
    def evaluate(metric: str, y_true, y_pred, multioutput="raw_values"):
        """``metric`` of ``y_pred`` against ``y_true``: one value per
        output column (``raw_values``, as scikit-learn shapes it: a
        1-element array for 1-D input), or one over every value."""
        if multioutput not in (None, "uniform_average", "raw_values"):
            raise ValueError(
                f"multioutput={multioutput!r}: expected None, "
                "'uniform_average' or 'raw_values'")
        metric = metric.lower()
        if metric not in _METRICS:
            raise ValueError(
                f"unknown metric {metric!r}; choose from "
                f"{sorted(_METRICS)}")
        y_true = np.asarray(y_true, np.float64)
        y_pred = np.asarray(y_pred, np.float64)
        if multioutput == "raw_values":
            if y_true.ndim > 1:
                flat_t = y_true.reshape(-1, y_true.shape[-1])
                flat_p = y_pred.reshape(-1, y_pred.shape[-1])
                return np.asarray(
                    [_METRICS[metric](flat_t[:, i], flat_p[:, i])
                     for i in range(flat_t.shape[-1])])
            return np.asarray(
                [_METRICS[metric](y_true.ravel(), y_pred.ravel())])
        return _METRICS[metric](y_true.ravel(), y_pred.ravel())
