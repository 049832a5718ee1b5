"""Anomaly detectors over 1-D and 2-D series (counterpart of
``zoo_tpu/chronos/detector/anomaly.py``): ``ThresholdDetector``
(distance from a forecast or the mean, over an absolute or fitted
percentile threshold) and ``DBScanDetector`` (scikit-learn's DBSCAN
outliers, imported when one fits) run on the host; ``AEDetector``
(a dense autoencoder's reconstruction error) trains on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _distance(y, y_pred) -> np.ndarray:
    y = np.asarray(y, np.float64)
    dist = np.abs(y - np.asarray(y_pred, np.float64)) \
        if y_pred is not None else np.abs(y - np.mean(y, axis=0))
    return dist.reshape(len(dist), -1).max(axis=1)


class ThresholdDetector:
    """Flags points whose |y - yhat| (or distance from the mean) is over
    an absolute threshold or the fitted ``1 - ratio`` quantile."""

    def __init__(self):
        self.th = np.inf
        self.ratio = 0.01
        self.dist: Optional[np.ndarray] = None

    def set_params(self, threshold: float = np.inf, ratio: float = 0.01):
        self.th = threshold
        self.ratio = ratio
        return self

    def fit(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None):
        self.dist = _distance(y, y_pred)
        if not np.isfinite(self.th):
            self.th = float(np.quantile(self.dist, 1 - self.ratio))
        return self

    def score(self, y=None, y_pred=None) -> np.ndarray:
        if y is not None:
            self.fit_dist_only(y, y_pred)
        if self.dist is None:
            raise RuntimeError("call fit() first")
        return self.dist

    def fit_dist_only(self, y, y_pred):
        self.dist = _distance(y, y_pred)

    def anomaly_indexes(self) -> np.ndarray:
        return np.where(self.score() > self.th)[0]


class AEDetector:
    """A dense autoencoder over windows of ``roll_len`` steps; a point's
    score is the largest reconstruction error of the windows covering
    it, z-scored. Trains on the current CUDA device unless ``device``
    names another. The batch is ``min(batch_size, windows)``, rounded
    down to a multiple of the data shards of the runtime context's mesh
    when one is live (as the JAX detector rounds it)."""

    def __init__(self, roll_len: int = 24, ratio: float = 0.1,
                 compress_rate: float = 0.25, batch_size: int = 100,
                 epochs: int = 20, lr: float = 0.001, device=None):
        self.roll_len = roll_len
        self.ratio = ratio
        self.compress_rate = compress_rate
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr = lr
        self.device = device
        self.model = None
        self._scores: Optional[np.ndarray] = None

    def _roll(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y, np.float32).reshape(len(y), -1)
        if self.roll_len <= 1:
            return y
        n = len(y) - self.roll_len + 1
        return y[np.arange(n)[:, None] + np.arange(self.roll_len)] \
            .reshape(n, -1)

    def fit(self, y: np.ndarray):
        from zoo_tpu_torch.common.device import resolve_device
        from zoo_tpu_torch.pipeline.api.keras import Sequential
        from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt
        from zoo_tpu_torch.pipeline.api.keras.layers import Dense

        dev = resolve_device(self.device)
        windows = self._roll(y)
        d = windows.shape[1]
        hidden = max(1, int(d * self.compress_rate))
        m = Sequential(name="ae_detector")
        m.add(Dense(hidden, activation="relu", input_shape=(d,)))
        m.add(Dense(d))
        m.compile(optimizer=zopt.Adam(lr=self.lr), loss="mse")
        bs = min(self.batch_size, len(windows))
        # keep the batch divisible by the mesh's data shards
        from zoo_tpu_torch.common.context import get_runtime_context
        ctx = get_runtime_context(required=False)
        if ctx is not None:
            from zoo_tpu_torch.parallel.mesh import data_axes
            denom = 1
            for a in data_axes(ctx.mesh):
                denom *= ctx.mesh.shape[a]
            bs = max(denom, (bs // denom) * denom)
        m.fit(windows, windows, batch_size=bs, nb_epoch=self.epochs,
              verbose=0, device=dev)
        self.model = m
        rec = m.predict(windows, device=dev)
        err = np.mean((rec - windows) ** 2, axis=1)
        # each point's score: the largest error of the windows over it
        scores = np.zeros(len(y))
        for i, e in enumerate(err):
            scores[i:i + self.roll_len] = np.maximum(
                scores[i:i + self.roll_len], e)
        self._scores = scores
        return self

    def score(self) -> np.ndarray:
        if self._scores is None:
            raise RuntimeError("call fit() first")
        mu, sd = self._scores.mean(), self._scores.std() + 1e-12
        return (self._scores - mu) / sd

    def anomaly_indexes(self) -> np.ndarray:
        s = self.score()
        return np.where(s > np.quantile(s, 1 - self.ratio))[0]


class DBScanDetector:
    """DBSCAN's noise points (label -1) as anomalies."""

    def __init__(self, eps: float = 0.5, min_samples: int = 5, **kwargs):
        self.eps = eps
        self.min_samples = min_samples
        self.kwargs = kwargs
        self._labels = None

    def fit(self, y: np.ndarray):
        from sklearn.cluster import DBSCAN

        y = np.asarray(y, np.float64).reshape(len(y), -1)
        self._labels = DBSCAN(eps=self.eps, min_samples=self.min_samples,
                              **self.kwargs).fit_predict(y)
        return self

    def score(self) -> np.ndarray:
        if self._labels is None:
            raise RuntimeError("call fit() first")
        return (self._labels == -1).astype(np.float64)

    def anomaly_indexes(self) -> np.ndarray:
        return np.where(self.score() > 0)[0]
