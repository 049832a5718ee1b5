"""LSTM anomaly detector (counterpart of
``zoo_tpu/models/anomalydetection/anomaly_detector.py``): stacked LSTMs,
each followed by its dropout, predict the next point of a series; the
anomalies are the largest forecast errors."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from zoo_tpu_torch.pipeline.api.keras.engine.topology import Sequential
from zoo_tpu_torch.pipeline.api.keras.layers import LSTM, Dense, Dropout


class AnomalyDetector(Sequential):
    def __init__(self, feature_shape: Tuple[int, int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2)):
        super().__init__(name="anomaly_detector")
        for i, (h, d) in enumerate(zip(hidden_layers, dropouts)):
            last = i == len(hidden_layers) - 1
            kwargs = {"input_shape": tuple(feature_shape)} if i == 0 else {}
            self.add(LSTM(h, return_sequences=not last, **kwargs))
            if d:
                self.add(Dropout(d))
        self.add(Dense(1))

    @staticmethod
    def unroll(data: np.ndarray, unroll_length: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(n, features) series -> (windows, unroll, features) x and the
        next step's first feature as y."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        n = len(data) - unroll_length
        x = np.stack([data[i:i + unroll_length] for i in range(n)])
        y = data[unroll_length:, 0]
        return x, y

    def detect_anomalies(self, y_true: np.ndarray, y_pred: np.ndarray,
                         anomaly_size: int) -> List[int]:
        """Indexes of the ``anomaly_size`` largest absolute errors."""
        err = np.abs(np.asarray(y_true).ravel() -
                     np.asarray(y_pred).ravel())
        return list(np.argsort(-err)[:anomaly_size])
