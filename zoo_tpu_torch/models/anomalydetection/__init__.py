"""Anomaly detection model of the port (counterpart of
``zoo_tpu/models/anomalydetection``)."""

from zoo_tpu_torch.models.anomalydetection.anomaly_detector import (
    AnomalyDetector,
)

__all__ = ["AnomalyDetector"]
