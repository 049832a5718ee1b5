from zoo_tpu_torch.chronos.detector.anomaly import (
    AEDetector,
    DBScanDetector,
    ThresholdDetector,
)

__all__ = ["AEDetector", "DBScanDetector", "ThresholdDetector"]
