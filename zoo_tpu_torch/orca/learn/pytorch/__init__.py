from zoo_tpu_torch.orca.learn.pytorch.estimator import (
    Estimator,
    PyTorchEstimator,
)

__all__ = ["Estimator", "PyTorchEstimator"]
