from zoo_tpu_torch.automl import hp  # noqa: F401  (reference: zoo.orca.automl.hp)
from zoo_tpu_torch.orca.automl.auto_estimator import AutoEstimator

__all__ = ["AutoEstimator", "hp"]
