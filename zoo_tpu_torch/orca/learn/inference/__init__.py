from zoo_tpu_torch.orca.learn.inference.estimator import (  # noqa: F401
    Estimator,
    InferenceEstimator,
)

__all__ = ["Estimator", "InferenceEstimator"]
