from zoo_tpu_torch.orca.learn.keras.estimator import Estimator, KerasEstimator

__all__ = ["Estimator", "KerasEstimator"]
