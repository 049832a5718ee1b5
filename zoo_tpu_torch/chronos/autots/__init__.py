from zoo_tpu_torch.chronos.autots.autotsestimator import (
    AutoTSEstimator,
    TSPipeline,
)

__all__ = ["AutoTSEstimator", "TSPipeline"]
