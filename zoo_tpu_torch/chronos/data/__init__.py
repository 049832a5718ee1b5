from zoo_tpu_torch.chronos.data.tsdataset import (
    TSDataset,
    dt_features,
    roll_windows,
)

__all__ = ["TSDataset", "dt_features", "roll_windows"]
