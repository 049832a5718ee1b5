"""NNFrames (counterpart of ``zoo_tpu/pipeline/nnframes``)."""
from zoo_tpu_torch.pipeline.nnframes.nn_classifier import (  # noqa: F401
    NNClassifier,
    NNClassifierModel,
    NNEstimator,
    NNModel,
)
from zoo_tpu_torch.pipeline.nnframes.nn_image_reader import (  # noqa: F401
    NNImageReader,
    RowToImageFeature,
)

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader", "RowToImageFeature"]
