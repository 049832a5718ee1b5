"""Keras-1 layers of the port (counterpart of
``zoo_tpu/pipeline/api/keras/layers``): the layers the image models
need. The others (``ZeroPadding2D``, recurrent, attention, ...) are not
ported yet."""

from zoo_tpu_torch.pipeline.api.keras.layers.convolutional import (
    Conv2D,
    Convolution2D,
)
from zoo_tpu_torch.pipeline.api.keras.layers.core import (
    Activation,
    BatchNormalization,
    Dense,
    Merge,
    merge,
)
from zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
    GlobalAveragePooling2D,
    MaxPooling2D,
)

__all__ = ["Activation", "BatchNormalization", "Conv2D", "Convolution2D",
           "Dense", "GlobalAveragePooling2D", "MaxPooling2D", "Merge",
           "merge"]
