"""Keras-1 layers of the port (counterpart of
``zoo_tpu/pipeline/api/keras/layers``): the layers the image models,
NCF, BERT and VGG need. The others (``ZeroPadding2D``, recurrent, ...)
are not ported yet."""

from zoo_tpu_torch.pipeline.api.keras.layers.convolutional import (
    Conv2D,
    Convolution2D,
)
from zoo_tpu_torch.pipeline.api.keras.layers.core import (
    Activation,
    BatchNormalization,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    Lambda,
    Merge,
    merge,
)
from zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
    GlobalAveragePooling2D,
    MaxPooling2D,
)
from zoo_tpu_torch.pipeline.api.keras.layers.self_attention import (
    BERT,
    LayerNorm,
    TransformerLayer,
)

__all__ = ["Activation", "BERT", "BatchNormalization", "Conv2D",
           "Convolution2D", "Dense", "Dropout", "Embedding", "Flatten",
           "GlobalAveragePooling2D",
           "Lambda", "LayerNorm", "MaxPooling2D", "Merge", "TransformerLayer",
           "merge"]
