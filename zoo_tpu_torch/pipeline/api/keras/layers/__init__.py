"""Keras-1 layers of the port (counterpart of
``zoo_tpu/pipeline/api/keras/layers``): the layers the image models,
NCF and BERT need. The others (``ZeroPadding2D``, ``Dropout``,
recurrent, ...) are not ported yet."""

from zoo_tpu_torch.pipeline.api.keras.layers.convolutional import (
    Conv2D,
    Convolution2D,
)
from zoo_tpu_torch.pipeline.api.keras.layers.core import (
    Activation,
    BatchNormalization,
    Dense,
    Embedding,
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
           "Convolution2D", "Dense", "Embedding", "GlobalAveragePooling2D",
           "Lambda", "LayerNorm", "MaxPooling2D", "Merge", "TransformerLayer",
           "merge"]
