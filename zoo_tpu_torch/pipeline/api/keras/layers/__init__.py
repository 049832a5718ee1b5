"""Keras-1 layers of the port (counterpart of
``zoo_tpu/pipeline/api/keras/layers``): the core, convolutional,
pooling, recurrent and self-attention layers. ``GaussianNoise`` raises;
``advanced``, ``extras``, ``conv_extras`` and ``compat_extras`` are not
ported yet (ROADMAP A.11)."""

from zoo_tpu_torch.pipeline.api.keras.layers.convolutional import (
    Conv1D,
    Conv2D,
    Convolution1D,
    Convolution2D,
    Cropping1D,
    Cropping2D,
    SpatialDropout1D,
    SpatialDropout2D,
    UpSampling1D,
    UpSampling2D,
    ZeroPadding1D,
    ZeroPadding2D,
)
from zoo_tpu_torch.pipeline.api.keras.layers.core import (
    Activation,
    BatchNormalization,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    GaussianNoise,
    InputLayer,
    Lambda,
    Merge,
    Permute,
    RepeatVector,
    Reshape,
    merge,
)
from zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
    AveragePooling1D,
    AveragePooling2D,
    GlobalAveragePooling1D,
    GlobalAveragePooling2D,
    GlobalMaxPooling1D,
    GlobalMaxPooling2D,
    MaxPooling1D,
    MaxPooling2D,
)
from zoo_tpu_torch.pipeline.api.keras.layers.recurrent import (
    GRU,
    LSTM,
    Bidirectional,
    SimpleRNN,
    TimeDistributed,
)
from zoo_tpu_torch.pipeline.api.keras.layers.self_attention import (
    BERT,
    LayerNorm,
    TransformerLayer,
)

__all__ = [
    "Activation", "BatchNormalization", "Dense", "Dropout", "Embedding",
    "Flatten", "GaussianNoise", "InputLayer", "Lambda", "Merge", "Permute",
    "RepeatVector", "Reshape", "merge",
    "Conv1D", "Conv2D", "Convolution1D", "Convolution2D", "Cropping1D",
    "Cropping2D", "SpatialDropout1D", "SpatialDropout2D", "UpSampling1D",
    "UpSampling2D", "ZeroPadding1D", "ZeroPadding2D",
    "AveragePooling1D", "AveragePooling2D", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalMaxPooling1D", "GlobalMaxPooling2D",
    "MaxPooling1D", "MaxPooling2D",
    "GRU", "LSTM", "Bidirectional", "SimpleRNN", "TimeDistributed",
    "BERT", "LayerNorm", "TransformerLayer",
]
