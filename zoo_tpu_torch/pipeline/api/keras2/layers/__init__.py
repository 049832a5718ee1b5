"""Keras-2 layer façade (counterpart of
``zoo_tpu/pipeline/api/keras2/layers``; reference:
``pyzoo/zoo/pipeline/api/keras2/layers``). Each function returns the
port's equivalent Keras-1 layer with its arguments translated, as the
JAX package's factories do; graphs and Sequentials mix both façades
because the layer objects are the same type underneath."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

from zoo_tpu_torch.pipeline.api.keras import layers as k1
from zoo_tpu_torch.pipeline.api.keras.layers.core import merge as _merge

__all__ = [
    "Dense", "Activation", "Dropout", "Flatten", "Embedding",
    "Conv1D", "Conv2D", "Cropping1D", "SeparableConv2D",
    "MaxPooling1D", "AveragePooling1D", "MaxPooling2D",
    "AveragePooling2D", "GlobalAveragePooling1D", "GlobalMaxPooling1D",
    "GlobalAveragePooling2D", "GlobalMaxPooling2D",
    "Maximum", "Minimum", "Average", "Add", "Concatenate",
    "average", "maximum", "minimum",
    "LocallyConnected1D", "LeakyReLU", "ELU", "ThresholdedReLU",
    "ConvLSTM2D", "BatchNormalization", "LSTM", "GRU", "SimpleRNN",
]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1] if len(v) > 1 else v[0])
    return int(v), int(v)


def _df(data_format: Optional[str]) -> str:
    """keras2 data_format -> keras1 dim_ordering."""
    if data_format in (None, "channels_last"):
        return "tf"
    if data_format == "channels_first":
        return "th"
    raise ValueError(f"unknown data_format {data_format!r}")


# ------------------------------------------------------------------ core

def Dense(units: int, kernel_initializer="glorot_uniform",
          bias_initializer="zero", activation=None,
          kernel_regularizer=None, bias_regularizer=None,
          use_bias: bool = True, input_dim: Optional[int] = None,
          input_shape=None, name: Optional[str] = None, **kwargs):
    """reference: ``keras2/layers/core.py:26``."""
    return k1.Dense(units, init=kernel_initializer, activation=activation,
                    bias=use_bias, W_regularizer=kernel_regularizer,
                    b_regularizer=bias_regularizer, input_dim=input_dim,
                    input_shape=input_shape, name=name, **kwargs)


def Activation(activation, input_shape=None, name=None, **kwargs):
    return k1.Activation(activation, input_shape=input_shape, name=name,
                         **kwargs)


def Dropout(rate: float, input_shape=None, name=None, **kwargs):
    """keras2 ``rate`` == keras1 ``p``."""
    return k1.Dropout(p=rate, input_shape=input_shape, name=name, **kwargs)


def Flatten(input_shape=None, name=None, **kwargs):
    return k1.Flatten(input_shape=input_shape, name=name, **kwargs)


def Embedding(input_dim: int, output_dim: int,
              embeddings_initializer="uniform", input_length=None,
              input_shape=None, name=None, **kwargs):
    """reference: ``keras2/layers/embeddings.py``."""
    if input_shape is None and input_length is not None:
        input_shape = (input_length,)
    return k1.Embedding(input_dim, output_dim,
                        init=embeddings_initializer,
                        input_shape=input_shape, name=name, **kwargs)


# --------------------------------------------------------- convolutional

def Conv1D(filters: int, kernel_size: int, strides: int = 1,
           padding: str = "valid", activation=None, use_bias: bool = True,
           kernel_initializer="glorot_uniform", input_shape=None,
           name=None, **kwargs):
    """reference: ``keras2/layers/convolutional.py:24``."""
    return k1.Conv1D(filters, kernel_size, subsample_length=strides,
                     border_mode=padding, activation=activation,
                     bias=use_bias, init=kernel_initializer,
                     input_shape=input_shape, name=name, **kwargs)


def Conv2D(filters: int, kernel_size, strides=(1, 1),
           padding: str = "valid", data_format=None, activation=None,
           use_bias: bool = True, kernel_initializer="glorot_uniform",
           input_shape=None, name=None, **kwargs):
    """reference: ``keras2/layers/convolutional.py:100``."""
    kh, kw = _pair(kernel_size)
    return k1.Conv2D(filters, kh, kw, subsample=_pair(strides),
                     border_mode=padding, dim_ordering=_df(data_format),
                     activation=activation, bias=use_bias,
                     init=kernel_initializer, input_shape=input_shape,
                     name=name, **kwargs)


def SeparableConv2D(filters: int, kernel_size, strides=(1, 1),
                    padding: str = "valid", data_format=None,
                    depth_multiplier: int = 1, activation=None,
                    use_bias: bool = True, input_shape=None, name=None,
                    **kwargs):
    kh, kw = _pair(kernel_size)
    return k1.SeparableConvolution2D(
        filters, kh, kw, subsample=_pair(strides), border_mode=padding,
        dim_ordering=_df(data_format), depth_multiplier=depth_multiplier,
        activation=activation, bias=use_bias, input_shape=input_shape,
        name=name, **kwargs)


def Cropping1D(cropping=(1, 1), input_shape=None, name=None, **kwargs):
    """reference: ``keras2/layers/convolutional.py:196``."""
    return k1.Cropping1D(cropping=tuple(cropping),
                         input_shape=input_shape, name=name, **kwargs)


def LocallyConnected1D(filters: int, kernel_size: int, strides: int = 1,
                       padding: str = "valid", activation=None,
                       use_bias: bool = True, input_shape=None, name=None,
                       **kwargs):
    """reference: ``keras2/layers/local.py:23``."""
    return k1.LocallyConnected1D(
        filters, kernel_size, subsample_length=strides,
        border_mode=padding, activation=activation, bias=use_bias,
        input_shape=input_shape, name=name, **kwargs)


def ConvLSTM2D(filters: int, kernel_size, strides=(1, 1),
               padding: str = "same", data_format="channels_first",
               return_sequences: bool = False, input_shape=None,
               name=None, **kwargs):
    """reference: ``keras2/layers/convolutional_recurrent.py`` (its BigDL
    backend is channels-first only; same here)."""
    if _df(data_format) != "th":
        raise ValueError("ConvLSTM2D supports data_format="
                         "'channels_first' only (like the reference)")
    kh, _ = _pair(kernel_size)
    return k1.ConvLSTM2D(filters, kh, border_mode=padding,
                         subsample=_pair(strides),
                         return_sequences=return_sequences,
                         input_shape=input_shape, name=name, **kwargs)


# --------------------------------------------------------------- pooling

def MaxPooling1D(pool_size: int = 2, strides=None, padding="valid",
                 input_shape=None, name=None, **kwargs):
    """reference: ``keras2/layers/pooling.py:24``."""
    return k1.MaxPooling1D(pool_length=pool_size, stride=strides,
                           border_mode=padding, input_shape=input_shape,
                           name=name, **kwargs)


def AveragePooling1D(pool_size: int = 2, strides=None, padding="valid",
                     input_shape=None, name=None, **kwargs):
    return k1.AveragePooling1D(pool_length=pool_size, stride=strides,
                               border_mode=padding,
                               input_shape=input_shape, name=name,
                               **kwargs)


def MaxPooling2D(pool_size=(2, 2), strides=None, padding="valid",
                 data_format=None, input_shape=None, name=None, **kwargs):
    return k1.MaxPooling2D(pool_size=_pair(pool_size),
                           strides=_pair(strides) if strides else None,
                           border_mode=padding,
                           dim_ordering=_df(data_format),
                           input_shape=input_shape, name=name, **kwargs)


def AveragePooling2D(pool_size=(2, 2), strides=None, padding="valid",
                     data_format=None, input_shape=None, name=None,
                     **kwargs):
    return k1.AveragePooling2D(pool_size=_pair(pool_size),
                               strides=_pair(strides) if strides else None,
                               border_mode=padding,
                               dim_ordering=_df(data_format),
                               input_shape=input_shape, name=name,
                               **kwargs)


def GlobalAveragePooling1D(input_shape=None, name=None, **kwargs):
    """reference: ``keras2/layers/pooling.py:100``."""
    return k1.GlobalAveragePooling1D(input_shape=input_shape, name=name,
                                     **kwargs)


def GlobalMaxPooling1D(input_shape=None, name=None, **kwargs):
    return k1.GlobalMaxPooling1D(input_shape=input_shape, name=name,
                                 **kwargs)


def GlobalAveragePooling2D(data_format=None, input_shape=None, name=None,
                           **kwargs):
    """reference: ``keras2/layers/pooling.py:149``."""
    return k1.GlobalAveragePooling2D(dim_ordering=_df(data_format),
                                     input_shape=input_shape, name=name,
                                     **kwargs)


def GlobalMaxPooling2D(data_format=None, input_shape=None, name=None,
                       **kwargs):
    return k1.GlobalMaxPooling2D(dim_ordering=_df(data_format),
                                 input_shape=input_shape, name=name,
                                 **kwargs)


# ----------------------------------------------------------------- merge

class _MergeN:
    """keras2 functional merge layers (reference ``keras2/layers/merge.py``:
    ``Maximum``/``Minimum``/``Average``): instantiate, then call on a list
    of graph tensors."""

    mode: str = "sum"

    def __init__(self, name: Optional[str] = None):
        self.name = name

    def __call__(self, inputs: Sequence):
        return _merge(list(inputs), mode=self.mode, name=self.name)


class Maximum(_MergeN):
    mode = "max"


class Minimum(_MergeN):
    mode = "min"


class Average(_MergeN):
    mode = "ave"


class Add(_MergeN):
    mode = "sum"


class Concatenate(_MergeN):
    mode = "concat"

    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def __call__(self, inputs: Sequence):
        return _merge(list(inputs), mode="concat", concat_axis=self.axis,
                      name=self.name)


def average(inputs: Sequence, name: Optional[str] = None):
    """Functional alias (reference ``keras2/layers/merge.py`` ``average``)."""
    return Average(name=name)(inputs)


def maximum(inputs: Sequence, name: Optional[str] = None):
    """Functional alias (reference ``keras2/layers/merge.py`` ``maximum``)."""
    return Maximum(name=name)(inputs)


def minimum(inputs: Sequence, name: Optional[str] = None):
    """Functional alias (reference ``keras2/layers/merge.py`` ``minimum``)."""
    return Minimum(name=name)(inputs)


# ------------------------------------------------- advanced activations

def LeakyReLU(alpha: float = 0.3, input_shape=None, name=None, **kwargs):
    return k1.LeakyReLU(alpha=alpha, input_shape=input_shape, name=name,
                        **kwargs)


def ELU(alpha: float = 1.0, input_shape=None, name=None, **kwargs):
    return k1.ELU(alpha=alpha, input_shape=input_shape, name=name,
                  **kwargs)


def ThresholdedReLU(theta: float = 1.0, input_shape=None, name=None,
                    **kwargs):
    return k1.ThresholdedReLU(theta=theta, input_shape=input_shape,
                              name=name, **kwargs)


# ------------------------------------------------------------- recurrent

def LSTM(units: int, activation="tanh", recurrent_activation="sigmoid",
         return_sequences: bool = False, input_shape=None, name=None,
         **kwargs):
    return k1.LSTM(units, activation=activation,
                   inner_activation=recurrent_activation,
                   return_sequences=return_sequences,
                   input_shape=input_shape, name=name, **kwargs)


def GRU(units: int, activation="tanh", recurrent_activation="sigmoid",
        return_sequences: bool = False, input_shape=None, name=None,
        **kwargs):
    return k1.GRU(units, activation=activation,
                  inner_activation=recurrent_activation,
                  return_sequences=return_sequences,
                  input_shape=input_shape, name=name, **kwargs)


def SimpleRNN(units: int, activation="tanh",
              return_sequences: bool = False, input_shape=None, name=None,
              **kwargs):
    return k1.SimpleRNN(units, activation=activation,
                        return_sequences=return_sequences,
                        input_shape=input_shape, name=name, **kwargs)


def BatchNormalization(axis: int = -1, momentum: float = 0.99,
                       epsilon: float = 1e-3, input_shape=None, name=None,
                       **kwargs):
    if axis != -1:
        raise ValueError("BatchNormalization supports the trailing feature "
                         "axis only (axis=-1)")
    return k1.BatchNormalization(epsilon=epsilon, momentum=momentum,
                                 input_shape=input_shape, name=name,
                                 **kwargs)