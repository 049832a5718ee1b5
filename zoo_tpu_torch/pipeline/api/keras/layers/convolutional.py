"""``Convolution2D`` (alias ``Conv2D``), keras-1 style (counterpart of
``zoo_tpu/pipeline/api/keras/layers/convolutional.py:43-119``).

Convs run in NHWC with HWIO weights, the JAX package's layout;
``dim_ordering="th"`` (NCHW) is honoured at the layer's boundary by a
permute on entry and exit. The float conv goes through the one conv
dispatch point (:func:`zoo_tpu_torch.ops.kernels.conv.conv2d`); after
``quantize_model`` the layer holds ``W_q``/``W_scale`` and runs
:func:`zoo_tpu_torch.ops.kernels.quant.quantized_conv2d`.
"""

from __future__ import annotations

from typing import Optional, Tuple

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_activation_fn,
    get_initializer,
)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _conv_out(size: Optional[int], k: int, s: int,
              mode: str) -> Optional[int]:
    if size is None:
        return None
    if mode == "same":
        return -(-size // s)
    return (size - k) // s + 1


class Convolution2D(Layer):
    """2-D convolution; weights ``W`` (kh, kw, c, nb_filter), bias
    ``b``. The class name gives the params key ``NNN_convolution2d``, as
    in the JAX package."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 init="glorot_uniform", activation=None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        if border_mode not in ("valid", "same"):
            raise ValueError("border_mode must be 'valid' or 'same'")
        if dim_ordering not in ("th", "tf"):
            raise ValueError("dim_ordering must be 'th' or 'tf'")
        self.nb_filter = int(nb_filter)
        self.kernel = (int(nb_row), int(nb_col))
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = _pair(subsample)
        self.dim_ordering = dim_ordering
        self.bias = bias

    def _in_channels(self, input_shape):
        return input_shape[1] if self.dim_ordering == "th" else \
            input_shape[3]

    def build(self, generator, input_shape):
        cin = self._in_channels(input_shape)
        params = {"W": self.init(generator,
                                 self.kernel + (cin, self.nb_filter))}
        if self.bias:
            params["b"] = get_initializer("zero")(generator,
                                                  (self.nb_filter,))
        return params

    def call(self, params, inputs, *, training=False):
        x = inputs
        if self.dim_ordering == "th":
            x = x.permute(0, 2, 3, 1).contiguous()   # NCHW -> NHWC
        if "W_q" in params:  # int8 weights (the quantize_model path)
            from zoo_tpu_torch.ops.kernels.quant import quantized_conv2d
            y = quantized_conv2d(
                x, params["W_q"], params["W_scale"],
                strides=self.subsample, padding=self.border_mode.upper(),
                bias=params.get("b") if self.bias else None)
        else:
            from zoo_tpu_torch.ops.kernels.conv import conv2d
            y = conv2d(x, params["W"], strides=self.subsample,
                       padding=self.border_mode.upper())
            if self.bias:
                y = y + params["b"]
        if self.activation:
            y = self.activation(y)
        if self.dim_ordering == "th":
            y = y.permute(0, 3, 1, 2).contiguous()
        return y

    def compute_output_shape(self, input_shape):
        if self.dim_ordering == "th":
            n, c, h, w = input_shape
        else:
            n, h, w, c = input_shape
        oh = _conv_out(h, self.kernel[0], self.subsample[0],
                       self.border_mode)
        ow = _conv_out(w, self.kernel[1], self.subsample[1],
                       self.border_mode)
        if self.dim_ordering == "th":
            return (n, self.nb_filter, oh, ow)
        return (n, oh, ow, self.nb_filter)


Conv2D = Convolution2D
