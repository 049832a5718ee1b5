"""Convolution, padding, upsampling, cropping and spatial dropout
layers, keras-1 style (counterpart of
``zoo_tpu/pipeline/api/keras/layers/convolutional.py``).

Convs run in NHWC with HWIO weights, the JAX package's layout;
``dim_ordering="th"`` (NCHW) is honoured at the layer's boundary by a
permute on entry and exit. ``Convolution2D``'s float conv goes through
the one conv dispatch point (:func:`zoo_tpu_torch.ops.kernels.conv.
conv2d`); after ``quantize_model`` the layer holds ``W_q``/``W_scale``
and runs :func:`zoo_tpu_torch.ops.kernels.quant.quantized_conv2d`.
``Convolution1D`` is ``lax.conv_general_dilated`` in the JAX package,
outside Pallas: here the reference conv
(:func:`~zoo_tpu_torch.ops.kernels.conv.conv2d_plain` over a one-row
image, f32 sums with TF32 off). The spatial dropouts draw JAX's mask
over the broadcast shape (one element per feature map) through the
dropout kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.nn.functional as F

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_activation_fn,
    get_initializer,
)
from zoo_tpu_torch.pipeline.api.keras.layers.core import spatial_dropout


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
                 dim_ordering: str = "th", bias: bool = True,
                 W_regularizer=None, b_regularizer=None, **kwargs):
        # the regularizers are accepted and not applied, as in the JAX
        # package
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

    def call(self, params, inputs, *, training=False, rng=None):
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


class Convolution1D(Layer):
    """1-D convolution over (batch, steps, dim); weights ``W``
    (filter_length, dim, nb_filter), bias ``b``."""

    def __init__(self, nb_filter: int, filter_length: int,
                 init="glorot_uniform", activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        if border_mode not in ("valid", "same"):
            raise ValueError("border_mode must be 'valid' or 'same'")
        self.nb_filter = int(nb_filter)
        self.filter_length = int(filter_length)
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = int(subsample_length)
        self.bias = bias

    def build(self, generator, input_shape):
        params = {"W": self.init(generator, (self.filter_length,
                                             input_shape[-1],
                                             self.nb_filter))}
        if self.bias:
            params["b"] = get_initializer("zero")(generator,
                                                  (self.nb_filter,))
        return params

    def call(self, params, inputs, *, training=False, rng=None):
        from zoo_tpu_torch.ops.kernels.conv import conv2d_plain
        y = conv2d_plain(inputs[:, None], params["W"][None],
                         (1, self.subsample),
                         self.border_mode.upper())[:, 0]
        if self.bias:
            y = y + params["b"]
        return self.activation(y) if self.activation else y

    def compute_output_shape(self, input_shape):
        n, steps, _ = input_shape
        return (n, _conv_out(steps, self.filter_length, self.subsample,
                             self.border_mode), self.nb_filter)


Conv1D = Convolution1D


def _spatial_axes(dim_ordering: str) -> Tuple[int, int]:
    return (2, 3) if dim_ordering == "th" else (1, 2)


class ZeroPadding1D(Layer):
    def __init__(self, padding: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.padding = int(padding)

    def call(self, params, inputs, *, training=False, rng=None):
        return F.pad(inputs, (0, 0, self.padding, self.padding))

    def compute_output_shape(self, input_shape):
        n, steps, d = input_shape
        return (n, None if steps is None else steps + 2 * self.padding, d)


class ZeroPadding2D(Layer):
    def __init__(self, padding=(1, 1), dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.padding = _pair(padding)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        ph, pw = self.padding
        pads = (pw, pw, ph, ph) if self.dim_ordering == "th" else \
            (0, 0, pw, pw, ph, ph)
        return F.pad(inputs, pads)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        for ax, pad in zip(_spatial_axes(self.dim_ordering), self.padding):
            if s[ax] is not None:
                s[ax] += 2 * pad
        return tuple(s)


class UpSampling1D(Layer):
    def __init__(self, length: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.length = int(length)

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs.repeat_interleave(self.length, dim=1)

    def compute_output_shape(self, input_shape):
        n, steps, d = input_shape
        return (n, None if steps is None else steps * self.length, d)


class UpSampling2D(Layer):
    def __init__(self, size=(2, 2), dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.size = _pair(size)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        hx, wx = _spatial_axes(self.dim_ordering)
        return inputs.repeat_interleave(self.size[0], dim=hx) \
            .repeat_interleave(self.size[1], dim=wx)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        for ax, k in zip(_spatial_axes(self.dim_ordering), self.size):
            if s[ax] is not None:
                s[ax] *= k
        return tuple(s)


class Cropping1D(Layer):
    def __init__(self, cropping=(1, 1), **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(int(v) for v in cropping)

    def call(self, params, inputs, *, training=False, rng=None):
        lo, hi = self.cropping
        return inputs[:, lo:inputs.shape[1] - hi, :]

    def compute_output_shape(self, input_shape):
        n, steps, d = input_shape
        return (n, None if steps is None else steps - sum(self.cropping), d)


class Cropping2D(Layer):
    def __init__(self, cropping=((0, 0), (0, 0)), dim_ordering: str = "th",
                 **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(tuple(int(v) for v in c) for c in cropping)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        (t, b), (lo, r) = self.cropping
        hx, wx = _spatial_axes(self.dim_ordering)
        return inputs.narrow(hx, t, inputs.shape[hx] - t - b) \
            .narrow(wx, lo, inputs.shape[wx] - lo - r)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        for ax, (a, b) in zip(_spatial_axes(self.dim_ordering),
                              self.cropping):
            if s[ax] is not None:
                s[ax] -= a + b
        return tuple(s)


class SpatialDropout1D(Layer):
    """Drop whole feature channels of (batch, steps, dim): JAX's mask of
    shape (batch, 1, dim)."""

    def __init__(self, p: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)

    def call(self, params, inputs, *, training=False, rng=None):
        if not training or self.p <= 0:
            return inputs
        return spatial_dropout(self, inputs, rng,
                               (inputs.shape[0], 1, inputs.shape[2]))


class SpatialDropout2D(Layer):
    """Drop whole feature maps: JAX's mask of shape (batch, C, 1, 1)
    (``th``) or (batch, 1, 1, C) (``tf``)."""

    def __init__(self, p: float = 0.5, dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        if not training or self.p <= 0:
            return inputs
        b = inputs.shape[0]
        shape = (b, inputs.shape[1], 1, 1) if self.dim_ordering == "th" \
            else (b, 1, 1, inputs.shape[3])
        return spatial_dropout(self, inputs, rng, shape)
