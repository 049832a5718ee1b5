"""Pooling layers, keras-1 style (counterpart of
``zoo_tpu/pipeline/api/keras/layers/pooling.py``): max and average
pooling in 1-D and 2-D, and the global max and average pools.
``dim_ordering="th"`` (NCHW) is honoured as in the conv layers. SAME
pooling pads on XLA's split (the odd pad at the end): max pooling with
-inf before ``max_pool1d``/``max_pool2d``, which pad only
symmetrically; average pooling with zeros, dividing each window's sum
by the count of its elements inside the input (``reduce_window`` of
ones, as the JAX layer divides). The global max pools reduce with
``amax``, whose gradient splits among ties as ``jnp.max``'s does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zoo_tpu_torch.ops.kernels.conv import _spatial_pads
from zoo_tpu_torch.pipeline.api.keras.engine.base import Layer
from zoo_tpu_torch.pipeline.api.keras.layers.convolutional import (
    _conv_out,
    _pair,
)


class MaxPooling2D(Layer):
    def __init__(self, pool_size=(2, 2), strides=None,
                 border_mode: str = "valid", dim_ordering: str = "th",
                 **kwargs):
        super().__init__(**kwargs)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None \
            else self.pool_size
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        x = inputs if self.dim_ordering == "th" else \
            inputs.permute(0, 3, 1, 2)                 # NHWC -> NCHW view
        (pt, pb), (pl, pr), _, _ = _spatial_pads(
            x.shape[2], x.shape[3], *self.pool_size, self.strides,
            self.border_mode)
        if pt or pb or pl or pr:
            x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
        y = F.max_pool2d(x, self.pool_size, self.strides)
        return y if self.dim_ordering == "th" else \
            y.permute(0, 2, 3, 1).contiguous()

    def compute_output_shape(self, input_shape):
        if self.dim_ordering == "th":
            n, c, h, w = input_shape
        else:
            n, h, w, c = input_shape
        oh = _conv_out(h, self.pool_size[0], self.strides[0],
                       self.border_mode)
        ow = _conv_out(w, self.pool_size[1], self.strides[1],
                       self.border_mode)
        return (n, c, oh, ow) if self.dim_ordering == "th" else \
            (n, oh, ow, c)


def _windows(x: torch.Tensor, dim: int, k: int, s: int, pads
             ) -> torch.Tensor:
    """``x`` zero-padded by ``pads`` on axis ``dim``, unfolded into
    windows of ``k`` at stride ``s`` (a trailing axis)."""
    lo, hi = pads
    if lo or hi:
        widths = [0, 0] * (x.ndim - 1 - dim) + [lo, hi]
        x = F.pad(x, widths)
    return x.unfold(dim, k, s)


def _average(x: torch.Tensor, dims, sizes, strides, mode: str
             ) -> torch.Tensor:
    """Window sums over ``dims`` divided by the count of in-input
    elements of each window (the JAX layers' ``summed / counts``)."""
    ones = torch.ones((1,) * x.ndim, dtype=x.dtype, device=x.device) \
        .expand(x.shape)
    summed, counts = x, ones
    for dim, k, s in zip(dims, sizes, strides):
        lo, hi = _axis_pads(x.shape[dim], k, s, mode)
        summed = _windows(summed, dim, k, s, (lo, hi)).sum(-1)
        counts = _windows(counts, dim, k, s, (lo, hi)).sum(-1)
    return summed / counts


def _axis_pads(size: int, k: int, s: int, mode: str):
    (lo, hi), _, _, _ = _spatial_pads(size, 1, k, 1, (s, 1), mode)
    return lo, hi


class AveragePooling2D(MaxPooling2D):
    def call(self, params, inputs, *, training=False, rng=None):
        hx, wx = (2, 3) if self.dim_ordering == "th" else (1, 2)
        return _average(inputs, (hx, wx), self.pool_size, self.strides,
                        self.border_mode)


class _Pool1D(Layer):
    def __init__(self, pool_length: int = 2, stride=None,
                 border_mode: str = "valid", **kwargs):
        super().__init__(**kwargs)
        self.pool_length = int(pool_length)
        self.stride = int(stride) if stride is not None else \
            self.pool_length
        self.border_mode = border_mode

    def compute_output_shape(self, input_shape):
        n, steps, d = input_shape
        return (n, _conv_out(steps, self.pool_length, self.stride,
                             self.border_mode), d)


class MaxPooling1D(_Pool1D):
    def call(self, params, inputs, *, training=False, rng=None):
        x = inputs.transpose(1, 2)                       # (B, D, T) view
        lo, hi = _axis_pads(x.shape[2], self.pool_length, self.stride,
                            self.border_mode)
        if lo or hi:
            x = F.pad(x, (lo, hi), value=float("-inf"))
        return F.max_pool1d(x, self.pool_length, self.stride) \
            .transpose(1, 2).contiguous()


class AveragePooling1D(_Pool1D):
    def call(self, params, inputs, *, training=False, rng=None):
        return _average(inputs, (1,), (self.pool_length,), (self.stride,),
                        self.border_mode)


class GlobalMaxPooling2D(Layer):
    def __init__(self, dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        return torch.amax(inputs, dim=axes)

    def compute_output_shape(self, input_shape):
        c = input_shape[1] if self.dim_ordering == "th" else input_shape[3]
        return (input_shape[0], c)


class GlobalAveragePooling2D(GlobalMaxPooling2D):
    def call(self, params, inputs, *, training=False, rng=None):
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        return torch.mean(inputs, dim=axes)


class GlobalMaxPooling1D(Layer):
    def call(self, params, inputs, *, training=False, rng=None):
        return torch.amax(inputs, dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[2])


class GlobalAveragePooling1D(GlobalMaxPooling1D):
    def call(self, params, inputs, *, training=False, rng=None):
        return torch.mean(inputs, dim=1)
