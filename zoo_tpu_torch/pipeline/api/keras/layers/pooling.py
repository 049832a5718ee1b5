"""2-D pooling layers, keras-1 style (counterpart of
``MaxPooling2D`` and ``GlobalAveragePooling2D`` of
``zoo_tpu/pipeline/api/keras/layers/pooling.py``). NHWC inside;
``dim_ordering="th"`` is permuted at the boundary, as in the conv
layer. SAME max pooling pads with -inf on XLA's split (the odd pad at
the end) before ``max_pool2d``, which pads only symmetrically.
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

    def call(self, params, inputs, *, training=False):
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


class GlobalAveragePooling2D(Layer):
    def __init__(self, dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False):
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        return torch.mean(inputs, dim=axes)

    def compute_output_shape(self, input_shape):
        c = input_shape[1] if self.dim_ordering == "th" else input_shape[3]
        return (input_shape[0], c)
