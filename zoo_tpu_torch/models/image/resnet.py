"""ResNet image classifiers (counterpart of
``zoo_tpu/models/image/resnet.py``).

NHWC throughout (inputs are ``dim_ordering="tf"``), BatchNorm over the
trailing channel axis, stride-2 convs in the blocks, residual adds as
functional-graph ``merge(mode="sum")`` nodes: the same graph, layer for
layer, as the JAX package builds, so the params keys match its tree.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F

from zoo_tpu_torch.ops.kernels.conv import conv2d_plain
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_initializer,
)
from zoo_tpu_torch.pipeline.api.keras.engine.topology import Input, Model
from zoo_tpu_torch.pipeline.api.keras.layers import (
    Activation,
    BatchNormalization,
    Conv2D,
    Dense,
    GlobalAveragePooling2D,
    MaxPooling2D,
    merge,
)


class SpaceToDepthStem(Layer):
    """The 7x7/s2 stem conv computed as a 4x4/s1 conv over the input
    folded 2x2 space-to-depth, the JAX package's formulation; params keep
    the canonical (7, 7, c, filters) HWIO shape. The 4x4 conv is the
    reference conv (outside the implicit-GEMM kernel's envelope, as in
    the JAX package)."""

    def __init__(self, filters: int = 64, init="glorot_uniform", **kwargs):
        super().__init__(**kwargs)
        self.filters = int(filters)
        self.init = get_initializer(init)

    def build(self, generator, input_shape):
        return {"W": self.init(generator,
                               (7, 7, input_shape[3], self.filters))}

    def call(self, params, x, *, training=False, rng=None):
        w = params["W"].to(x.dtype)
        b, h, wd, c = x.shape
        # kernel tap k covers pixel 2i-2+k (SAME pad (2, 3) at k=7, s=2);
        # an 8-tap window over 4 super-pixels covers 2i-2..2i+5: one zero
        # tap at the end, then (dy, dx) folded into channels
        w8 = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))
        w4 = w8.reshape(4, 2, 4, 2, c, self.filters) \
            .permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * c, self.filters)
        xs = x.reshape(b, h // 2, 2, wd // 2, 2, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, wd // 2, 4 * c)
        return conv2d_plain(xs, w4, (1, 1), ((1, 2), (1, 2)))

    def compute_output_shape(self, input_shape):
        n, h, w, _ = input_shape
        return (n, None if h is None else h // 2,
                None if w is None else w // 2, self.filters)


def _conv_bn(x, filters, k, stride=1, act=True):
    h = Conv2D(filters, k, k, subsample=(stride, stride),
               border_mode="same", dim_ordering="tf", bias=False)(x)
    h = BatchNormalization()(h)
    if act:
        h = Activation("relu")(h)
    return h


def _basic_block(x, filters, stride=1, downsample=False):
    h = _conv_bn(x, filters, 3, stride)
    h = _conv_bn(h, filters, 3, 1, act=False)
    shortcut = x
    if downsample:
        shortcut = _conv_bn(x, filters, 1, stride, act=False)
    out = merge([h, shortcut], mode="sum")
    return Activation("relu")(out)


def _bottleneck(x, filters, stride=1, downsample=False):
    h = _conv_bn(x, filters, 1, 1)
    h = _conv_bn(h, filters, 3, stride)
    h = _conv_bn(h, filters * 4, 1, 1, act=False)
    shortcut = x
    if downsample:
        shortcut = _conv_bn(x, filters * 4, 1, stride, act=False)
    out = merge([h, shortcut], mode="sum")
    return Activation("relu")(out)


class ResNet(Model):
    def __init__(self, class_num: int, blocks: Sequence[int],
                 bottleneck: bool, input_shape=(224, 224, 3),
                 stem_pool: bool = True, stem: str = "auto",
                 name: str = "resnet"):
        """``stem``: "s2d" (space-to-depth 7x7/s2), "conv" (a plain
        7x7/s2 conv) or "auto" (s2d when the spatial dims are even)."""
        if stem not in ("auto", "s2d", "conv"):
            raise ValueError(f"unknown stem: {stem!r}")
        if stem == "auto":
            stem = ("s2d" if input_shape[0] % 2 == 0
                    and input_shape[1] % 2 == 0 else "conv")
        x_in = Input(shape=tuple(input_shape), name="image")
        if stem == "s2d":
            h = SpaceToDepthStem(64)(x_in)
            h = BatchNormalization()(h)
            h = Activation("relu")(h)
        else:
            h = _conv_bn(x_in, 64, 7, stride=2)
        if stem_pool:
            h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                             dim_ordering="tf")(h)
        block = _bottleneck if bottleneck else _basic_block
        filters = 64
        for stage, n in enumerate(blocks):
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                h = block(h, filters, stride=stride, downsample=(i == 0))
            filters *= 2
        h = GlobalAveragePooling2D(dim_ordering="tf")(h)
        out = Dense(class_num, activation="softmax")(h)
        Model.__init__(self, input=x_in, output=out, name=name)


def resnet18(class_num: int, input_shape=(224, 224, 3)) -> ResNet:
    return ResNet(class_num, (2, 2, 2, 2), bottleneck=False,
                  input_shape=input_shape, name="resnet18")


def resnet50(class_num: int, input_shape=(224, 224, 3)) -> ResNet:
    return ResNet(class_num, (3, 4, 6, 3), bottleneck=True,
                  input_shape=input_shape, name="resnet50")
