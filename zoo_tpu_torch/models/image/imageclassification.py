"""Image classifiers of the port beyond ResNet (counterpart of
``zoo_tpu/models/image/imageclassification.py``): VGG-16 and VGG-19.

The same functional graph, layer for layer, as the JAX package builds,
so the params keys match its tree: 3x3 SAME convs with ReLU in five
blocks, each closed by a 2x2/2 max pool, ``Flatten`` (NHWC order), then
``Dense(4096)`` x 2 with ``Dropout(0.5)`` and a softmax head. fc6 takes
7 x 7 x 512 = 25,088 features at 224 x 224, so a quantized VGG runs it
through the two-pass int8 GEMM (K > 8192).

The rest of the family (Inception-v1, the MobileNets, SqueezeNet,
DenseNet-121), ``ImageClassifier`` and the preprocessing table are not
ported yet: each raises, naming ROADMAP A.12.
"""

from __future__ import annotations

from zoo_tpu_torch.pipeline.api.keras.engine.topology import Input, Model
from zoo_tpu_torch.pipeline.api.keras.layers import (
    Conv2D,
    Dense,
    Dropout,
    Flatten,
    MaxPooling2D,
)

_TF = {"dim_ordering": "tf"}


def _vgg(class_num, cfg, input_shape, name):
    x_in = Input(shape=tuple(input_shape), name="image")
    h = x_in
    for block in cfg:
        for filters in block:
            h = Conv2D(filters, 3, 3, activation="relu",
                       border_mode="same", **_TF)(h)
        h = MaxPooling2D((2, 2), strides=(2, 2), **_TF)(h)
    h = Flatten()(h)
    h = Dense(4096, activation="relu")(h)
    h = Dropout(0.5)(h)
    h = Dense(4096, activation="relu")(h)
    h = Dropout(0.5)(h)
    out = Dense(class_num, activation="softmax")(h)
    return Model(input=x_in, output=out, name=name)


def vgg16(class_num: int, input_shape=(224, 224, 3)) -> Model:
    return _vgg(class_num, [[64] * 2, [128] * 2, [256] * 3, [512] * 3,
                            [512] * 3], input_shape, "vgg-16")


def vgg19(class_num: int, input_shape=(224, 224, 3)) -> Model:
    return _vgg(class_num, [[64] * 2, [128] * 2, [256] * 4, [512] * 4,
                            [512] * 4], input_shape, "vgg-19")


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to zoo_tpu_torch yet (ROADMAP A.12)")
    refuse.__name__ = name
    return refuse


inception_v1 = _not_ported("inception_v1")
mobilenet_v1 = _not_ported("mobilenet_v1")
mobilenet_v2 = _not_ported("mobilenet_v2")
squeezenet = _not_ported("squeezenet")
densenet121 = _not_ported("densenet121")
create_image_classifier = _not_ported("create_image_classifier")
image_classification_preprocess = _not_ported(
    "image_classification_preprocess")
ImageClassifier = _not_ported("ImageClassifier")
