"""Image-classification model zoo and the ``ImageClassifier`` pipeline
(counterpart of ``zoo_tpu/models/image/imageclassification.py``):
Inception-v1 (GoogLeNet), VGG-16/19, MobileNet v1 (with ``alpha``) and
v2, SqueezeNet and DenseNet-121, the per-family deploy preprocessing
(resize to 256, centre crop to 224, channel normalization), and
``ImageClassifier`` (``create``, ``load_model``, ``save_model``,
``predict_image_set``).

Each family is the same functional graph, layer for layer, as the JAX
package builds, so the params keys match its tree and
``keras_params_from_jax`` carries a JAX-built tree over. The convs go
through the one conv dispatch point: every 1x1 conv and every 3x3 conv
at stride 1 takes the implicit-GEMM kernel on the card (the kernel's
envelope, as in JAX); the stems (7x7/2, 3x3/2), Inception's 5x5s and
the MobileNets' depthwise convs take the reference conv.

``ImageClassifier.predict_image_set`` and the models' ``predict`` and
``fit`` run on the current CUDA device unless given ``device``
(``device="cpu"`` runs every plain version); without a card and without
``device`` they raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from zoo_tpu_torch.feature.common import ChainedPreprocessing
from zoo_tpu_torch.feature.image import (
    ImageCenterCrop,
    ImageChannelNormalize,
    ImageFeature,
    ImageMatToTensor,
    ImageResize,
    ImageSet,
)
from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
    Input,
    KerasNet,
    Model,
)
from zoo_tpu_torch.pipeline.api.keras.layers import (
    Activation,
    AveragePooling2D,
    BatchNormalization,
    Conv2D,
    Dense,
    DepthwiseConvolution2D,
    Dropout,
    Flatten,
    GlobalAveragePooling2D,
    MaxPooling2D,
    merge,
)

_TF = {"dim_ordering": "tf"}


def _conv_bn(x, filters, k, stride=1, act="relu", name=None):
    h = Conv2D(filters, k, k, subsample=(stride, stride),
               border_mode="same", bias=False, **_TF)(x)
    h = BatchNormalization()(h)
    if act:
        h = Activation(act)(h)
    return h


# ------------------------------------------------------------ Inception v1

def _inception_module(x, c1, c3r, c3, c5r, c5, pp):
    b1 = Conv2D(c1, 1, 1, activation="relu", border_mode="same", **_TF)(x)
    b2 = Conv2D(c3r, 1, 1, activation="relu", border_mode="same", **_TF)(x)
    b2 = Conv2D(c3, 3, 3, activation="relu", border_mode="same", **_TF)(b2)
    b3 = Conv2D(c5r, 1, 1, activation="relu", border_mode="same", **_TF)(x)
    b3 = Conv2D(c5, 5, 5, activation="relu", border_mode="same", **_TF)(b3)
    b4 = MaxPooling2D((3, 3), strides=(1, 1), border_mode="same", **_TF)(x)
    b4 = Conv2D(pp, 1, 1, activation="relu", border_mode="same", **_TF)(b4)
    return merge([b1, b2, b3, b4], mode="concat", concat_axis=-1)


def inception_v1(class_num: int, input_shape=(224, 224, 3)) -> Model:
    """GoogLeNet (the catalogue's ``inception-v1``)."""
    x_in = Input(shape=tuple(input_shape), name="image")
    h = Conv2D(64, 7, 7, subsample=(2, 2), activation="relu",
               border_mode="same", **_TF)(x_in)
    h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same", **_TF)(h)
    h = Conv2D(64, 1, 1, activation="relu", border_mode="same", **_TF)(h)
    h = Conv2D(192, 3, 3, activation="relu", border_mode="same", **_TF)(h)
    h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same", **_TF)(h)
    h = _inception_module(h, 64, 96, 128, 16, 32, 32)     # 3a
    h = _inception_module(h, 128, 128, 192, 32, 96, 64)   # 3b
    h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same", **_TF)(h)
    h = _inception_module(h, 192, 96, 208, 16, 48, 64)    # 4a
    h = _inception_module(h, 160, 112, 224, 24, 64, 64)   # 4b
    h = _inception_module(h, 128, 128, 256, 24, 64, 64)   # 4c
    h = _inception_module(h, 112, 144, 288, 32, 64, 64)   # 4d
    h = _inception_module(h, 256, 160, 320, 32, 128, 128)  # 4e
    h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same", **_TF)(h)
    h = _inception_module(h, 256, 160, 320, 32, 128, 128)  # 5a
    h = _inception_module(h, 384, 192, 384, 48, 128, 128)  # 5b
    h = GlobalAveragePooling2D(**_TF)(h)
    h = Dropout(0.4)(h)
    out = Dense(class_num, activation="softmax")(h)
    return Model(input=x_in, output=out, name="inception-v1")


# ------------------------------------------------------------------- VGG

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


# ------------------------------------------------------------- MobileNet

def _dw_block(x, filters, stride, alpha):
    h = DepthwiseConvolution2D(3, 3, subsample=(stride, stride),
                               border_mode="same", bias=False, **_TF)(x)
    h = BatchNormalization()(h)
    h = Activation("relu")(h)
    h = Conv2D(int(filters * alpha), 1, 1, border_mode="same", bias=False,
               **_TF)(h)
    h = BatchNormalization()(h)
    return Activation("relu")(h)


def mobilenet_v1(class_num: int, alpha: float = 1.0,
                 input_shape=(224, 224, 3)) -> Model:
    x_in = Input(shape=tuple(input_shape), name="image")
    h = _conv_bn(x_in, int(32 * alpha), 3, stride=2)
    for filters, stride in ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                            (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                            (512, 1), (1024, 2), (1024, 1)):
        h = _dw_block(h, filters, stride, alpha)
    h = GlobalAveragePooling2D(**_TF)(h)
    h = Dropout(0.001)(h)
    out = Dense(class_num, activation="softmax")(h)
    return Model(input=x_in, output=out, name="mobilenet")


def _inverted_residual(x, cin, cout, stride, expand):
    h = x
    if expand != 1:
        h = _conv_bn(h, cin * expand, 1, act="relu")
    h = DepthwiseConvolution2D(3, 3, subsample=(stride, stride),
                               border_mode="same", bias=False, **_TF)(h)
    h = BatchNormalization()(h)
    h = Activation("relu")(h)
    h = Conv2D(cout, 1, 1, border_mode="same", bias=False, **_TF)(h)
    h = BatchNormalization()(h)
    if stride == 1 and cin == cout:
        h = merge([h, x], mode="sum")
    return h


def mobilenet_v2(class_num: int, input_shape=(224, 224, 3)) -> Model:
    x_in = Input(shape=tuple(input_shape), name="image")
    h = _conv_bn(x_in, 32, 3, stride=2)
    cin = 32
    for expand, cout, n, stride in ((1, 16, 1, 1), (6, 24, 2, 2),
                                    (6, 32, 3, 2), (6, 64, 4, 2),
                                    (6, 96, 3, 1), (6, 160, 3, 2),
                                    (6, 320, 1, 1)):
        for i in range(n):
            h = _inverted_residual(h, cin, cout, stride if i == 0 else 1,
                                   expand)
            cin = cout
    h = _conv_bn(h, 1280, 1)
    h = GlobalAveragePooling2D(**_TF)(h)
    out = Dense(class_num, activation="softmax")(h)
    return Model(input=x_in, output=out, name="mobilenet-v2")


# ------------------------------------------------------------- SqueezeNet

def _fire(x, squeeze, expand):
    s = Conv2D(squeeze, 1, 1, activation="relu", border_mode="same",
               **_TF)(x)
    e1 = Conv2D(expand, 1, 1, activation="relu", border_mode="same",
                **_TF)(s)
    e3 = Conv2D(expand, 3, 3, activation="relu", border_mode="same",
                **_TF)(s)
    return merge([e1, e3], mode="concat", concat_axis=-1)


def squeezenet(class_num: int, input_shape=(224, 224, 3)) -> Model:
    x_in = Input(shape=tuple(input_shape), name="image")
    h = Conv2D(64, 3, 3, subsample=(2, 2), activation="relu",
               border_mode="same", **_TF)(x_in)
    h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same", **_TF)(h)
    h = _fire(h, 16, 64)
    h = _fire(h, 16, 64)
    h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same", **_TF)(h)
    h = _fire(h, 32, 128)
    h = _fire(h, 32, 128)
    h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same", **_TF)(h)
    h = _fire(h, 48, 192)
    h = _fire(h, 48, 192)
    h = _fire(h, 64, 256)
    h = _fire(h, 64, 256)
    h = Dropout(0.5)(h)
    h = Conv2D(class_num, 1, 1, activation="relu", border_mode="same",
               **_TF)(h)
    h = GlobalAveragePooling2D(**_TF)(h)
    out = Activation("softmax")(h)
    return Model(input=x_in, output=out, name="squeezenet")


# -------------------------------------------------------------- DenseNet

def _dense_block(x, n_layers, growth):
    for _ in range(n_layers):
        h = BatchNormalization()(x)
        h = Activation("relu")(h)
        h = Conv2D(4 * growth, 1, 1, border_mode="same", bias=False,
                   **_TF)(h)
        h = BatchNormalization()(h)
        h = Activation("relu")(h)
        h = Conv2D(growth, 3, 3, border_mode="same", bias=False, **_TF)(h)
        x = merge([x, h], mode="concat", concat_axis=-1)
    return x


def _transition(x, channels):
    h = BatchNormalization()(x)
    h = Activation("relu")(h)
    h = Conv2D(channels, 1, 1, border_mode="same", bias=False, **_TF)(h)
    return AveragePooling2D((2, 2), strides=(2, 2), **_TF)(h)


def densenet121(class_num: int, growth: int = 32,
                input_shape=(224, 224, 3)) -> Model:
    x_in = Input(shape=tuple(input_shape), name="image")
    h = _conv_bn(x_in, 64, 7, stride=2)
    h = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same", **_TF)(h)
    channels = 64
    for i, n_layers in enumerate((6, 12, 24, 16)):
        h = _dense_block(h, n_layers, growth)
        channels += n_layers * growth
        if i < 3:
            channels //= 2
            h = _transition(h, channels)
    h = BatchNormalization()(h)
    h = Activation("relu")(h)
    h = GlobalAveragePooling2D(**_TF)(h)
    out = Dense(class_num, activation="softmax")(h)
    return Model(input=x_in, output=out, name="densenet-121")


# --------------------------------------------------- configs + classifier

_ZOO = {"inception-v1": inception_v1, "vgg-16": vgg16, "vgg-19": vgg19,
        "mobilenet": mobilenet_v1, "mobilenet-v2": mobilenet_v2,
        "squeezenet": squeezenet, "densenet-121": densenet121}

# Per-family deploy preprocessing: resize to 256, centre crop to 224,
# channel normalization with the family's training statistics.
_IMAGENET_MEAN = (123.68, 116.78, 103.94)
_CONFIGS = {
    "inception-v1": dict(resize=256, crop=224, mean=_IMAGENET_MEAN,
                         std=(1.0, 1.0, 1.0)),
    "vgg-16": dict(resize=256, crop=224, mean=_IMAGENET_MEAN,
                   std=(1.0, 1.0, 1.0)),
    "vgg-19": dict(resize=256, crop=224, mean=_IMAGENET_MEAN,
                   std=(1.0, 1.0, 1.0)),
    "mobilenet": dict(resize=256, crop=224, mean=(127.5, 127.5, 127.5),
                      std=(127.5, 127.5, 127.5)),
    "mobilenet-v2": dict(resize=256, crop=224, mean=(127.5, 127.5, 127.5),
                         std=(127.5, 127.5, 127.5)),
    "squeezenet": dict(resize=256, crop=224, mean=_IMAGENET_MEAN,
                       std=(1.0, 1.0, 1.0)),
    "densenet-121": dict(resize=256, crop=224, mean=_IMAGENET_MEAN,
                         std=(58.4, 57.1, 57.4)),
}


def image_classification_preprocess(model_name: str) -> ChainedPreprocessing:
    """The deploy-time transform chain of a zoo family: resize, centre
    crop, BGR channel normalization, NHWC f32 ``tensor``."""
    cfg = _CONFIGS[model_name]
    mb, mg, mr = cfg["mean"][2], cfg["mean"][1], cfg["mean"][0]
    sb, sg, sr = cfg["std"][2], cfg["std"][1], cfg["std"][0]
    return ChainedPreprocessing([
        ImageResize(cfg["resize"], cfg["resize"]),
        ImageCenterCrop(cfg["crop"], cfg["crop"]),
        ImageChannelNormalize(mb, mg, mr, sb, sg, sr),
        ImageMatToTensor(format="NHWC"),
    ])


def create_image_classifier(model_name: str, class_num: int = 1000):
    """Build a zoo architecture by catalogue name."""
    if model_name not in _ZOO:
        raise ValueError(f"unknown image-classification model "
                         f"{model_name!r}; have {sorted(_ZOO)}")
    return _ZOO[model_name](class_num)


class LabelOutput:
    """Attach the top ``top_k`` labels and probabilities, in descending
    order, to a feature that holds ``predict``."""

    def __init__(self, label_map: dict, clses: str = "classes",
                 probs: str = "probs", top_k: int = 5):
        self.label_map = label_map
        self.clses, self.probs, self.top_k = clses, probs, int(top_k)

    def __call__(self, feature):
        logits = np.asarray(feature["predict"]).reshape(-1)
        order = np.argsort(-logits)[:self.top_k]
        feature[self.clses] = [self.label_map.get(int(i), str(int(i)))
                               for i in order]
        feature[self.probs] = logits[order].tolist()
        return feature


class ImageClassifier:
    """A classification model and its deploy pipeline."""

    def __init__(self, model: KerasNet, model_name: Optional[str] = None,
                 label_map: Optional[dict] = None):
        self.model = model
        self.model_name = model_name or getattr(model, "name", None)
        self.label_map = label_map or {}

    @classmethod
    def create(cls, model_name: str, class_num: int = 1000,
               label_map: Optional[dict] = None) -> "ImageClassifier":
        return cls(create_image_classifier(model_name, class_num),
                   model_name, label_map)

    @staticmethod
    def load_model(path: str, label_map: Optional[dict] = None,
                   device=None) -> "ImageClassifier":
        """A model file of :meth:`save_model`, its params on the current
        CUDA device unless ``device`` names another."""
        return ImageClassifier(KerasNet.load(path, device=device),
                               label_map=label_map)

    def save_model(self, path: str):
        self.model.save(path)

    def preprocess(self, image_set) -> np.ndarray:
        """The family's deploy chain over copies of the set's images
        (transformers change features in place; the caller's images stay
        as they are), stacked into one NHWC f32 batch."""
        if self.model_name in _CONFIGS:
            chain = image_classification_preprocess(self.model_name)
        else:  # unknown family: still resize so mixed-size sets stack
            chain = ChainedPreprocessing([
                ImageResize(224, 224), ImageMatToTensor(format="NHWC")])
        work = ImageSet([ImageFeature(image=np.asarray(f["image"]).copy())
                         for f in image_set.features])
        transformed = work.transform(chain)
        return np.stack(
            [np.asarray(f["tensor"]) for f in transformed.features])

    def predict_image_set(self, image_set, top_k: int = 5,
                          batch_size: int = 256, device=None):
        """Each feature gains ``predict`` (the class probabilities) and
        the top ``top_k`` ``classes`` and ``probs`` (``LabelOutput``).
        Runs on the current CUDA device unless ``device`` names
        another."""
        probs = np.asarray(self.model.predict(
            self.preprocess(image_set), batch_size=batch_size,
            device=device))
        labeler = LabelOutput(self.label_map, top_k=top_k)
        for f, p in zip(image_set.features, probs):
            f["predict"] = p
            labeler(f)
        return image_set
