"""Image models of the port: the ResNet family and the classification
zoo (Inception-v1, VGG-16/19, the MobileNets, SqueezeNet, DenseNet-121,
``ImageClassifier``). The detectors of
``zoo_tpu/models/image/objectdetection.py`` are not ported yet: their
names raise, naming ROADMAP A.12."""

from zoo_tpu_torch.models.image.imageclassification import (
    ImageClassifier,
    LabelOutput,
    create_image_classifier,
    densenet121,
    image_classification_preprocess,
    inception_v1,
    mobilenet_v1,
    mobilenet_v2,
    squeezenet,
    vgg16,
    vgg19,
)
from zoo_tpu_torch.models.image.resnet import ResNet, resnet18, resnet50


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (models/image/objectdetection.py) is not ported to "
            "zoo_tpu_torch yet (ROADMAP A.12)")
    refuse.__name__ = name
    return refuse


SSD = _not_ported("SSD")
ObjectDetector = _not_ported("ObjectDetector")
generate_anchors = _not_ported("generate_anchors")
decode_boxes = _not_ported("decode_boxes")
nms = _not_ported("nms")
encode_targets = _not_ported("encode_targets")
multibox_loss = _not_ported("multibox_loss")

__all__ = ["ResNet", "resnet18", "resnet50", "SSD", "ObjectDetector",
           "generate_anchors", "decode_boxes", "nms", "encode_targets",
           "multibox_loss",
           "ImageClassifier", "LabelOutput", "create_image_classifier",
           "image_classification_preprocess", "inception_v1", "vgg16",
           "vgg19", "mobilenet_v1", "mobilenet_v2", "squeezenet",
           "densenet121"]
