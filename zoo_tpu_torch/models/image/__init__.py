"""Image models of the port: the ResNet family and VGG-16/19. The other
classifiers of ``zoo_tpu/models/image/imageclassification.py`` raise,
naming ROADMAP A.12; the detectors are not ported yet."""

from zoo_tpu_torch.models.image.imageclassification import (
    ImageClassifier,
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

__all__ = ["ResNet", "resnet18", "resnet50", "vgg16", "vgg19",
           "ImageClassifier", "create_image_classifier", "densenet121",
           "image_classification_preprocess", "inception_v1",
           "mobilenet_v1", "mobilenet_v2", "squeezenet"]
