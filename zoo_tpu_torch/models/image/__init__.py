"""Image models of the port: the ResNet family and the classification
zoo (Inception-v1, VGG-16/19, the MobileNets, SqueezeNet, DenseNet-121,
``ImageClassifier``) and SSD detection (``SSD``, ``ObjectDetector`` and
the anchor, target, decoding, NMS and multibox-loss functions)."""

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
from zoo_tpu_torch.models.image.objectdetection import (
    SSD,
    ObjectDetector,
    decode_boxes,
    encode_targets,
    generate_anchors,
    iou_matrix,
    multibox_loss,
    nms,
)
from zoo_tpu_torch.models.image.resnet import ResNet, resnet18, resnet50


__all__ = ["ResNet", "resnet18", "resnet50", "SSD", "ObjectDetector",
           "generate_anchors", "decode_boxes", "nms", "encode_targets",
           "multibox_loss",
           "ImageClassifier", "LabelOutput", "create_image_classifier",
           "image_classification_preprocess", "inception_v1", "vgg16",
           "vgg19", "mobilenet_v1", "mobilenet_v2", "squeezenet",
           "densenet121"]
