"""Image models of the port: the ResNet family. The other
classifiers of ``zoo_tpu/models/image`` (``imageclassification.py``)
and the detectors are not ported yet."""

from zoo_tpu_torch.models.image.resnet import ResNet, resnet18, resnet50

__all__ = ["ResNet", "resnet18", "resnet50"]
