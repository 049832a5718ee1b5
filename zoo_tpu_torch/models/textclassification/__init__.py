"""Text classification model of the port (counterpart of
``zoo_tpu/models/textclassification``)."""

from zoo_tpu_torch.models.textclassification.text_classifier import (
    TextClassifier,
)

__all__ = ["TextClassifier"]
