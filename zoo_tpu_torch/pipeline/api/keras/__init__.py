"""Keras-style API of the port (counterpart of
``zoo_tpu/pipeline/api/keras``): ``Sequential`` and the functional
``Model``/``Input`` with ``compile``/``fit``/``predict`` on one
device."""

from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
    Input,
    Model,
    Sequential,
)

__all__ = ["Input", "Model", "Sequential"]
