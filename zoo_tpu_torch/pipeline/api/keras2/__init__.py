"""Keras-2-style API (counterpart of ``zoo_tpu/pipeline/api/keras2``;
reference: ``pyzoo/zoo/pipeline/api/keras2``): the Keras-2 argument
names (``units``, ``filters``, ``kernel_size``, ``strides``,
``padding``, ``use_bias``, ``kernel_initializer``) translated onto the
port's Keras-1 layers: one engine, two façades.
"""

from zoo_tpu_torch.pipeline.api.keras.engine.topology import (  # noqa: F401
    Input,
    Model,
    Sequential,
)
from zoo_tpu_torch.pipeline.api.keras2 import layers  # noqa: F401

__all__ = ["Input", "Model", "Sequential", "layers"]
