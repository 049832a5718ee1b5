"""Keras models namespace (counterpart of
``zoo_tpu/pipeline/api/keras/models.py``): the engine lives in
``engine.topology``; this module is the reference's import path for it."""

from zoo_tpu_torch.pipeline.api.keras.engine.topology import (  # noqa: F401
    Input,
    KerasNet,
    Model,
    Sequential,
)

__all__ = ["Input", "KerasNet", "Model", "Sequential"]
