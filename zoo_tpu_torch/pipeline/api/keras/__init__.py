"""Keras-style training API of the port (counterpart of
``zoo_tpu/pipeline/api/keras``): ``Sequential`` with ``compile``/``fit``
on one device. The functional ``Model`` and ``Input`` are not ported
yet."""

from zoo_tpu_torch.pipeline.api.keras.engine.topology import Sequential

__all__ = ["Sequential"]
