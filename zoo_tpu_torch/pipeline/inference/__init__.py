"""Inference holders of the port (counterpart of
``zoo_tpu/pipeline/inference``)."""

from zoo_tpu_torch.pipeline.inference.inference_model import (
    InferenceModel,
    quantize_model,
    save_encrypted,
)

__all__ = ["InferenceModel", "quantize_model", "save_encrypted"]
