"""Decoder-only language models of the port: ``Llama`` and its
Mixture-of-Experts variant ``MoELlama``."""

from zoo_tpu_torch.models.llm.llama import (
    Llama,
    LlamaConfig,
    llama3_8b_config,
    llama_param_count,
    tiny_llama_config,
)
from zoo_tpu_torch.models.llm.moe_llama import MoELlama, place_moe_params

__all__ = ["Llama", "LlamaConfig", "llama3_8b_config", "llama_param_count",
           "tiny_llama_config", "MoELlama", "place_moe_params"]
