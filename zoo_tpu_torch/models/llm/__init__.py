"""Decoder-only language models of the port."""

from zoo_tpu_torch.models.llm.llama import (
    Llama,
    LlamaConfig,
    llama3_8b_config,
    llama_param_count,
    tiny_llama_config,
)

__all__ = ["Llama", "LlamaConfig", "llama3_8b_config", "llama_param_count",
           "tiny_llama_config"]
