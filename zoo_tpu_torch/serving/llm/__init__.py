"""Autoregressive LLM serving: continuous batching over a paged KV cache
(counterpart of ``zoo_tpu/serving/llm``).

* :mod:`kv_cache` — fixed-size token-block allocator with prefix sharing;
* :mod:`model` — bucket/chunk prefill and the fixed-shape decode tick,
  whose attention runs the paged CUDA kernels on a CUDA device;
* :mod:`engine` — the iteration-level scheduler;
* :mod:`spec` — ``llama:...`` and ``synthllm:...`` specs to build an
  engine.

``PagedLlamaModel`` (and with it ``torch``) loads on first access, so an
engine over the host-only ``synthllm`` stand-in never imports torch.
"""

from zoo_tpu_torch.serving.llm.engine import (
    AdmissionError,
    GenHandle,
    LLMEngine,
)
from zoo_tpu_torch.serving.llm.kv_cache import BlockAllocator
from zoo_tpu_torch.serving.llm.spec import (
    build_llm_engine,
    is_llm_spec,
    parse_llm_spec,
)

__all__ = ["AdmissionError", "BlockAllocator", "GenHandle", "LLMEngine",
           "PagedLlamaModel", "build_llm_engine", "is_llm_spec",
           "parse_llm_spec"]


def __getattr__(name):
    if name == "PagedLlamaModel":
        from zoo_tpu_torch.serving.llm.model import PagedLlamaModel
        return PagedLlamaModel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
