"""PyTorch/CUDA port of ``zoo_tpu`` for one NVIDIA Hopper card.

The JAX package beside this one is the reference; module paths mirror
it (``zoo_tpu.serving.llm.model`` -> ``zoo_tpu_torch.serving.llm.model``)
so each counterpart is easy to find. This package imports ``torch`` and
numpy only — never ``jax`` and never a ``zoo_tpu`` module.

What is ported so far is the LLM serving path: ``LLMEngine`` over a
paged-KV ``PagedLlamaModel``, whose attention runs three CUDA C++
kernels written for ``sm_90a`` (``zoo_tpu_torch/csrc``): paged decode,
paged prefill and flash-attention forward. Each kernel has a plain
PyTorch version beside it in :mod:`zoo_tpu_torch.ops.kernels`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit device they raise.
"""
