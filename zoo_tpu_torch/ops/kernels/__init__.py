"""Hand-written Hopper kernels (counterpart of ``zoo_tpu/ops/pallas``).

Each kernel is CUDA C++ for ``sm_90a`` under ``zoo_tpu_torch/csrc``,
built by ``nvcc`` at first use (:mod:`._build`) and bound with
``ctypes``. Its Python wrapper sits in a module of its own together
with the kernel's plain PyTorch version:

- :mod:`.conv` — implicit-GEMM NHWC convolution, float and int8
  (replaces ``_conv_kernel`` and ``_conv_kernel_q`` of
  ``zoo_tpu/ops/pallas/conv.py``), and the conv dispatch point;
- :mod:`.dropout` — inverted dropout on JAX's threefry bits and the
  key derivations of the training loop's key chain (no Pallas
  counterpart: the JAX package's masks are ``jax.random.bernoulli``
  under ``jnp.where``, fused by XLA);
- :mod:`.flash_attention` — blockwise flash attention, the forward and
  the two backward kernels (dK/dV, dQ) behind an autograd function
  (replaces ``_fwd_kernel``, ``_dkdv_kernel`` and ``_dq_kernel`` of
  ``zoo_tpu/ops/pallas/flash_attention.py``);
- :mod:`.fused_block` — the whole ResNet identity bottleneck in one
  kernel, differentiable through a recompute backward (replaces
  ``_kernel`` of ``zoo_tpu/ops/pallas/fused_block.py``);
- :mod:`.fused_optim` — AdamW and SGD updates in one in-place pass
  (replaces ``_adam_kernel`` and ``_sgd_kernel`` of
  ``zoo_tpu/ops/pallas/fused_optim.py``);
- :mod:`.paged_decode` — single-query attention through a block table
  (replaces ``zoo_tpu/ops/pallas/paged_decode.py``);
- :mod:`.paged_prefill` — a chunk of query rows through a block table
  (replaces ``zoo_tpu/ops/pallas/paged_prefill.py``);
- :mod:`.quant` — int8 GEMMs with the dequant fused, on quantized
  activations or quantizing float ones inside the kernel (replaces
  ``_qmm_kernel`` and ``_fqmm_kernel`` of ``zoo_tpu/ops/pallas/quant.py``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel or raises — it never falls back. Every launch
adds one to the wrapper's count (:func:`launch_counts`), so a run can
show which kernels its main path went through. An op that falls back
to a composition outside its kernel's envelope counts that dispatch
too (:data:`DISPATCHES`), apart from the kernels.

Nothing here imports a compiler or builds anything at import time.
"""

from __future__ import annotations

from typing import Dict

import torch

# kernel -> (module of ops.kernels, its launch-count attribute)
_COUNTERS = {
    "conv2d": ("conv", "LAUNCHES"),
    "conv2d_int8": ("conv", "INT8_LAUNCHES"),
    "dropout": ("dropout", "LAUNCHES"),
    "derive_keys": ("dropout", "KEY_LAUNCHES"),
    "flash_attention": ("flash_attention", "LAUNCHES"),
    "flash_attention_dkdv": ("flash_attention", "DKDV_LAUNCHES"),
    "flash_attention_dq": ("flash_attention", "DQ_LAUNCHES"),
    "fused_bottleneck": ("fused_block", "LAUNCHES"),
    "fused_adam": ("fused_optim", "ADAM_LAUNCHES"),
    "fused_sgd": ("fused_optim", "SGD_LAUNCHES"),
    "paged_decode": ("paged_decode", "LAUNCHES"),
    "paged_prefill": ("paged_prefill", "LAUNCHES"),
    "quantized_matmul": ("quant", "QMM_LAUNCHES"),
    "fused_quantized_matmul": ("quant", "FQMM_LAUNCHES"),
}
KERNELS = tuple(_COUNTERS)
# op -> (module, attribute) of the count of its composition fallbacks
DISPATCHES = {
    "fused_bottleneck_reference": ("fused_block", "REFERENCE_DISPATCHES"),
}


def on_cuda(device=None) -> bool:
    """True when ``device`` (default: the current CUDA device, if any)
    is a CUDA device. ``auto`` dispatch picks the kernels there on any
    card: off Hopper they fail to build or launch and raise, never
    falling back to the plain versions."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def on_hopper(device=None) -> bool:
    """True when ``device`` (default: the current CUDA device) is a
    Hopper card, compute capability (9, 0) — the only target the
    kernels are built for."""
    if not on_cuda(device) or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)


def _module(name: str):
    import importlib
    return importlib.import_module(f"zoo_tpu_torch.ops.kernels.{name}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches (and composition fallbacks, :data:`DISPATCHES`)
    since the last :func:`reset_launch_counts`."""
    return {k: getattr(_module(mod), attr)
            for k, (mod, attr) in {**_COUNTERS, **DISPATCHES}.items()}


def reset_launch_counts() -> None:
    for mod, attr in (*_COUNTERS.values(), *DISPATCHES.values()):
        setattr(_module(mod), attr, 0)
