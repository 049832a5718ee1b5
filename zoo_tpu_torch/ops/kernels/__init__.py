"""Hand-written Hopper kernels (counterpart of ``zoo_tpu/ops/pallas``).

Each kernel is CUDA C++ for ``sm_90a`` under ``zoo_tpu_torch/csrc``,
built by ``nvcc`` at first use (:mod:`._build`) and bound with
``ctypes``. Its Python wrapper sits in a module of its own together
with the kernel's plain PyTorch version:

- :mod:`.flash_attention` — blockwise flash-attention forward
  (replaces ``_fwd_kernel`` of ``zoo_tpu/ops/pallas/flash_attention.py``);
- :mod:`.paged_decode` — single-query attention through a block table
  (replaces ``zoo_tpu/ops/pallas/paged_decode.py``);
- :mod:`.paged_prefill` — a chunk of query rows through a block table
  (replaces ``zoo_tpu/ops/pallas/paged_prefill.py``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel or raises — it never falls back. Every launch
adds one to the wrapper's count (:func:`launch_counts`), so a run can
show which kernels its main path went through.

Nothing here imports a compiler or builds anything at import time.
"""

from __future__ import annotations

from typing import Dict

import torch

KERNELS = ("flash_attention", "paged_decode", "paged_prefill")


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


def _modules():
    from zoo_tpu_torch.ops.kernels import (flash_attention, paged_decode,
                                           paged_prefill)
    return {"flash_attention": flash_attention,
            "paged_decode": paged_decode,
            "paged_prefill": paged_prefill}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: mod.LAUNCHES for name, mod in _modules().items()}


def reset_launch_counts() -> None:
    for mod in _modules().values():
        mod.LAUNCHES = 0
