"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on the current CUDA
device unless the caller names another one. With no card and no
explicit device it raises: the port never carries on quietly on the
CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); any
    other value -> ``torch.device(value)``, checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev
