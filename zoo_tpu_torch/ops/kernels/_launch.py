"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

# dtype codes of zt_common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float


def require(tensor: Optional[torch.Tensor], name: str,
            device: torch.device, dtypes: Sequence[torch.dtype],
            shape: Optional[tuple] = None) -> None:
    """Raise unless ``tensor`` is a contiguous tensor on ``device`` with
    one of ``dtypes`` (and ``shape``, where given)."""
    if tensor is None:
        raise ValueError(f"{name} is required")
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if tensor.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {tensor.dtype}; the kernel "
                        f"takes {', '.join(map(str, dtypes))}")
    if shape is not None and tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(tensor.shape)}, "
                         f"expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two, at most 16, dividing every data
    pointer (the widest copy the kernels may make of them)."""
    a = 16
    for t in tensors:
        while t.data_ptr() % a:
            a //= 2
    return a


def copy_bytes(row_bytes: int, align: int) -> int:
    """The widest ``cp.async`` copy (16, 8 or 4 bytes) that divides a
    row of ``row_bytes`` and a pointer aligned to ``align``; 0 when none
    does (the kernels then copy element by element)."""
    return next((c for c in (16, 8, 4)
                 if row_bytes % c == 0 and align % c == 0), 0)


def ptr(tensor: Optional[torch.Tensor]):
    return None if tensor is None else tensor.data_ptr()


def stream(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = lib.zt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
