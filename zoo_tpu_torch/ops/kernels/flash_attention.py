"""Flash-attention forward (counterpart of the forward pass of
``zoo_tpu/ops/pallas/flash_attention.py``).

The kernel is ``zoo_tpu_torch/csrc/flash_attention_fwd.cu``; its header
says what bounds it and how it is laid out. This module holds the
wrapper and the plain version, which is the dense path of
:mod:`zoo_tpu_torch.ops.attention`. The backward kernels of the JAX
package (``_dkdv_kernel``, ``_dq_kernel``) belong to the training slice;
the forward already returns the logsumexp they recompute from.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
LAUNCHES = 0
_fn = None

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q, k, v, causal=False, scale=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` by the dense path: the plain PyTorch version of
    :func:`flash_attention_fwd`."""
    from zoo_tpu_torch.ops.attention import dense_attention
    o, scores = dense_attention(q, k, v, causal=causal, scale=scale)
    return o, torch.logsumexp(scores, dim=-1)


def _entry():
    global _fn
    if _fn is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("flash_attention")
        fn = lib.zt_flash_attention_fwd
        fn.argtypes = [L.P] * 5 + [L.I] * 6 + [L.F, L.I, L.I, L.P]
        fn.restype = L.I
        _fn = (lib, fn)
    return _fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over (B, H, T, D) returning ``(o, lse)``: ``o`` in
    ``q``'s dtype, ``lse`` (B, H, Tq) f32. ``k``/``v`` may carry fewer
    heads than ``q`` (GQA, never repeated). Causal masking is
    end-aligned (column <= row + Tk - Tq).

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch
    the kernel (or raise)."""
    global LAUNCHES
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({Hkv})")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    dev = q.device
    L.require(q, "q", dev, (torch.float32, torch.bfloat16))
    L.require(k, "k", dev, (q.dtype,), (B, Hkv, Tk, D))
    L.require(v, "v", dev, (q.dtype,), (B, Hkv, Tk, D))
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), device=dev, dtype=torch.float32)
    lib, fn = _entry()
    rc = fn(L.ptr(q), L.ptr(k), L.ptr(v), L.ptr(o), L.ptr(lse), B, H, Hkv,
            Tq, Tk, D, float(scale), int(bool(causal)),
            L.DTYPE_CODES[q.dtype], L.stream(dev))
    L.check(lib, rc, "flash_attention")
    LAUNCHES += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over (B, H, T, D); see :func:`flash_attention_fwd`."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
