"""Paged flash-prefill: a chunk of query rows through a block table.

Counterpart of ``zoo_tpu/ops/pallas/paged_prefill.py``. The kernel is
``zoo_tpu_torch/csrc/paged_prefill.cu``; this module holds its wrapper
and the plain PyTorch version: the dense gather of
``_prefill_attend`` (``zoo_tpu/serving/llm/model.py:670-684``), each row
masked to the columns at or before its own position.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from zoo_tpu_torch.ops.kernels import _launch as L
from zoo_tpu_torch.ops.kernels.paged_decode import (
    masked_gather_attention,
    widen_gather,
)

# kernel launches since the last reset (see ops.kernels.launch_counts)
LAUNCHES = 0
_fn = None


def paged_prefill_plain(q, k_cache, v_cache, block_tables, positions, *,
                        k_scale=None, v_scale=None, scale=None):
    """The plain PyTorch version of :func:`paged_flash_prefill`."""
    B, R, H, D = q.shape
    n_kv = k_cache.shape[2]
    ctx = block_tables.shape[1] * k_cache.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kv = (B, ctx, n_kv, D)
    keys = widen_gather(k_cache, k_scale, block_tables).reshape(kv)
    vals = widen_gather(v_cache, v_scale, block_tables).reshape(kv)
    keys = keys[:, None].expand((B, R) + kv[1:]).reshape((B * R,) + kv[1:])
    vals = vals[:, None].expand((B, R) + kv[1:]).reshape((B * R,) + kv[1:])
    live = torch.arange(ctx, device=q.device)[None, :] <= \
        positions.reshape(-1).long()[:, None]
    out = masked_gather_attention(q.reshape(B * R, H, D), keys, vals, live,
                                  scale)
    return out.reshape(B, R, H, D).to(q.dtype)


def _entry():
    global _fn
    if _fn is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("paged_prefill")
        fn = lib.zt_paged_prefill
        fn.argtypes = [L.P] * 8 + [L.I] * 7 + [L.F, L.I, L.I, L.P]
        fn.restype = L.I
        _fn = (lib, fn)
    return _fn


def paged_flash_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, block_tables: torch.Tensor,
                        positions: torch.Tensor, *,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Chunk-of-queries paged attention over a resident cache.

    ``q``: (S, C, H, D) f32/bf16, C query rows per sequence; caches and
    scales as in :func:`~.paged_decode.paged_flash_decode`;
    ``block_tables``: (S, W) int32; ``positions``: (S, C) int32, the
    cache index each row's token was written at (row r attends every
    column ``<= positions[s, r]``). Returns (S, C, H, D) in ``q``'s
    dtype.

    CPU tensors take :func:`paged_prefill_plain`; CUDA tensors launch
    the kernel (or raise)."""
    global LAUNCHES
    S, C, H, D = q.shape
    n_blocks, bs, n_kv, _ = k_cache.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale travel together")
    if H % n_kv:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({n_kv})")
    if tuple(positions.shape) != (S, C):
        raise ValueError(f"positions shape {tuple(positions.shape)} != "
                         f"{(S, C)}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_cache, v_cache, block_tables,
                                   positions, k_scale=k_scale,
                                   v_scale=v_scale, scale=scale)
    G = H // n_kv
    W = block_tables.shape[1]
    dev = q.device
    L.require(q, "q", dev, (torch.float32, torch.bfloat16))
    cache_types = (torch.int8,) if k_scale is not None else \
        (torch.float32, torch.bfloat16)
    L.require(k_cache, "k_cache", dev, cache_types)
    L.require(v_cache, "v_cache", dev, (k_cache.dtype,), k_cache.shape)
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            L.require(t, name, dev, (torch.float32,), (n_blocks, bs, n_kv))
    L.require(block_tables, "block_tables", dev, (torch.int32,), (S, W))
    L.require(positions, "positions", dev, (torch.int32,), (S, C))
    if bs > 32 or D > 128:
        raise ValueError(f"paged prefill kernel takes block_size <= 32 "
                         f"and head_dim <= 128 (got {bs}, {D})")
    out = torch.empty_like(q)
    lib, fn = _entry()
    rc = fn(L.ptr(q), L.ptr(k_cache), L.ptr(v_cache), L.ptr(k_scale),
            L.ptr(v_scale), L.ptr(block_tables), L.ptr(positions),
            L.ptr(out), S, C, n_kv, G, D, bs, W, float(scale),
            L.DTYPE_CODES[q.dtype], L.DTYPE_CODES[k_cache.dtype],
            L.stream(dev))
    L.check(lib, rc, "paged_prefill")
    LAUNCHES += 1
    return out
