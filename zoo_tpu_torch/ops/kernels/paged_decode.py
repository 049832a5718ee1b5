"""Paged flash-decode: single-query attention through a block table.

Counterpart of ``zoo_tpu/ops/pallas/paged_decode.py``. The kernel is
``zoo_tpu_torch/csrc/paged_decode.cu`` (its header says what bounds it
and how it is laid out); this module holds its wrapper, the split-KV
merge, and the plain PyTorch version the kernel is held against.

The plain version is the dense gather of
``PagedLlamaModel._masked_gather_attention`` (``zoo_tpu/serving/llm/
model.py:686``): materialise ``cache[block_table]``, widen it to f32,
mask each row to its live length, softmax in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
LAUNCHES = 0
_fn = None


def resolve_num_splits(table_width: int,
                       requested: Optional[int] = None) -> int:
    """Largest divisor of ``table_width`` not exceeding the request
    (``ZOO_LLM_DECODE_SPLITS``, default 4): splits tile the table
    exactly so every block walks the same number of entries."""
    if requested is None:
        requested = int(knob_value("ZOO_LLM_DECODE_SPLITS"))
    requested = max(1, min(int(requested), table_width))
    for d in range(requested, 0, -1):
        if table_width % d == 0:
            return d
    return 1


# ------------------------------------------------------------ plain version

def widen_gather(cache: torch.Tensor, scale: Optional[torch.Tensor],
                 idx: torch.Tensor) -> torch.Tensor:
    """Cache blocks gathered by table ``idx``, widened to f32 (int8 rows
    times their scales; bf16/f32 a plain cast)."""
    g = cache[idx.long()].float()
    if scale is not None:
        g = g * scale[idx.long()][..., None]
    return g


def masked_gather_attention(q: torch.Tensor, keys: torch.Tensor,
                            vals: torch.Tensor, live: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """``q`` (R, H, D) rows against gathered ``keys``/``vals``
    (R, ctx, n_kv, D) under a (R, ctx) liveness mask — GQA grouped, f32
    scores. Returns (R, H * D) in the dtype of ``vals``."""
    R, H, D = q.shape
    n_kv = keys.shape[2]
    qg = q.reshape(R, n_kv, H // n_kv, D)
    s = torch.einsum("rkgd,rtkd->rkgt", qg.to(keys.dtype), keys).float() \
        * scale
    s = torch.where(live[:, None, None, :], s,
                    torch.finfo(torch.float32).min)
    probs = torch.softmax(s, dim=-1).to(vals.dtype)
    return torch.einsum("rkgt,rtkd->rkgd", probs, vals).reshape(R, H * D)


def paged_decode_plain(q, k_cache, v_cache, block_tables, positions, *,
                       k_scale=None, v_scale=None, scale=None):
    """The plain PyTorch version of :func:`paged_flash_decode`."""
    S, H, D = q.shape
    n_kv = k_cache.shape[2]
    ctx = block_tables.shape[1] * k_cache.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    live = torch.arange(ctx, device=q.device)[None, :] <= \
        positions.long()[:, None]
    keys = widen_gather(k_cache, k_scale, block_tables).reshape(
        S, ctx, n_kv, D)
    vals = widen_gather(v_cache, v_scale, block_tables).reshape(
        S, ctx, n_kv, D)
    out = masked_gather_attention(q, keys, vals, live, scale)
    return out.reshape(S, H, D).to(q.dtype)


# ------------------------------------------------------------------- kernel

def _entry():
    global _fn
    if _fn is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("paged_decode")
        fn = lib.zt_paged_decode
        fn.argtypes = [L.P] * 10 + [L.I] * 7 + [L.F, L.I, L.I, L.P]
        fn.restype = L.I
        _fn = (lib, fn)
    return _fn


def merge_splits(acc: torch.Tensor, m: torch.Tensor,
                 l: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp merge of the per-split partials: ``acc``
    (S, n_kv, splits, G, D), ``m``/``l`` (S, n_kv, splits, G) ->
    (S, n_kv, G, D). Dead splits carry m=-inf, l=0 and drop out."""
    m_max = m.amax(dim=2, keepdim=True)
    m_safe = torch.where(torch.isfinite(m_max), m_max,
                         torch.zeros_like(m_max))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                        torch.zeros_like(m))
    l_tot = (alpha * l).sum(dim=2)
    o = (alpha[..., None] * acc).sum(dim=2)
    return o / torch.where(l_tot == 0, torch.ones_like(l_tot),
                           l_tot)[..., None]


def paged_flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, block_tables: torch.Tensor,
                       positions: torch.Tensor, *,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None,
                       num_splits: Optional[int] = None) -> torch.Tensor:
    """Single-query paged attention for one decode tick.

    ``q``: (S, H, D) f32/bf16, one query per slot; ``k_cache``/
    ``v_cache``: (num_blocks, block_size, H_kv, D) f32, bf16 or int8;
    ``block_tables``: (S, W) int32; ``positions``: (S,) int32, the cache
    index of the slot's newest token (tokens ``0..position`` are
    attended). An int8 cache passes ``k_scale``/``v_scale``
    (num_blocks, block_size, H_kv) f32. Returns (S, H, D) in ``q``'s
    dtype.

    CPU tensors take :func:`paged_decode_plain`; CUDA tensors launch
    the kernel (or raise)."""
    global LAUNCHES
    S, H, D = q.shape
    n_blocks, bs, n_kv, _ = k_cache.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale travel together")
    if H % n_kv:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({n_kv})")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_cache, v_cache, block_tables,
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
    L.require(positions, "positions", dev, (torch.int32,), (S,))
    if bs > 32 or D > 128 or G > 16:
        raise ValueError(f"paged decode kernel takes block_size <= 32, "
                         f"head_dim <= 128 and <= 16 query heads per kv "
                         f"head (got {bs}, {D}, {G})")
    splits = resolve_num_splits(W, num_splits)
    acc = torch.empty((S, n_kv, splits, G, D), device=dev,
                      dtype=torch.float32)
    m = torch.empty((S, n_kv, splits, G), device=dev, dtype=torch.float32)
    l = torch.empty_like(m)
    lib, fn = _entry()
    rc = fn(L.ptr(q), L.ptr(k_cache), L.ptr(v_cache), L.ptr(k_scale),
            L.ptr(v_scale), L.ptr(block_tables), L.ptr(positions),
            L.ptr(acc), L.ptr(m), L.ptr(l), S, n_kv, G, D, bs, W, splits,
            float(scale), L.DTYPE_CODES[q.dtype],
            L.DTYPE_CODES[k_cache.dtype], L.stream(dev))
    L.check(lib, rc, "paged_decode")
    LAUNCHES += 1
    return merge_splits(acc, m, l).to(q.dtype).reshape(S, H, D)
