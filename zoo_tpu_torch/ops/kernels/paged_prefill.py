"""Paged flash-prefill: a chunk of query rows through a block table.

Counterpart of ``zoo_tpu/ops/pallas/paged_prefill.py``. The kernel is
``zoo_tpu_torch/csrc/paged_prefill.cu``; this module holds its wrapper
and the plain PyTorch version: the dense gather of
``_prefill_attend`` (``zoo_tpu/serving/llm/model.py:670-684``), each row
masked to the columns at or before its own position.
"""

from __future__ import annotations

import dataclasses
import functools
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

# the kernel's tile (csrc/paged_prefill.cu kRows, kKeys, kStages): query
# rows of a block, keys of a K/V tile, tiles in the ring; its largest
# head dim; the SMs of an H100 SXM, which the grid should cover
ROW_TILE, KEY_TILE, RING_STAGES, MAX_HEAD_DIM = 64, 32, 2, 128
NUM_SMS, BLOCKS_PER_SM = 132, 2
MAX_SPLITS = 8


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """Launch plan of the paged-prefill kernel: ``row_tile`` query rows a
    block, ``key_tile`` keys a K/V tile, ``splits`` blocks along the key
    axis for each row tile, ``smem`` bytes of dynamic shared memory,
    ``row_tiles`` row tiles per (sequence, kv head)."""
    row_tile: int
    key_tile: int
    splits: int
    smem: int
    row_tiles: int
    blocks: int


@functools.lru_cache(maxsize=256)
def prefill_plan(S: int, C: int, n_kv: int, G: int, D: int, block_size: int,
                 W: int, cache_itemsize: int) -> PrefillPlan:
    """The kernel's plan for ``S`` sequences of ``C`` rows, ``n_kv`` kv
    heads of ``G`` query heads, head dim ``D``, a block table of ``W``
    blocks of ``block_size`` rows, cache elements of ``cache_itemsize``
    bytes (4 f32, 2 bf16, 1 int8).

    - Rows: the C x G rows of a (sequence, kv head) in tiles of 64.
    - Splits: a block walks its key tiles one after another, so where
      the row tiles give fewer blocks than two for each of the 132 SMs,
      the key axis is split, as few times as reaches that (at most 8,
      and no more than the table has key tiles); the blocks of a row
      tile share the key tiles its rows reach and a second kernel merges
      them (8 splits, 256 blocks at the serving shape).
    - Shared memory: the f32 q tile (64 rows of D + 4 floats), the f32 p
      tile (64 x 36), a ring of two K and V tiles (32 rows of
      D * itemsize + 16 bytes) and, for int8, their f32 row scales:
      110,592 bytes at D=128 f32, so two blocks share an SM.
    """
    if D % 4 or not 4 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"paged prefill kernel takes head_dim a multiple "
                         f"of 4 up to {MAX_HEAD_DIM} (got {D})")
    if min(S, C, n_kv, G, block_size, W) < 1:
        raise ValueError("empty paged prefill")
    row_tiles = -(-C * G // ROW_TILE)
    base = S * n_kv * row_tiles
    key_tiles = -(-W * block_size // KEY_TILE)
    splits = max(1, min(-(-NUM_SMS * BLOCKS_PER_SM // base), MAX_SPLITS,
                        key_tiles))
    row = D * cache_itemsize + 16
    smem = (4 * ROW_TILE * (D + 4) + 4 * ROW_TILE * (KEY_TILE + 4)
            + RING_STAGES * 2 * KEY_TILE * row
            + (RING_STAGES * 2 * KEY_TILE * 4 if cache_itemsize == 1
               else 0))
    return PrefillPlan(ROW_TILE, KEY_TILE, splits, smem, row_tiles,
                       base * splits)


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
        fn.argtypes = [L.P] * 10 + [L.I] * 7 + [L.F] + [L.I] * 6 + [L.P]
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
    the kernel (or raise) with :func:`prefill_plan`'s tiles, and, where
    the plan splits the key axis, its merge of the splits in the same
    call (one launch counted)."""
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
    plan = prefill_plan(S, C, n_kv, G, D, bs, W, k_cache.element_size())
    # the kernel copies q rows 16 bytes and cache rows up to 16 bytes at a
    # time: an unaligned view of q reaches it as an aligned copy
    if q.data_ptr() % 16:
        q = q.clone()
    row = D * k_cache.element_size()
    align = 16 if row % 16 == 0 else 8 if row % 8 == 0 else 4
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte "
                             "boundary")
    out = torch.empty_like(q)
    part_o = part_ml = None
    if plan.splits > 1:   # the splits' partials (o; m, l), one buffer
        rows = plan.splits * S * C * H
        part = torch.empty(rows * (D + 2), dtype=torch.float32, device=dev)
        part_o, part_ml = part[:rows * D], part[rows * D:]
    lib, fn = _entry()
    rc = fn(L.ptr(q), L.ptr(k_cache), L.ptr(v_cache), L.ptr(k_scale),
            L.ptr(v_scale), L.ptr(block_tables), L.ptr(positions),
            L.ptr(out), L.ptr(part_o), L.ptr(part_ml), S, C, n_kv, G, D, bs,
            W, float(scale), L.DTYPE_CODES[q.dtype],
            L.DTYPE_CODES[k_cache.dtype], plan.row_tile, plan.key_tile,
            plan.splits, plan.smem, L.stream(dev))
    L.check(lib, rc, "paged_prefill")
    LAUNCHES += 1
    return out
