"""Paged flash-decode: single-query attention through a block table.

Counterpart of ``zoo_tpu/ops/pallas/paged_decode.py``. The kernel is
``zoo_tpu_torch/csrc/paged_decode.cu`` (its header says what bounds it
and how it is laid out): one launch per call, the split-KV merge inside
it. This module holds its wrapper, its launch plan
(:func:`decode_plan`), the plain PyTorch version the kernel is held
against, and :func:`merge_splits`, the plain model of the kernel's
merge of its partial softmaxes.

The plain version is the dense gather of
``PagedLlamaModel._masked_gather_attention`` (``zoo_tpu/serving/llm/
model.py:686``): materialise ``cache[block_table]``, widen it to f32,
mask each row to its live length, softmax in f32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
LAUNCHES = 0
_fn = None

# the kernel's envelope and fixed shape (csrc/paged_decode.cu): block
# size, head dim and query heads a kv head; warps a CTA, ring slots a
# warp, CTAs a cluster (the portable cluster size); a chunk of K (or V)
# rows is at most CHUNK_BYTES
MAX_BLOCK_SIZE, MAX_HEAD_DIM, MAX_GROUP = 32, 128, 16
WARPS, RING_STAGES, MAX_CLUSTER = 4, 2, 8
CHUNK_BYTES = 4096


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


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Launch plan of the paged-decode kernel: ``ctas`` CTAs (a cluster)
    per (slot, kv head), ``warps`` warps a CTA, ``stages`` ring slots a
    warp, ``chunk_rows`` cache rows a slot holds of K and of V,
    ``copy_bytes`` a ``cp.async`` copy (0: an element copy), ``smem``
    bytes of dynamic shared memory, ``blocks`` CTAs in the grid."""
    ctas: int
    warps: int
    stages: int
    chunk_rows: int
    copy_bytes: int
    smem: int
    blocks: int


def _round16(v: int) -> int:
    return -(-v // 16) * 16


@functools.lru_cache(maxsize=256)
def decode_plan(S: int, n_kv: int, G: int, D: int, bs: int, W: int,
                itemsize: int, splits: Optional[int] = None,
                align: int = 16) -> DecodePlan:
    """The kernel's plan for ``S`` slots, ``n_kv`` kv heads of ``G``
    query heads, head dim ``D``, a table of ``W`` blocks of ``bs`` rows,
    cache elements of ``itemsize`` bytes (4 f32, 2 bf16, 1 int8), cache
    pointers aligned to ``align`` bytes.

    - CTAs: the split count (``splits``, else ``ZOO_LLM_DECODE_SPLITS``,
      resolved as the JAX package resolves it, :func:`resolve_num_splits`)
      CTAs per (slot, kv head), at most 8: they form one cluster, which
      merges its partials in distributed shared memory. The CTAs divide
      the slot's live rows, not the table, whatever the count.
    - Chunks: a ring slot holds ``chunk_rows`` rows of one cache block
      of K and of V, at most 4 KB each (8 rows at D=128 f32, 16 bf16,
      the whole 16-row block int8), so two slots for each of 4 warps
      leave room for three CTAs an SM.
    - Copies: 16 bytes where a row and the pointers allow, else 8 or 4;
      an element copy for rows that are not whole 4-byte units.
    - Shared memory, as the kernel lays it out: the warps' rings (rows
      padded to 16 bytes, then for int8 the K and V row scales), which
      the partials (acc, m and l of every warp, then the CTA's merged m
      and l, f32) overwrite at the end, then each warp's p buffer
      (chunk_rows x 4 or 16 heads, f32).
    """
    if not (1 <= bs <= MAX_BLOCK_SIZE and 1 <= D <= MAX_HEAD_DIM
            and 1 <= G <= MAX_GROUP):
        raise ValueError(f"paged decode kernel takes block_size <= "
                         f"{MAX_BLOCK_SIZE}, head_dim <= {MAX_HEAD_DIM} and "
                         f"<= {MAX_GROUP} query heads per kv head (got {bs}, "
                         f"{D}, {G})")
    if min(S, n_kv, W) < 1:
        raise ValueError("empty paged decode")
    ctas = min(resolve_num_splits(W, splits), MAX_CLUSTER)
    row = D * itemsize
    chunk_rows = max(1, min(bs, CHUNK_BYTES // row))
    copy_bytes = L.copy_bytes(row, align)
    slot = _round16(2 * chunk_rows * _round16(row)
                    + (8 * chunk_rows if itemsize == 1 else 0))
    ring = WARPS * RING_STAGES * slot
    partials = (WARPS * G * (D + 2) + 2 * G) * 4
    heads = 4 if G <= 4 else 16
    smem = _round16(max(ring, partials)) + WARPS * chunk_rows * heads * 4
    return DecodePlan(ctas, WARPS, RING_STAGES, chunk_rows, copy_bytes,
                      smem, S * n_kv * ctas)


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
        fn.argtypes = [L.P] * 8 + [L.I] * 6 + [L.F] + [L.I] * 8 + [L.P]
        fn.restype = L.I
        _fn = (lib, fn)
    return _fn


def merge_splits(acc: torch.Tensor, m: torch.Tensor,
                 l: torch.Tensor) -> torch.Tensor:
    """The plain model of the kernel's merge (the JAX split-KV
    epilogue): log-sum-exp merge of partial softmaxes ``acc``
    (..., parts, G, D) with ``m``/``l`` (..., parts, G) in part order ->
    (..., G, D). Dead parts carry m=-inf, l=0 and drop out; l_tot = 0
    divides by 1."""
    m_max = m.amax(dim=-2, keepdim=True)
    m_safe = torch.where(torch.isfinite(m_max), m_max,
                         torch.zeros_like(m_max))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                        torch.zeros_like(m))
    l_tot = (alpha * l).sum(dim=-2)
    o = (alpha[..., None] * acc).sum(dim=-3)
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
    dtype. ``num_splits`` (default ``ZOO_LLM_DECODE_SPLITS``) sets the
    CTAs per (slot, kv head), at most 8 (:func:`decode_plan`).

    CPU tensors take :func:`paged_decode_plain`; CUDA tensors launch
    the kernel, once (or raise)."""
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
    plan = decode_plan(S, n_kv, G, D, bs, W, k_cache.element_size(),
                       resolve_num_splits(W, num_splits),
                       L.alignment(k_cache, v_cache))
    out = torch.empty_like(q)
    lib, fn = _entry()
    rc = fn(L.ptr(q), L.ptr(k_cache), L.ptr(v_cache), L.ptr(k_scale),
            L.ptr(v_scale), L.ptr(block_tables), L.ptr(positions),
            L.ptr(out), S, n_kv, G, D, bs, W, float(scale),
            L.DTYPE_CODES[q.dtype], L.DTYPE_CODES[k_cache.dtype],
            plan.ctas, plan.warps, plan.stages, plan.chunk_rows,
            plan.copy_bytes, plan.smem, L.stream(dev))
    L.check(lib, rc, "paged_decode")
    LAUNCHES += 1
    return out
