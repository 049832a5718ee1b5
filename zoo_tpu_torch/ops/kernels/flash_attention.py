"""Flash attention, forward and backward (counterpart of
``zoo_tpu/ops/pallas/flash_attention.py``).

The kernels are ``zoo_tpu_torch/csrc/flash_attention_fwd.cu`` (forward,
returning the logsumexp: bf16 on the tensor cores with the plan
:func:`flash_plan` counts, f32 on the SIMT units with the plan
:func:`flash_f32_plan` counts) and
``zoo_tpu_torch/csrc/flash_attention_bwd.cu`` (dK/dV, then dQ,
recomputed from that logsumexp: bf16 on the tensor cores with the plan
:func:`flash_bwd_plan` counts, f32 on the SIMT units with the plan
:func:`flash_bwd_f32_plan` counts); their headers say
what bounds them and how they are laid out. This module holds the wrappers,
the plain versions and :class:`FlashAttention`, the autograd function
that makes :func:`flash_attention` differentiable, as the JAX package's
``custom_vjp`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
LAUNCHES = 0          # forward
DKDV_LAUNCHES = 0     # backward, dK/dV
DQ_LAUNCHES = 0       # backward, dQ
_fn = None
_bwd_fns = None

HEAD_DIMS = (16, 32, 64, 128)


# the bf16 tensor-core kernel (csrc/flash_attention_fwd.cu, tc::): query
# rows of a block (4 warps of 16), rows of a K/V tile, slots of its ring
_TC_BQ, _TC_BKV, _TC_STAGES = 64, 64, 2
# slots of the bf16 backward kernels' rings (flash_bwd_plan)
_TC_BWD_STAGES = 2
# the f32 SIMT kernels (f32:: in csrc/flash_attention_fwd.cu and
# flash_attention_bwd.cu): query rows of a tile, rows of a K/V tile,
# warps (the forward's: 4 row groups of 16 rows x 2 key halves), slots of
# the ring; a forward warp's P buffer holds its 16 rows (+4 floats of
# padding) for each key of its half
_F32_BQ, _F32_BKV, _F32_WARPS, _F32_STAGES = 64, 64, 8, 2
_F32_P_ROW = 16 + 4


def flash_plan(head_dim: int) -> int:
    """The bf16 forward kernel's launch plan at ``head_dim``: the bytes of
    dynamic shared memory it takes, the bf16 Q tile and the K/V ring.
    The tiles are the same at every head dim: 4 warps (64 query rows),
    64-row K and V tiles, 2 stages."""
    _require_head_dim(head_dim)
    return 2 * head_dim * (_TC_BQ + 2 * _TC_STAGES * _TC_BKV)


class FlashF32Plan(NamedTuple):
    """The f32 forward kernel's launch plan: ``block_q`` query rows and
    ``block_k``-row K/V tiles, ``threads`` a block, ``stages`` ring
    slots, ``smem`` bytes of dynamic shared memory, and ``pair``: 1 when
    a block takes two q tiles, the heaviest and the lightest left
    (causal), 0 when it takes one."""
    block_q: int
    block_k: int
    threads: int
    stages: int
    smem: int
    pair: int


def flash_f32_plan(head_dim: int, causal: bool = False) -> FlashF32Plan:
    """The f32 forward kernel's plan at ``head_dim``. Shared memory, as
    the kernel lays it out: the Q tile and the ring's K and V tiles in
    rows of ``head_dim + 4`` floats (16 bytes of padding), then each
    warp's P buffer (its half of the keys x 20 floats). Causal q tiles
    are paired: block x takes q tile n-1-x, then q tile x (one tile
    where they meet), so every block walks n+1 key tiles."""
    _require_head_dim(head_dim)
    row = 4 * (head_dim + 4)
    smem = (_F32_BQ + 2 * _F32_STAGES * _F32_BKV) * row \
        + _F32_WARPS * (_F32_BKV // 2) * _F32_P_ROW * 4
    return FlashF32Plan(_F32_BQ, _F32_BKV, 32 * _F32_WARPS, _F32_STAGES,
                        smem, int(bool(causal)))


class FlashBwdPlan(NamedTuple):
    """The bf16 backward kernels' launch plan at one head dim: the rows a
    step takes (q rows in dK/dV, key rows in dQ), the slots of each
    kernel's ``cp.async`` ring, and the bytes of dynamic shared memory
    each takes."""
    step: int
    stages: int
    dkdv_smem: int
    dq_smem: int


def flash_bwd_plan(head_dim: int) -> FlashBwdPlan:
    """The bf16 backward kernels' plan at ``head_dim``. dK/dV: the 64-row
    K and V tiles, and per ring slot a Q and a dO tile of ``step`` rows
    with their f32 lse and delta. dQ: the 64-row Q and dO tiles, and per
    slot a K and a V tile of ``step`` rows. The step is 32 rows at
    D = 128, which keeps the dK/dV (dQ) accumulators in registers, and
    64 below."""
    _require_head_dim(head_dim)
    step = 32 if head_dim > 64 else 64
    row = 2 * head_dim                              # bytes of a bf16 row
    dkdv = 2 * _TC_BKV * row + _TC_BWD_STAGES * step * (2 * row + 2 * 4)
    dq = 2 * _TC_BQ * row + _TC_BWD_STAGES * 2 * step * row
    return FlashBwdPlan(step, _TC_BWD_STAGES, dkdv, dq)


class FlashBwdF32Plan(NamedTuple):
    """The f32 backward kernels' launch plan: ``block_q`` query rows and
    ``block_k`` keys a tile, ``threads`` a block, ``stages`` ring slots,
    the bytes of dynamic shared memory each kernel takes, and ``pair``:
    1 when a block takes two tiles, the heaviest and the lightest left
    (causal), 0 when it takes one. The kernels take the first three
    numbers and the bytes; they pair tiles exactly when causal."""
    block_q: int
    block_k: int
    threads: int
    stages: int
    dkdv_smem: int
    dq_smem: int
    pair: int


def flash_bwd_f32_plan(head_dim: int, causal: bool = False
                       ) -> FlashBwdF32Plan:
    """The f32 backward kernels' plan at ``head_dim``, 8 warps a block.
    Shared memory, as the kernels lay it out, in rows of ``head_dim + 4``
    floats (16 bytes of padding). dK/dV: the 64-row K and V tiles, a
    2-slot ring of a Q and a dO tile with their lse and delta, then each
    warp's P/dS buffer (64 rows x its 8 keys). dQ: the Q and dO tiles
    with their lse and delta, a 2-slot ring of a K and a V tile, then
    each warp's dS buffer (64 keys x its 8 rows). Causal tiles are
    paired: dK/dV block x takes key tile x, then key tile n-1-x; dQ block
    x takes q tile n-1-x, then q tile x (one tile where they meet)."""
    _require_head_dim(head_dim)
    tile = _F32_BQ * (head_dim + 4) * 4
    stats = 2 * _F32_BQ * 4
    buffers = _F32_WARPS * _F32_BQ * (_F32_BKV // _F32_WARPS) * 4
    dkdv = 2 * tile + _F32_STAGES * (2 * tile + stats) + buffers
    dq = 2 * tile + stats + _F32_STAGES * 2 * tile + buffers
    return FlashBwdF32Plan(_F32_BQ, _F32_BKV, 32 * _F32_WARPS, _F32_STAGES,
                           dkdv, dq, int(bool(causal)))


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
        fn.argtypes = [L.P] * 5 + [L.I] * 6 + [L.F] + [L.I] * 4 + [L.P]
        fn.restype = L.I
        _fn = (lib, fn)
    return _fn


def _bwd_entries():
    global _bwd_fns
    if _bwd_fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("flash_attention_bwd")
        dkdv, dq = lib.zt_flash_bwd_dkdv, lib.zt_flash_bwd_dq
        dkdv.argtypes = [L.P] * 8 + [L.I] * 6 + [L.F] + [L.I] * 5 + [L.P]
        dq.argtypes = [L.P] * 7 + [L.I] * 6 + [L.F] + [L.I] * 5 + [L.P]
        dkdv.restype = dq.restype = L.I
        _bwd_fns = (lib, dkdv, dq)
    return _bwd_fns


def _check_shapes(q, k):
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({Hkv})")
    return B, H, Hkv, Tq, Tk, D


def _require_head_dim(D):
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over (B, H, T, D) returning ``(o, lse)``: ``o`` in
    ``q``'s dtype, ``lse`` (B, H, Tq) f32. ``k``/``v`` may carry fewer
    heads than ``q`` (GQA, never repeated). Causal masking is
    end-aligned (column <= row + Tk - Tq). An input that is not
    16-byte aligned is copied to an aligned buffer for the kernel.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch
    the kernel (or raise)."""
    global LAUNCHES
    B, H, Hkv, Tq, Tk, D = _check_shapes(q, k)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    dev = q.device
    L.require(q, "q", dev, (torch.float32, torch.bfloat16))
    L.require(k, "k", dev, (q.dtype,), (B, Hkv, Tk, D))
    L.require(v, "v", dev, (q.dtype,), (B, Hkv, Tk, D))
    _require_head_dim(D)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), device=dev, dtype=torch.float32)
    # the kernels copy 16 bytes at a time: a view off a 16-byte boundary
    # is copied into a fresh (aligned) buffer first
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        smem, pair = flash_plan(D), 0
    else:
        plan = flash_f32_plan(D, causal)
        smem, pair = plan.smem, plan.pair
    lib, fn = _entry()
    rc = fn(L.ptr(q), L.ptr(k), L.ptr(v), L.ptr(o), L.ptr(lse), B, H, Hkv,
            Tq, Tk, D, float(scale), int(bool(causal)),
            L.DTYPE_CODES[q.dtype], smem, pair, L.stream(dev))
    L.check(lib, rc, "flash_attention")
    LAUNCHES += 1
    return o, lse


# ---------------------------------------------------------------- backward

def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32, (B, H, Tq): computed outside the kernels,
    as the JAX package's ``_bwd`` does."""
    return (do.float() * o.float()).sum(-1)


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """The backward's recomputation, grouped by kv head: p and ds as
    (B, Hkv, rep, Tq, Tk) f32. p = exp(s - lse) on live pairs (0 on
    masked pairs and on rows whose lse is -inf); ds = p (dO.v - delta)
    scale."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.float().reshape(B, Hkv, rep, Tq, D)
    dof = do.float().reshape(B, Hkv, rep, Tq, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float()) * scale
    live = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        live = live.tril(diagonal=Tk - Tq)
    lse = lse.reshape(B, Hkv, rep, Tq, 1)
    finite = torch.isfinite(lse)
    p = torch.where(live & finite,
                    torch.exp(s - torch.where(finite, lse, 0.0)), 0.0)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dof, v.float())
    ds = p * (dp - delta.reshape(B, Hkv, rep, Tq, 1)) * scale
    return qf, dof, p, ds


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and widened back, as the kernels round
    p and ds to the input type before the products that consume them."""
    return x.to(dtype).float()


def flash_attention_dkdv_plain(q, k, v, do, lse, delta, causal=False,
                               scale=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` by the explicit recomputation: the plain version of
    the dK/dV kernel. ``delta`` = rowsum(dO * O), (B, H, Tq) f32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, dof, p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", _rounded(p, q.dtype), dof)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", _rounded(ds, q.dtype), qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_plain(q, k, v, do, lse, delta, causal=False,
                             scale=None) -> torch.Tensor:
    """``dq`` by the explicit recomputation: the plain version of the dQ
    kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, _, _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", _rounded(ds, q.dtype), k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False,
                              scale=None):
    """``(dq, dk, dv)`` by the explicit recomputation from ``lse``: the
    plain PyTorch version of :func:`flash_attention_bwd`."""
    delta = _delta(o, do)
    dk, dv = flash_attention_dkdv_plain(q, k, v, do, lse, delta, causal,
                                        scale)
    return (flash_attention_dq_plain(q, k, v, do, lse, delta, causal,
                                     scale), dk, dv)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_fwd`'s ``o``
    given its cotangent ``do``, from the saved ``o`` and ``lse``. Each is
    in its input's dtype; ``dk``/``dv`` sum over the query heads of each
    kv head.

    CPU tensors take :func:`flash_attention_bwd_plain`; CUDA tensors
    launch the dK/dV kernel, then the dQ kernel (or raise): for bf16 the
    tensor-core bodies with the plan :func:`flash_bwd_plan` counts, for
    f32 the SIMT bodies with the plan :func:`flash_bwd_f32_plan` counts.
    An input off a 16-byte boundary is copied to an aligned buffer."""
    global DKDV_LAUNCHES, DQ_LAUNCHES
    B, H, Hkv, Tq, Tk, D = _check_shapes(q, k)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    dev = q.device
    L.require(q, "q", dev, (torch.float32, torch.bfloat16))
    L.require(k, "k", dev, (q.dtype,), (B, Hkv, Tk, D))
    L.require(v, "v", dev, (q.dtype,), (B, Hkv, Tk, D))
    L.require(o, "o", dev, (q.dtype,), (B, H, Tq, D))
    L.require(do, "do", dev, (q.dtype,), (B, H, Tq, D))
    L.require(lse, "lse", dev, (torch.float32,), (B, H, Tq))
    _require_head_dim(D)
    delta = _delta(o, do)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    # the kernels copy 16 bytes at a time: a view off a 16-byte boundary
    # is copied into a fresh (aligned) buffer first
    q, k, v, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v, do))
    if q.dtype == torch.bfloat16:
        p = flash_bwd_plan(D)
        dkdv_plan = (p.step, p.stages, p.dkdv_smem)
        dq_plan = (p.step, p.stages, p.dq_smem)
    else:
        # the kernels pair causal tiles themselves
        p = flash_bwd_f32_plan(D, causal)
        dkdv_plan = (p.block_q, p.stages, p.dkdv_smem)
        dq_plan = (p.block_q, p.stages, p.dq_smem)
    lib, dkdv_fn, dq_fn = _bwd_entries()
    args = (B, H, Hkv, Tq, Tk, D, float(scale), int(bool(causal)),
            L.DTYPE_CODES[q.dtype])
    ins = (L.ptr(q), L.ptr(k), L.ptr(v), L.ptr(do), L.ptr(lse),
           L.ptr(delta))
    st = L.stream(dev)
    L.check(lib, dkdv_fn(*ins, L.ptr(dk), L.ptr(dv), *args, *dkdv_plan, st),
            "flash_attention dK/dV")
    DKDV_LAUNCHES += 1
    L.check(lib, dq_fn(*ins, L.ptr(dq), *args, *dq_plan, st),
            "flash_attention dQ")
    DQ_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel saves q, k, v,
    o and lse; the backward recomputes p from lse in the two backward
    kernels (the plain versions on CPU tensors). ``apply(q, k, v,
    causal, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the cotangent arrives through the caller's transpose; the
        # kernels read rows of D contiguous elements
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention over (B, H, T, D); see
    :func:`flash_attention_fwd` and :func:`flash_attention_bwd`."""
    return FlashAttention.apply(q, k, v, causal, scale)
