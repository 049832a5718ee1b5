"""Flash attention, forward and backward (counterpart of
``zoo_tpu/ops/pallas/flash_attention.py``).

The kernels are ``zoo_tpu_torch/csrc/flash_attention_fwd.cu`` (forward,
returning the logsumexp) and ``zoo_tpu_torch/csrc/flash_attention_bwd.cu``
(dK/dV, then dQ, recomputed from that logsumexp); their headers say what
bounds them and how they are laid out. This module holds the wrappers,
the plain versions and :class:`FlashAttention`, the autograd function
that makes :func:`flash_attention` differentiable, as the JAX package's
``custom_vjp`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
LAUNCHES = 0          # forward
DKDV_LAUNCHES = 0     # backward, dK/dV
DQ_LAUNCHES = 0       # backward, dQ
_fn = None
_bwd_fns = None

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


def _bwd_entries():
    global _bwd_fns
    if _bwd_fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("flash_attention_bwd")
        dkdv, dq = lib.zt_flash_bwd_dkdv, lib.zt_flash_bwd_dq
        dkdv.argtypes = [L.P] * 8 + [L.I] * 6 + [L.F, L.I, L.I, L.P]
        dq.argtypes = [L.P] * 7 + [L.I] * 6 + [L.F, L.I, L.I, L.P]
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
    end-aligned (column <= row + Tk - Tq).

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
    lib, fn = _entry()
    rc = fn(L.ptr(q), L.ptr(k), L.ptr(v), L.ptr(o), L.ptr(lse), B, H, Hkv,
            Tq, Tk, D, float(scale), int(bool(causal)),
            L.DTYPE_CODES[q.dtype], L.stream(dev))
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
    launch the dK/dV kernel, then the dQ kernel (or raise)."""
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
    lib, dkdv_fn, dq_fn = _bwd_entries()
    args = (B, H, Hkv, Tq, Tk, D, float(scale), int(bool(causal)),
            L.DTYPE_CODES[q.dtype], L.stream(dev))
    ins = (L.ptr(q), L.ptr(k), L.ptr(v), L.ptr(do), L.ptr(lse),
           L.ptr(delta))
    L.check(lib, dkdv_fn(*ins, L.ptr(dk), L.ptr(dv), *args),
            "flash_attention dK/dV")
    DKDV_LAUNCHES += 1
    L.check(lib, dq_fn(*ins, L.ptr(dq), *args), "flash_attention dQ")
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
