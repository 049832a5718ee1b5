"""Scaled dot-product attention (counterpart of ``zoo_tpu/ops/attention.py``).

Layout (batch, heads, seq, head_dim) throughout, as in the JAX package.
The dense path here is the plain PyTorch version of the flash-attention
kernel (:mod:`zoo_tpu_torch.ops.kernels.flash_attention`): f32 softmax
island, end-aligned causal triangle, GQA by broadcasting kv heads.
Float32 products run in full f32: the port leaves
``torch.backends.cuda.matmul.allow_tf32`` at its default, False.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(T^2) path: returns ``(out, scores)`` where ``scores`` are
    the masked f32 logits (masked entries hold the f32 minimum)."""
    if k.shape[1] != q.shape[1]:   # GQA: broadcast the kv heads
        if q.shape[1] % k.shape[1]:
            raise ValueError(f"q heads ({q.shape[1]}) must be a multiple "
                             f"of kv heads ({k.shape[1]})")
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # QK^T in the input dtype, softmax in an f32 island, then back to
    # the input dtype for the PV product (as the JAX dense path)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    neg = torch.finfo(torch.float32).min
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((tq, tk), dtype=torch.bool,
                         device=q.device).tril(diagonal=tk - tq)
        scores = scores.masked_fill(~tri, neg)
    if mask is not None:
        scores = scores.masked_fill(~mask, neg)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v), scores


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over (B, H, T, D) tensors.

    ``mask``: optional boolean mask broadcastable to (B, H, Tq, Tk)
    (True = attend). ``impl``: ``"dense"``, ``"flash"`` (the CUDA
    kernel; CUDA tensors only, causal or none masking), or ``"auto"``
    (:func:`~zoo_tpu_torch.models.llm.llama.resolve_attention_impl`).
    GQA: ``k``/``v`` may carry fewer heads than ``q``."""
    flash_ok = mask is None
    if impl == "auto":
        from zoo_tpu_torch.models.llm.llama import resolve_attention_impl
        impl = resolve_attention_impl("auto", q.shape[-2], q.device) \
            if flash_ok else "dense"
    if impl == "flash":
        if not flash_ok:
            raise ValueError("flash attention supports causal masking only "
                             "(no arbitrary mask); use impl='dense'")
        if q.device.type != "cuda":
            raise ValueError("impl='flash' runs the CUDA kernel and needs "
                             "CUDA tensors; CPU tensors take impl='dense'")
        from zoo_tpu_torch.ops.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(dense / flash / auto)")
    return dense_attention(q, k, v, mask, causal, scale)[0]
