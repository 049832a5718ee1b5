"""Absmax int8 narrowing on tensors (counterpart of
``zoo_tpu/util/quantize.py``).

Same conventions as the reference:

* ``scale = absmax / 127``, an all-zero slice mapping to scale 1.0;
* narrowing is ``clip(round(x / scale), -127, 127)`` with round half to
  even (``torch.round`` rounds like ``np.rint``), so -128 never appears;
* widening is ``q.float() * scale``.
"""

from __future__ import annotations

import torch

__all__ = ["absmax_scale", "narrow_int8", "widen_int8"]


def absmax_scale(x: torch.Tensor, dim=None,
                 keepdim: bool = False) -> torch.Tensor:
    """``absmax / 127`` along ``dim`` (None = whole tensor), f32, with
    exact-zero slices mapped to 1.0."""
    a = x.float().abs()
    absmax = a.amax() if dim is None else a.amax(dim=dim, keepdim=keepdim)
    return torch.where(absmax > 0, absmax / 127.0,
                       torch.ones_like(absmax))


def narrow_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` -> int8 under ``scale`` (broadcastable)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def widen_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Invert :func:`narrow_int8`: the int8 payload times its scale."""
    return q.float() * scale
