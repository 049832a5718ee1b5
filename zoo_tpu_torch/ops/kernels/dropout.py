"""Inverted dropout on JAX's threefry bits, and the key derivations of
the training loop's key chain (the kernels of
``zoo_tpu_torch/csrc/dropout.cu``; no Pallas kernel is their
counterpart: the JAX package's masks are ``jax.random.bernoulli`` and
``jnp.where``, fused by XLA).

:func:`dropout` ``(x, key, p)`` is ``where(bernoulli(key, 1 - p, shape),
x / (1 - p), 0)`` in ``x``'s dtype (f32 or bf16), bit for bit
:func:`dropout_plain`, which composes it from :mod:`zoo_tpu_torch.ops.
random`. ``mask_shape`` broadcasts one mask element over a run of axes
(the spatial dropouts). Its gradient is a ``torch.autograd.Function``
whose backward draws the same mask again from the saved key: no mask
is stored. :func:`split` and :func:`fold_in` derive keys on the key's
device (one launch of a tiny kernel on the card), so the key chain
never visits the host.

On CPU tensors the wrappers run the plain versions; on CUDA tensors
they launch their kernel or raise, never falling back.
:func:`resolve_dropout_impl` names the one that runs and :data:`LAST_IMPL`
records it.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from zoo_tpu_torch.ops import random as R
from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
LAUNCHES = 0
KEY_LAUNCHES = 0
#: the implementation the last dropout call ran ("cuda" or "plain")
LAST_IMPL: Optional[str] = None
_fns = None


def _entries():
    global _fns
    if _fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("dropout")
        drop, keys = lib.zt_dropout, lib.zt_derive_keys
        drop.argtypes = [L.P, L.P, L.LL, L.LL, L.LL, L.P, L.F, L.F, L.I, L.P]
        keys.argtypes = [L.P, L.P, L.I, L.LL, L.P]
        drop.restype = keys.restype = L.I
        _fns = (lib, drop, keys)
    return _fns


def resolve_dropout_impl(device) -> str:
    """``"cuda"`` (the kernel) for a CUDA device, ``"plain"`` for the
    CPU; any other device raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "plain"
    raise ValueError(f"dropout has no implementation on {kind}")


def _check_key(key: torch.Tensor, device: torch.device) -> None:
    L.require(key, "key", device, (torch.int64,), (2,))


# ------------------------------------------------------------- key chain

def derive_keys(key: torch.Tensor, n: int, first: int = 0) -> torch.Tensor:
    """(n, 2) keys on ``key``'s device: key ``i`` is both words of
    threefry(key, (0, first + i)); its plain version is
    :func:`zoo_tpu_torch.ops.random.derive`, on any device."""
    global KEY_LAUNCHES
    if resolve_dropout_impl(key.device) == "plain":
        return R.derive(key, n, first)
    _check_key(key, key.device)
    out = torch.empty((n, 2), dtype=torch.int64, device=key.device)
    lib, _, keys = _entries()
    rc = keys(L.ptr(key), L.ptr(out), int(n), int(first) & R.M32,
              L.stream(key.device))
    L.check(lib, rc, "derive_keys")
    KEY_LAUNCHES += 1
    return out


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` on ``key``'s device: (num, 2)."""
    return derive_keys(key, num, 0)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` on ``key``'s device."""
    return derive_keys(key, 1, int(data) & R.M32)[0]


# ---------------------------------------------------------------- dropout

def _spans(shape: Tuple[int, ...], mask_shape: Optional[Sequence[int]]
           ) -> Tuple[int, int]:
    """``(inner, c)`` of the kernel: the elements of the one run of axes
    the mask broadcasts over, and those after it (``(1, numel)`` for a
    mask of ``shape``)."""
    n = math.prod(shape)
    if mask_shape is None or tuple(mask_shape) == tuple(shape):
        return 1, max(n, 1)
    mask_shape = tuple(mask_shape)
    if len(mask_shape) != len(shape) or any(
            m not in (1, s) for m, s in zip(mask_shape, shape)):
        raise ValueError(f"mask shape {mask_shape} does not broadcast to "
                         f"{tuple(shape)}")
    run = [i for i, (m, s) in enumerate(zip(mask_shape, shape))
           if m == 1 and s != 1]
    if run != list(range(run[0], run[-1] + 1)):
        raise ValueError(f"mask shape {mask_shape}: the kernel broadcasts "
                         "over one run of adjacent axes")
    return (math.prod(shape[run[0]:run[-1] + 1]),
            max(math.prod(shape[run[-1] + 1:]), 1))


@functools.lru_cache(maxsize=None)
def _keep_divisor(p: float, dtype: torch.dtype) -> Tuple[float, float]:
    """float32(1 - p), the mask's threshold, and 1 - p rounded to
    ``dtype``, the divisor (JAX divides by the weak float in the
    tensor's dtype)."""
    keep = 1.0 - float(p)
    return (float(torch.tensor(keep, dtype=torch.float32)),
            float(torch.tensor(keep, dtype=dtype)))


def dropout_plain(x: torch.Tensor, key: torch.Tensor, p: float,
                  mask_shape: Optional[Sequence[int]] = None
                  ) -> torch.Tensor:
    """The kernel's plain version, composed from :mod:`..random` on
    ``x``'s device: the mask of ``mask_shape`` (default ``x``'s),
    broadcast to ``x``; the quotient in f32, rounded to ``x``'s dtype;
    differentiable by autograd to the same gradient."""
    keep, div = _keep_divisor(p, x.dtype)
    mask = R.bernoulli(key, keep,
                       x.shape if mask_shape is None else mask_shape)
    # a 0-dim device tensor, not a Python scalar: PyTorch's CUDA
    # division by a scalar multiplies by its reciprocal, an ulp off the
    # quotient in f32
    scaled = (x.float() / torch.full((), div, device=x.device)).to(x.dtype)
    return torch.where(mask, scaled, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def _launch(x: torch.Tensor, key: torch.Tensor, keep: float, div: float,
            inner: int, c: int) -> torch.Tensor:
    global LAUNCHES
    L.require(x, "x", x.device, (torch.float32, torch.bfloat16))
    _check_key(key, x.device)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib, drop, _ = _entries()
    rc = drop(L.ptr(x), L.ptr(y), x.numel(), inner, c, L.ptr(key), keep,
              div, L.DTYPE_CODES[x.dtype], L.stream(x.device))
    L.check(lib, rc, "dropout")
    LAUNCHES += 1
    return y


class _Dropout(torch.autograd.Function):
    """The kernel forward; the backward is the same kernel on the
    gradient, the mask drawn again from the saved key."""

    @staticmethod
    def forward(ctx, x, key, keep, div, inner, c):
        ctx.save_for_backward(key)
        ctx.args = (keep, div, inner, c)
        return _launch(x.contiguous(), key, keep, div, inner, c)

    @staticmethod
    def backward(ctx, g):
        (key,) = ctx.saved_tensors
        return (_launch(g.contiguous(), key, *ctx.args), None, None, None,
                None, None)


def dropout(x: torch.Tensor, key: torch.Tensor, p: float,
            mask_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Inverted dropout of rate ``p`` with JAX's mask for ``key`` (a
    (2,) int64 key on ``x``'s device): the identity for ``p <= 0``, the
    kernel on a CUDA tensor, :func:`dropout_plain` on a CPU one."""
    global LAST_IMPL
    if p <= 0.0:
        return x
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout rate {p} is not in [0, 1)")
    LAST_IMPL = resolve_dropout_impl(x.device)
    if LAST_IMPL == "plain":
        return dropout_plain(x, key, p, mask_shape)
    inner, c = _spans(tuple(x.shape), mask_shape)
    keep, div = _keep_divisor(p, x.dtype)
    return _Dropout.apply(x, key, keep, div, inner, c)
