"""Fused optimizer updates (counterpart of
``zoo_tpu/ops/pallas/fused_optim.py``).

The kernels are ``zoo_tpu_torch/csrc/fused_optim.cu``; its header says
what bounds them. Unlike the JAX package, whose arrays are immutable,
the wrappers update the parameter and its optimizer state IN PLACE and
return the same tensors: one pass, 28 bytes per element for AdamW and
20 for SGD, and no second copy of any of them. Every tensor is f32 and
contiguous; the scalars (learning rate, step, ...) are runtime
arguments.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
ADAM_LAUNCHES = 0
SGD_LAUNCHES = 0
_fns = None


def _entries():
    global _fns
    if _fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("fused_optim")
        adam, sgd = lib.zt_fused_adam, lib.zt_fused_sgd
        adam.argtypes = [L.P] * 4 + [L.LL] + [L.F] * 7 + [L.I, L.P]
        sgd.argtypes = [L.P] * 3 + [L.LL] + [L.F] * 3 + [L.I, L.P]
        adam.restype = sgd.restype = L.I
        _fns = (lib, adam, sgd)
    return _fns


def bias_corrections(step: int, beta1: float, beta2: float
                     ) -> Tuple[float, float]:
    """``1 / (1 - beta1**step)`` and ``1 / (1 - beta2**step)`` in f32, as
    the JAX package computes them (``jnp.float32(beta) ** step``).
    ``step`` is 1-based."""
    one, t = np.float32(1.0), np.float32(step)
    return (float(one / (one - np.float32(beta1) ** t)),
            float(one / (one - np.float32(beta2) ** t)))


def reference_apply_adam(param, grad, m, v, step, lr, beta1=0.9,
                         beta2=0.999, eps=1e-8, weight_decay=0.0):
    """The AdamW math of :func:`fused_apply_adam` in plain PyTorch, f32,
    returning new ``(param, m, v)`` tensors (the plain version of the
    kernel; the JAX package's ``reference_apply_adam``)."""
    b1, b2 = torch.tensor(beta1, dtype=torch.float32), \
        torch.tensor(beta2, dtype=torch.float32)
    bc1, bc2 = bias_corrections(step, beta1, beta2)
    p32, g = param.float(), grad.float()
    m = b1 * m.float() + (1.0 - b1) * g
    v = b2 * v.float() + (1.0 - b2) * g * g
    update = (m * bc1) / (torch.sqrt(v * bc2) + eps) + weight_decay * p32
    return (p32 - lr * update).to(param.dtype), m, v


def reference_apply_sgd(param, grad, momentum_buf, lr, momentum=0.0,
                        weight_decay=0.0):
    """The SGD(+momentum, +L2) math of :func:`fused_apply_sgd` in plain
    PyTorch, f32, returning new ``(param, momentum_buf)``."""
    g = grad.float() + weight_decay * param.float()
    buf = momentum * momentum_buf.float() + g
    return (param.float() - lr * buf).to(param.dtype), buf


def _check(dev, named):
    shape = named[0][1].shape
    for name, t in named:
        L.require(t, name, dev, (torch.float32,), tuple(shape))


def _aligned(*tensors) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def fused_apply_adam(param: torch.Tensor, grad: torch.Tensor,
                     m: torch.Tensor, v: torch.Tensor, step: int, lr,
                     beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-8, weight_decay: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step (1-based ``step``) on ``param``, ``m`` and ``v``
    IN PLACE; returns ``(param, m, v)``, the same tensors.

    CPU tensors take :func:`reference_apply_adam` (its results copied
    into the operands); CUDA tensors launch the kernel (or raise)."""
    global ADAM_LAUNCHES
    if param.device.type == "cpu":
        with torch.no_grad():
            for dst, src in zip((param, m, v), reference_apply_adam(
                    param, grad, m, v, step, lr, beta1, beta2, eps,
                    weight_decay)):
                dst.copy_(src)
        return param, m, v
    _check(param.device, (("param", param), ("grad", grad), ("m", m),
                          ("v", v)))
    bc1, bc2 = bias_corrections(step, beta1, beta2)
    lib, adam, _ = _entries()
    rc = adam(L.ptr(param), L.ptr(grad), L.ptr(m), L.ptr(v),
              param.numel(), float(lr), float(beta1), float(beta2),
              float(eps), float(weight_decay), bc1, bc2,
              _aligned(param, grad, m, v), L.stream(param.device))
    L.check(lib, rc, "fused_adam")
    ADAM_LAUNCHES += 1
    return param, m, v


def fused_apply_sgd(param: torch.Tensor, grad: torch.Tensor,
                    momentum_buf: torch.Tensor, lr, momentum: float = 0.0,
                    weight_decay: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD(+momentum, +L2) step on ``param`` and ``momentum_buf`` IN
    PLACE; returns ``(param, momentum_buf)``, the same tensors.

    CPU tensors take :func:`reference_apply_sgd`; CUDA tensors launch
    the kernel (or raise)."""
    global SGD_LAUNCHES
    if param.device.type == "cpu":
        with torch.no_grad():
            for dst, src in zip((param, momentum_buf), reference_apply_sgd(
                    param, grad, momentum_buf, lr, momentum,
                    weight_decay)):
                dst.copy_(src)
        return param, momentum_buf
    _check(param.device, (("param", param), ("grad", grad),
                          ("momentum_buf", momentum_buf)))
    lib, _, sgd = _entries()
    rc = sgd(L.ptr(param), L.ptr(grad), L.ptr(momentum_buf), param.numel(),
             float(lr), float(momentum), float(weight_decay),
             _aligned(param, grad, momentum_buf), L.stream(param.device))
    L.check(lib, rc, "fused_sgd")
    SGD_LAUNCHES += 1
    return param, momentum_buf
