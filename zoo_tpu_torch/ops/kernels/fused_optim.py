"""Fused optimizer updates (counterpart of
``zoo_tpu/ops/pallas/fused_optim.py``).

The kernels are ``zoo_tpu_torch/csrc/fused_optim.cu``; its header says
what bounds them. Unlike the JAX package, whose arrays are immutable,
the wrappers update the parameter and its optimizer state IN PLACE and
return the same tensors: one pass, 28 bytes per element for AdamW and
20 for SGD, and no second copy of any of them. Every tensor is f32 and
contiguous.

The per-step scalars are device tensors, as the training step keeps
them (so no step reads one back to the host): AdamW's 1-based ``step``
(0-dim int32) and, where the learning rate is scheduled or decayed,
``lr`` (0-dim f32; a Python float is a constant rate, a launch
argument). ``ok`` (0-dim bool, or None) is the training guard's
predicate: where it is false the update leaves every operand
bit-unchanged, the identity branch of the JAX step's ``lax.cond``. The
constant hyperparameters (betas, eps, weight decay, momentum) are
Python floats.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
ADAM_LAUNCHES = 0
SGD_LAUNCHES = 0
_fns = None

Rate = Union[float, torch.Tensor]


def _entries():
    global _fns
    if _fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("fused_optim")
        adam, sgd = lib.zt_fused_adam, lib.zt_fused_sgd
        bcs = lib.zt_adam_bias_corrections
        adam.argtypes = [L.P] * 4 + [L.LL, L.P, L.P] + [L.F] * 5 + \
            [L.P, L.I, L.P]
        sgd.argtypes = [L.P] * 3 + [L.LL, L.P] + [L.F] * 3 + [L.P, L.I, L.P]
        bcs.argtypes = [L.P, L.I, L.F, L.F, L.P, L.P]
        adam.restype = sgd.restype = bcs.restype = L.I
        _fns = (lib, adam, sgd, bcs)
    return _fns


def bias_corrections(step: int, beta1: float, beta2: float
                     ) -> Tuple[float, float]:
    """``1 / (1 - beta1**step)`` and ``1 / (1 - beta2**step)`` in f32 for
    the 1-based ``step``: the power taken in double from the f32 beta and
    rounded once (the correctly rounded f32 power), then the f32
    subtraction and division. The kernel computes the same from its
    device step, bit for bit; the JAX package's ``jnp.float32(beta) **
    step`` (XLA's f32 power) and numpy's ``powf`` land an ulp off it at
    some steps."""
    one = np.float32(1.0)
    return tuple(float(one / (one - np.float32(math.pow(
        float(np.float32(b)), float(step))))) for b in (beta1, beta2))


def device_beta_powers(step: torch.Tensor, *betas: float
                       ) -> Tuple[torch.Tensor, ...]:
    """``beta**step`` for each beta, of a 1-based device ``step`` tensor
    and on its device (f32 tensors of its shape, no host read): the
    power of :func:`bias_corrections`, taken in double from the f32 beta
    and rounded once."""
    t = step.to(torch.float64)
    # a fill on the device, not a copy from the host (no sync in a step)
    return tuple(torch.pow(torch.full(
        (), float(np.float32(b)), dtype=torch.float64, device=step.device),
        t).to(torch.float32) for b in betas)


def device_bias_corrections(step: torch.Tensor, beta1: float, beta2: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`bias_corrections` of a device ``step`` tensor, on its
    device: f32 tensors of its shape, no host read."""
    one = torch.ones((), dtype=torch.float32, device=step.device)
    return tuple(one / (one - p)
                 for p in device_beta_powers(step, beta1, beta2))


def adam_bias_corrections(steps: torch.Tensor, beta1: float, beta2: float
                          ) -> torch.Tensor:
    """The bias corrections the AdamW kernel computes for each 1-based
    step of the int32 CUDA tensor ``steps``, as an ``(n, 2)`` f32 tensor
    (its own small kernel around the same device function): what a
    check holds to :func:`bias_corrections`. Not a launch of the
    update, so not counted."""
    L.require(steps, "steps", steps.device, (torch.int32,))
    out = torch.empty((steps.numel(), 2), dtype=torch.float32,
                      device=steps.device)
    lib, _, _, bcs = _entries()
    rc = bcs(L.ptr(steps), steps.numel(), float(beta1), float(beta2),
             L.ptr(out), L.stream(steps.device))
    L.check(lib, rc, "adam_bias_corrections")
    return out


def _fold(ok: Optional[torch.Tensor], new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    return new if ok is None else torch.where(ok, new, old)


def reference_apply_adam(param, grad, m, v, step: torch.Tensor, lr: Rate,
                         beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
                         ok: Optional[torch.Tensor] = None):
    """The AdamW math of :func:`fused_apply_adam` in plain PyTorch, f32,
    returning new ``(param, m, v)`` tensors (the plain version of the
    kernel; the JAX package's ``reference_apply_adam``). ``step`` is the
    1-based device step; where ``ok`` is false the old tensors come
    back."""
    b1 = torch.tensor(beta1, dtype=torch.float32)
    b2 = torch.tensor(beta2, dtype=torch.float32)
    bc1, bc2 = device_bias_corrections(step, beta1, beta2)
    p32, g = param.float(), grad.float()
    m_new = b1 * m.float() + (1.0 - b1) * g
    v_new = b2 * v.float() + (1.0 - b2) * g * g
    update = (m_new * bc1) / (torch.sqrt(v_new * bc2) + eps) + \
        weight_decay * p32
    p_new = (p32 - lr * update).to(param.dtype)
    return (_fold(ok, p_new, param), _fold(ok, m_new, m),
            _fold(ok, v_new, v))


def reference_apply_sgd(param, grad, momentum_buf, lr: Rate, momentum=0.0,
                        weight_decay=0.0,
                        ok: Optional[torch.Tensor] = None):
    """The SGD(+momentum, +L2) math of :func:`fused_apply_sgd` in plain
    PyTorch, f32, returning new ``(param, momentum_buf)``; where ``ok``
    is false the old tensors come back."""
    g = grad.float() + weight_decay * param.float()
    buf = momentum * momentum_buf.float() + g
    p_new = (param.float() - lr * buf).to(param.dtype)
    return _fold(ok, p_new, param), _fold(ok, buf, momentum_buf)


def _check(dev, named):
    shape = named[0][1].shape
    for name, t in named:
        L.require(t, name, dev, (torch.float32,), tuple(shape))


def _scalar(t, name: str, dev, dtype) -> None:
    """Raise unless ``t`` is a 0-dim ``dtype`` tensor on ``dev``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a 0-dim {dtype} tensor on {dev} "
                        f"(the kernels read it from device memory); got "
                        f"{type(t).__name__}")
    L.require(t, name, dev, (dtype,), ())


def _rate(lr: Rate, dev) -> Tuple[Optional[int], float]:
    """(pointer of a device rate or None, the launch argument)."""
    if isinstance(lr, torch.Tensor):
        _scalar(lr, "lr", dev, torch.float32)
        return lr.data_ptr(), 0.0
    return None, float(lr)


def _aligned(*tensors) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def fused_apply_adam(param: torch.Tensor, grad: torch.Tensor,
                     m: torch.Tensor, v: torch.Tensor, step: torch.Tensor,
                     lr: Rate, beta1: float = 0.9, beta2: float = 0.999,
                     eps: float = 1e-8, weight_decay: float = 0.0,
                     ok: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step (``step``: the 1-based int32 device step) on
    ``param``, ``m`` and ``v`` IN PLACE; returns ``(param, m, v)``, the
    same tensors. Where the device predicate ``ok`` is false nothing is
    written.

    CPU tensors take :func:`reference_apply_adam` (its results copied
    into the operands); CUDA tensors launch the kernel (or raise)."""
    global ADAM_LAUNCHES
    if param.device.type == "cpu":
        with torch.no_grad():
            for dst, src in zip((param, m, v), reference_apply_adam(
                    param, grad, m, v, step, lr, beta1, beta2, eps,
                    weight_decay, ok)):
                dst.copy_(src)
        return param, m, v
    dev = param.device
    _check(dev, (("param", param), ("grad", grad), ("m", m), ("v", v)))
    _scalar(step, "step", dev, torch.int32)
    if ok is not None:
        _scalar(ok, "ok", dev, torch.bool)
    lr_ptr, lr_arg = _rate(lr, dev)
    lib, adam, _, _ = _entries()
    rc = adam(L.ptr(param), L.ptr(grad), L.ptr(m), L.ptr(v),
              param.numel(), step.data_ptr(), lr_ptr, lr_arg, float(beta1),
              float(beta2), float(eps), float(weight_decay), L.ptr(ok),
              _aligned(param, grad, m, v), L.stream(dev))
    L.check(lib, rc, "fused_adam")
    ADAM_LAUNCHES += 1
    return param, m, v


def fused_apply_sgd(param: torch.Tensor, grad: torch.Tensor,
                    momentum_buf: torch.Tensor, lr: Rate,
                    momentum: float = 0.0, weight_decay: float = 0.0,
                    ok: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD(+momentum, +L2) step on ``param`` and ``momentum_buf`` IN
    PLACE (``lr``: a Python float or a 0-dim f32 device tensor); returns
    ``(param, momentum_buf)``, the same tensors. Where the device
    predicate ``ok`` is false nothing is written.

    CPU tensors take :func:`reference_apply_sgd`; CUDA tensors launch
    the kernel (or raise)."""
    global SGD_LAUNCHES
    if param.device.type == "cpu":
        with torch.no_grad():
            for dst, src in zip((param, momentum_buf), reference_apply_sgd(
                    param, grad, momentum_buf, lr, momentum, weight_decay,
                    ok)):
                dst.copy_(src)
        return param, momentum_buf
    dev = param.device
    _check(dev, (("param", param), ("grad", grad),
                 ("momentum_buf", momentum_buf)))
    if ok is not None:
        _scalar(ok, "ok", dev, torch.bool)
    lr_ptr, lr_arg = _rate(lr, dev)
    lib, _, sgd, _ = _entries()
    rc = sgd(L.ptr(param), L.ptr(grad), L.ptr(momentum_buf), param.numel(),
             lr_ptr, lr_arg, float(momentum), float(weight_decay), L.ptr(ok),
             _aligned(param, grad, momentum_buf), L.stream(dev))
    L.check(lib, rc, "fused_sgd")
    SGD_LAUNCHES += 1
    return param, momentum_buf
