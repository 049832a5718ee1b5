"""Optimizers with keras-1 names (counterpart of
``zoo_tpu/pipeline/api/keras/optimizers.py``).

Ported: :class:`AdamWeightDecay`, the optimizer of the Llama and BERT
training configs, :class:`SGD`, that of the ResNet-50 one, and
:class:`Adam`, that of the NCF flagship. Each updates the parameter
tensors IN PLACE. AdamW and SGD go leaf by leaf in tree order through a
hand-written kernel on a CUDA device (``ops/kernels/fused_optim.py``)
or through the kernel's plain PyTorch version, which repeats optax's
arithmetic; Adam is plain PyTorch on every device, as ``optax.adam``
is plain XLA in the JAX package. AdamW's state is ``{"m": tree, "v":
tree, "step": int}`` (f32 moments shaped like the parameters, the
1-based step of the last update); Adam's is ``{"mu": tree, "nu": tree,
"count": int}`` (optax's names, its count of updates applied); SGD's is
``{"momentum": tree, "count": int}`` (the f32 momentum buffers, optax's
0-based count of updates applied). The other optimizers and the orca
learning-rate schedulers are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.ops.kernels.fused_optim import (
    fused_apply_adam,
    fused_apply_sgd,
    reference_apply_adam,
)
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    model_file_part,
    tree_leaves,
    tree_map,
)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """A contiguous f32 zero state tensor shaped like ``p``."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


@model_file_part
class Optimizer:
    """Base optimizer: ``init(trainable) -> state`` and ``apply(grads,
    state, trainable) -> (trainable, state)``, updating ``trainable`` in
    place."""

    def __init__(self, name: str):
        self.name = name

    def init(self, trainable) -> Dict:
        raise NotImplementedError

    def apply(self, grads, state, trainable) -> Tuple[Dict, Dict]:
        raise NotImplementedError


class AdamWeightDecay(Optimizer):
    """BERT-style AdamW: decoupled weight decay, bias-corrected moments.

    ``fused=True`` applies the update with the fused AdamW kernel
    (``ops/kernels/fused_optim.py``), once per parameter leaf in tree
    order; constant lr only. ``fused=None`` (default) reads the
    ``ZOO_FUSED_OPTIM`` knob. Unfused, the update is the same math in
    plain PyTorch (:func:`reference_apply_adam`)."""

    def __init__(self, lr: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.01, total_steps: int = 0,
                 warmup_ratio: float = 0.1, learningrate_schedule=None,
                 fused: Optional[bool] = None):
        super().__init__("adamw")
        scheduled = learningrate_schedule is not None or bool(total_steps)
        if fused and scheduled:
            raise ValueError("fused=True supports a constant lr only")
        if scheduled:
            raise NotImplementedError(
                "learning-rate schedules (total_steps, "
                "learningrate_schedule) are not ported to zoo_tpu_torch yet")
        if fused is None:
            fused = bool(knob_value("ZOO_FUSED_OPTIM"))
        self.fused = bool(fused)
        self._args = (float(lr), float(beta_1), float(beta_2),
                      float(epsilon), float(weight_decay))

    def init(self, trainable) -> Dict:
        return {"m": tree_map(_zeros_f32, trainable),
                "v": tree_map(_zeros_f32, trainable), "step": 0}

    def apply(self, grads, state, trainable):
        """One update of every leaf, in tree order, in place: through
        the kernel when ``fused``, else its plain version. Returns
        ``(trainable, state)``."""
        lr, b1, b2, eps, wd = self._args
        step = state["step"] + 1
        with torch.no_grad():
            for p, g, m, v in zip(tree_leaves(trainable), tree_leaves(grads),
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"])):
                if self.fused:
                    fused_apply_adam(p, g.contiguous(), m, v, step, lr, b1,
                                     b2, eps, wd)
                    continue
                for dst, src in zip((p, m, v), reference_apply_adam(
                        p, g, m, v, step, lr, b1, b2, eps, wd)):
                    dst.copy_(src)
        return trainable, {"m": state["m"], "v": state["v"], "step": step}


def _inverse_time(lr: float, decay: float, count: int) -> float:
    """keras-1's ``decay``: ``lr / (1 + decay * count)`` in f32, as the
    optax schedule computes it from its 0-based count."""
    if not decay:
        return lr
    one = np.float32(1.0)
    return float(np.float32(lr) / (
        one + np.float32(decay) * np.float32(count)))


class Adam(Optimizer):
    """``optax.adam`` with keras-1 arguments, in f32 and in optax's
    rounding order: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g**2 +
    b2 nu``, each divided by its bias correction ``1 - b**count``
    (f32), then ``p += -lr_t * mu_hat / (sqrt(nu_hat) + eps)`` (``eps``
    outside the root, optax's ``eps_root`` 0). ``decay`` is keras-1's
    inverse-time decay, as :class:`SGD` takes it. Plain PyTorch on every
    device: no kernel serves ``optax.adam`` in the JAX package either."""

    def __init__(self, lr: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 decay: float = 0.0, learningrate_schedule=None):
        super().__init__("adam")
        if learningrate_schedule is not None:
            raise NotImplementedError(
                "learningrate_schedule: the orca learning-rate schedulers "
                "are not ported to zoo_tpu_torch yet (ROADMAP A.11)")
        self.lr, self.decay = float(lr), float(decay)
        self.beta_1, self.beta_2 = float(beta_1), float(beta_2)
        self.epsilon = float(epsilon)

    def init(self, trainable) -> Dict:
        return {"mu": tree_map(_zeros_f32, trainable),
                "nu": tree_map(_zeros_f32, trainable), "count": 0}

    def apply(self, grads, state, trainable):
        """One update of every leaf, in place. Returns ``(trainable,
        state)``. Each step is one multi-tensor op over all the leaves
        (``torch._foreach_*``), elementwise as optax's arithmetic."""
        f32 = np.float32
        b1, b2 = f32(self.beta_1), f32(self.beta_2)
        # python scalars, each exactly the f32 value optax multiplies by
        c1, c2 = float(f32(1.0 - self.beta_1)), float(f32(1.0 - self.beta_2))
        count = state["count"] + 1
        bc1 = float(f32(1.0) - b1 ** f32(count))
        bc2 = float(f32(1.0) - b2 ** f32(count))
        step = -_inverse_time(self.lr, self.decay, state["count"])
        ps, mus, nus = (tree_leaves(t) for t in (trainable, state["mu"],
                                                 state["nu"]))
        with torch.no_grad():
            gs = [g.float() for g in tree_leaves(grads)]
            torch._foreach_mul_(mus, float(b1))
            torch._foreach_add_(mus, torch._foreach_mul(gs, c1))
            torch._foreach_mul_(nus, float(b2))
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(gs, gs), c2))
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.epsilon)
            upd = torch._foreach_div(mus, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, step)
            torch._foreach_add_(ps, upd)
        return trainable, {"mu": state["mu"], "nu": state["nu"],
                           "count": count}


class SGD(Optimizer):
    """``optax.sgd`` with keras-1 arguments: ``buf = momentum * buf +
    g``, then ``p -= lr_t * buf`` (with ``nesterov``, ``p -= lr_t * (g +
    momentum * buf)``), in f32, no weight decay. ``decay`` is keras-1's
    inverse-time decay, ``lr_t = lr / (1 + decay * count)`` in f32 with
    optax's 0-based count of updates applied; ``lr_t`` is a runtime
    scalar of the update.

    Without ``nesterov`` the update is :func:`fused_apply_sgd`: the
    hand-written kernel on CUDA leaves, one launch per leaf, and its
    plain version on CPU leaves (``fused`` is True). With ``nesterov``
    it is plain PyTorch on every device (``fused`` is False): the kernel
    has no Nesterov form."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 decay: float = 0.0, nesterov: bool = False,
                 learningrate_schedule=None):
        super().__init__("sgd")
        if learningrate_schedule is not None:
            raise NotImplementedError(
                "learningrate_schedule: the orca learning-rate schedulers "
                "are not ported to zoo_tpu_torch yet")
        self.lr, self.momentum = float(lr), float(momentum)
        self.decay, self.nesterov = float(decay), bool(nesterov)
        self.fused = not self.nesterov

    def learning_rate(self, count: int) -> float:
        """``lr_t`` after ``count`` updates, in f32 as optax's schedule
        computes it."""
        return _inverse_time(self.lr, self.decay, count)

    def init(self, trainable) -> Dict:
        return {"momentum": tree_map(_zeros_f32, trainable), "count": 0}

    def apply(self, grads, state, trainable):
        """One update of every leaf, in tree order, in place. Returns
        ``(trainable, state)``."""
        lr = self.learning_rate(state["count"])
        mu = self.momentum
        with torch.no_grad():
            for p, g, buf in zip(tree_leaves(trainable), tree_leaves(grads),
                                 tree_leaves(state["momentum"])):
                if self.fused:
                    # autograd may hand back a permuted (strided) gradient
                    fused_apply_sgd(p, g.contiguous(), buf, lr, mu)
                    continue
                g = g.float()
                buf.mul_(mu).add_(g)
                p.sub_((g + mu * buf) * lr)
        return trainable, {"momentum": state["momentum"],
                           "count": state["count"] + 1}


_ALIASES = {"adam": Adam, "adamw": AdamWeightDecay, "sgd": SGD}
_NOT_PORTED = ("rmsprop", "adagrad", "adadelta", "adamax", "lars")


def get_optimizer(identifier) -> Optimizer:
    if isinstance(identifier, Optimizer):
        return identifier
    key = str(identifier).lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {identifier!r} is not ported to zoo_tpu_torch yet "
            "(Adam / 'adam', AdamWeightDecay / 'adamw' and SGD / 'sgd' "
            "are)")
    if key not in _ALIASES:
        raise ValueError(f"unknown optimizer: {identifier}")
    return _ALIASES[key]()
