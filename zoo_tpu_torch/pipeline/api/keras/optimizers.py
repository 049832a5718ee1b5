"""Optimizers with keras-1 names (counterpart of
``zoo_tpu/pipeline/api/keras/optimizers.py``).

This slice ports :class:`AdamWeightDecay`, the optimizer of the Llama
training config. Its state is ``{"m": tree, "v": tree, "step": int}``
(f32 moments shaped like the parameters, the 1-based step of the last
update), and it updates the parameter tensors IN PLACE: with
``fused=True`` through the hand-written AdamW kernel, one launch per
leaf; otherwise through the kernel's plain PyTorch version, the optax
AdamW math. The other optimizers and learning-rate schedules are not
ported yet and raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.ops.kernels.fused_optim import (
    fused_apply_adam,
    reference_apply_adam,
)
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves, tree_map


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
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
        return {"m": tree_map(zeros, trainable),
                "v": tree_map(zeros, trainable), "step": 0}

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
                    fused_apply_adam(p, g, m, v, step, lr, b1, b2, eps, wd)
                    continue
                for dst, src in zip((p, m, v), reference_apply_adam(
                        p, g, m, v, step, lr, b1, b2, eps, wd)):
                    dst.copy_(src)
        return trainable, {"m": state["m"], "v": state["v"], "step": step}


_ALIASES = {"adamw": AdamWeightDecay}
_NOT_PORTED = ("sgd", "adam", "rmsprop", "adagrad", "adadelta", "adamax",
               "lars")


def get_optimizer(identifier) -> Optimizer:
    if isinstance(identifier, Optimizer):
        return identifier
    key = str(identifier).lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {identifier!r} is not ported to zoo_tpu_torch yet "
            "(AdamWeightDecay / 'adamw' is)")
    if key not in _ALIASES:
        raise ValueError(f"unknown optimizer: {identifier}")
    return _ALIASES[key]()
