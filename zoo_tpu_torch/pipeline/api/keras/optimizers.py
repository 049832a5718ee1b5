"""Optimizers with keras-1 names (counterpart of
``zoo_tpu/pipeline/api/keras/optimizers.py``).

:class:`SGD`, :class:`Adam`, :class:`AdamWeightDecay`, :class:`RMSprop`,
:class:`Adagrad`, :class:`Adadelta`, :class:`Adamax` and :class:`LARS`,
each with keras-1 ``decay`` (inverse time, where the JAX class takes
it) and ``learningrate_schedule=`` (a schedule of
``zoo_tpu_torch.orca.learn.optimizers.schedule``, a ``count -> lr``
callable over device tensors, or a :class:`Plateau`). Each updates the
parameter tensors IN PLACE with optax 0.2.6's arithmetic and rounding
order in f32.

Every count is a 0-dim int32 tensor on the parameters' device, as optax
keeps it, and so is every scalar derived from it (a bias correction, a
scheduled or decayed rate): a step never reads one back to the host.
AdamW's state is ``{"m", "v", "step"}`` (``step``: the 1-based step of
the last update), SGD's ``{"momentum", "count"}``, Adam's and Adamax's
``{"mu", "nu", "count"}``, RMSprop's ``{"nu", "count"}``, Adagrad's
``{"sum_of_squares", "count"}``, Adadelta's ``{"e_g", "e_x", "count"}``
and LARS's ``{"trace", "count"}`` (``count``: updates applied). Under a
:class:`Plateau` the state also holds ``"lr"``, the 0-dim f32 device
rate the fit loop rewrites between epochs.

``apply(grads, state, trainable, ok=None)`` takes the training guard's
0-dim bool device predicate: where it is false, every parameter and
every leaf of the state (the count included) comes back bit-unchanged
(the JAX step's ``lax.cond`` identity branch). AdamW and SGD go leaf by
leaf through a hand-written kernel on a CUDA device
(``ops/kernels/fused_optim.py``), which reads the step, the rate and
``ok`` from device memory, or through the kernel's plain version; the
others are plain PyTorch on every device, as the optax transforms are
plain XLA in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.ops.kernels.fused_optim import (
    device_beta_powers,
    fused_apply_adam,
    fused_apply_sgd,
    reference_apply_adam,
)
from zoo_tpu_torch.orca.learn.optimizers.schedule import (
    Plateau,
    Scheduler,
    WarmupCosineDecay,
)
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    model_file_part,
    tree_leaves,
    tree_map,
)

# a compiled model pickles its optimizer and, with it, its schedule
model_file_part(Scheduler)

_F32 = torch.float32
Rate = Union[float, torch.Tensor]


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """A contiguous f32 zero state tensor shaped like ``p``."""
    return torch.zeros_like(p, dtype=_F32,
                            memory_format=torch.contiguous_format)


def _full_f32(value: float):
    return lambda p: torch.full_like(p, value, dtype=_F32,
                                     memory_format=torch.contiguous_format)


def _device_of(trainable) -> torch.device:
    leaves = tree_leaves(trainable)
    return leaves[0].device if leaves else torch.device("cpu")


def _count(dev: torch.device) -> torch.Tensor:
    """A fresh 0-dim int32 count on ``dev`` (a fill, not a host copy)."""
    return torch.zeros((), dtype=torch.int32, device=dev)


def _advance(count: torch.Tensor, ok: Optional[torch.Tensor]
             ) -> torch.Tensor:
    """``count + 1``, or ``count`` where the guard skipped the step."""
    nxt = count + 1
    return nxt if ok is None else torch.where(ok, nxt, count)


def _commit(dsts: Sequence[torch.Tensor], news: Sequence[torch.Tensor],
            ok: Optional[torch.Tensor]) -> None:
    """Write each new value into its tensor; where ``ok`` is false the
    tensors keep their bits (one ``where`` into the tensor itself)."""
    for d, n in zip(dsts, news):
        if ok is None:
            d.copy_(n)
        else:
            torch.where(ok, n, d, out=d)


@model_file_part
class Optimizer:
    """Base optimizer: ``init(trainable) -> state`` and ``apply(grads,
    state, trainable, ok=None) -> (trainable, state)``, updating
    ``trainable`` in place.

    The learning rate of an update is :meth:`rate`: the constant ``lr``
    (a Python float, a launch argument of the kernels), keras-1's
    inverse-time ``decay`` of it, a schedule's value at the count, or
    the state's ``"lr"`` under a :class:`Plateau` (``plateau`` is then
    the controller the fit loop drives)."""

    #: True when the update runs the fused kernel on CUDA leaves
    fused = False

    def __init__(self, name: str, lr: float = 0.001, decay: float = 0.0,
                 learningrate_schedule=None):
        self.name = name
        self.lr, self.decay = float(lr), float(decay)
        self.schedule = None
        self.plateau: Optional[Plateau] = None
        if isinstance(learningrate_schedule, Plateau):
            self.plateau = learningrate_schedule.bind(self.lr)
        elif learningrate_schedule is not None:
            if not (isinstance(learningrate_schedule, Scheduler)
                    or callable(learningrate_schedule)):
                raise TypeError("learningrate_schedule: a Scheduler or a "
                                "count -> lr callable, got "
                                f"{type(learningrate_schedule).__name__}")
            self.schedule = learningrate_schedule

    def _state(self, dev: torch.device, **trees) -> Dict:
        state = dict(trees, count=_count(dev))
        if self.plateau is not None:
            state["lr"] = torch.full((), self.lr, dtype=_F32, device=dev)
        return state

    def rate(self, state: Dict, count: torch.Tensor) -> Rate:
        """The learning rate of the update after ``count`` updates (0-dim
        int32 device tensor): a Python float when it is constant, else a
        0-dim f32 tensor on the count's device."""
        if self.plateau is not None:
            return state["lr"]
        if self.schedule is not None:
            fn = self.schedule.get_scheduler(self.lr) \
                if isinstance(self.schedule, Scheduler) else self.schedule
            return fn(count)
        if self.decay:
            return self.lr / (1.0 + self.decay * count.to(_F32))
        return self.lr

    def _next(self, state: Dict, count: torch.Tensor,
              ok: Optional[torch.Tensor]) -> Dict:
        out = dict(state)
        out["count"] = _advance(count, ok)
        return out

    def init(self, trainable) -> Dict:
        raise NotImplementedError

    def apply(self, grads, state, trainable,
              ok: Optional[torch.Tensor] = None) -> Tuple[Dict, Dict]:
        raise NotImplementedError


def _neg(rate: Rate) -> Rate:
    return -rate


class AdamWeightDecay(Optimizer):
    """BERT-style AdamW: decoupled weight decay, bias-corrected moments.

    ``fused=True`` applies the update with the fused AdamW kernel
    (``ops/kernels/fused_optim.py``), once per parameter leaf in tree
    order; a constant lr only (a schedule raises, as in the JAX
    package). ``fused=None`` (default) reads the ``ZOO_FUSED_OPTIM``
    knob and keeps the plain update for a scheduled config. Unfused,
    the update is the kernel's math in plain PyTorch
    (:func:`reference_apply_adam`). ``total_steps`` builds optax's
    ``warmup_cosine_decay_schedule(0, lr, max(1, int(total_steps *
    warmup_ratio)), total_steps)``."""

    def __init__(self, lr: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.01, total_steps: int = 0,
                 warmup_ratio: float = 0.1, learningrate_schedule=None,
                 fused: Optional[bool] = None):
        if learningrate_schedule is None and total_steps:
            learningrate_schedule = WarmupCosineDecay(
                0.0, max(1, int(total_steps * warmup_ratio)),
                int(total_steps))
        super().__init__("adamw", lr, 0.0, learningrate_schedule)
        if fused and learningrate_schedule is not None:
            raise ValueError("fused=True supports a constant lr only")
        if fused is None:
            fused = bool(knob_value("ZOO_FUSED_OPTIM")) and \
                learningrate_schedule is None
        self.fused = bool(fused)
        self._args = (float(beta_1), float(beta_2), float(epsilon),
                      float(weight_decay))

    def init(self, trainable) -> Dict:
        state = self._state(_device_of(trainable),
                            m=tree_map(_zeros_f32, trainable),
                            v=tree_map(_zeros_f32, trainable))
        state["step"] = state.pop("count")
        return state

    def apply(self, grads, state, trainable, ok=None):
        """One update of every leaf, in tree order, in place: through
        the kernel when ``fused``, else its plain version. Returns
        ``(trainable, state)``."""
        b1, b2, eps, wd = self._args
        lr = self.rate(state, state["step"])
        step = state["step"] + 1
        with torch.no_grad():
            for p, g, m, v in zip(tree_leaves(trainable), tree_leaves(grads),
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"])):
                if self.fused:
                    fused_apply_adam(p, g.contiguous(), m, v, step, lr, b1,
                                     b2, eps, wd, ok)
                    continue
                _commit((p, m, v), reference_apply_adam(
                    p, g, m, v, step, lr, b1, b2, eps, wd), ok)
        out = dict(state)
        out["step"] = step if ok is None else torch.where(ok, step,
                                                          state["step"])
        return trainable, out


class Adam(Optimizer):
    """``optax.adam`` with keras-1 arguments, in f32 and in optax's
    rounding order: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g**2 +
    b2 nu``, each divided by its bias correction ``1 - b**count`` (f32),
    then ``p += -lr_t * mu_hat / (sqrt(nu_hat) + eps)`` (``eps`` outside
    the root, optax's ``eps_root`` 0). Plain PyTorch on every device: no
    kernel serves ``optax.adam`` in the JAX package either."""

    def __init__(self, lr: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 decay: float = 0.0, learningrate_schedule=None):
        super().__init__("adam", lr, decay, learningrate_schedule)
        self.beta_1, self.beta_2 = float(beta_1), float(beta_2)
        self.epsilon = float(epsilon)

    def init(self, trainable) -> Dict:
        return self._state(_device_of(trainable),
                           mu=tree_map(_zeros_f32, trainable),
                           nu=tree_map(_zeros_f32, trainable))

    def apply(self, grads, state, trainable, ok=None):
        """One update of every leaf, in place. Returns ``(trainable,
        state)``. Unguarded, each step is one multi-tensor op over all
        the leaves (``torch._foreach_*``), elementwise as optax's
        arithmetic; under the guard the same ops write new tensors,
        folded in with ``ok``."""
        f32 = np.float32
        b1, b2 = f32(self.beta_1), f32(self.beta_2)
        # python scalars, each exactly the f32 value optax multiplies by
        c1, c2 = float(f32(1.0 - self.beta_1)), float(f32(1.0 - self.beta_2))
        count = state["count"]
        lr = self.rate(state, count)
        bc1, bc2 = (1 - p for p in device_beta_powers(count + 1, b1, b2))
        ps, mus, nus = (tree_leaves(x) for x in (trainable, state["mu"],
                                                 state["nu"]))
        with torch.no_grad():
            gs = [g.float() for g in tree_leaves(grads)]
            if ok is None:
                torch._foreach_mul_(mus, float(b1))
                torch._foreach_add_(mus, torch._foreach_mul(gs, c1))
                torch._foreach_mul_(nus, float(b2))
                torch._foreach_add_(nus, torch._foreach_mul(
                    torch._foreach_mul(gs, gs), c2))
                new_mu, new_nu = mus, nus
            else:
                new_mu = torch._foreach_add(torch._foreach_mul(
                    mus, float(b1)), torch._foreach_mul(gs, c1))
                new_nu = torch._foreach_add(torch._foreach_mul(
                    nus, float(b2)), torch._foreach_mul(
                        torch._foreach_mul(gs, gs), c2))
            den = torch._foreach_div(new_nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.epsilon)
            upd = torch._foreach_div(new_mu, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, _neg(lr))
            if ok is None:
                torch._foreach_add_(ps, upd)
            else:
                _commit(ps, torch._foreach_add(ps, upd), ok)
                _commit(mus, new_mu, ok)
                _commit(nus, new_nu, ok)
        return trainable, self._next(state, count, ok)


class SGD(Optimizer):
    """``optax.sgd`` with keras-1 arguments: ``buf = momentum * buf +
    g``, then ``p -= lr_t * buf`` (with ``nesterov``, ``p -= lr_t * (g +
    momentum * buf)``), in f32, no weight decay. ``decay`` is keras-1's
    inverse-time decay, ``lr_t = lr / (1 + decay * count)`` in f32 with
    optax's 0-based count of updates applied; ``lr_t`` is a device
    scalar of the update when it is not constant.

    Without ``nesterov`` the update is :func:`fused_apply_sgd`: the
    hand-written kernel on CUDA leaves, one launch per leaf, and its
    plain version on CPU leaves (``fused`` is True). With ``nesterov``
    it is plain PyTorch on every device (``fused`` is False): the kernel
    has no Nesterov form."""

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 decay: float = 0.0, nesterov: bool = False,
                 learningrate_schedule=None):
        super().__init__("sgd", lr, decay, learningrate_schedule)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.fused = not self.nesterov

    def init(self, trainable) -> Dict:
        return self._state(_device_of(trainable),
                           momentum=tree_map(_zeros_f32, trainable))

    def apply(self, grads, state, trainable, ok=None):
        """One update of every leaf, in tree order, in place. Returns
        ``(trainable, state)``."""
        count = state["count"]
        lr = self.rate(state, count)
        mu = self.momentum
        with torch.no_grad():
            for p, g, buf in zip(tree_leaves(trainable), tree_leaves(grads),
                                 tree_leaves(state["momentum"])):
                if self.fused:
                    # autograd may hand back a permuted (strided) gradient
                    fused_apply_sgd(p, g.contiguous(), buf, lr, mu, 0.0, ok)
                    continue
                g = g.float()
                new_buf = g + mu * buf
                _commit((buf, p), (new_buf,
                                   p - (g + mu * new_buf) * lr), ok)
        return trainable, self._next(state, count, ok)


class RMSprop(Optimizer):
    """``optax.rmsprop(lr, decay=rho, eps=epsilon)``: ``nu = (1 - rho)
    g**2 + rho nu``, ``p += -lr_t * rsqrt(nu + eps) * g``, in f32.
    Plain PyTorch on every device."""

    def __init__(self, lr: float = 0.001, rho: float = 0.9,
                 epsilon: float = 1e-8, decay: float = 0.0,
                 learningrate_schedule=None):
        super().__init__("rmsprop", lr, decay, learningrate_schedule)
        self.rho, self.epsilon = float(rho), float(epsilon)

    def init(self, trainable) -> Dict:
        return self._state(_device_of(trainable),
                           nu=tree_map(_zeros_f32, trainable))

    def apply(self, grads, state, trainable, ok=None):
        count = state["count"]
        neg = _neg(self.rate(state, count))
        rho = self.rho
        with torch.no_grad():
            for p, g, nu in zip(tree_leaves(trainable), tree_leaves(grads),
                                tree_leaves(state["nu"])):
                g = g.float()
                new_nu = (1 - rho) * (g * g) + rho * nu
                upd = torch.rsqrt(new_nu + self.epsilon) * g
                _commit((nu, p), (new_nu, p + neg * upd), ok)
        return trainable, self._next(state, count, ok)


class Adagrad(Optimizer):
    """``optax.adagrad(lr, eps=epsilon)`` (initial accumulator 0.1):
    ``s = g**2 + s``, ``p += -lr_t * where(s > 0, rsqrt(s + eps), 0) *
    g``, in f32. Plain PyTorch on every device."""

    def __init__(self, lr: float = 0.01, epsilon: float = 1e-8,
                 decay: float = 0.0, learningrate_schedule=None):
        super().__init__("adagrad", lr, decay, learningrate_schedule)
        self.epsilon = float(epsilon)

    def init(self, trainable) -> Dict:
        return self._state(_device_of(trainable),
                           sum_of_squares=tree_map(_full_f32(0.1),
                                                   trainable))

    def apply(self, grads, state, trainable, ok=None):
        count = state["count"]
        neg = _neg(self.rate(state, count))
        with torch.no_grad():
            for p, g, s in zip(tree_leaves(trainable), tree_leaves(grads),
                               tree_leaves(state["sum_of_squares"])):
                g = g.float()
                new_s = g * g + s
                inv = torch.where(new_s > 0, torch.rsqrt(new_s + self.epsilon),
                                  torch.zeros((), dtype=_F32,
                                              device=g.device))
                _commit((s, p), (new_s, p + neg * (inv * g)), ok)
        return trainable, self._next(state, count, ok)


class Adadelta(Optimizer):
    """``optax.adadelta(lr, rho, eps)``: its ``add_decayed_weights(0)``
    (``u = g + 0 p``), ``e_g = (1 - rho) u**2 + rho e_g``, ``d =
    sqrt(e_x + eps) / sqrt(e_g + eps) * u``, ``e_x = (1 - rho) d**2 +
    rho e_x``, ``p += -lr_t * d``, in f32. Plain PyTorch on every
    device."""

    def __init__(self, lr: float = 1.0, rho: float = 0.95,
                 epsilon: float = 1e-8, decay: float = 0.0,
                 learningrate_schedule=None):
        super().__init__("adadelta", lr, decay, learningrate_schedule)
        self.rho, self.epsilon = float(rho), float(epsilon)

    def init(self, trainable) -> Dict:
        return self._state(_device_of(trainable),
                           e_g=tree_map(_zeros_f32, trainable),
                           e_x=tree_map(_zeros_f32, trainable))

    def apply(self, grads, state, trainable, ok=None):
        count = state["count"]
        neg = _neg(self.rate(state, count))
        rho, eps = self.rho, self.epsilon
        with torch.no_grad():
            for p, g, e_g, e_x in zip(
                    tree_leaves(trainable), tree_leaves(grads),
                    tree_leaves(state["e_g"]), tree_leaves(state["e_x"])):
                u = g.float() + 0.0 * p
                new_eg = (1 - rho) * (u * u) + rho * e_g
                d = (torch.sqrt(e_x + eps) / torch.sqrt(new_eg + eps)) * u
                new_ex = (1 - rho) * (d * d) + rho * e_x
                _commit((e_g, e_x, p), (new_eg, new_ex, p + neg * d), ok)
        return trainable, self._next(state, count, ok)


class Adamax(Optimizer):
    """``optax.adamax(lr, b1, b2, eps)``: ``mu = (1 - b1) g + b1 mu``,
    ``nu = max(|g| + eps, b2 nu)``, ``p += -lr_t * (mu / (1 -
    b1**count)) / nu``, in f32. Plain PyTorch on every device."""

    def __init__(self, lr: float = 0.002, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 decay: float = 0.0, learningrate_schedule=None):
        super().__init__("adamax", lr, decay, learningrate_schedule)
        self.beta_1, self.beta_2 = float(beta_1), float(beta_2)
        self.epsilon = float(epsilon)

    def init(self, trainable) -> Dict:
        return self._state(_device_of(trainable),
                           mu=tree_map(_zeros_f32, trainable),
                           nu=tree_map(_zeros_f32, trainable))

    def apply(self, grads, state, trainable, ok=None):
        count = state["count"]
        neg = _neg(self.rate(state, count))
        b1, b2 = self.beta_1, self.beta_2
        bc1 = 1 - device_beta_powers(count + 1, b1)[0]
        with torch.no_grad():
            for p, g, mu, nu in zip(tree_leaves(trainable), tree_leaves(grads),
                                    tree_leaves(state["mu"]),
                                    tree_leaves(state["nu"])):
                g = g.float()
                new_mu = (1 - b1) * g + b1 * mu
                new_nu = torch.maximum(g.abs() + self.epsilon, b2 * nu)
                upd = (new_mu / bc1) / new_nu
                _commit((mu, nu, p), (new_mu, new_nu, p + neg * upd), ok)
        return trainable, self._next(state, count, ok)


class LARS(Optimizer):
    """``optax.lars(lr, weight_decay, trust_coefficient, momentum)``:
    ``u = g + wd p``, scaled per leaf by the trust ratio ``tc ||p|| /
    ||u||`` (1 where either norm is 0), then ``u = -lr_t u``, then the
    momentum trace ``t = u + momentum t``, ``p += t``, in f32. Plain
    PyTorch on every device."""

    def __init__(self, lr: float = 0.1, momentum: float = 0.9,
                 weight_decay: float = 1e-4, trust_coefficient: float = 0.001,
                 learningrate_schedule=None):
        super().__init__("lars", lr, 0.0, learningrate_schedule)
        self.momentum, self.weight_decay = float(momentum), float(weight_decay)
        self.trust_coefficient = float(trust_coefficient)

    def init(self, trainable) -> Dict:
        return self._state(_device_of(trainable),
                           trace=tree_map(_zeros_f32, trainable))

    def apply(self, grads, state, trainable, ok=None):
        count = state["count"]
        neg = _neg(self.rate(state, count))
        with torch.no_grad():
            for p, g, tr in zip(tree_leaves(trainable), tree_leaves(grads),
                                tree_leaves(state["trace"])):
                u = g.float() + self.weight_decay * p
                pn = torch.linalg.vector_norm(p)
                un = torch.linalg.vector_norm(u)
                ratio = self.trust_coefficient * pn / (un + 0.0)
                ratio = torch.where((pn == 0.0) | (un == 0.0),
                                    torch.ones((), dtype=_F32,
                                               device=p.device), ratio)
                u = neg * (u * ratio)
                new_tr = u + self.momentum * tr
                _commit((tr, p), (new_tr, p + new_tr), ok)
        return trainable, self._next(state, count, ok)


_ALIASES = {"sgd": SGD, "adam": Adam, "adamw": AdamWeightDecay,
            "rmsprop": RMSprop, "adagrad": Adagrad, "adadelta": Adadelta,
            "adamax": Adamax, "lars": LARS}


def get_optimizer(identifier) -> Optimizer:
    if isinstance(identifier, Optimizer):
        return identifier
    key = str(identifier).lower()
    if key not in _ALIASES:
        raise ValueError(f"unknown optimizer: {identifier}")
    return _ALIASES[key]()


def state_to_device(state, dev: torch.device) -> Optional[Dict]:
    """An optimizer state read back from a checkpoint (host numpy, as
    ``orca.learn.ckpt`` writes it) with every array leaf as a tensor on
    ``dev`` (0-dim counts keep int32, moments f32); None stays None."""
    if state is None:
        return None
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)
                    if isinstance(a, (np.ndarray, np.generic)) else a, state)
