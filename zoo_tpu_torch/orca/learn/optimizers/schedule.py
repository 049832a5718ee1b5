"""Learning-rate schedules (counterpart of
``zoo_tpu/orca/learn/optimizers/schedule.py``).

Default, Poly, Exponential, Step, MultiStep, Warmup, SequentialSchedule
and Plateau. Each pure schedule's ``get_scheduler(base_lr)`` returns a
``count -> lr`` callable over torch tensors: ``count`` is the
optimizer's 0-dim int32 device count of updates applied, the result a
0-dim f32 tensor on its device, computed with the f32 arithmetic the
JAX package's ``jnp`` expressions use, from device scalars only (no
tensor is copied from the host in a step). So a scheduled rate lives
on the device next to the count and the fused kernels read it from
there: no step reads a count back to the host.

``Plateau`` is the one metric-driven schedule: the fit loop runs it on
the host at each epoch end and writes the new rate into the 0-dim f32
device scalar ``"lr"`` of the optimizer state (as the JAX package
writes ``optax.inject_hyperparams``' ``learning_rate``).

Each class is a part of a model file (a compiled model pickles its
optimizer, and with it its schedule): ``pipeline.api.keras.optimizers``
registers :class:`Scheduler` as one.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

_F32 = torch.float32


def _const(value: float, count: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=_F32, device=count.device)


def _ratio(count: torch.Tensor, denom: int) -> torch.Tensor:
    """``count / denom`` as ``jnp`` divides an int32 array by an int:
    both as f32, one f32 division."""
    return count.to(_F32) / float(denom)


def _pow(base: float, exponent: torch.Tensor) -> torch.Tensor:
    """``base ** exponent`` of a Python float and an f32 tensor (the
    f32 power ``jnp`` takes of a weakly typed base)."""
    return torch.pow(_const(base, exponent), exponent)


class Scheduler:
    """Base: ``get_scheduler(base_lr)`` returns a ``count -> lr``
    callable."""

    def get_scheduler(self, base_lr: float) -> Callable:
        raise NotImplementedError


class Default(Scheduler):
    """Constant lr."""

    def get_scheduler(self, base_lr):
        return lambda step: _const(base_lr, step)


class Poly(Scheduler):
    """lr = base_lr * (1 - iter/max_iteration)^power, clamped at zero."""

    def __init__(self, power, max_iteration):
        self.power = float(power)
        self.max_iteration = int(max_iteration)

    def get_scheduler(self, base_lr):
        def sched(step):
            frac = torch.clamp(1.0 - _ratio(step, self.max_iteration),
                               0.0, 1.0)
            return base_lr * frac ** self.power
        return sched


class Exponential(Scheduler):
    """lr = base_lr * decay_rate^(iter/decay_step); ``stair_case``
    floors the exponent."""

    def __init__(self, decay_step, decay_rate, stair_case=False):
        self.decay_step = int(decay_step)
        self.decay_rate = float(decay_rate)
        self.stair_case = bool(stair_case)

    def get_scheduler(self, base_lr):
        def sched(step):
            e = _ratio(step, self.decay_step)
            if self.stair_case:
                e = torch.floor(e)
            return base_lr * _pow(self.decay_rate, e)
        return sched


class Step(Scheduler):
    """lr = base_lr * gamma^floor(iter/step_size)."""

    def __init__(self, step_size, gamma):
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def get_scheduler(self, base_lr):
        return lambda step: base_lr * _pow(
            self.gamma, torch.floor(_ratio(step, self.step_size)))


class MultiStep(Scheduler):
    """Step with non-uniform boundaries."""

    def __init__(self, step_sizes: List[int], gamma):
        self.step_sizes = [int(s) for s in step_sizes]
        self.gamma = float(gamma)

    def get_scheduler(self, base_lr):
        def sched(step):
            k = sum((step >= b).to(_F32) for b in self.step_sizes)
            return base_lr * _pow(self.gamma, k)
        return sched


class Warmup(Scheduler):
    """lr = base_lr + delta * iteration — a gradual ramp, normally the
    first segment of a :class:`SequentialSchedule`."""

    def __init__(self, delta):
        self.delta = float(delta)

    def get_scheduler(self, base_lr):
        return lambda step: base_lr + self.delta * step.to(_F32)


class SequentialSchedule(Scheduler):
    """Concatenate schedules, each running ``max_iteration`` steps; the
    last one extends to infinity. ``iteration_per_epoch`` is kept for
    signature parity."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.iteration_per_epoch = int(iteration_per_epoch)
        self.schedules: List[Tuple[Scheduler, int]] = []

    def add(self, scheduler: Scheduler, max_iteration: int):
        self.schedules.append((scheduler, int(max_iteration)))
        return self

    def get_scheduler(self, base_lr):
        if not self.schedules:
            return Default().get_scheduler(base_lr)
        segs = [(s.get_scheduler(base_lr), n) for s, n in self.schedules]

        def sched(step):
            out = None
            offset = 0
            for fn, n in segs:
                local = fn(step - offset)
                out = local if out is None else torch.where(
                    step >= offset, local, out)
                offset += n
            return out
        return sched


class Plateau(Scheduler):
    """Reduce lr by ``factor`` when a monitored metric stops improving.
    Metric-driven, so run on the host between epochs: ``update(metric)``
    returns the new lr, which the fit loop writes into the optimizer
    state's device ``"lr"``."""

    def __init__(self, monitor="Loss", factor=0.1, patience=10, mode="min",
                 epsilon=1e-4, cooldown=0, min_lr=0.0):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = int(patience)
        self.mode = mode
        self.epsilon = float(epsilon)
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.base_lr = None  # bound by the optimizer
        self.current_lr = None
        self._best = None
        self._wait = 0
        self._cooldown_left = 0

    def bind(self, base_lr: float):
        """(Re)attach to an optimizer: resets ALL plateau state so a
        reused instance does not carry a previous run's best metric."""
        self.base_lr = float(base_lr)
        self.current_lr = float(base_lr)
        self._best = None
        self._wait = 0
        self._cooldown_left = 0
        return self

    def _improved(self, metric: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            return metric < self._best - self.epsilon
        return metric > self._best + self.epsilon

    def update(self, metric: float) -> float:
        """Feed one epoch's monitored value; returns the lr to use next."""
        if self.current_lr is None:
            raise RuntimeError("Plateau.update before bind(base_lr)")
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._wait = 0
        if self._improved(metric):
            self._best = metric
            self._wait = 0
        elif self._cooldown_left == 0:
            self._wait += 1
            if self._wait >= self.patience:
                self.current_lr = max(self.current_lr * self.factor,
                                      self.min_lr)
                self._cooldown_left = self.cooldown
                self._wait = 0
        return self.current_lr

    def get_scheduler(self, base_lr):
        # constant until update() writes a new lr into the state
        self.bind(base_lr)
        return lambda step: _const(base_lr, step)


class WarmupCosineDecay(Scheduler):
    """``optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps)`` (end value 0, exponent 1), the schedule
    ``AdamWeightDecay(total_steps=, warmup_ratio=)`` builds: a linear
    ramp from ``init_value`` to the peak over ``warmup_steps``, then a
    cosine decay to 0 at ``decay_steps``, in optax's f32 arithmetic. The
    peak is the optimizer's ``base_lr``."""

    def __init__(self, init_value: float, warmup_steps: int,
                 decay_steps: int):
        if not decay_steps - warmup_steps > 0:
            raise ValueError("the cosine decay needs decay_steps > "
                             f"warmup_steps ({decay_steps}, {warmup_steps})")
        self.init_value = float(init_value)
        self.warmup_steps = int(warmup_steps)
        self.decay_steps = int(decay_steps)

    def get_scheduler(self, base_lr):
        peak, w = float(base_lr), self.warmup_steps
        span = float(self.decay_steps - w)
        pi = torch.pi

        def linear(count):
            # polynomial_schedule(init, peak, power=1, w)
            c = torch.clamp(count, 0, w)
            frac = 1 - _ratio(c, w)
            return (self.init_value - peak) * frac + peak

        def cosine(count):
            # cosine_decay_schedule(peak, span), alpha 0
            c = torch.minimum(count.to(_F32), _const(span, count))
            decay = 0.5 * (1 + torch.cos(pi * c / span))
            return peak * ((1 - 0.0) * decay + 0.0)

        def sched(step):
            return torch.where(step < w, linear(step), cosine(step - w))
        return sched
