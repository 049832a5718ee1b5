"""Trigger DSL for checkpoint/validation cadence (a copy of
``zoo_tpu/orca/learn/trigger.py``).

EveryEpoch, SeveralIteration, MaxIteration, MaxEpoch, And, Or. A
trigger is consulted with the current (epoch, iteration) counters;
epoch triggers fire at epoch boundaries.
"""

from __future__ import annotations


class Trigger:
    def fire_on_epoch(self, epoch: int) -> bool:
        return False

    def fire_on_iteration(self, iteration: int) -> bool:
        return False

    @staticmethod
    def convert_trigger(t):
        if t is None or isinstance(t, Trigger):
            return t
        raise ValueError(f"not a trigger: {t}")


class EveryEpoch(Trigger):
    """Fire at every epoch end (reference: ``ZooTrigger.scala`` EveryEpoch)."""

    def fire_on_epoch(self, epoch: int) -> bool:
        return True


class SeveralIteration(Trigger):
    """Fire every ``interval`` iterations (reference: SeveralIteration)."""

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = int(interval)

    def fire_on_iteration(self, iteration: int) -> bool:
        return iteration > 0 and iteration % self.interval == 0


class MaxEpoch(Trigger):
    """End-condition trigger: fires once ``max`` epochs completed."""

    def __init__(self, max_epoch: int):
        self.max_epoch = int(max_epoch)

    def fire_on_epoch(self, epoch: int) -> bool:
        return epoch >= self.max_epoch


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = int(max_iteration)

    def fire_on_iteration(self, iteration: int) -> bool:
        return iteration >= self.max_iteration


class And(Trigger):
    def __init__(self, first: Trigger, *others: Trigger):
        self.triggers = (first,) + others

    def fire_on_epoch(self, epoch: int) -> bool:
        return all(t.fire_on_epoch(epoch) for t in self.triggers)

    def fire_on_iteration(self, iteration: int) -> bool:
        return all(t.fire_on_iteration(iteration) for t in self.triggers)


class Or(Trigger):
    def __init__(self, first: Trigger, *others: Trigger):
        self.triggers = (first,) + others

    def fire_on_epoch(self, epoch: int) -> bool:
        return any(t.fire_on_epoch(epoch) for t in self.triggers)

    def fire_on_iteration(self, iteration: int) -> bool:
        return any(t.fire_on_iteration(iteration) for t in self.triggers)
