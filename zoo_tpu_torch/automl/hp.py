"""The search-space DSL (counterpart of ``zoo_tpu/automl/hp.py``, the
port's own copy): samplers drawing from a ``numpy.random.RandomState``,
for the local search engine (and ray.tune's spaces, where ray is
installed).
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np


class Sampler:
    def sample(self, rng: np.random.RandomState) -> Any:
        raise NotImplementedError

    def grid(self) -> List[Any]:
        raise NotImplementedError("not a grid dimension")

    def is_grid(self) -> bool:
        return False


class Choice(Sampler):
    def __init__(self, options: Sequence):
        self.options = list(options)

    def sample(self, rng):
        return self.options[rng.randint(len(self.options))]


class GridSearch(Choice):
    def is_grid(self):
        return True

    def grid(self):
        return list(self.options)


class Uniform(Sampler):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = float(lower), float(upper)

    def sample(self, rng):
        return float(rng.uniform(self.lower, self.upper))


class QUniform(Uniform):
    def __init__(self, lower, upper, q=1):
        super().__init__(lower, upper)
        self.q = q

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        return type(self.q)(np.round(v / self.q) * self.q)


class LogUniform(Sampler):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = float(lower), float(upper)

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.lower),
                                        np.log(self.upper))))


class RandInt(Sampler):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = int(lower), int(upper)

    def sample(self, rng):
        return int(rng.randint(self.lower, self.upper))


def choice(options):
    """reference: ``hp.choice``."""
    return Choice(options)


def grid_search(options):
    """reference: ``hp.grid_search`` — every value is tried."""
    return GridSearch(options)


def uniform(lower, upper):
    return Uniform(lower, upper)


def quniform(lower, upper, q=1):
    return QUniform(lower, upper, q)


def loguniform(lower, upper):
    return LogUniform(lower, upper)


def randint(lower, upper):
    return RandInt(lower, upper)
