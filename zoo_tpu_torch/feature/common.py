"""Preprocessing transformer algebra (counterpart of
``zoo_tpu/feature/common.py``): small composable transforms over numpy
shared by the model zoo and the data pipelines. ``a > b`` or
``ChainedPreprocessing([a, b])`` composes. ``FeatureSet`` wraps any
iterable dataset; ``FeatureSet.ndarrays`` caches it in the tiered sample
cache of :mod:`zoo_tpu_torch.orca.data.cache`. ``Relations.read_parquet``
imports pyarrow when it runs.
"""

from __future__ import annotations

import csv as _csv
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


class Preprocessing:
    """Base transformer: ``__call__`` maps one element; ``apply`` maps an
    iterable (reference: ``Preprocessing`` with ``transform``)."""

    def __call__(self, x):
        raise NotImplementedError

    def apply(self, data):
        return [self(x) for x in data]

    # reference composes with ChainedPreprocessing; `>` sugar added here
    def __gt__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])


class ChainedPreprocessing(Preprocessing):
    """reference: ``common.py:122``."""

    def __init__(self, transformers: Sequence[Preprocessing]):
        flat: List[Preprocessing] = []
        for t in transformers:
            if isinstance(t, ChainedPreprocessing):
                flat.extend(t.transformers)
            else:
                flat.append(t)
        self.transformers = flat

    def __call__(self, x):
        for t in self.transformers:
            x = t(x)
        return x


class Lambda(Preprocessing):
    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, x):
        return self.fn(x)


class ScalarToTensor(Preprocessing):
    """reference: ``common.py:136``."""

    def __call__(self, x):
        return np.asarray(x, dtype=np.float32)


class SeqToTensor(Preprocessing):
    """Sequence of numbers → 1-D tensor of ``size`` (reference:
    ``common.py:145``)."""

    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = tuple(size) if size else None

    def __call__(self, x):
        arr = np.asarray(x, dtype=np.float32)
        if self.size:
            arr = arr.reshape(self.size)
        return arr


class SeqToMultipleTensors(Preprocessing):
    """Flat sequence split into several tensors of the given sizes
    (reference: ``common.py:155``, used for multi-input models)."""

    def __init__(self, sizes: Sequence[Sequence[int]]):
        self.sizes = [tuple(s) for s in sizes]

    def __call__(self, x):
        arr = np.asarray(x, dtype=np.float32).reshape(-1)
        outs, pos = [], 0
        for s in self.sizes:
            n = int(np.prod(s))
            outs.append(arr[pos:pos + n].reshape(s))
            pos += n
        return tuple(outs)


class ArrayToTensor(Preprocessing):
    """reference: ``common.py:165``."""

    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = tuple(size) if size else None

    def __call__(self, x):
        arr = np.asarray(x, dtype=np.float32)
        return arr.reshape(self.size) if self.size else arr


class TensorToSample(Preprocessing):
    """reference: ``common.py:200`` — terminal step producing an
    (features, label) Sample; here label defaults to None."""

    def __call__(self, x):
        if isinstance(x, tuple) and len(x) == 2:
            return x
        return (x, None)


class FeatureLabelPreprocessing(Preprocessing):
    """Pair transformer: apply one preprocessing to features, another to
    labels (reference: ``common.py:186``)."""

    def __init__(self, feature_transformer: Preprocessing,
                 label_transformer: Preprocessing):
        self.feature_transformer = feature_transformer
        self.label_transformer = label_transformer

    def __call__(self, xy: Tuple[Any, Any]):
        x, y = xy
        return (self.feature_transformer(x), self.label_transformer(y))


class ToTuple(Preprocessing):
    """reference: ``common.py:219``."""

    def __call__(self, x):
        return x if isinstance(x, tuple) else (x,)


class SampleToMiniBatch(Preprocessing):
    """Batch a list of (features, label) samples (reference:
    ``common.py:229``); ``apply`` yields stacked minibatches."""

    def __init__(self, batch_size: int, drop_remainder: bool = False):
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder

    def __call__(self, samples):
        xs = np.stack([np.asarray(s[0]) for s in samples])
        ys = None
        if samples and samples[0][1] is not None:
            ys = np.stack([np.asarray(s[1]) for s in samples])
        return (xs, ys)

    def apply(self, data):
        data = list(data)
        out = []
        for i in range(0, len(data), self.batch_size):
            chunk = data[i:i + self.batch_size]
            if self.drop_remainder and len(chunk) < self.batch_size:
                break
            out.append(self(chunk))
        return out


# ------------------------------------------------------------- relations

@dataclass(frozen=True)
class Relation:
    """QA-ranking relation (reference: ``common.py:30``)."""
    id1: str
    id2: str
    label: int


class Relations:
    """reference: ``common.py:52`` — csv/parquet readers for relations."""

    @staticmethod
    def read(path: str) -> List[Relation]:
        out = []
        with open(path, newline="") as f:
            for row in _csv.reader(f):
                if len(row) >= 3:
                    out.append(Relation(row[0], row[1], int(row[2])))
        return out

    @staticmethod
    def read_parquet(path: str) -> List[Relation]:
        """Relations from a parquet file with ``id1``, ``id2`` and
        ``label`` columns (pyarrow is imported here)."""
        from zoo_tpu_torch.orca.data.parquet_dataset import _need
        tb = _need("pyarrow.parquet").read_table(path).to_pydict()
        return [Relation(str(a), str(b), int(c)) for a, b, c in
                zip(tb["id1"], tb["id2"], tb["label"])]


class FeatureSet:
    """A dataset behind the reference's ``FeatureSet`` name (the tiered
    training-sample cache): iterates what it wraps. ``ndarrays`` caches
    an iterable of batches in :class:`~zoo_tpu_torch.orca.data.cache.
    CachedDataset` on the tier ``memory_type`` names."""

    def __init__(self, dataset):
        self.dataset = dataset

    @staticmethod
    def ndarrays(arrays, memory_type: str = "DRAM"):
        from zoo_tpu_torch.orca.data.cache import CachedDataset

        # the reference's PMEM and DIRECT tiers (Optane, off-heap) mean
        # "bigger than DRAM", which the cache models as a DISK_n budget
        store = memory_type.upper()
        if store in ("PMEM", "DIRECT"):
            store = "DISK_2"
        return FeatureSet(CachedDataset(arrays, store=store))

    def cache(self):
        return self

    def __iter__(self):
        return iter(self.dataset)
