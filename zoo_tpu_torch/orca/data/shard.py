"""XShards — a partitioned collection of Python objects (counterpart
of ``zoo_tpu/orca/data/shard.py``).

Each shard is an arbitrary Python object, most commonly a dict of numpy
arrays or a pandas DataFrame, and transforms run per shard in a thread
pool sized by the runtime context's ``cores``. ``LocalXShards`` is
always materialized in this process. The training path concatenates the
shards on the host (:meth:`LocalXShards.stack_numpy`) and the Keras
``fit`` slices its batches from that, as from numpy arrays.

pandas is imported only where a shard is a DataFrame: numpy-dict shards
never import it (the machine with the card has no pandas).
:meth:`LocalXShards.load_pickle` reads through a restricted unpickler
that resolves numpy's array parts and pandas' (and pyarrow's) frame
parts only.
"""

from __future__ import annotations

import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from zoo_tpu_torch.common.context import get_runtime_context


def _pool_size() -> int:
    ctx = get_runtime_context(required=False)
    return max(1, ctx.cores if ctx else (os.cpu_count() or 1))


def _pandas():
    """pandas when it is already imported (a DataFrame shard exists only
    then), else None: a type test never imports it."""
    return sys.modules.get("pandas")


def _is_frame(d) -> bool:
    pd = _pandas()
    return pd is not None and isinstance(d, (pd.DataFrame, pd.Series))


class XShards:
    """Abstract distributed collection."""

    def transform_shard(self, func: Callable, *args) -> "XShards":
        raise NotImplementedError

    def collect(self) -> List[Any]:
        raise NotImplementedError

    def num_partitions(self) -> int:
        raise NotImplementedError

    @staticmethod
    def partition(data, num_shards: Optional[int] = None) -> "LocalXShards":
        """Split an ndarray / dict / (nested) list-or-tuple of ndarrays
        (or DataFrames) into shards along axis 0. All leaves must share
        the same length."""

        def _len(d):
            if isinstance(d, np.ndarray):
                return d.shape[0]
            if _is_frame(d):
                return len(d)
            if isinstance(d, dict):
                sizes = {k: _len(v) for k, v in d.items()}
                return next(iter(sizes.values()))
            if isinstance(d, (list, tuple)):
                return _len(d[0])
            raise ValueError(f"cannot partition data of type {type(d)}")

        n = _len(data)
        if num_shards is None:
            num_shards = _pool_size()
        num_shards = max(1, min(num_shards, n))
        bounds = np.linspace(0, n, num_shards + 1).astype(int)

        def _slice(d, lo, hi):
            if isinstance(d, np.ndarray):
                return d[lo:hi]
            if _is_frame(d):
                return d.iloc[lo:hi].reset_index(drop=True)
            if isinstance(d, dict):
                return {k: _slice(v, lo, hi) for k, v in d.items()}
            if isinstance(d, tuple):
                return tuple(_slice(v, lo, hi) for v in d)
            return [_slice(v, lo, hi) for v in d]

        return LocalXShards([_slice(data, bounds[i], bounds[i + 1])
                             for i in range(num_shards)])


class LocalXShards(XShards):
    """Materialized in-process XShards (one list entry per shard)."""

    def __init__(self, shards: Sequence[Any]):
        self._shards = list(shards)

    def transform_shard(self, func: Callable, *args) -> "LocalXShards":
        """Apply ``func(shard, *args)`` to every shard in a thread pool
        sized by the context's ``cores``."""
        with ThreadPoolExecutor(max_workers=_pool_size()) as pool:
            out = list(pool.map(lambda s: func(s, *args), self._shards))
        return LocalXShards(out)

    def collect(self) -> List[Any]:
        return list(self._shards)

    def num_partitions(self) -> int:
        return len(self._shards)

    def repartition(self, num_partitions: int) -> "LocalXShards":
        """Re-split into ``num_partitions`` parts; ndarray, dict-of-
        ndarray and DataFrame shards are rebalanced row by row, other
        shard objects regrouped whole."""
        first = self._shards[0] if self._shards else None
        if isinstance(first, np.ndarray):
            whole = np.concatenate(self._shards, axis=0)
            return XShards.partition(whole, num_partitions)
        if isinstance(first, dict) and all(
                isinstance(v, np.ndarray) for v in first.values()):
            whole = {k: np.concatenate([s[k] for s in self._shards], axis=0)
                     for k in first}
            return XShards.partition(whole, num_partitions)
        pd = _pandas()
        if pd is not None and isinstance(first, pd.DataFrame):
            whole = pd.concat(self._shards, ignore_index=True)
            n = len(whole)
            num_partitions = max(1, min(num_partitions, max(n, 1)))
            bounds = np.linspace(0, n, num_partitions + 1).astype(int)
            return LocalXShards(
                [whole.iloc[bounds[i]:bounds[i + 1]].reset_index(drop=True)
                 for i in range(num_partitions)])
        groups = [[] for _ in range(num_partitions)]
        for i, s in enumerate(self._shards):
            groups[i % num_partitions].append(s)
        return LocalXShards([g if len(g) != 1 else g[0] for g in groups if g])

    def partition_by(self, cols, num_partitions: Optional[int] = None
                     ) -> "LocalXShards":
        """Hash-partition DataFrame shards by column(s) so that equal
        keys land in the same shard."""
        import pandas as pd
        if isinstance(cols, str):
            cols = [cols]
        whole = pd.concat(self.collect(), ignore_index=True)
        n = num_partitions or self.num_partitions()
        codes = pd.util.hash_pandas_object(
            whole[cols], index=False).to_numpy() % n
        return LocalXShards(
            [whole[codes == i].reset_index(drop=True) for i in range(n)])

    def unique(self) -> np.ndarray:
        """Distinct values across shards of 1-D data."""
        vals = [np.unique(np.asarray(s)) for s in self._shards]
        return np.unique(np.concatenate(vals)) if vals else np.array([])

    def split(self) -> List["LocalXShards"]:
        """Shards of tuples/lists -> one XShards per element."""
        first = self._shards[0]
        if not isinstance(first, (list, tuple)):
            return [self]
        return [LocalXShards([s[i] for s in self._shards])
                for i in range(len(first))]

    def zip(self, other: "LocalXShards") -> "LocalXShards":
        """Pairwise-zip equal-length shard lists."""
        if not isinstance(other, LocalXShards):
            raise ValueError("zip requires another LocalXShards")
        if other.num_partitions() != self.num_partitions():
            raise ValueError("zip requires equal numbers of partitions")
        return LocalXShards(list(zip(self._shards, other.collect())))

    def __len__(self) -> int:
        total = 0
        for s in self._shards:
            try:
                total += len(s)
            except TypeError:
                total += 1
        return total

    def save_pickle(self, path: str) -> "LocalXShards":
        """One pickle file per shard under ``path``."""
        os.makedirs(path, exist_ok=True)
        width = max(5, len(str(len(self._shards))))
        for i, s in enumerate(self._shards):
            with open(os.path.join(path, f"part-{i:0{width}d}.pkl"), "wb") as f:
                pickle.dump(s, f, protocol=pickle.HIGHEST_PROTOCOL)
        return self

    @classmethod
    def load_pickle(cls, path: str) -> "LocalXShards":
        """Read ``save_pickle``'s files (either package's) through
        :class:`_ShardUnpickler`: numpy arrays, pandas frames, and
        dicts, lists, tuples and numbers of them; a file that names
        anything else is refused."""
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".pkl"))
        shards = []
        for fp in files:
            with open(fp, "rb") as f:
                shards.append(_ShardUnpickler(f).load())
        return cls(shards)

    def stack_numpy(self, cols: Optional[Sequence[str]] = None):
        """Concatenate all shards into one host dict of numpy arrays
        (one array for ndarray shards)."""
        shards = self.collect()
        first = shards[0]
        pd = _pandas()
        if pd is not None and isinstance(first, pd.DataFrame):
            whole = pd.concat(shards, ignore_index=True)
            cols = cols or list(whole.columns)
            missing = [c for c in cols if c not in whole.columns]
            if missing:
                raise ValueError(f"feature/label column(s) not found: "
                                 f"{missing}; available: {list(whole.columns)}")
            return {c: whole[c].to_numpy() for c in cols}
        if isinstance(first, dict):
            keys = cols or list(first.keys())
            return {k: _concat_leaf([s[k] for s in shards]) for k in keys}
        if isinstance(first, np.ndarray):
            return np.concatenate(shards, axis=0)
        raise ValueError(f"cannot stack shards of type {type(first)}")


def _concat_leaf(parts):
    if isinstance(parts[0], (list, tuple)):
        return type(parts[0])(
            _concat_leaf([p[i] for p in parts]) for i in range(len(parts[0])))
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


class _ShardUnpickler(pickle.Unpickler):
    """The checkpoint codec's numpy parts, pandas' own classes and
    reconstructors and pyarrow's (a pickled frame names only those,
    ``slice`` and numpy's; pandas keeps string columns in arrow arrays),
    and nothing else: a file naming ``os.system`` is refused."""

    def find_class(self, module, name):
        from zoo_tpu_torch.orca.learn.ckpt import (
            _SAFE_GLOBALS,
            _numpy_type,
        )
        if "." not in name and (
                (module, name) in _SAFE_GLOBALS
                or (module.split(".")[0] == "numpy"
                    and _numpy_type(module, name))
                or module.split(".")[0] in ("pandas", "pyarrow")
                or (module, name) == ("builtins", "slice")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"an XShards pickle holds numpy arrays, pandas frames and "
            f"containers of them; this file names {module}.{name}")


def shards_for_process(shards: "LocalXShards",
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None
                       ) -> "LocalXShards":
    """This process's partitions, round-robin, trimmed so every process
    holds the same count. The port runs one process (a world above one
    is ROADMAP A.14), so by default that is every partition."""
    pi = 0 if process_index is None else process_index
    pcnt = 1 if process_count is None else process_count
    parts = shards.collect()
    per = len(parts) // pcnt
    if per == 0:
        raise ValueError(f"{len(parts)} partitions cannot feed "
                         f"{pcnt} processes; repartition() first")
    if len(parts) % pcnt:
        import warnings
        warnings.warn(
            f"dropping {len(parts) % pcnt} of {len(parts)} partitions so "
            f"all {pcnt} processes hold {per}; repartition() to a "
            "multiple to keep every row")
    return LocalXShards(parts[pi::pcnt][:per])
