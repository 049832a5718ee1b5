"""Input plumbing of the Keras facade (counterpart of
``zoo_tpu/pipeline/api/keras/engine/data_utils.py``).

Inputs: numpy ``x`` as one array, a list of arrays, or ``{"x": ...,
"y": ...}``; labels as one array or, for a multi-output model, a list of
arrays; or a DataFrame-like table with ``feature_cols``/``label_cols``
(anything with ``columns`` whose columns have ``to_numpy()``: duck-typed,
so pandas is never imported); or XShards
(:mod:`zoo_tpu_torch.orca.data`) of numpy dicts (``{"x", "y"}``) or of
such tables (with ``feature_cols``/``label_cols``), concatenated on the
host into the same arrays, so a fit from shards is a fit from the
stacked arrays; or a torch ``DataLoader`` of ``(x, y)``, ``(x1, ...,
xn, y)`` or ``{"x", "y"}`` batches, materialized on the host as the JAX
package materializes it; or a Spark DataFrame with
``feature_cols``/``label_cols``, staged into shards by
:mod:`zoo_tpu_torch.orca.data.spark` (no pyspark import). ``tf.data`` is
refused. Batch
order is the JAX package's: one ``RandomState.shuffle`` of the sample
indices per epoch, the ragged tail dropped, so both packages train on
the same batches, ``group`` whole batches at a time.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _as_list(x) -> List[np.ndarray]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


def _normalize_labels(y):
    """A list is a multi-output label SET only when its elements are
    arrays of rank >= 1; a plain Python list of scalars (keras-style
    ``fit(x, [0, 1, ...])``) is one label array."""
    if y is None:
        return None
    if isinstance(y, (list, tuple)):
        if y and all(isinstance(a, np.ndarray) and a.ndim >= 1 for a in y):
            return [np.asarray(a) for a in y]
        return np.asarray(y)
    return np.asarray(y)


def _stack_labels(cols: List[np.ndarray]) -> Optional[np.ndarray]:
    if not cols:
        return None
    if len(cols) == 1:
        return cols[0]
    return np.stack(cols, axis=-1)


def _is_table(x) -> bool:
    return hasattr(x, "columns") and hasattr(x, "__getitem__") and \
        not isinstance(x, (np.ndarray, dict, list, tuple))


# full-materialization cap: an infinite loader fails naming the cause
_MAX_LOADER_BATCHES = 100_000


def _np_leaf(o):
    if hasattr(o, "detach"):   # a torch tensor
        import torch
        o = o.detach().cpu()
        return (o.float() if o.dtype == torch.bfloat16 else o).numpy()
    return np.asarray(o)


def _loader_xy(loader, y):
    """A torch ``DataLoader``'s batches stacked into ``(inputs_list,
    labels)`` (the JAX package's ``to_xy_arrays`` for a loader)."""
    if y is not None:
        raise ValueError("pass labels inside the DataLoader batches, not "
                         "as a separate y= argument")
    xs_b, ys_b = [], []
    for n, batch in enumerate(loader):
        if n >= _MAX_LOADER_BATCHES:
            raise ValueError(
                f"the loader yielded more than {_MAX_LOADER_BATCHES} "
                "batches: is it infinite (an IterableDataset)? "
                "Materialization needs a finite dataset")
        if isinstance(batch, dict):
            bx, by = batch.get("x"), batch.get("y")
            if bx is None:
                raise ValueError("dict batches must carry 'x' (and "
                                 f"optionally 'y'); got keys {sorted(batch)}")
        elif isinstance(batch, (list, tuple)):
            if len(batch) == 1:
                bx, by = batch[0], None
            else:   # (x, y) or (x1, ..., xn, y): the last item is labels
                bx, by = list(batch[:-1]), batch[-1]
                if len(bx) == 1:
                    bx = bx[0]
        else:
            bx, by = batch, None
        bx = bx if isinstance(bx, (list, tuple)) else [bx]
        xs_b.append([_np_leaf(a) for a in bx])
        if by is not None:
            ys_b.append(_np_leaf(by))
    if not xs_b:
        raise ValueError("empty dataloader")
    xs = [np.concatenate([b[i] for b in xs_b]) for i in range(len(xs_b[0]))]
    return xs, _normalize_labels(np.concatenate(ys_b) if ys_b else None)


def _is_loader(x) -> bool:
    """A torch ``DataLoader`` (a user subclass too), told by its class
    so this module imports no torch."""
    return any(c.__name__ == "DataLoader" and c.__module__.startswith(
        "torch.utils.data") for c in type(x).__mro__)


def to_xy_arrays(x, y=None, feature_cols: Optional[Sequence[str]] = None,
                 label_cols: Optional[Sequence[str]] = None
                 ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """Normalize the inputs to ``(inputs_list, labels)``; labels are one
    array, a list of arrays (multi-output) or None."""
    from zoo_tpu_torch.orca.data.spark import is_spark_dataframe
    if is_spark_dataframe(x):
        # a Spark DataFrame: the executors write shard files and this
        # process loads them (no collect of rows, orca/data/spark.py)
        from zoo_tpu_torch.orca.data.spark import spark_dataframe_to_shards
        if y is not None:
            raise ValueError("labels come from label_cols for Spark "
                             "DataFrame input, not a separate y= "
                             "argument")
        if not feature_cols:
            raise ValueError("feature_cols required for Spark DataFrame "
                             "input")
        shards = spark_dataframe_to_shards(x, feature_cols, label_cols)
        return to_xy_arrays(shards, None, None, None)
    if _is_loader(x):
        return _loader_xy(x, y)
    if hasattr(x, "transform_shard"):
        return _xshards_xy(x, feature_cols, label_cols)
    if _is_table(x):
        if not feature_cols:
            raise ValueError("feature_cols required for DataFrame input")
        cols = list(x.columns)
        missing = [c for c in list(feature_cols) + list(label_cols or [])
                   if c not in cols]
        if missing:
            raise ValueError(f"feature/label column(s) not found: "
                             f"{missing}; available: {cols}")
        xs = [np.asarray(x[c].to_numpy()) for c in feature_cols]
        ys = _stack_labels([np.asarray(x[c].to_numpy())
                            for c in (label_cols or [])])
        return xs, ys
    if isinstance(x, dict):
        x, y = x["x"], x.get("y")
    if not isinstance(x, (np.ndarray, list, tuple)):
        raise TypeError(f"the Keras API takes numpy arrays (or a dict of "
                        f"them, or a DataFrame) in this port; got "
                        f"{type(x).__name__}")
    return _as_list(x), _normalize_labels(y)


def _xshards_xy(shards, feature_cols, label_cols):
    """XShards of tables (``feature_cols``/``label_cols``) or of
    ``{"x", "y"}`` numpy dicts, stacked on the host."""
    first = shards.collect()[0]
    if _is_table(first):
        if not feature_cols:
            raise ValueError("feature_cols required for DataFrame shards")
        stacked = shards.stack_numpy(list(feature_cols)
                                     + list(label_cols or []))
        xs = [np.asarray(stacked[c]) for c in feature_cols]
        ys = _stack_labels([np.asarray(stacked[c])
                            for c in (label_cols or [])])
        return xs, ys
    if isinstance(first, dict):
        stacked = shards.stack_numpy()
        return _as_list(stacked.get("x")), stacked.get("y")
    raise ValueError(f"unsupported shard type: {type(first)}")


def num_samples(xs: List[np.ndarray]) -> int:
    return int(xs[0].shape[0]) if xs else 0


def batch_slices(n: int, batch_size: int, shuffle: bool,
                 rng: Optional[np.random.RandomState] = None,
                 drop_remainder: bool = True, group: int = 1):
    """Yield index arrays, ``group`` whole batches at a time (a
    superbatch: one host-to-device copy covers several training
    batches): one shuffle of the sample indices (the JAX package's numpy
    calls, so both packages see the same batches), the ragged tail
    dropped in training; inference keeps it and pads it
    (:func:`pad_batch`)."""
    idx = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(idx)
    if drop_remainder:
        idx = idx[:(n // batch_size) * batch_size]
    chunk = batch_size * group
    for i in range(0, len(idx), chunk):
        yield idx[i:i + chunk]


def pad_batch(arrs: List[np.ndarray], batch_size: int
              ) -> Tuple[List[np.ndarray], int]:
    """Pad a ragged final batch up to ``batch_size`` by repeating row 0;
    returns (padded, real_count)."""
    real = arrs[0].shape[0]
    if real == batch_size:
        return arrs, real
    out = []
    for a in arrs:
        pad = np.repeat(a[:1], batch_size - real, axis=0)
        out.append(np.concatenate([a, pad], axis=0))
    return out, real
