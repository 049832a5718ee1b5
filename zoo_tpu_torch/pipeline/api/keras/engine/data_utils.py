"""Input plumbing of the Keras facade (counterpart of
``zoo_tpu/pipeline/api/keras/engine/data_utils.py``).

Inputs: numpy ``x`` as one array, a list of arrays, or ``{"x": ...,
"y": ...}``; labels as one array or, for a multi-output model, a list of
arrays; or a DataFrame-like table with ``feature_cols``/``label_cols``
(anything with ``columns`` whose columns have ``to_numpy()``: duck-typed,
so pandas is never imported). XShards wait for the data plane (ROADMAP
A.15) and are refused by name; DataLoaders and ``tf.data`` too. Batch
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


def to_xy_arrays(x, y=None, feature_cols: Optional[Sequence[str]] = None,
                 label_cols: Optional[Sequence[str]] = None
                 ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """Normalize the inputs to ``(inputs_list, labels)``; labels are one
    array, a list of arrays (multi-output) or None."""
    if hasattr(x, "transform_shard"):
        raise NotImplementedError(
            "XShards inputs are not ported to zoo_tpu_torch yet (ROADMAP "
            "A.15); pass numpy arrays, a dict of them or a DataFrame with "
            "feature_cols/label_cols")
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
