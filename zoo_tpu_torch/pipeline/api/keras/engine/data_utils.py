"""Input plumbing of the Keras facade (counterpart of
``zoo_tpu/pipeline/api/keras/engine/data_utils.py``).

Numpy inputs only in this slice: ``x`` as one array, a list of arrays,
or ``{"x": ..., "y": ...}``, and one label array. XShards, DataFrames,
DataLoaders and ``tf.data`` wait for the data plane. Batch order is the JAX package's:
one ``RandomState.shuffle`` of the sample indices per epoch, the ragged
tail dropped, so both packages train on the same batches.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _as_list(x) -> List[np.ndarray]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


def to_xy_arrays(x, y=None
                 ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """Normalize numpy inputs to ``(inputs_list, labels)``."""
    if isinstance(x, dict):
        x, y = x["x"], x.get("y")
    if not isinstance(x, (np.ndarray, list, tuple)):
        raise TypeError(f"fit takes numpy arrays (or a dict of them) in "
                        f"this port; got {type(x).__name__}")
    return _as_list(x), None if y is None else np.asarray(y)


def num_samples(xs: List[np.ndarray]) -> int:
    return int(xs[0].shape[0]) if xs else 0


def batch_slices(n: int, batch_size: int, shuffle: bool,
                 rng: Optional[np.random.RandomState] = None):
    """Yield the index array of each training batch: one shuffle of the
    sample indices (the JAX package's numpy calls, so both packages see
    the same batches), the ragged tail dropped."""
    idx = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(idx)
    idx = idx[:(n // batch_size) * batch_size]
    for i in range(0, len(idx), batch_size):
        yield idx[i:i + batch_size]
