"""Spark DataFrame ingestion: partitions to shards, no collect of rows
(counterpart of ``zoo_tpu/orca/data/spark.py``).

The reference's Orca estimators and NNFrames take a Spark DataFrame with
feature and label columns. Here the executors write each partition as a
numpy shard file (``mapPartitionsWithIndex``) into a staging directory,
and this process loads the files as ``LocalXShards``: only the list of
file paths reaches Spark's coordinating process, never row data.

pyspark is not a dependency: the adapter talks to a four-method surface
(``df.columns``, ``df.rdd``, ``rdd.mapPartitionsWithIndex(f)``,
``.collect()``), so it runs against a pandas-backed stub, and
:func:`is_spark_dataframe` tells a DataFrame by its module name without
importing pyspark. The port runs one process (a world above one is
ROADMAP A.14), so one process stages and reads every partition.
"""

from __future__ import annotations

import os
import uuid
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["is_spark_dataframe", "spark_dataframe_to_shards"]


def is_spark_dataframe(obj) -> bool:
    """True for ``pyspark.sql.DataFrame`` (connect or classic) without
    importing pyspark."""
    mod = type(obj).__module__ or ""
    return mod.startswith("pyspark.") and type(obj).__name__ == "DataFrame"


def _column_array(name: str, vals: List) -> np.ndarray:
    """Convert one column's python values (as Spark rows deliver them) to
    a numeric ndarray, covering the SQL-type edge cases: nulls become NaN
    in float columns (and are an error in non-float ones), ``Decimal``
    becomes float64, array columns (``ArrayType``) stack to 2-D. String/
    object columns fail with a clear message — the staged ``.npz`` files
    are loaded with ``allow_pickle=False`` by the reading process."""
    import decimal

    has_null = any(v is None for v in vals)
    if vals and any(isinstance(v, decimal.Decimal) for v in vals):
        return np.asarray([np.nan if v is None else float(v)
                           for v in vals], np.float64)
    if has_null:
        if all(v is None or isinstance(v, float) for v in vals):
            return np.asarray([np.nan if v is None else v for v in vals],
                              np.float64)
        raise ValueError(
            f"column {name!r} contains nulls in a non-float type; "
            "fill or drop them in Spark (df.na.fill / df.na.drop) "
            "before handing the DataFrame to the estimator")
    if vals and isinstance(vals[0], (list, tuple, np.ndarray)):
        try:
            return np.stack([np.asarray(v, np.float32) for v in vals])
        except ValueError as e:
            raise ValueError(
                f"array column {name!r} has ragged lengths; pad it to a "
                "fixed size in Spark before ingestion") from e
    arr = np.asarray(vals)
    if arr.dtype.kind not in "biufc":  # unicode/object/bytes/datetime
        raise TypeError(
            f"column {name!r} has non-numeric type "
            f"{type(vals[0]).__name__}; select/cast numeric columns "
            "(StringIndexer etc. happen Spark-side)")
    return arr


class _PartitionWriter:
    """The callable shipped to Spark executors via
    ``rdd.mapPartitionsWithIndex``. A module-level class instance — NOT a
    closure — so it serializes under plain pickle as well as Spark's
    cloudpickle; executors only need this module importable (the
    zoo_tpu_torch wheel on the executor python path, the reference's
    ``--py-files`` story). Converts a partition's rows to one ``.npz`` of
    column arrays and yields only the (partition_id, path, row_count)
    triple."""

    def __init__(self, columns: Sequence[str], staging_dir: str, run: str):
        self.columns = list(columns)
        self.staging_dir = staging_dir
        self.run = run

    def __call__(self, pid, rows):
        cols = {c: [] for c in self.columns}
        n = 0
        for row in rows:
            for c in self.columns:
                cols[c].append(row[c])
            n += 1
        if n == 0:
            return iter(())
        path = os.path.join(self.staging_dir,
                            f"zoo-{self.run}-p{pid:05d}.npz")
        np.savez(path, **{c: _column_array(c, v)
                          for c, v in cols.items()})
        return iter([(pid, path, n)])


def _partition_writer(columns: Sequence[str], staging_dir: str, run: str):
    return _PartitionWriter(columns, staging_dir, run)


def spark_dataframe_to_shards(df, feature_cols: Sequence[str],
                              label_cols: Optional[Sequence[str]] = None,
                              staging_dir: Optional[str] = None,
                              process_index: Optional[int] = None,
                              process_count: Optional[int] = None):
    """Materialize a Spark DataFrame as THIS process's ``LocalXShards``.

    ``staging_dir`` must be visible to both the Spark executors and the
    reading host (defaults to ``$ZOO_SPARK_STAGING`` or a tmp dir — the
    latter only works in ``local[*]`` mode where executors share the
    filesystem). Returns shards shaped for the estimator feed:
    ``{"x": (n, F) | (n,), "y": (n, L) | (n,)}``.

    Every call stages a fresh uuid-tagged copy of the DataFrame; a
    single reader deletes the run's files after loading them.
    """
    if not feature_cols:
        raise ValueError("feature_cols required for DataFrame input")
    label_cols = list(label_cols or [])
    missing = [c for c in list(feature_cols) + label_cols
               if c not in df.columns]
    if missing:
        raise ValueError(f"column(s) not found: {missing}; "
                         f"available: {list(df.columns)}")
    staging_dir = staging_dir or os.environ.get("ZOO_SPARK_STAGING")
    if staging_dir is None:
        import tempfile
        staging_dir = tempfile.mkdtemp(prefix="zoo_spark_")
    run = uuid.uuid4().hex[:8]
    writer = _partition_writer(list(feature_cols) + label_cols,
                               staging_dir, run)
    # executors write the shard files; ONLY the path metadata collects
    meta = sorted(df.rdd.mapPartitionsWithIndex(writer).collect())

    from zoo_tpu_torch.orca.data.shard import (LocalXShards,
                                               shards_for_process)

    paths = LocalXShards([p for _, p, _ in meta])
    mine = shards_for_process(paths, process_index=process_index,
                              process_count=process_count)

    def load(path: str):
        with np.load(path, allow_pickle=False) as z:
            feats = [z[c] for c in feature_cols]
            labs = [z[c] for c in label_cols]
        x = feats[0] if len(feats) == 1 else np.stack(feats, axis=1)
        shard = {"x": x}
        if labs:
            shard["y"] = labs[0] if len(labs) == 1 \
                else np.stack(labs, axis=1)
        return shard

    out = LocalXShards([load(p) for p in mine.collect()])
    if (process_count or 1) == 1:
        for _, p, _ in meta:  # single reader: reclaim this run's staging
            try:
                os.remove(p)
            except OSError:
                pass
    return out
