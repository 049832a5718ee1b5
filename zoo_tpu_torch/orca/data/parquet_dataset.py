"""ParquetDataset: write generator, ndarray or image-folder datasets as
parquet and read them back as arrays, XShards or a streaming iterator
(counterpart of ``zoo_tpu/orca/data/parquet_dataset.py``).

The files and the ``_orca_metadata.json`` sidecar (the schema and the
ndarray columns' dtypes) are the JAX package's, byte for byte, so either
package reads what the other wrote. pyarrow is imported when a function
runs, never when this module is imported.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

_META = "_orca_metadata.json"


def _need(module: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"ParquetDataset needs the {module.split('.')[0]} package, "
            "which is not installed here") from e


def _list_column(pa, vals, dt):
    """The ndarray column of one block as a list<dt> array: the rows
    flattened into one values buffer and offsets (the same array, and
    the same file, as a list of Python lists gives, without building
    one)."""
    flat = [np.asarray(v, dt).reshape(-1) for v in vals]
    offsets = np.zeros(len(flat) + 1, np.int32)
    np.cumsum([f.size for f in flat], out=offsets[1:])
    values = np.concatenate(flat) if flat else np.zeros(0, dt)
    return pa.ListArray.from_arrays(pa.array(offsets, pa.int32()),
                                    pa.array(values,
                                             pa.from_numpy_dtype(dt)))


def _ndarray_rows(table, name: str, dt: np.dtype) -> List[np.ndarray]:
    """The rows of an ndarray column of ``table``, each reshaped to its
    ``<name>_shape`` (views of one values buffer)."""
    col = table[name].combine_chunks()
    values = np.asarray(col.values.to_numpy(zero_copy_only=False), dt)
    offsets = np.asarray(col.offsets.to_numpy())
    shapes = table[name + "_shape"].to_pylist()
    return [values[offsets[i]:offsets[i + 1]].reshape(shape)
            for i, shape in enumerate(shapes)]


class ParquetDataset:
    @staticmethod
    def write(path: str, generator: Iterator[Dict], schema: Dict[str, str],
              block_size: int = 1000, write_mode: str = "overwrite"):
        """``schema``: {column: kind} with kind in
        ``scalar | ndarray | image`` (image = raw bytes). Records from
        ``generator`` are dicts keyed by the schema."""
        pa = _need("pyarrow")
        pq = _need("pyarrow.parquet")

        if write_mode not in ("overwrite", "error", "append"):
            raise ValueError(f"write_mode must be overwrite|error|append, "
                             f"got {write_mode!r}")
        start_idx = 0
        if os.path.isdir(path):
            if write_mode == "error":
                raise FileExistsError(path)
            if write_mode == "overwrite":
                import shutil
                shutil.rmtree(path)
            else:  # append continues the part numbering
                parts = [f for f in os.listdir(path)
                         if f.endswith(".parquet")]
                start_idx = len(parts)
        os.makedirs(path, exist_ok=True)
        dtypes: Dict[str, str] = {}

        def flush(rows: List[Dict], idx: int):
            if not rows:
                return
            cols = {}
            for name, kind in schema.items():
                vals = [r[name] for r in rows]
                if kind == "ndarray":
                    dt = np.asarray(vals[0]).dtype
                    dtypes.setdefault(name, dt.name)
                    cols[name] = _list_column(pa, vals, dt)
                    cols[name + "_shape"] = pa.array(
                        [list(np.asarray(v).shape) for v in vals],
                        pa.list_(pa.int32()))
                elif kind == "image":
                    cols[name] = pa.array(
                        [v if isinstance(v, bytes) else bytes(v)
                         for v in vals], pa.binary())
                else:
                    cols[name] = pa.array(vals)
            table = pa.table(cols)
            pq.write_table(table,
                           os.path.join(path, f"part-{idx:05d}.parquet"))

        rows: List[Dict] = []
        idx = start_idx
        for rec in generator:
            rows.append(rec)
            if len(rows) >= block_size:
                flush(rows, idx)
                rows, idx = [], idx + 1
        flush(rows, idx)
        with open(os.path.join(path, _META), "w") as f:
            json.dump({"schema": schema, "dtypes": dtypes}, f)

    # -- read -------------------------------------------------------------
    @staticmethod
    def _meta(path: str) -> Dict:
        with open(os.path.join(path, _META)) as f:
            return json.load(f)

    @staticmethod
    def _schema(path: str) -> Dict[str, str]:
        return ParquetDataset._meta(path)["schema"]

    @staticmethod
    def read_as_arrays(path: str) -> Dict[str, np.ndarray]:
        """Whole dataset as {column: array} (ndarray columns reshaped,
        dtypes restored from the metadata sidecar)."""
        pq = _need("pyarrow.parquet")

        meta = ParquetDataset._meta(path)
        schema = meta["schema"]
        dtypes = meta.get("dtypes", {})
        parts = sorted(f for f in os.listdir(path)
                       if f.endswith(".parquet"))
        out: Dict[str, List] = {k: [] for k in schema}
        for part in parts:
            table = pq.read_table(os.path.join(path, part))
            for name, kind in schema.items():
                if kind == "ndarray":
                    out[name].extend(_ndarray_rows(
                        table, name, np.dtype(dtypes.get(name, "float32"))))
                else:
                    out[name].extend(table[name].to_pylist())
        return {k: (np.stack(v) if schema[k] == "ndarray"
                    and len({a.shape for a in v}) == 1
                    else np.asarray(v) if schema[k] == "scalar"
                    else v)
                for k, v in out.items()}

    @staticmethod
    def read_as_xshards(path: str, num_shards: Optional[int] = None):
        """reference ``read_as_tf``/``read_as_torch`` role: a partitioned
        dataset feeding workers."""
        from zoo_tpu_torch.orca.data.shard import LocalXShards

        arrays = ParquetDataset.read_as_arrays(path)
        return LocalXShards.partition(arrays, num_shards=num_shards)

    @staticmethod
    def read_batched(path: str, batch_size: int = 32,
                     columns: Optional[List[str]] = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Streaming batches straight off the parquet blocks (the input-
        pipeline form; wrap with DoubleBufferedIterator to stage ahead)."""
        pq = _need("pyarrow.parquet")

        meta = ParquetDataset._meta(path)
        schema = meta["schema"]
        dtypes = meta.get("dtypes", {})
        want = columns or list(schema)
        parts = sorted(f for f in os.listdir(path)
                       if f.endswith(".parquet"))
        buf: Dict[str, List] = {k: [] for k in want}
        for part in parts:
            table = pq.read_table(os.path.join(path, part))
            cols = {name: (_ndarray_rows(
                table, name, np.dtype(dtypes.get(name, "float32")))
                if schema[name] == "ndarray" else table[name].to_pylist())
                for name in want}
            n = table.num_rows
            for i in range(n):
                for name in want:
                    buf[name].append(cols[name][i])
                if len(buf[want[0]]) == batch_size:
                    yield {k: np.stack(v) if schema[k] == "ndarray"
                           else np.asarray(v) for k, v in buf.items()}
                    buf = {k: [] for k in want}
        if buf[want[0]]:
            yield {k: np.stack(v) if schema[k] == "ndarray"
                   else np.asarray(v) for k, v in buf.items()}


def write_from_directory(directory: str, label_map: Dict[str, int],
                         output_path: str, shuffle: bool = True,
                         seed: int = 0, **kwargs):
    """Image folder (``dir/<class>/*.jpg``) → parquet of (image bytes,
    label, origin) — reference ``write_from_directory``."""
    records = []
    for cls, label in sorted(label_map.items()):
        cdir = os.path.join(directory, cls)
        for fname in sorted(os.listdir(cdir)):
            records.append((os.path.join(cdir, fname), label))
    if shuffle:
        np.random.RandomState(seed).shuffle(records)

    def gen():
        for fpath, label in records:
            with open(fpath, "rb") as f:
                yield {"image": f.read(), "label": label, "origin": fpath}

    ParquetDataset.write(output_path, gen(),
                         {"image": "image", "label": "scalar",
                          "origin": "scalar"}, **kwargs)


def write_ndarrays(images: np.ndarray, labels: np.ndarray,
                   output_path: str, **kwargs):
    """reference ``_write_ndarrays`` (the mnist path)."""
    def gen():
        for img, lab in zip(images, labels):
            yield {"image": np.asarray(img, np.float32),
                   "label": int(lab)}

    ParquetDataset.write(output_path, gen(),
                         {"image": "ndarray", "label": "scalar"}, **kwargs)


def write_parquet(format: str, output_path: str, *args, **kwargs):
    """reference ``orca/data/image/parquet_dataset.py`` ``write_parquet``
    — format-dispatching writer ("ndarray" arrays, "image_folder" a
    class-subdir tree)."""
    if format in ("ndarray", "ndarrays"):
        return write_ndarrays(*args, output_path=output_path, **kwargs)
    if format in ("image_folder", "voc", "directory"):
        return write_from_directory(*args, output_path=output_path,
                                    **kwargs)
    raise ValueError(f"unknown format {format!r}; use 'ndarray' or "
                     "'image_folder'")


def read_parquet(format: str, path: str, **kwargs):
    """reference ``read_parquet`` — "tf"/"torch" loaders collapse onto
    the framework-neutral array/batched readers here."""
    if format in ("arrays", "numpy"):
        return ParquetDataset.read_as_arrays(path)
    if format == "batched":
        return ParquetDataset.read_batched(path, **kwargs)
    if format in ("xshards", "shards"):
        return ParquetDataset.read_as_xshards(path, **kwargs)
    if format in ("tf", "torch"):
        # the reference returns tf.data / torch datasets; the rebuild's
        # estimators consume arrays or XShards directly
        return ParquetDataset.read_as_arrays(path)
    raise ValueError(f"unknown format {format!r}")
