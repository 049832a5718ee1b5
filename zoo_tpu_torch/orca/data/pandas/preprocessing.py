"""Readers producing XShards of pandas DataFrames (counterpart of
``zoo_tpu/orca/data/pandas/preprocessing.py``): ``read_csv``,
``read_json`` and ``read_parquet``. The files are read in a thread pool
sized by the runtime context's ``cores``; ``OrcaContext.
pandas_read_backend`` picks pandas' or pyarrow's csv parser, and
``OrcaContext.shard_size`` the rows per shard.

Each reader imports pandas (and the arrow backend and ``read_parquet``
pyarrow) when it runs; without the package it raises, naming it. The
machine with the card has neither: there, build XShards from numpy with
``XShards.partition``.
"""

from __future__ import annotations

import importlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from zoo_tpu_torch.common.context import ZooContext
from zoo_tpu_torch.orca.data.file import list_files
from zoo_tpu_torch.orca.data.shard import LocalXShards, _pool_size


def _need(module: str, what: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{what} needs the {module.split('.')[0]} package, which is not "
            "installed here; build XShards from numpy arrays with "
            "XShards.partition instead") from e


def _read_one_csv(path: str, **kwargs):
    if ZooContext.pandas_read_backend == "arrow":
        pacsv = _need("pyarrow.csv", "read_csv's arrow backend")
        # the common pandas kwargs, mapped onto pyarrow
        opts = {}
        if "names" in kwargs:
            opts["column_names"] = kwargs["names"]
        if kwargs.get("header", "infer") is None and "names" not in kwargs:
            opts["autogenerate_column_names"] = True
        ropt = pacsv.ReadOptions(**opts)
        popt = pacsv.ParseOptions(delimiter=kwargs.get("sep", ","))
        df = pacsv.read_csv(path, read_options=ropt,
                            parse_options=popt).to_pandas()
        if "usecols" in kwargs:
            df = df[list(kwargs["usecols"])]
        if "dtype" in kwargs:
            df = df.astype(kwargs["dtype"])
        return df
    return _need("pandas", "read_csv").read_csv(path, **kwargs)


def _read_one_json(path: str, **kwargs):
    return _need("pandas", "read_json").read_json(path, **kwargs)


def _read_one_parquet(path, **kwargs):
    _need("pyarrow", "read_parquet")
    return _need("pandas", "read_parquet").read_parquet(path, **kwargs)


def _read_files(paths: List[str], reader, num_shards: Optional[int], **kwargs
                ) -> LocalXShards:
    if not paths:
        raise FileNotFoundError("no input files found")
    with ThreadPoolExecutor(max_workers=_pool_size()) as pool:
        dfs = list(pool.map(lambda p: reader(p, **kwargs), paths))
    shards = LocalXShards(dfs)
    if ZooContext.shard_size:  # rows-per-shard flag wins over num_shards
        total = sum(len(d) for d in dfs)
        nparts = max(1, -(-total // ZooContext.shard_size))
        return shards.repartition(nparts)
    if num_shards and num_shards != shards.num_partitions():
        return shards.repartition(num_shards)
    return shards


def read_csv(file_path: str, num_shards: Optional[int] = None, **kwargs
             ) -> LocalXShards:
    """csv file(s), a folder or a glob as an XShards of DataFrames;
    extra kwargs pass through to the parser."""
    return _read_files(list_files(file_path), _read_one_csv, num_shards,
                       **kwargs)


def read_json(file_path: str, num_shards: Optional[int] = None, **kwargs
              ) -> LocalXShards:
    """json file(s) as an XShards of DataFrames."""
    return _read_files(list_files(file_path), _read_one_json, num_shards,
                       **kwargs)


def read_parquet(file_path: str, num_shards: Optional[int] = None,
                 **kwargs) -> LocalXShards:
    """parquet file(s) or a folder as an XShards of DataFrames."""
    files = [f for f in list_files(file_path) if f.endswith(".parquet")]
    if not files:  # a single file given directly, whatever its suffix
        files = [file_path]
    return _read_files(files, _read_one_parquet, num_shards, **kwargs)
