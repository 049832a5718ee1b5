"""The data plane (counterpart of ``zoo_tpu/orca/data/__init__.py``):
``XShards`` and ``LocalXShards``, the staged ingest pipelines
(:mod:`~zoo_tpu_torch.orca.data.ingest`) and ``SharedValue``; the
readers are in :mod:`zoo_tpu_torch.orca.data.pandas`,
:mod:`~zoo_tpu_torch.orca.data.tfrecord` and
:mod:`~zoo_tpu_torch.orca.data.parquet_dataset`. The shard exchange
(``rebalance_shards``, ``fetch_many``, ``iter_fetch``,
``ExchangeConfig``) is ROADMAP A.15 item 9 and raises, naming it."""

from zoo_tpu_torch.orca.data.ingest import (
    ReadaheadController,
    async_device_ingest,
    staged_pipeline,
)
from zoo_tpu_torch.orca.data.shard import LocalXShards, XShards


class SharedValue:
    """The reference's ``SharedValue``: a broadcast handle (a Spark
    Broadcast there). One process here: it carries ``.value``."""

    def __init__(self, value=None):
        self.value = value


def _exchange_not_ported(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the shard exchange (orca/data/plane.py) is not "
            "ported to zoo_tpu_torch yet (ROADMAP A.15 item 9)")
    refuse.__name__ = refuse.__qualname__ = name
    return refuse


rebalance_shards = _exchange_not_ported("rebalance_shards")
fetch_many = _exchange_not_ported("fetch_many")
iter_fetch = _exchange_not_ported("iter_fetch")
ExchangeConfig = _exchange_not_ported("ExchangeConfig")

__all__ = ["XShards", "LocalXShards", "rebalance_shards", "fetch_many",
           "iter_fetch", "ExchangeConfig", "ReadaheadController",
           "staged_pipeline", "async_device_ingest", "SharedValue"]
