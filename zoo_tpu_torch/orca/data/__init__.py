"""The shard core of the data plane (counterpart of
``zoo_tpu/orca/data/__init__.py``): ``XShards`` and ``LocalXShards``;
the readers are in :mod:`zoo_tpu_torch.orca.data.pandas`. The
exchange plane, the ingest pipelines and ``SharedValue`` are ROADMAP
A.15."""

from zoo_tpu_torch.orca.data.shard import LocalXShards, XShards

__all__ = ["XShards", "LocalXShards"]
