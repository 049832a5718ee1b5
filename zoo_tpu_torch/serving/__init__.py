"""Serving stacks of the port: the TCP predict door and its HA client
and replica group, the LLM engine, and Cluster Serving (the Redis
stream job, its HTTP front end, the embedded RESP server and the queue
clients)."""

from zoo_tpu_torch.serving.client import InputQueue, OutputQueue  # noqa: F401
from zoo_tpu_torch.serving.cluster_serving import (  # noqa: F401
    ClusterServing,
    FrontEnd,
)
from zoo_tpu_torch.serving.redis_embedded import EmbeddedRedis  # noqa: F401

__all__ = ["InputQueue", "OutputQueue", "ClusterServing", "FrontEnd",
           "EmbeddedRedis"]
