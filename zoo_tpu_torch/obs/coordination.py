"""The ``torch.distributed`` key-value store, in one place (counterpart
of ``zoo_tpu/obs/coordination.py``, which reaches the JAX coordination
service).

Present whenever a default process group is initialised — exactly the
multi-process case. The obs control planes (trace-id propagation,
snapshot aggregation) ride the c10d store rather than device
collectives: its ``set``/``wait``/``get`` work on every backend (gloo
included) and its waits carry timeouts, so a dead peer becomes a raised
error instead of an eternal barrier.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["coordination_store", "process_topology"]


def process_topology() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) when
    none is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def coordination_store():
    """The default process group's store, or None outside an initialised
    multi-process group (callers raise their own, context-specific
    error)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    try:
        return dist.distributed_c10d._get_default_store()
    except Exception:  # pragma: no cover - c10d internals moved
        return None


def store_get(store, key: str, timeout_s: float) -> Optional[str]:
    """Block until ``key`` is set (at most ``timeout_s``) and return its
    value as text; raises on timeout."""
    import datetime

    store.wait([key], datetime.timedelta(seconds=float(timeout_s)))
    raw = store.get(key)
    return raw.decode() if isinstance(raw, bytes) else raw
