"""Multihost metric aggregation over the ``torch.distributed`` store
(counterpart of ``zoo_tpu/obs/aggregate.py``, which rides the JAX
coordination service).

Workers publish registry snapshots into the default process group's
key-value store (it works on every backend and its waits carry
timeouts, so a dead peer becomes a raised error, not an eternal
barrier). The merge semantics:

* counters   — **summed** across processes (total retries, total bytes);
* gauges     — **max and min** across processes (the cluster's worst and
  best queue depth / heartbeat age — a cluster-wide *sum* of a gauge is
  rarely meaningful);
* histograms — **bucket-merged** count-by-count (every registry uses the
  same fixed bucket bounds per family, so per-worker distributions add
  exactly; a bounds mismatch falls back to merging ``sum``/``count``).

:func:`aggregate_cluster` is collective — every process calls it, every
process gets the merged cluster view back (the coordinator's view is the
same dict; a symmetric gather keeps the API barrier-shaped).
Single-process: merges just the local snapshot, so the call sites need
no topology branch.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from zoo_tpu_torch.obs.coordination import (
    coordination_store,
    process_topology,
    store_get,
)
from zoo_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = ["merge_snapshots", "aggregate_cluster", "last_cluster_view"]

logger = logging.getLogger(__name__)

_agg_generation = 0
_agg_gen_lock = threading.Lock()
_last_view: Optional[Dict] = None


def _series_key(entry: Dict) -> Tuple:
    return (entry["name"], tuple(sorted(entry.get("labels", {}).items())))


def merge_snapshots(snaps: List[Dict]) -> Dict:
    """Merge per-process registry snapshots into one cluster view."""
    counters: Dict[Tuple, Dict] = {}
    gauges: Dict[Tuple, Dict] = {}
    hists: Dict[Tuple, Dict] = {}
    for snap in snaps:
        for e in snap.get("counters", []):
            k = _series_key(e)
            cur = counters.get(k)
            if cur is None:
                counters[k] = {"name": e["name"],
                               "labels": dict(e.get("labels", {})),
                               "value": float(e["value"])}
            else:
                cur["value"] += float(e["value"])
        for e in snap.get("gauges", []):
            k = _series_key(e)
            v = float(e["value"])
            cur = gauges.get(k)
            if cur is None:
                gauges[k] = {"name": e["name"],
                             "labels": dict(e.get("labels", {})),
                             "max": v, "min": v}
            else:
                cur["max"] = max(cur["max"], v)
                cur["min"] = min(cur["min"], v)
        for e in snap.get("histograms", []):
            k = _series_key(e)
            cur = hists.get(k)
            if cur is None:
                hists[k] = {"name": e["name"],
                            "labels": dict(e.get("labels", {})),
                            "bounds": list(e["bounds"]),
                            "counts": list(e["counts"]),
                            "sum": float(e["sum"]),
                            "count": int(e["count"])}
            elif cur["bounds"] == list(e["bounds"]):
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], e["counts"])]
                cur["sum"] += float(e["sum"])
                cur["count"] += int(e["count"])
            else:  # drifted bounds (version skew): totals still add
                logger.warning(
                    "histogram %s: bucket bounds differ across hosts; "
                    "merging sum/count only", e["name"])
                cur["sum"] += float(e["sum"])
                cur["count"] += int(e["count"])
    return {"processes": len(snaps),
            "counters": list(counters.values()),
            "gauges": list(gauges.values()),
            "histograms": list(hists.values())}


def aggregate_cluster(registry: Optional[MetricsRegistry] = None,
                      timeout_s: float = 30.0) -> Dict:
    """Collective: publish this process's snapshot, gather every peer's,
    return the merged cluster view (identical on all processes). A peer
    that never publishes times out within ``timeout_s`` on every waiter.

    The result is cached for :meth:`MetricsExporter.set_cluster_view` /
    :func:`last_cluster_view`, so a scrape of the coordinator's
    ``/cluster`` endpoint shows the latest aggregation."""
    global _last_view
    registry = registry or get_registry()
    own = registry.snapshot()
    rank, nprocs = process_topology()
    if nprocs == 1:
        merged = merge_snapshots([own])
        _last_view = merged
        return merged
    store = coordination_store()
    if store is None:
        raise RuntimeError(
            "aggregate_cluster needs the torch.distributed default store "
            "(init_process_group) in multi-process mode")
    global _agg_generation
    with _agg_gen_lock:
        _agg_generation += 1
        gen = _agg_generation
    prefix = f"zoo:obs:agg:{gen}:"
    store.set(prefix + str(rank), json.dumps(own, separators=(",", ":")))
    deadline = time.monotonic() + timeout_s
    snaps = []
    for p in range(nprocs):
        left = max(1.0, deadline - time.monotonic())
        try:
            raw = store_get(store, prefix + str(p), left)
        except Exception as e:
            raise TimeoutError(
                f"host {p} never published its metrics snapshot within "
                f"{timeout_s:.0f}s (crashed or hung peer): {e}") from e
        snaps.append(json.loads(raw))
    merged = merge_snapshots(snaps)
    _last_view = merged
    return merged


def last_cluster_view() -> Optional[Dict]:
    """The most recent :func:`aggregate_cluster` result in this process
    (None before the first aggregation)."""
    return _last_view
