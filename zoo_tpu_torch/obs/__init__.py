"""zoo_tpu_torch.obs — telemetry of the port: metrics, traces, the
flight recorder, the SLO watchdog, exporters and the cluster view
(counterpart of ``zoo_tpu/obs/__init__.py``, the same ``__all__``).

* :mod:`zoo_tpu_torch.obs.metrics`   — process-global Counters / Gauges /
  Histograms with labels; near-zero cost when disabled.
* :mod:`zoo_tpu_torch.obs.tracing`   — ``span("name", **attrs)`` JSONL
  trace events, request trace ids over the wire, cross-host trace ids
  over the ``torch.distributed`` store.
* :mod:`zoo_tpu_torch.obs.exporters` — loopback HTTP ``/metrics``,
  ``/healthz`` (with the SLO verdict), ``/cluster``; JSONL snapshots.
* :mod:`zoo_tpu_torch.obs.aggregate` — snapshots merged across the
  processes of a group into one cluster view.
* :mod:`zoo_tpu_torch.obs.timeline`  — per-process trace files joined
  by request trace id into one timeline.
* :mod:`zoo_tpu_torch.obs.flight`    — the crash flight recorder: a
  bounded ring of recent events, spilled to disk, dumped as a
  postmortem bundle (served live as ``op=debug_dump``).
* :mod:`zoo_tpu_torch.obs.slo`       — the SLO watchdog: rolling-window
  burn rates over the registry.
* :mod:`zoo_tpu_torch.obs.catalog`   — every declared family and event
  kind.
"""

# metrics must import first: the other submodules (and every instrumented
# module of the package) depend on it
from zoo_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StatTimer,
    counter,
    gauge,
    get_registry,
    histogram,
)
from zoo_tpu_torch.obs.tracing import (  # noqa: F401
    TRACE_DIR_ENV,
    ambient_trace_id,
    current_span_id,
    current_trace_id,
    emit_event,
    emit_span,
    new_trace_id,
    read_trace,
    set_trace_id,
    share_trace_id,
    span,
    stop_tracing,
    trace_context,
    trace_to,
    tracing_enabled,
)
from zoo_tpu_torch.obs.exporters import (  # noqa: F401
    MetricsExporter,
    start_snapshot_thread,
    validate_prometheus_text,
    write_snapshot,
)
from zoo_tpu_torch.obs.aggregate import (  # noqa: F401
    aggregate_cluster,
    last_cluster_view,
    merge_snapshots,
)
from zoo_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    dump_bundle,
    flight_recorder,
    install_crash_handlers,
    record_event,
)
from zoo_tpu_torch.obs.slo import SLORule, SLOWatchdog  # noqa: F401
from zoo_tpu_torch.obs.slo import last_status as slo_last_status  # noqa: F401
from zoo_tpu_torch.obs.timeline import (  # noqa: F401
    build_timeline,
    merge_timeline,
    to_chrome_trace,
)

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "StatTimer", "counter", "gauge", "get_registry", "histogram",
    "TRACE_DIR_ENV", "current_trace_id", "read_trace", "set_trace_id",
    "share_trace_id", "span", "stop_tracing", "trace_to", "tracing_enabled",
    "trace_context", "ambient_trace_id", "current_span_id",
    "new_trace_id", "emit_span", "emit_event",
    "MetricsExporter", "start_snapshot_thread", "validate_prometheus_text",
    "write_snapshot",
    "aggregate_cluster", "last_cluster_view", "merge_snapshots",
    "FlightRecorder", "flight_recorder", "record_event", "dump_bundle",
    "install_crash_handlers",
    "SLORule", "SLOWatchdog", "slo_last_status",
    "build_timeline", "merge_timeline", "to_chrome_trace",
]
