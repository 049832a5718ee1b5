"""Observability of the port: the metrics registry and the exporters
(``/metrics``, ``/healthz``, JSONL snapshots); spans, the flight ring
and the SLO watchdog come with ROADMAP A.6."""
