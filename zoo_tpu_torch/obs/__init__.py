"""Observability of the port: the metrics registry (spans, the flight
ring and the exporters come with ROADMAP A.6)."""
