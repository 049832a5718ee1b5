"""Exporters: Prometheus HTTP endpoint, health probe, JSONL snapshots
(counterpart of ``zoo_tpu/obs/exporters.py``).

:class:`MetricsExporter` binds a loopback HTTP server (ephemeral port by
default) serving:

* ``GET /metrics``  — the registry in Prometheus text format 0.0.4;
* ``GET /healthz``  — liveness JSON; reuses the resilience layer's
  heartbeat file (``$ZOO_HEARTBEAT_FILE``): a stale heartbeat turns the
  probe 503 so an external supervisor sees a hung process exactly like
  ``ProcessMonitor`` does; the body also names the seat's role
  (``ZOO_LLM_ROLE``).

The SLO watchdog's verdict that the JAX package adds to ``/healthz``,
its ``/cluster`` view and the periodic snapshot thread come with
ROADMAP A.6. Loopback by default: there is no authentication on these
endpoints. :func:`write_snapshot` appends one JSON line per call to a
snapshot file (the drain's metrics flush).
``validate_prometheus_text`` is a line-grammar + histogram-consistency
check of one exposition payload.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from zoo_tpu_torch.common.knobs import value as _knob_value
from zoo_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = ["MetricsExporter", "write_snapshot", "validate_prometheus_text"]

logger = logging.getLogger(__name__)


def _heartbeat_health(stale_after: Optional[float]) -> Dict:
    """Liveness verdict from the resilience heartbeat file, when one is
    configured; a process with no heartbeat file is healthy by virtue of
    answering at all. Imported lazily — resilience imports our metrics
    module, so a top-level import here would be a cycle."""
    from zoo_tpu_torch.util.resilience import (
        HEARTBEAT_FILE_ENV,
        HEARTBEAT_INTERVAL_ENV,
        heartbeat_age,
    )

    path = os.environ.get(HEARTBEAT_FILE_ENV)
    if not path:
        return {"ok": True, "heartbeat": None}
    age = heartbeat_age(path)
    if stale_after is None:
        interval = float(os.environ.get(HEARTBEAT_INTERVAL_ENV, "1.0"))
        stale_after = max(10.0, 3.0 * interval)
    if age is None:  # not stamped yet: booting, not hung
        return {"ok": True, "heartbeat": None, "stale_after": stale_after}
    return {"ok": age <= stale_after, "heartbeat_age": age,
            "stale_after": stale_after}


class MetricsExporter:
    """``MetricsExporter().start()`` → scrape ``/metrics`` until
    ``stop()``. Serves the process-global registry unless another one is
    passed."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 healthz_stale_after: Optional[float] = None):
        self.registry = registry or get_registry()
        self._stale_after = healthz_stale_after
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = outer.registry.render_prometheus().encode()
                    self._reply(200, body,
                                "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    try:
                        health = _heartbeat_health(outer._stale_after)
                    except Exception as e:  # noqa: BLE001 — probe, not crash
                        health = {"ok": False, "error": repr(e)}
                    # disaggregation role (ZOO_LLM_ROLE — the knob a
                    # ReplicaGroup injects per seat): external probes
                    # and routing see the pool topology on the same
                    # door that says the seat is alive
                    try:
                        health["role"] = _knob_value("ZOO_LLM_ROLE")
                    except Exception:  # noqa: BLE001 — probe, not crash
                        pass
                    self._reply(200 if health.get("ok") else 503,
                                json.dumps(health).encode(),
                                "application/json")
                else:
                    self._reply(404, b"not found", "text/plain")

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # scrapes are not stderr news
                logger.debug("exporter: " + fmt, *args)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="zoo-metrics-exporter")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


# ------------------------------------------------------- JSONL snapshots

def write_snapshot(path: str, registry: Optional[MetricsRegistry] = None,
                   extra: Optional[Dict] = None) -> Dict:
    """Append one JSON line — ``{ts, host, pid, metrics}`` — to ``path``
    and return the record. The offline sibling of ``/metrics``: grep-able
    history instead of a live scrape."""
    registry = registry or get_registry()
    rec = {"ts": time.time(), "host": socket.gethostname(),
           "pid": os.getpid(), "metrics": registry.snapshot()}
    if extra:
        rec["extra"] = extra
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec, separators=(",", ":"), default=str) + "\n")
    return rec


# ---------------------------------------------- text-format validation

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{((?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*)\})?'
    r' (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|\+Inf|NaN)$')
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) .*$")
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|histogram|summary|untyped)$")
_HIST_SUFFIX = re.compile(r"_(bucket|sum|count)$")


def validate_prometheus_text(text: str) -> List[str]:
    """Syntax + histogram-consistency check of one exposition payload.
    Returns a list of human-readable problems (empty = valid)."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    buckets: Dict[str, List[float]] = {}  # series key -> cumulative counts
    counts: Dict[str, float] = {}
    if text and not text.endswith("\n"):
        errors.append("payload must end with a newline")
    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            if _HELP_RE.match(line) or _TYPE_RE.match(line):
                m = _TYPE_RE.match(line)
                if m:
                    if m.group(1) in types:
                        errors.append(
                            f"line {i}: duplicate TYPE for {m.group(1)}")
                    types[m.group(1)] = m.group(2)
            elif line.startswith(("# HELP", "# TYPE")):
                errors.append(f"line {i}: malformed comment: {line!r}")
            continue  # other comments are legal free text
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {i}: malformed sample: {line!r}")
            continue
        name = m.group(1)
        base = _HIST_SUFFIX.sub("", name)
        family = name if name in types else base
        if family not in types:
            errors.append(f"line {i}: sample {name} has no # TYPE line")
            continue
        if types[family] == "histogram":
            labels = m.group(3) or ""
            key = base + "{" + \
                re.sub(r'le="[^"]*",?', "", labels).strip(",") + "}"
            val = float(m.group(4).replace("+Inf", "inf"))
            if name.endswith("_bucket"):
                le = re.search(r'le="([^"]*)"', labels)
                if not le:
                    errors.append(f"line {i}: histogram bucket without le")
                    continue
                buckets.setdefault(key, []).append(val)
                if le.group(1) == "+Inf":
                    counts["inf:" + key] = val
            elif name.endswith("_count"):
                counts["count:" + key] = val
    for key, series in buckets.items():
        if series != sorted(series):
            errors.append(
                f"{key}: bucket counts are not cumulative: {series}")
        if "inf:" + key not in counts:
            errors.append(f"{key}: histogram is missing the +Inf bucket")
        elif counts.get("count:" + key) != counts["inf:" + key]:
            errors.append(
                f"{key}: _count ({counts.get('count:' + key)}) != +Inf "
                f"bucket ({counts['inf:' + key]})")
    return errors
