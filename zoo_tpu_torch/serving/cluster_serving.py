"""Cluster Serving: Redis stream -> micro-batch -> model -> Redis hash
(own copy of ``zoo_tpu/serving/cluster_serving.py``).

:class:`ClusterServing` is the serving job: a consumer thread
XREADGROUPs up to ``batch_size`` records of ``serving_stream`` (waiting
at most ``batch_wait_ms`` for the first), decodes each record's Arrow
payload, stacks the batch and runs the model's ``predict`` (the port's
``InferenceModel``, on the card unless it was loaded elsewhere), then
HSETs each result under ``cluster-serving_<stream>:<uri>``. Stage
timers ``decode``, ``inference`` and ``encode`` time each batch.

The NaN contract is the reference's: a batch whose ``predict`` raises
(ragged shapes, a bad record) is retried one record at a time, and a
record that fails again is answered ``"NaN"``; a record whose payload
does not decode is answered ``"NaN"`` without costing the rest of its
batch. Neither is silent: ``metrics()`` counts the batches that fell
back (``fallback_batches``), the records retried alone
(``fallback_records``) and the ``"NaN"`` replies (``nan_records``), so
a kernel fault cannot hide behind a reply.

:class:`FrontEnd` is the HTTP door: ``POST /predict`` with ``{"instances":
[...]}`` (each instance through the queue), ``GET /metrics`` (the job's
``metrics()``) and ``GET /``. It adopts ``X-Zoo-Trace`` /
``X-Zoo-Parent-Span`` for a ``http.predict`` span, charges
``X-Zoo-Tenant`` to its token bucket (429 when dry), enforces
``X-Zoo-Deadline-Ms`` before each instance (504 once expired), and
echoes the trace and tenant on every reply, as the JAX door does.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from zoo_tpu_torch.obs.metrics import StatTimer as StageTimer
from zoo_tpu_torch.obs.tracing import emit_span, trace_context
from zoo_tpu_torch.serving.client import (
    RESULT_PREFIX,
    decode_input_b64,
    encode_ndarray_b64,
)
from zoo_tpu_torch.serving.resp import RedisClient, RedisError
from zoo_tpu_torch.serving.server import _deadline_expired, _tenant_shed
from zoo_tpu_torch.serving.tenancy import registry as tenant_registry
from zoo_tpu_torch.util.resilience import Deadline

logger = logging.getLogger(__name__)


class ClusterServing:
    """The serving job's consumer loop."""

    def __init__(self, model, redis_host: str = "localhost",
                 redis_port: int = 6379, stream: str = "serving_stream",
                 batch_size: int = 8, batch_wait_ms: int = 5):
        self.model = model
        self.stream = stream
        self.batch_size = batch_size
        self.batch_wait_ms = batch_wait_ms
        self.db = RedisClient(redis_host, redis_port)
        try:
            self.db.xgroup_create(stream, "serving", "0")
        except RedisError:
            pass
        self.timers = {name: StageTimer()
                       for name in ("decode", "inference", "encode")}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.records_out = 0
        self.batches = 0
        self.fallback_batches = 0
        self.fallback_records = 0
        self.nan_records = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ClusterServing":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop after the batch in flight (joins the consumer)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -- the job ----------------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            try:
                resp = self.db.xreadgroup("serving", "worker-0", self.stream,
                                          count=self.batch_size,
                                          block_ms=self.batch_wait_ms)
                if not resp:
                    continue
                entries = resp[0][1]
                self._handle_batch(entries)
                self.db.xack(self.stream, "serving",
                             *[eid for eid, _ in entries])
            except ConnectionError:
                return  # redis gone: stop the worker
            except Exception as e:  # noqa: BLE001 — keep serving
                logger.exception("serving batch failed: %s", e)
                time.sleep(0.05)

    def _handle_batch(self, entries):
        t0 = time.perf_counter()
        uris, inputs = [], []
        for _eid, flat in entries:
            kv = {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}
            uris.append(kv[b"uri"].decode())
            try:
                inputs.append(decode_input_b64(kv[b"data"].decode()))
            except Exception as e:  # noqa: BLE001 — NaN contract
                logger.warning("record %s does not decode: %r",
                               uris[-1], e)
                inputs.append(None)
        self.timers["decode"].record(time.perf_counter() - t0)

        t0 = time.perf_counter()
        good = [d for d in inputs if d is not None]
        outs = [None] * len(inputs)
        if good:
            try:
                keys = list(good[0].keys())
                batched = [np.stack([d[k] for d in good]) for k in keys]
                preds = iter(self.model.predict(
                    batched if len(batched) > 1 else batched[0],
                    batch_size=max(self.batch_size, len(good))))
                outs = [None if d is None else next(preds) for d in inputs]
            except Exception:  # noqa: BLE001 — per-record fallback
                self.fallback_batches += 1
                outs = [None if d is None else self._predict_one(d)
                        for d in inputs]
        self.timers["inference"].record(time.perf_counter() - t0)

        t0 = time.perf_counter()
        vals = ["NaN" if out is None else encode_ndarray_b64(out)
                for out in outs]
        # counted before any reply is visible, so a client that reads its
        # reply and then metrics() finds its record and batch counted
        self.nan_records += sum(out is None for out in outs)
        self.records_out += len(vals)
        self.batches += 1
        for uri, val in zip(uris, vals):
            self.db.hset(RESULT_PREFIX + self.stream + ":" + uri,
                         {"value": val})
        self.timers["encode"].record(time.perf_counter() - t0)

    def _predict_one(self, d):
        """One record at batch 1 (the fallback); ``None`` if it fails."""
        self.fallback_records += 1
        try:
            arrs = list(d.values())
            return self.model.predict(
                [a[None] for a in arrs] if len(arrs) > 1 else arrs[0][None],
                batch_size=1)[0]
        except Exception:  # noqa: BLE001 — NaN contract
            return None

    def metrics(self) -> Dict:
        out = {"records_out": self.records_out, "batches": self.batches,
               "fallback_batches": self.fallback_batches,
               "fallback_records": self.fallback_records,
               "nan_records": self.nan_records}
        for name, t in self.timers.items():
            out[name] = t.stats()
        return out


class FrontEnd:
    """HTTP front end: ``POST /predict`` with ``{"instances": [...]}``,
    ``GET /metrics`` and ``GET /``."""

    def __init__(self, serving: ClusterServing, input_queue,
                 host: str = "127.0.0.1", port: int = 0):
        self.serving = serving
        self.iq = input_queue
        front = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                self._trace = None  # never echo a prior POST's trace
                self._tenant = None
                if self.path.rstrip("/") in ("", "/"):
                    self._reply(200, {"status": "ok"})
                elif self.path.startswith("/metrics"):
                    self._reply(200, front.serving.metrics())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                self._trace = self.headers.get("X-Zoo-Trace")
                self._tenant = self.headers.get("X-Zoo-Tenant")
                if not self.path.startswith("/predict"):
                    self._reply(404, {"error": "not found"})
                    return
                pspan = self.headers.get("X-Zoo-Parent-Span")
                with trace_context(self._trace, pspan):
                    t0 = time.time()
                    code, obj = self._predict()
                    if self._trace is not None:
                        # written before the reply: a caller that stops
                        # tracing once it holds its reply finds the span
                        emit_span("http.predict", t0,
                                  time.time() - t0, trace=self._trace,
                                  parent=pspan)
                self._reply(code, obj)

            def _predict(self):
                """(status, body) of a ``/predict``: the remaining
                budget arrives as a header and is enforced before each
                instance (expired work is dropped at the door, and a
                mid-request expiry stops the instances left); the tenant
                is charged before any instance runs."""
                dl_ms = self.headers.get("X-Zoo-Deadline-Ms")
                try:
                    dl = Deadline.from_ms(float(dl_ms)) \
                        if dl_ms is not None else None
                except ValueError:
                    return 400, {"error": "malformed X-Zoo-Deadline-Ms"}
                reg = tenant_registry()
                if reg.enabled:
                    ok, hint = reg.admit(self._tenant)
                    if not ok:
                        _tenant_shed.labels(
                            tenant=self._tenant or "default",
                            reason="rate").inc()
                        return 429, {"error": "tenant rate limited",
                                     "shed": True, "retryable": True,
                                     "reason": "rate",
                                     "retry_after_ms": hint}
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode()
                try:
                    instances = json.loads(body)["instances"]
                except Exception:  # noqa: BLE001 — any malformed body
                    return 400, {"error": "expected {\"instances\": [...]}"}
                preds = []
                for inst in instances:
                    if dl is not None and dl.expired():
                        _deadline_expired.labels(stage="http").inc()
                        return 504, {"error": "deadline expired",
                                     "expired": True,
                                     "completed": len(preds)}
                    data = {k: np.asarray(v, np.float32)
                            for k, v in inst.items()}
                    out = front.iq.predict(data)
                    if isinstance(out, str):
                        preds.append(out)
                    else:
                        preds.append(json.dumps(
                            {"value": json.dumps(
                                {"data": np.asarray(out).flatten().tolist(),
                                 "shape": list(np.asarray(out).shape)})}))
                return 200, {"predictions": preds}

            def _reply(self, code, obj):
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                trace = getattr(self, "_trace", None)
                if trace is not None:
                    self.send_header("X-Zoo-Trace", trace)
                tenant = getattr(self, "_tenant", None)
                if tenant is not None:
                    self.send_header("X-Zoo-Tenant", tenant)
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FrontEnd":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop serving and close the listening socket."""
        self._httpd.shutdown()
        self._httpd.server_close()
