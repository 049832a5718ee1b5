"""The serving TCP door: micro-batching ``predict`` and the streaming
LLM ``generate`` op (counterpart of ``zoo_tpu/serving/server.py``).

A threaded TCP server accepts length-prefixed requests in the
non-executable codec (:mod:`zoo_tpu_torch.serving.codec` — JSON
structure plus raw array buffers, never pickle) and answers on the same
connection. The framing is byte for byte the JAX package's, CRC trailer
included, so a client of either package talks to a server of either.

What the door serves:

* ``predict`` — batcher threads micro-batch requests up to
  ``batch_size`` or ``max_wait_ms`` (capped by the tightest propagated
  deadline), pad every window with zeros to a whole multiple of
  ``batch_size`` so each occupancy runs the same shapes on the card,
  run the live model and route each row back; with request-id dedup,
  version pins, the load-shedding breaker, deadlines and a bounded
  queue at the door;
* ``reload`` — a zero-downtime hot-swap (load, verify and warm the new
  model beside the old one, then flip under the batcher's lock);
* ``generate`` (a stream of frames from a mounted
  :class:`~zoo_tpu_torch.serving.llm.engine.LLMEngine`), ``ping``,
  ``version``, ``stats`` (the stage timers) and ``llm_stats``;
* tenant admission (``tenancy``, ``ZOO_TENANT_CONFIG``): a request is
  charged to its tenant's token bucket before it reaches the queue, and
  a shed carries that bucket's own refill hint;
* disaggregation: a ``handoff: [host, port]`` generate prefills here,
  parks the KV and pushes it to the decode seat as ``kv_migrate``
  begin/block/commit frames before its terminal ``handoff`` frame; the
  decode seat stages the payload per connection and binds it when the
  matching generate arrives; a ``role=prefill`` seat sheds plain
  generates;

* ``debug_dump`` (the flight recorder's bundle, live) and ``chaos``
  (arm or clear a fault site in this process, refused unless
  ``ZOO_CHAOS_ALLOW`` is ``1`` or ``true``);

with TLS, the graceful drain and the ``_reply`` echo of id, trace,
tenant, version and role. Every request that carries a ``trace`` gets
its span under that id (``server.predict``, ``server.generate``; a shed
gets a ``server.shed`` event), a batch runs under ``serving.batch``,
and sheds, handoff aborts, dropped corrupt requests and the drain land
in the flight ring.

The server binds loopback by default; pass ``host="0.0.0.0"`` only on a
trusted network — there is no authentication on this door.
"""

from __future__ import annotations

import collections
import os
import queue
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.obs.flight import flight_recorder, record_event
from zoo_tpu_torch.obs.metrics import StatTimer, counter, gauge, histogram
from zoo_tpu_torch.obs.tracing import emit_event, emit_span, span
from zoo_tpu_torch.serving.tenancy import registry as tenant_registry
from zoo_tpu_torch.util.integrity import (
    corrupt_seam,
    frame_crc,
    verify_crc,
    wire_crc_enabled,
)
from zoo_tpu_torch.util.resilience import (
    CircuitBreaker,
    Deadline,
    FrameCorrupt,
    env_float,
    env_int,
    fault_point,
)

_queue_depth = gauge(
    "zoo_serving_queue_depth", "Predict requests waiting in the batcher "
    "queue of this process")
_batch_occupancy = histogram(
    "zoo_serving_batch_occupancy", "Requests per inference micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
_stage_seconds = histogram(
    "zoo_serving_stage_seconds",
    "Per-stage serving latency (batch assembly / inference / total "
    "round-trip)", labels=("stage",))
_requests = counter(
    "zoo_serving_requests_total", "Predict requests by outcome "
    "(ok / error / shed / expired)", labels=("outcome",))
_shed = counter(
    "zoo_serve_shed_total", "Requests rejected at the admission door, "
    "by cause (queue_full / breaker_open / draining)", labels=("reason",))
_deadline_expired = counter(
    "zoo_serve_deadline_expired_total",
    "Requests dropped because their propagated deadline expired, by the "
    "stage that caught it (admission / batch / reply / http)",
    labels=("stage",))
_dedup = counter(
    "zoo_serve_dedup_total", "Duplicate request ids absorbed without "
    "re-executing (inflight = joined a pending request, replay = served "
    "from the completed-request cache)", labels=("kind",))
_version_info = gauge(
    "zoo_registry_version_info",
    "Registry model version served by this replica (1 = current; a "
    "version flips to 0 when a reload swaps it out)", labels=("version",))
_reloads = counter(
    "zoo_serve_reload_total", "Hot-swap model reloads, by outcome "
    "(ok / failed — failed never flips, the old model keeps serving)",
    labels=("outcome",))
_drain_seconds = histogram(
    "zoo_serve_drain_seconds",
    "Graceful-drain wall time (raise the ZOO_SERVE_DRAIN_TIMEOUT_S "
    "budget when this nears it)")
# the predict door's per-tenant admission tallies (the same families
# the engine keeps for generate; the registry dedupes)
_tenant_admitted = counter(
    "zoo_tenant_admitted_total",
    "Requests admitted past the tenant token bucket, per tenant",
    labels=("tenant",))
_tenant_shed = counter(
    "zoo_tenant_shed_total",
    "Requests shed per tenant and reason (rate = the tenant's own "
    "token bucket ran dry, queue_full = the shared waiting queue was "
    "at bound, slots/kv = per-tenant quota)", labels=("tenant", "reason"))
# what the prefill seat pays to push a parked sequence's KV
_migrated_bytes = counter(
    "zoo_llm_kv_migrated_bytes_total",
    "KV cache bytes pushed to decode replicas over kv_migrate (int8 "
    "rows + scale planes; 0 for stateless-decodable models)")
_handoff_seconds = histogram(
    "zoo_llm_handoff_seconds",
    "Prefill-side kv_migrate push wall time (export + begin/block/"
    "commit round trip), successful pushes only",
    buckets=(.001, .005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5))

# what the port's door does not serve yet, and the ROADMAP item that
# brings it


def drain_timeout() -> float:
    """The graceful-drain budget (``ZOO_SERVE_DRAIN_TIMEOUT_S``, default
    30 s), shared by :meth:`ServingServer.drain` and
    :meth:`zoo_tpu_torch.serving.ha.ReplicaGroup.rolling_update`."""
    return env_float("ZOO_SERVE_DRAIN_TIMEOUT_S", 30.0)


# Frame layout: a u32 length word, then the ZSRV codec payload. When the
# length word's HIGH BIT is set, a u32 CRC of the payload follows it on
# the wire (the real length is the low 31 bits) — self-describing per
# frame, so a receiver needs no negotiation to VERIFY; negotiation (the
# client stamps ``crc: 1`` into a request, a CRC-capable server answers
# with a CRC-framed reply) only decides whether a sender may USE the bit.
_FRAME_CRC_BIT = 0x80000000


def _send_msg(sock: socket.socket, obj, crc: bool = False):
    from zoo_tpu_torch.serving.codec import dumps

    payload = dumps(obj)
    if not crc:
        sock.sendall(struct.pack(">I", len(payload)) + payload)
        return
    trailer = frame_crc(payload)
    # chaos seam: bit rot "in transit" — AFTER the CRC was computed, so
    # the receiver's verify catches it exactly like real corruption
    payload = corrupt_seam("serving.wire.corrupt", payload)
    sock.sendall(struct.pack(">I", _FRAME_CRC_BIT | len(payload))
                 + payload + struct.pack(">I", trailer))


def _recv_frame(sock: socket.socket):
    """One frame off the wire → ``(msg | None, frame_had_crc)``. A
    CRC-flagged frame whose trailer does not match its payload raises
    :class:`FrameCorrupt` — the bytes never reach the codec."""
    from zoo_tpu_torch.serving.codec import loads

    header = _recv_exact(sock, 4)
    if header is None:
        return None, False
    (word,) = struct.unpack(">I", header)
    has_crc = bool(word & _FRAME_CRC_BIT)
    body = _recv_exact(sock, word & ~_FRAME_CRC_BIT)
    if body is None:
        return None, has_crc
    if has_crc:
        trailer = _recv_exact(sock, 4)
        if trailer is None:
            return None, True
        verify_crc(body, struct.unpack(">I", trailer)[0], "serving")
    return loads(body), has_crc


def _recv_msg(sock: socket.socket):
    return _recv_frame(sock)[0]


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    # preallocate + recv_into: multi-MB array payloads would otherwise
    # pay quadratic bytes-concat
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            return None
        got += r
    return buf


class _Request:
    """One predict request between the door and a batcher, with its
    trace identity off the wire and its queue timing (the request
    span's queue wait)."""

    __slots__ = ("uri", "data", "event", "result", "error", "id",
                 "deadline", "expired", "version", "trace", "pspan",
                 "t_enqueue", "t_dequeue")

    def __init__(self, uri: str, data, rid: Optional[str] = None,
                 deadline: Optional[Deadline] = None,
                 trace: Optional[str] = None,
                 pspan: Optional[str] = None):
        self.uri = uri
        self.data = data
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.id = rid
        self.deadline = deadline
        self.expired = False
        self.trace = trace
        self.pspan = pspan
        self.t_enqueue: Optional[float] = None
        self.t_dequeue: Optional[float] = None
        # the version of the model that computed ``result``: the reply
        # echoes it, not the version live at reply time, which a
        # hot-swap may have moved on since the batch ran
        self.version: Optional[str] = None


class _DedupCache:
    """Request-id → :class:`_Request` LRU, the server half of idempotent
    retries/hedges: a duplicate id joins the pending request (or replays
    the finished one) instead of executing the model twice. Entries keep
    their result arrays until evicted, so the capacity knob
    (``ZOO_SERVE_DEDUP_CACHE``) bounds memory, not correctness — an
    evicted id simply re-executes, which is safe for a pure predict."""

    def __init__(self, capacity: int):
        self._cap = int(capacity)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _Request]" = \
            collections.OrderedDict()

    def get(self, rid: str) -> Optional[_Request]:
        with self._lock:
            req = self._entries.get(rid)
            if req is not None:
                self._entries.move_to_end(rid)
            return req

    def put(self, rid: str, req: _Request):
        with self._lock:
            self._entries[rid] = req
            self._entries.move_to_end(rid)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)


class ServingServer:
    """``ServingServer(inference_model).start()`` → serve until
    ``stop()``; ``ServingServer(None, llm_engine=engine)`` serves the
    streaming ``generate`` op only.

    The JAX package's signature. ``num_replicas`` batcher threads drain
    one shared request queue; ``models=[...]`` gives each its own model
    copy, else they share ``model`` (bounded by its
    ``supported_concurrent_num``). ``tenancy``: the
    :class:`~zoo_tpu_torch.serving.tenancy.TenantRegistry` of the
    predict door's tenant admission (default: the process registry,
    ``ZOO_TENANT_CONFIG``; inert without a config).

    ``certfile``/``keyfile``: serve over TLS. ``breaker``: optional
    :class:`CircuitBreaker` — after its failure threshold trips,
    requests are shed at the door with a retryable error until it
    half-opens. ``max_queue`` (``ZOO_SERVE_MAX_QUEUE``) bounds the
    batcher queue: past it predicts are shed retryable with a
    ``retry_after_ms`` hint (0 = unbounded). ``request_timeout``
    (``ZOO_SERVE_REQUEST_TIMEOUT``) bounds the reply of a request that
    propagated no deadline; ``handshake_timeout`` the TLS handshake.
    ``dedup_cache`` (``ZOO_SERVE_DEDUP_CACHE``) sizes the request-id LRU
    that makes client retries and hedges idempotent (0 = off).

    Lifecycle identity: ``version`` (``"v3"``, echoed on every reply and
    published as ``zoo_registry_version_info``), ``model_spec`` the spec
    it was loaded from, and ``model_loader`` a ``spec -> (model,
    version)`` callable the wire ``reload`` op uses (default:
    :func:`zoo_tpu_torch.serving.ha.resolve_model_spec` at this server's
    batch size, on the live model's device)."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0,
                 batch_size: int = 8, max_wait_ms: float = 5.0,
                 num_replicas: int = 1, models=None,
                 certfile: str = None, keyfile: str = None,
                 breaker: Optional[CircuitBreaker] = None,
                 max_queue: Optional[int] = None,
                 request_timeout: Optional[float] = None,
                 handshake_timeout: Optional[float] = None,
                 dedup_cache: Optional[int] = None,
                 llm_engine=None,
                 version: Optional[str] = None,
                 model_spec: Optional[str] = None,
                 model_loader=None,
                 tenancy=None):
        if model is None and llm_engine is None:
            raise ValueError("ServingServer needs a model, an "
                             "llm_engine, or both")
        self.model = model
        self.llm_engine = llm_engine
        # disaggregation role, advertised on every reply frame so the HA
        # client learns the pool topology passively; predict-only
        # replicas have none
        self.role = getattr(llm_engine, "role", None)
        self.tenancy = tenancy if tenancy is not None \
            else tenant_registry()
        self.version = version
        self.model_spec = model_spec
        self.model_loader = model_loader
        # hot-swap: the batcher reads the live model under this lock and
        # reload_model flips it under the same lock — atomic, no drain
        self._swap_lock = threading.Lock()
        # input signatures seen by the batcher ((row_shape, dtype) ->
        # None, insertion-ordered): reload warms the incoming model with
        # one padded batch per signature before the flip
        # guarded-by: _swap_lock
        self._warm_shapes: "collections.OrderedDict" = \
            collections.OrderedDict()
        if version is not None:
            _version_info.labels(version=version).set(1)
        self.breaker = breaker
        self.max_queue = max_queue if max_queue is not None else \
            env_int("ZOO_SERVE_MAX_QUEUE", 1024)
        self.request_timeout = request_timeout if request_timeout \
            is not None else env_float("ZOO_SERVE_REQUEST_TIMEOUT", 120.0)
        self.handshake_timeout = handshake_timeout if handshake_timeout \
            is not None else env_float("ZOO_SERVE_HANDSHAKE_TIMEOUT", 10.0)
        cap = dedup_cache if dedup_cache is not None else \
            env_int("ZOO_SERVE_DEDUP_CACHE", 1024)
        self._dedup_cache = _DedupCache(cap) if cap > 0 else None
        # wire-frame integrity (ZOO_WIRE_CRC, default on): replies to
        # CRC-speaking clients carry a CRC trailer
        self._wire_crc = wire_crc_enabled()
        self._replicas = list(models) if models else (
            [model] * max(1, int(num_replicas))
            if model is not None else [])
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self._ssl_ctx = None
        if certfile:
            import ssl
            self._ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl_ctx.load_cert_chain(certfile, keyfile)
        # per-stage stats (served by the "stats" op), mirrored into the
        # registry's stage-latency histogram for /metrics scrapes
        self.timers = {
            name: StatTimer(histogram=_stage_seconds.labels(stage=name))
            for name in ("batch", "inference", "total")}
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._draining = threading.Event()
        # exact drain accounting: a request is ACCEPTED (under
        # _accept_lock, so no admission can race the drain flag) before
        # it is queued, and COMPLETED when its batch resolves — drain is
        # done iff completed == accepted
        self._accept_lock = threading.Lock()
        self._accepted = 0
        self._completed = 0
        self._inflight = 0  # batches currently in model.predict
        self._inflight_lock = threading.Lock()
        # open connections, shut down by stop() so a client blocked on a
        # reply or a stream sees a transport error (its failover
        # trigger), not a hang
        self._conns: set = set()
        self._conns_lock = threading.Lock()

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                # flips True (sticky, per connection) once the peer
                # proves it speaks CRC frames
                self._crc = False
                try:
                    self.request.setsockopt(socket.IPPROTO_TCP,
                                            socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                if outer._ssl_ctx is not None:
                    self.request.settimeout(outer.handshake_timeout)
                    self.request = outer._ssl_ctx.wrap_socket(
                        self.request, server_side=True)
                    self.request.settimeout(None)
                with outer._conns_lock:
                    outer._conns.add(self.request)
                # kv_migrate staging, PER CONNECTION: begin/block frames
                # collect here until the commit hands the payload over
                self._migrate: Dict[str, Dict] = {}

            def finish(self):
                with outer._conns_lock:
                    outer._conns.discard(self.request)
                if outer._ssl_ctx is not None:
                    try:
                        self.request.close()
                    except OSError:
                        pass

            def _reply(self, msg, extra):
                """One response frame; the request's id, trace and
                tenant (when sent) and this replica's version and role
                are ALWAYS echoed."""
                out = {}
                if "uri" in msg:
                    out["uri"] = msg.get("uri")
                if msg.get("id") is not None:
                    out["id"] = msg["id"]
                if msg.get("trace") is not None:
                    out["trace"] = msg["trace"]
                if msg.get("tenant") is not None:
                    out["tenant"] = msg["tenant"]
                if outer.version is not None:
                    out["version"] = outer.version
                if outer.role is not None:
                    out["role"] = outer.role
                out.update(extra)
                _send_msg(self.request, out, crc=self._crc)

            def _note_reject(self, msg, reason):
                """A door rejection beyond the counters: the flight ring
                gets the shed with its reason, and the request's trace
                an instant event, so rejected requests reconstruct in
                the timeline too."""
                kw = {}
                if msg.get("tenant"):
                    kw["tenant"] = msg["tenant"]
                record_event("shed", op=msg.get("op", "predict"),
                             reason=reason, **kw)
                if msg.get("trace") is not None:
                    emit_event("server.shed", trace=msg["trace"],
                               parent=msg.get("pspan"), reason=reason,
                               rid=msg.get("id"), **kw)

            def _await_and_reply(self, msg, req, deadline):
                """Reply stage: wait for the batcher to resolve ``req``
                under a deadline-derived bound (the propagated deadline
                when present, else ZOO_SERVE_REQUEST_TIMEOUT) and send
                the outcome. Used by fresh requests and by duplicates
                joining an in-flight or completed request; a reply-stage
                timeout is this connection's verdict only."""
                if deadline is not None:
                    done = req.event.wait(
                        timeout=max(0.0, deadline.remaining()))
                else:
                    done = req.event.wait(timeout=outer.request_timeout)
                if not done:
                    if deadline is not None:
                        _requests.labels(outcome="expired").inc()
                        _deadline_expired.labels(stage="reply").inc()
                        self._reply(msg, {
                            "expired": True,
                            "error": "deadline expired before the batch "
                                     "resolved (request dropped)"})
                        return "expired"
                    _requests.labels(outcome="error").inc()
                    self._reply(msg, {
                        "error": "timeout waiting for batch inference "
                                 "(first request may be paying XLA "
                                 "compile; bound is "
                                 "$ZOO_SERVE_REQUEST_TIMEOUT "
                                 f"= {outer.request_timeout:g}s)"})
                    return "error"
                if req.error is not None:
                    if req.expired:
                        _requests.labels(outcome="expired").inc()
                        self._reply(msg, {"expired": True,
                                          "error": req.error})
                        return "expired"
                    _requests.labels(outcome="error").inc()
                    self._reply(msg, {"error": req.error})
                    return "error"
                _requests.labels(outcome="ok").inc()
                extra = {"result": req.result}
                if req.version is not None:
                    extra["version"] = req.version
                self._reply(msg, extra)
                return "ok"

            def _handle_predict(self, msg):
                rid = msg.get("id")
                if outer.model is None:
                    # the JAX package's routing error of an llm-only
                    # replica
                    _requests.labels(outcome="error").inc()
                    self._reply(msg, {
                        "error": "this replica serves the llm "
                                 "generate op only (no predict "
                                 "model mounted)"})
                    return
                deadline = Deadline.from_ms(msg.get("deadline_ms"))
                # 1. idempotency: a duplicate id (a retry after a
                # mid-RPC reset, or a hedge landing on the same replica)
                # joins the original request — never a second execution
                if rid is not None and outer._dedup_cache is not None:
                    prior = outer._dedup_cache.get(rid)
                    if prior is not None:
                        _dedup.labels(
                            kind="replay" if prior.event.is_set()
                            else "inflight").inc()
                        self._await_and_reply(msg, prior, deadline)
                        return
                # 2. version pinning: a request pinned to a version this
                # replica does not serve is bounced retryable, so the
                # client's failover finds one that does. After dedup: a
                # retry of an executed request joins it even across a
                # hot-swap.
                want = msg.get("model_version")
                if want is not None and outer.version is not None \
                        and want != outer.version:
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="version_mismatch").inc()
                    self._note_reject(msg, "version_mismatch")
                    self._reply(msg, {
                        "shed": True, "retryable": True,
                        "version_mismatch": True,
                        "error": f"this replica serves {outer.version}, "
                                 f"not {want}; retry another replica"})
                    return
                # 3. breaker load shedding: fail fast at the door while
                # the model is known-broken
                if outer.breaker is not None and \
                        not outer.breaker.allow():
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="breaker_open").inc()
                    self._note_reject(msg, "breaker_open")
                    self._reply(msg, {
                        "shed": True, "retryable": True,
                        "retry_after_ms": int(
                            1000 * outer.breaker.recovery_timeout),
                        "error": "server shedding load (circuit "
                                 "open after repeated inference "
                                 "failures; retry later)"})
                    return
                # 4. dead-on-arrival: the budget was spent upstream
                if deadline is not None and deadline.expired():
                    _requests.labels(outcome="expired").inc()
                    _deadline_expired.labels(stage="admission").inc()
                    self._note_reject(msg, "expired_admission")
                    self._reply(msg, {
                        "expired": True,
                        "error": "deadline expired before admission "
                                 "(budget exhausted upstream)"})
                    return
                # 5. tenant admission: charge the request to ITS
                # tenant's bucket before it can touch the shared queue;
                # the hint is that bucket's own refill time
                tenant = msg.get("tenant") or ""
                if outer.tenancy.enabled:
                    ok, t_hint = outer.tenancy.admit(tenant)
                    if not ok:
                        label = tenant or "default"
                        _requests.labels(outcome="shed").inc()
                        _shed.labels(reason="tenant_rate").inc()
                        self._note_reject(msg, "tenant_rate")
                        _tenant_shed.labels(tenant=label,
                                            reason="rate").inc()
                        self._reply(msg, {
                            "shed": True, "retryable": True,
                            "retry_after_ms": t_hint,
                            "reason": "rate",
                            "error": f"tenant {label!r} rate limited; "
                                     f"retry after ~{t_hint}ms"})
                        return
                    _tenant_admitted.labels(
                        tenant=tenant or "default").inc()
                # 6. admission control: early rejection at the bounded
                # queue, with a retry-after hint sized to the backlog
                depth = outer._queue.qsize()
                if outer.max_queue and depth >= outer.max_queue:
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="queue_full").inc()
                    self._note_reject(msg, "queue_full")
                    hint = int(outer.max_wait_ms * max(
                        1, depth // max(1, outer.batch_size)))
                    if outer.tenancy.enabled:
                        # a rate-limited tenant waits out its OWN refill
                        # when that is the longer bound
                        own = outer.tenancy.bucket(
                            tenant).retry_after_ms()
                        hint = max(hint, own)
                        _tenant_shed.labels(
                            tenant=tenant or "default",
                            reason="queue_full").inc()
                    self._reply(msg, {
                        "shed": True, "retryable": True,
                        "retry_after_ms": hint,
                        "error": f"server queue full ({depth} waiting, "
                                 f"bound {outer.max_queue}); retry "
                                 f"after ~{hint}ms or another replica"})
                    return
                with outer._accept_lock:
                    draining = outer._draining.is_set()
                    if not draining:
                        outer._accepted += 1
                if draining:
                    # graceful drain: NEW work is turned away at the
                    # door; everything already accepted still completes
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="draining").inc()
                    self._note_reject(msg, "draining")
                    self._reply(msg, {
                        "shed": True, "draining": True,
                        "retryable": True,
                        "error": "server draining (shutting "
                                 "down); retry another replica"})
                    return
                req = _Request(msg["uri"], msg["data"], rid=rid,
                               deadline=deadline,
                               trace=msg.get("trace"),
                               pspan=msg.get("pspan"))
                if rid is not None and outer._dedup_cache is not None:
                    outer._dedup_cache.put(rid, req)
                t0 = time.perf_counter()
                t0_wall = time.time()
                req.t_enqueue = t0
                outer._queue.put(req)
                _queue_depth.set(outer._queue.qsize())
                outcome = self._await_and_reply(msg, req, deadline)
                dur = time.perf_counter() - t0
                outer.timers["total"].record(dur)
                # the request's server-side span (queue wait, batch,
                # inference, reply) under ITS trace id; ``outcome`` is
                # what THIS caller was told
                if req.trace is not None:
                    attrs = {"rid": rid, "outcome": outcome}
                    if req.t_dequeue is not None:
                        attrs["queue_wait_s"] = round(
                            req.t_dequeue - t0, 6)
                    emit_span("server.predict", t0_wall, dur,
                              trace=req.trace, parent=req.pspan,
                              ok=outcome == "ok", **attrs)

            def _handle_generate(self, msg):
                """Streaming autoregressive generation: the reply is a
                SEQUENCE of frames on this connection — ``{id, seq,
                tokens: [...]}`` chunks as the engine emits them, then
                one terminal ``{id, done: true, outcome, n_tokens}``.
                ``resume_from`` skips the first N generated tokens (the
                HA client's failover-resume: a fresh replica regenerates
                the same stream and only the unseen suffix goes on the
                wire)."""
                eng = outer.llm_engine
                rid = msg.get("id")
                deadline = Deadline.from_ms(msg.get("deadline_ms"))
                if eng is None:
                    self._reply(msg, {
                        "done": True, "outcome": "error",
                        "error": "no llm engine mounted on this "
                                 "replica (generate needs a "
                                 "llama:* model spec)"})
                    return
                if outer.breaker is not None and \
                        not outer.breaker.allow():
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="breaker_open").inc()
                    self._note_reject(msg, "breaker_open")
                    self._reply(msg, {
                        "shed": True, "retryable": True,
                        "error": "server shedding load (circuit open)"})
                    return
                if outer._draining.is_set():
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="draining").inc()
                    self._note_reject(msg, "draining")
                    self._reply(msg, {
                        "shed": True, "draining": True,
                        "retryable": True,
                        "error": "server draining; retry another "
                                 "replica"})
                    return
                if deadline is not None and deadline.expired():
                    _requests.labels(outcome="expired").inc()
                    _deadline_expired.labels(stage="admission").inc()
                    self._note_reject(msg, "expired_admission")
                    self._reply(msg, {
                        "done": True, "outcome": "expired",
                        "expired": True,
                        "error": "deadline expired before admission"})
                    return
                # disaggregation: ``handoff: [host, port]`` asks THIS
                # seat to prefill only and push the KV to the decode
                # target; a prefill seat sheds everything else retryable
                handoff = msg.get("handoff")
                if eng.role == "prefill" and not handoff:
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="role").inc()
                    self._note_reject(msg, "role")
                    self._reply(msg, {
                        "shed": True, "retryable": True,
                        "error": "role=prefill replica serves handoff "
                                 "generates only; retry a decode/mixed "
                                 "replica"})
                    return
                if handoff and eng.role == "decode":
                    # a decode seat never prefills for export: serve the
                    # request as a plain local generate
                    handoff = None
                from zoo_tpu_torch.serving.llm.engine import AdmissionError
                # adoption: a payload staged under this rid means the
                # prompt is prefilled already; a prompt mismatch (an id
                # collision) discards it, and the plain re-prefill gives
                # the same stream
                adopt = None
                if rid is not None:
                    adopt = eng.pop_adopted(rid)
                    if adopt is not None and adopt.get("prompt") != \
                            [int(t) for t in msg["prompt"]]:
                        adopt = None
                # per-stream sampling params ride the wire; a missing
                # seed derives from the request id server-side, so a
                # failover resume (same rid, another replica) replays
                # the same draws
                sampling = {k: msg[k] for k in
                            ("temperature", "top_k", "top_p", "seed")
                            if msg.get(k) is not None}
                spec_k = msg.get("spec_k")
                trace_id = msg.get("trace")
                try:
                    h = eng.submit(
                        np.asarray(msg["prompt"]),
                        int(msg.get("max_new_tokens", 16)),
                        rid=rid, deadline=deadline,
                        sampling=sampling or None,
                        spec_k=None if spec_k is None else int(spec_k),
                        trace_id=trace_id,
                        parent_span=msg.get("pspan"),
                        handoff=bool(handoff), adopt=adopt,
                        tenant=msg.get("tenant"))
                except AdmissionError as e:
                    # the engine computed the hint from the SHEDDING
                    # tenant's own bucket and names the quota that
                    # tripped: relay both, so the client backs off per
                    # tenant
                    reason = getattr(e, "reason", "queue_full")
                    door = "tenant_rate" if reason == "rate" \
                        else "queue_full"
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason=door).inc()
                    self._note_reject(msg, door)
                    self._reply(msg, {
                        "shed": True, "retryable": True,
                        "retry_after_ms": e.retry_after_ms,
                        "reason": reason,
                        "error": str(e)})
                    return
                except (ValueError, KeyError) as e:
                    _requests.labels(outcome="error").inc()
                    self._reply(msg, {"done": True, "outcome": "error",
                                      "error": repr(e)})
                    return
                cursor = max(0, int(msg.get("resume_from") or 0))
                resume_from = cursor
                seq = 0
                t_stream = time.perf_counter()
                t_stream_wall = time.time()
                h.subscribe()
                completed = False
                try:
                    last_progress = time.monotonic()
                    while True:
                        toks, done = h.wait_new(cursor, 0.25)
                        if toks:
                            cursor += len(toks)
                            last_progress = time.monotonic()
                            if not done:
                                self._reply(msg, {"seq": seq,
                                                  "tokens": toks,
                                                  "done": False})
                                seq += 1
                                continue
                        if done:
                            if h.outcome == "handoff":
                                # prefill parked: push the KV to the
                                # decode target BEFORE the terminal
                                # frame, so the client's second leg finds
                                # the staged adoption (or learns the
                                # push failed and re-prefills)
                                migrated = self._push_handoff(
                                    eng, rid, handoff, deadline, msg)
                                _requests.labels(outcome="ok").inc()
                                self._reply(msg, {
                                    "seq": seq, "done": True,
                                    "outcome": "handoff",
                                    "migrated": migrated,
                                    "tokens": [], "n_tokens": 0})
                                completed = True
                                return
                            out = {"seq": seq, "done": True,
                                   "outcome": h.outcome,
                                   "tokens": toks,
                                   "n_tokens": len(h.tokens)}
                            if h.truncated:
                                out["truncated"] = True
                            if h.outcome == "expired":
                                out["expired"] = True
                                _requests.labels(
                                    outcome="expired").inc()
                                _deadline_expired.labels(
                                    stage="stream").inc()
                            elif h.outcome == "ok":
                                _requests.labels(outcome="ok").inc()
                            else:
                                _requests.labels(outcome="error").inc()
                            if h.error:
                                out["error"] = h.error
                            self._reply(msg, out)
                            completed = True
                            return
                        # no progress: enforce the no-deadline reply
                        # bound (a deadline-carrying stream is expired
                        # by the engine itself)
                        if deadline is None and time.monotonic() - \
                                last_progress > outer.request_timeout:
                            _requests.labels(outcome="error").inc()
                            self._reply(msg, {
                                "seq": seq, "done": True,
                                "outcome": "error",
                                "error": "no tokens within "
                                         "$ZOO_SERVE_REQUEST_TIMEOUT "
                                         f"={outer.request_timeout:g}s"})
                            return
                except OSError:
                    # client went away mid-stream; fall through to the
                    # unsubscribe cleanup and stop pushing frames
                    pass
                finally:
                    if h.unsubscribe() <= 0 and not h.done \
                            and not completed:
                        # last reader gone with the stream still
                        # decoding: cancel so its KV blocks free NOW,
                        # not at max_new_tokens
                        eng.cancel(h.id)
                    if trace_id is not None:
                        # this HOP's serving span (one per attempt:
                        # original, hedge, failover resume, each with
                        # its resume cursor); the engine's llm.* spans
                        # nest under the same trace
                        emit_span("server.generate", t_stream_wall,
                                  time.perf_counter() - t_stream,
                                  trace=trace_id,
                                  parent=msg.get("pspan"),
                                  ok=completed, rid=rid,
                                  resume_from=resume_from,
                                  sent_tokens=cursor - resume_from,
                                  outcome=h.outcome if completed
                                  else "disconnected")

            def _push_handoff(self, eng, rid, target, deadline, msg):
                """Prefill side of a disaggregated generate: take the
                parked payload, export its KV rows and stream them to
                the decode target as ``kv_migrate`` begin/block/commit
                frames (only the commit is answered: whether the peer
                staged the adoption). The parked blocks are ALWAYS
                released before returning; on any failure the client
                falls back to a plain re-prefill, which gives the same
                stream. The engine lock is never held across the socket;
                the export gathers under the model's dispatch lock."""
                t0 = time.perf_counter()
                payload = eng.take_handoff(rid)
                if payload is None or not target:
                    if payload is not None:
                        eng.release_handoff(rid)
                    record_event("kv_handoff_abort", rid=rid,
                                 reason="expired" if payload is None
                                 else "no_target")
                    return False
                ok = False
                err = None
                nbytes = 0
                try:
                    host, port = str(target[0]), int(target[1])
                    # a chaos seam: tests arm it to fail or stall a push
                    fault_point("serving.kv_migrate.push", rid=rid,
                                blocks=len(payload["blocks"]))
                    exp = getattr(eng.model, "export_kv_blocks", None)
                    kv = None if exp is None else exp(payload["blocks"])
                    sock = socket.create_connection((host, port),
                                                    timeout=5.0)
                    try:
                        try:
                            sock.setsockopt(socket.IPPROTO_TCP,
                                            socket.TCP_NODELAY, 1)
                        except OSError:
                            pass
                        crc = outer._wire_crc
                        begin = {
                            "op": "kv_migrate", "phase": "begin",
                            "id": rid, "crc": 1 if crc else 0,
                            "prompt": payload["prompt"],
                            "first": payload["first"],
                            "sampling": payload["sampling"],
                            "hashes": [h.hex()
                                       for h in payload["hashes"]],
                            "max_new": payload["max_new"],
                            "aux": payload["aux"],
                            "block_size": payload["block_size"],
                            "n_blocks": len(payload["blocks"])}
                        if msg.get("trace") is not None:
                            begin["trace"] = msg["trace"]
                        _send_msg(sock, begin, crc=crc)
                        if kv is not None:
                            step = max(1, int(knob_value(
                                "ZOO_KV_MIGRATE_CHUNK_BLOCKS")))
                            for i in range(0, len(payload["blocks"]),
                                           step):
                                part = {name: a[:, i:i + step]
                                        for name, a in kv.items()}
                                nbytes += sum(int(a.nbytes)
                                              for a in part.values())
                                _send_msg(sock, {
                                    "op": "kv_migrate",
                                    "phase": "block", "id": rid,
                                    "index": i, "kv": part}, crc=crc)
                        commit = {"op": "kv_migrate",
                                  "phase": "commit", "id": rid}
                        if deadline is not None:
                            # what is left of the request's budget
                            # bounds the adoption
                            commit["deadline_ms"] = int(1000 * max(
                                0.0, deadline.remaining()))
                        _send_msg(sock, commit, crc=crc)
                        resp = _recv_msg(sock)
                        ok = bool(resp and resp.get("ok")
                                  and resp.get("adopted"))
                    finally:
                        sock.close()
                except (OSError, FrameCorrupt) as e:
                    err = repr(e)
                finally:
                    eng.release_handoff(rid)
                if ok:
                    _migrated_bytes.inc(nbytes)
                    _handoff_seconds.observe(time.perf_counter() - t0)
                    return True
                record_event("kv_handoff_abort", rid=rid,
                             reason=err or "peer_refused")
                return False

            def _handle_kv_migrate(self, msg):
                """Decode side of the handoff wire: ``begin`` stages a
                sequence's metadata on this connection, ``block`` frames
                add its exported KV chunks, ``commit`` hands the
                assembled payload to the engine (the only answered
                phase). The allocator is not touched until the matching
                generate arrives, so a pusher that dies after commit
                leaks nothing here."""
                eng = outer.llm_engine
                phase = msg.get("phase")
                rid = msg.get("id")
                if eng is None or not rid:
                    if phase == "commit":
                        self._reply(msg, {
                            "ok": False, "adopted": False,
                            "error": "no llm engine mounted"
                                     if eng is None else
                                     "kv_migrate needs an id"})
                    return
                if phase == "begin":
                    self._migrate[rid] = {"msg": msg, "chunks": []}
                    return
                st = self._migrate.get(rid)
                if phase == "block":
                    if st is not None:
                        st["chunks"].append(
                            (int(msg.get("index") or 0),
                             msg.get("kv") or {}))
                    return
                if phase != "commit":
                    self._reply(msg, {
                        "ok": False, "adopted": False,
                        "error": f"unknown kv_migrate phase {phase!r}"})
                    return
                st = self._migrate.pop(rid, None)
                if st is None:
                    self._reply(msg, {
                        "ok": False, "adopted": False,
                        "error": "commit without a begin on this "
                                 "connection"})
                    return
                deadline = Deadline.from_ms(msg.get("deadline_ms"))
                if deadline is not None and deadline.expired():
                    _deadline_expired.labels(stage="admission").inc()
                    self._reply(msg, {"ok": False, "adopted": False,
                                      "expired": True})
                    return
                b = st["msg"]
                kv = None
                if st["chunks"]:
                    st["chunks"].sort(key=lambda t: t[0])
                    names = sorted(st["chunks"][0][1])
                    try:
                        kv = {name: np.concatenate(
                            [np.asarray(c[1][name])
                             for c in st["chunks"]], axis=1)
                            for name in names}
                    except (KeyError, ValueError) as e:
                        self._reply(msg, {"ok": False,
                                          "adopted": False,
                                          "error": repr(e)})
                        return
                try:
                    payload = {
                        "rid": rid,
                        "prompt": [int(t)
                                   for t in b.get("prompt") or ()],
                        "first": int(b.get("first") or 0),
                        "sampling": b.get("sampling"),
                        "hashes": [bytes.fromhex(h)
                                   for h in b.get("hashes") or ()],
                        "block_size": int(b.get("block_size") or 0),
                        "aux": b.get("aux") or {},
                        "max_new": int(b.get("max_new") or 0),
                        "kv": kv,
                    }
                except (TypeError, ValueError) as e:
                    self._reply(msg, {"ok": False, "adopted": False,
                                      "error": repr(e)})
                    return
                adopted = eng.offer_adopted(payload)
                self._reply(msg, {"ok": True,
                                  "adopted": bool(adopted)})

            def _handle_reload(self, msg):
                """Wire half of :meth:`ServingServer.reload_model`. The
                reply is sent only AFTER the swap (or its failure): an
                ``ok`` means the new version is live here, an error
                means the old model never stopped serving."""
                spec = msg.get("spec")
                if not spec:
                    self._reply(msg, {"error": "reload needs a spec"})
                    return
                try:
                    info = outer.reload_model(
                        spec, version=msg.get("version"),
                        warm=bool(msg.get("warm", True)))
                except Exception as e:  # noqa: BLE001 — the caller
                    # (the rolling updater) turns this into a rollback;
                    # the incumbent model is still serving
                    self._reply(msg, {"error": repr(e),
                                      "reload_failed": True})
                    return
                self._reply(msg, {"ok": True, **info})

            def _handle_chaos(self, msg):
                """Arm (or clear) a fault site in THIS replica process —
                the remote half of the deterministic chaos harness.
                Refused unless the operator
                deliberately armed the door (``ZOO_CHAOS_ALLOW=1`` in
                the replica env, which the chaos smokes set): a
                production replica must never take fault commands off
                an unauthenticated socket."""
                if os.environ.get("ZOO_CHAOS_ALLOW") not in ("1", "true"):
                    self._reply(msg, {
                        "error": "chaos ops disabled on this replica "
                                 "(set ZOO_CHAOS_ALLOW=1 in its env)"})
                    return
                from zoo_tpu_torch.util.resilience import default_injector
                site = msg.get("site")
                if not site:
                    self._reply(msg, {"error": "chaos needs a site"})
                    return
                if msg.get("clear"):
                    default_injector.clear(site)
                    record_event("chaos_clear", site=site)
                    self._reply(msg, {"ok": True, "cleared": site})
                    return
                delay = float(msg.get("delay_ms") or 0.0) / 1000.0
                err = msg.get("error")
                exc = None
                if err == "oserror":
                    exc = OSError(f"injected fault at {site}")
                elif err == "connection":
                    exc = ConnectionResetError(
                        f"injected fault at {site}")
                elif err:
                    self._reply(msg, {
                        "error": f"unknown chaos error kind {err!r} "
                                 "(oserror | connection)"})
                    return
                action = (lambda **_k: time.sleep(delay)) if delay \
                    else None
                if action is None and exc is None:
                    self._reply(msg, {
                        "error": "chaos needs delay_ms, error, or "
                                 "clear"})
                    return
                default_injector.inject(
                    site, exc=exc, action=action,
                    times=(int(msg["times"]) if msg.get("times")
                           is not None else None),
                    p=float(msg.get("p", 1.0)))
                record_event("chaos_arm", site=site,
                             delay_ms=msg.get("delay_ms"),
                             error=err, p=msg.get("p"))
                self._reply(msg, {"ok": True, "site": site})

            def handle(self):
                while True:
                    try:
                        msg, had_crc = _recv_frame(self.request)
                    except FrameCorrupt:
                        # a corrupt REQUEST cannot be trusted for a
                        # reply (id/op unreadable): drop the connection
                        record_event("corrupt_request_dropped")
                        return
                    except OSError:
                        return   # stop() shut the connection down
                    if msg is None:
                        return
                    if outer._wire_crc and \
                            (had_crc or msg.get("crc")):
                        self._crc = True
                    op = msg.get("op")
                    try:
                        if op == "predict":
                            self._handle_predict(msg)
                        elif op == "generate":
                            self._handle_generate(msg)
                        elif op == "kv_migrate":
                            self._handle_kv_migrate(msg)
                        elif op == "reload":
                            self._handle_reload(msg)
                        elif op == "version":
                            self._reply(msg, {
                                "ok": True,
                                "model_spec": outer.model_spec,
                                "version": outer.version})
                        elif op == "llm_stats":
                            eng = outer.llm_engine
                            self._reply(msg, {"stats": eng.stats()}
                                        if eng is not None else
                                        {"error": "no llm engine"})
                        elif op == "stats":
                            self._reply(msg, {
                                k: t.stats()
                                for k, t in outer.timers.items()})
                        elif op == "debug_dump":
                            # the flight recorder's bundle, pulled live:
                            # ring + metrics + config + open spans
                            self._reply(msg, {
                                "ok": True,
                                "bundle": flight_recorder(
                                ).snapshot_bundle("debug_dump")})
                        elif op == "chaos":
                            self._handle_chaos(msg)
                        elif op == "ping":
                            self._reply(msg, {"ok": True})
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

            def handle_error(inner, request, client_address):
                # under TLS, failed handshakes are a per-connection
                # event, not a server stack trace
                import sys as _sys
                exc = _sys.exc_info()[1]
                if outer._ssl_ctx is not None and isinstance(exc,
                                                             OSError):
                    return
                super(Server, inner).handle_error(request,
                                                  client_address)

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address

    # -- model lifecycle ---------------------------------------------------
    def _note_warm_shape(self, row_shape, dtype):
        key = (tuple(int(d) for d in row_shape), np.dtype(dtype).str)
        # under the swap lock: reload_model snapshots this dict while
        # batcher threads keep recording
        with self._swap_lock:
            if key not in self._warm_shapes:
                self._warm_shapes[key] = None
                while len(self._warm_shapes) > 8:
                    self._warm_shapes.popitem(last=False)

    def reload_model(self, spec: str, version: Optional[str] = None,
                     warm: bool = True) -> Dict:
        """Hot-swap to the model at ``spec`` with ZERO downtime: load and
        verify the new model BESIDE the old one (which keeps serving),
        prime it with one padded batch at every input signature this
        server has seen (so the first request after the flip finds its
        kernels loaded and its memory allocated), then flip atomically
        under the batcher's swap lock. Any load/verify/warm failure
        raises WITHOUT flipping.

        The wire ``reload`` op's engine, and what
        :meth:`zoo_tpu_torch.serving.ha.ReplicaGroup.rolling_update`
        drives one replica at a time."""
        if self.model is None:
            raise RuntimeError("this replica serves the llm generate op "
                               "only; hot-swap reload applies to the "
                               "predict model path")
        if len({id(m) for m in self._replicas}) > 1:
            raise RuntimeError(
                "hot-swap reload is not supported on a server built "
                "with distinct per-replica model copies (models=[...]); "
                "restart the replica process instead")
        t0 = time.perf_counter()
        try:
            loader = self.model_loader
            if loader is None:
                from zoo_tpu_torch.serving.ha import resolve_model_spec
                # the incoming model lands where the live one runs
                device = getattr(self.model, "_device", None)
                loader = lambda s: resolve_model_spec(  # noqa: E731
                    s, batch_size=self.batch_size, device=device)
            fault_point("serving.reload", spec=spec)
            new_model, loaded_version = loader(spec)
            version = version or loaded_version
            warmed = 0
            if warm:
                with self._swap_lock:
                    shapes = list(self._warm_shapes)
                for row_shape, dtype in shapes:
                    x = np.zeros((self.batch_size,) + row_shape,
                                 np.dtype(dtype))
                    np.asarray(new_model.predict(
                        x, batch_size=self.batch_size))
                    warmed += 1
        except Exception:
            _reloads.labels(outcome="failed").inc()
            raise
        with self._swap_lock:
            previous = self.version
            self.model = new_model
            self._replicas = [new_model] * max(1, len(self._replicas))
            self.version = version
            self.model_spec = spec
        if previous is not None:
            _version_info.labels(version=previous).set(0)
        if version is not None:
            _version_info.labels(version=version).set(1)
        _reloads.labels(outcome="ok").inc()
        return {"version": version, "previous": previous,
                "warmed": warmed,
                "reload_seconds": round(time.perf_counter() - t0, 4)}

    # -- batcher -----------------------------------------------------------
    def _drop_expired(self, req: _Request):
        """Answer an expired request WITHOUT computing it; counts toward
        drain accounting like any completed request."""
        req.expired = True
        req.error = ("deadline expired before inference "
                     "(dropped unexecuted)")
        _deadline_expired.labels(stage="batch").inc()
        req.event.set()
        with self._inflight_lock:
            self._completed += 1

    def _batch_loop(self, idx: int = 0):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            first.t_dequeue = time.perf_counter()
            if first.deadline is not None and first.deadline.expired():
                self._drop_expired(first)
                continue
            t0 = time.perf_counter()
            batch: List[_Request] = [first]
            deadline = time.perf_counter() + self.max_wait_ms / 1000.0
            while len(batch) < self.batch_size:
                remaining = deadline - time.perf_counter()
                # the window never burns a member's remaining budget:
                # the tightest propagated deadline caps the assembly
                tightest = min(
                    (r.deadline.remaining() for r in batch
                     if r.deadline is not None), default=remaining)
                remaining = min(remaining, tightest)
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                nxt.t_dequeue = time.perf_counter()
                if nxt.deadline is not None and nxt.deadline.expired():
                    self._drop_expired(nxt)
                    continue
                batch.append(nxt)
            # final pre-inference gate: anything that expired while the
            # batch assembled is dropped here, not computed
            live = []
            for r in batch:
                if r.deadline is not None and r.deadline.expired():
                    self._drop_expired(r)
                else:
                    live.append(r)
            batch = live
            self.timers["batch"].record(time.perf_counter() - t0)
            _queue_depth.set(self._queue.qsize())
            if not batch:
                continue
            _batch_occupancy.observe(len(batch))

            with self._inflight_lock:
                self._inflight += 1
            t1 = time.perf_counter()
            try:
                with span("serving.batch", size=len(batch)):
                    fault_point("serving.infer", batch=len(batch))
                    arrays = [np.asarray(r.data) for r in batch]
                    # pad UP to a whole multiple of batch_size with zeros,
                    # so every occupancy runs the same shapes on the card
                    # (one set of kernel plans and allocations); max() keeps
                    # an all-empty window a full batch too
                    real = sum(len(a) for a in arrays)
                    padded = max(self.batch_size,
                                 -(-real // self.batch_size) * self.batch_size)
                    to_stack = arrays if padded == real else arrays + [
                        np.zeros((padded - real,) + arrays[0].shape[1:],
                                 arrays[0].dtype)]
                    stacked = np.concatenate(to_stack, axis=0)
                    # the LIVE model, read under the swap lock so a
                    # concurrent reload flips between batches — a batch
                    # runs wholly on the old or wholly on the new version
                    with self._swap_lock:
                        model = self._replicas[idx]
                        version = self.version
                    self._note_warm_shape(stacked.shape[1:], stacked.dtype)
                    preds = model.predict(stacked, batch_size=self.batch_size)
                    preds = np.asarray(preds)[:real]
                    offset = 0
                    for r, a in zip(batch, arrays):
                        r.result = np.asarray(preds[offset:offset + len(a)])
                        # a deliberate break from the JAX door's frames: its
                        # reply echoes the version live when it replies, which
                        # a reload may have moved past the one that computed
                        # the batch; this one names the computing version
                        # (test_a_reply_echoes_the_version_that_computed_it)
                        r.version = version
                        offset += len(a)
                    if self.breaker is not None:
                        self.breaker.record_success()
            except Exception as e:  # route the error to every caller
                if self.breaker is not None:
                    self.breaker.record_failure()
                for r in batch:
                    r.error = repr(e)
            self.timers["inference"].record(time.perf_counter() - t1)
            for r in batch:
                r.event.set()
            with self._inflight_lock:
                self._inflight -= 1
                self._completed += len(batch)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingServer":
        self._threads = [
            threading.Thread(target=self._server.serve_forever,
                             daemon=True, name="zoo-serving-door")]
        self._threads += [
            threading.Thread(target=self._batch_loop, args=(i,),
                             daemon=True, name=f"zoo-serving-replica-{i}")
            for i in range(len(self._replicas))]
        for t in self._threads:
            t.start()
        return self

    def drain(self, timeout: Optional[float] = None,
              snapshot_path: str = None) -> bool:
        """Graceful shutdown (the SIGTERM path): stop taking new work,
        finish every accepted predict, flush the metrics snapshot, then
        :meth:`stop` (whose engine stop ends every live stream
        ``cancelled``; the HA client resumes each one elsewhere).
        Returns True when every accepted request was answered inside
        ``timeout`` (``None`` → ``ZOO_SERVE_DRAIN_TIMEOUT_S``, default
        30); False = timed out and force-closed. The measured drain
        time lands on ``zoo_serve_drain_seconds``.

        Order: (1) ``_draining`` is raised under the accept lock, so no
        handler can slip a request past the closing door; (2) wait until
        every accepted request has completed (exact counters); (3) write
        the metrics snapshot (``snapshot_path`` or
        ``$ZOO_OBS_SNAPSHOT``); (4) ``stop()``."""
        if timeout is None:
            timeout = drain_timeout()
        t0 = time.monotonic()
        with self._accept_lock:
            self._draining.set()
            outstanding_at_close = self._accepted
        deadline = t0 + timeout
        drained = False
        while time.monotonic() < deadline:
            with self._inflight_lock:
                done = self._completed
            if done >= outstanding_at_close and \
                    self._queue.qsize() == 0:
                drained = True
                break
            time.sleep(0.01)
        _drain_seconds.observe(time.monotonic() - t0)
        record_event("drain", drained=drained,
                     seconds=round(time.monotonic() - t0, 3))
        path = snapshot_path or knob_value("ZOO_OBS_SNAPSHOT")
        if path:
            try:
                from zoo_tpu_torch.obs.exporters import write_snapshot
                write_snapshot(path)
            except Exception as e:  # noqa: BLE001 — flush is best-effort
                import logging
                logging.getLogger(__name__).warning(
                    "drain: metrics snapshot flush failed: %s", e)
        self.stop()
        return drained

    def install_drain_handler(self, signals=None,
                              timeout: Optional[float] = None,
                              snapshot_path: str = None):
        """Route SIGTERM (default) to :meth:`drain` on a helper thread.
        Main-thread only; returns False elsewhere."""
        import signal as _signal
        sigs = signals or (_signal.SIGTERM,)
        try:
            for s in sigs:
                _signal.signal(s, lambda *_: threading.Thread(
                    target=self.drain,
                    kwargs={"timeout": timeout,
                            "snapshot_path": snapshot_path},
                    daemon=True, name="zoo-serving-drain").start())
            return True
        except ValueError:  # not the main thread
            return False

    def stop(self):
        """Close the door: the batchers stop, the engine (when mounted)
        stops (every live stream ends ``cancelled`` and returns its KV
        blocks), and every open connection is shut down, so a client
        blocked on a reply or a stream sees a transport error at
        once."""
        self._stop.set()
        self._draining.set()
        if self.llm_engine is not None:
            self.llm_engine.stop()
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
