"""The serving TCP door with the streaming LLM ``generate`` op
(counterpart of ``zoo_tpu/serving/server.py``).

A threaded TCP server accepts length-prefixed requests in the
non-executable codec (:mod:`zoo_tpu_torch.serving.codec` — JSON
structure plus raw array buffers, never pickle) and answers on the same
connection. The framing is byte for byte the JAX package's, CRC trailer
included, so a client of either package talks to a server of either.

What the door serves: ``generate`` (a stream of frames from a mounted
:class:`~zoo_tpu_torch.serving.llm.engine.LLMEngine`), ``ping``,
``version``, ``stats`` and ``llm_stats``, with TLS, the load-shedding
breaker, deadlines, the graceful drain and the ``_reply`` echo of id,
trace, tenant, version and role. What waits, and answers with an error
that names its ROADMAP item instead of a silent ``ok``:

* ``predict`` — the micro-batching predict door, hot-swap ``reload``
  and the model registry (ROADMAP A.3b); an llm-only replica answers
  predict with the JAX package's routing error;
* ``kv_migrate`` and a ``handoff`` generate — disaggregation (A.5);
* ``debug_dump`` and the wire ``chaos`` op — the flight recorder and the
  chaos harness (A.6).

The server binds loopback by default; pass ``host="0.0.0.0"`` only on a
trusted network — there is no authentication on this door.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import socketserver
import struct
import threading
import time
from typing import Optional

import numpy as np

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.obs.metrics import counter, gauge, get_registry
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
)

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
_version_info = gauge(
    "zoo_registry_version_info",
    "Registry model version served by this replica (1 = current; a "
    "version flips to 0 when a reload swaps it out)", labels=("version",))

# what the port's door does not serve yet, and the ROADMAP item that
# brings each one
PREDICT_ITEM = "ROADMAP A.3b (the predict door and the model registry)"
HANDOFF_ITEM = "ROADMAP A.5 (disaggregation)"
OBS_ITEM = "ROADMAP A.6 (observability)"
TENANCY_ITEM = "ROADMAP A.4 (tenancy)"


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


class _DedupCache:
    """Request-id → request LRU, the server half of idempotent predict
    retries/hedges (a duplicate id joins the pending request instead of
    executing twice). The predict door that fills it, and sizes it from
    ``ZOO_SERVE_DEDUP_CACHE``, waits for ROADMAP A.3b; ``generate``
    dedups in the engine (a duplicate id joins the live stream)."""

    def __init__(self, capacity: int):
        self._cap = int(capacity)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, rid: str):
        with self._lock:
            req = self._entries.get(rid)
            if req is not None:
                self._entries.move_to_end(rid)
            return req

    def put(self, rid: str, req):
        with self._lock:
            self._entries[rid] = req
            self._entries.move_to_end(rid)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)


def _write_snapshot(path: str):
    """Append one JSON line — ``{ts, host, pid, metrics}`` — to ``path``,
    the record the JAX package's exporter writes on drain."""
    rec = {"ts": time.time(), "host": socket.gethostname(),
           "pid": os.getpid(), "metrics": get_registry().snapshot()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec, separators=(",", ":"), default=str) + "\n")


class ServingServer:
    """``ServingServer(None, llm_engine=engine).start()`` → serve the
    streaming ``generate`` op until ``stop()``.

    The JAX signature is kept, less the arguments that only shape the
    predict door (``batch_size``, ``max_wait_ms``, ``num_replicas``,
    ``max_queue``, ``dedup_cache``), which come with it in ROADMAP A.3b;
    every argument after ``port`` is keyword-only, so a positional JAX
    call fails loudly. ``model``/``models`` (the predict door),
    ``tenancy`` and ``model_loader`` (hot-swap reload) wait for their
    ROADMAP items and raise when given.

    ``certfile``/``keyfile``: serve over TLS. ``breaker``: optional
    :class:`CircuitBreaker` — while it is open, requests are shed at the
    door with a retryable error. ``request_timeout`` bounds a stream's
    wait for its next token when the client propagated no deadline
    (``ZOO_SERVE_REQUEST_TIMEOUT``); ``handshake_timeout`` bounds the TLS
    handshake. ``version``/``model_spec`` are the lifecycle identity
    echoed on every reply and by the ``version`` op."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0, *,
                 models=None,
                 certfile: str = None, keyfile: str = None,
                 breaker: Optional[CircuitBreaker] = None,
                 request_timeout: Optional[float] = None,
                 handshake_timeout: Optional[float] = None,
                 llm_engine=None,
                 version: Optional[str] = None,
                 model_spec: Optional[str] = None,
                 model_loader=None,
                 tenancy=None):
        if model is not None or models:
            raise NotImplementedError(
                "the port's ServingServer mounts an llm_engine only; the "
                f"predict door waits for {PREDICT_ITEM}")
        if llm_engine is None:
            raise ValueError("ServingServer needs a model, an "
                             "llm_engine, or both")
        if model_loader is not None:
            raise NotImplementedError(
                f"hot-swap reload waits for {PREDICT_ITEM}")
        if tenancy is not None or knob_value("ZOO_TENANT_CONFIG"):
            raise NotImplementedError(
                f"tenant admission waits for {TENANCY_ITEM}; unset "
                "ZOO_TENANT_CONFIG")
        self.model = None
        self.llm_engine = llm_engine
        # disaggregation role, advertised on every reply frame so the HA
        # client learns the pool topology passively
        self.role = getattr(llm_engine, "role", None)
        self.version = version
        self.model_spec = model_spec
        if version is not None:
            _version_info.labels(version=version).set(1)
        self.breaker = breaker
        self.request_timeout = request_timeout if request_timeout \
            is not None else env_float("ZOO_SERVE_REQUEST_TIMEOUT", 120.0)
        self.handshake_timeout = handshake_timeout if handshake_timeout \
            is not None else env_float("ZOO_SERVE_HANDSHAKE_TIMEOUT", 10.0)
        # wire-frame integrity (ZOO_WIRE_CRC, default on): replies to
        # CRC-speaking clients carry a CRC trailer
        self._wire_crc = wire_crc_enabled()
        self._ssl_ctx = None
        if certfile:
            import ssl
            self._ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl_ctx.load_cert_chain(certfile, keyfile)
        self._stop = threading.Event()
        self._draining = threading.Event()
        # open connections, shut down by stop() so a client blocked on a
        # stream sees a transport error (its failover trigger), not a hang
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

            def _handle_predict(self, msg):
                # the JAX package's routing error of an llm-only replica
                _requests.labels(outcome="error").inc()
                self._reply(msg, {
                    "error": "this replica serves the llm "
                             "generate op only (no predict "
                             "model mounted)"})

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
                if outer.breaker is not None and \
                        not outer.breaker.allow():
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="breaker_open").inc()
                    self._reply(msg, {
                        "shed": True, "retryable": True,
                        "error": "server shedding load (circuit open)"})
                    return
                if outer._draining.is_set():
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="draining").inc()
                    self._reply(msg, {
                        "shed": True, "draining": True,
                        "retryable": True,
                        "error": "server draining; retry another "
                                 "replica"})
                    return
                if deadline is not None and deadline.expired():
                    _requests.labels(outcome="expired").inc()
                    _deadline_expired.labels(stage="admission").inc()
                    self._reply(msg, {
                        "done": True, "outcome": "expired",
                        "expired": True,
                        "error": "deadline expired before admission"})
                    return
                if msg.get("handoff"):
                    _requests.labels(outcome="error").inc()
                    self._reply(msg, {
                        "done": True, "outcome": "error",
                        "error": "a handoff generate (prefill here, "
                                 "decode on another seat) waits for "
                                 f"{HANDOFF_ITEM} in the port"})
                    return
                from zoo_tpu_torch.serving.llm.engine import AdmissionError
                # per-stream sampling params ride the wire; a missing
                # seed derives from the request id server-side, so a
                # failover resume (same rid, another replica) replays
                # the same draws
                sampling = {k: msg[k] for k in
                            ("temperature", "top_k", "top_p", "seed")
                            if msg.get(k) is not None}
                spec_k = msg.get("spec_k")
                try:
                    h = eng.submit(
                        np.asarray(msg["prompt"]),
                        int(msg.get("max_new_tokens", 16)),
                        rid=rid, deadline=deadline,
                        sampling=sampling or None,
                        spec_k=None if spec_k is None else int(spec_k))
                except AdmissionError as e:
                    _requests.labels(outcome="shed").inc()
                    _shed.labels(reason="queue_full").inc()
                    self._reply(msg, {
                        "shed": True, "retryable": True,
                        "retry_after_ms": e.retry_after_ms,
                        "reason": "queue_full",
                        "error": str(e)})
                    return
                except (ValueError, KeyError) as e:
                    _requests.labels(outcome="error").inc()
                    self._reply(msg, {"done": True, "outcome": "error",
                                      "error": repr(e)})
                    return
                cursor = max(0, int(msg.get("resume_from") or 0))
                seq = 0
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

            def _refuse(self, msg, what: str, item: str, **extra):
                self._reply(msg, {"ok": False, **extra,
                                  "error": f"{what} waits for {item} in "
                                           "the port"})

            def handle(self):
                while True:
                    try:
                        msg, had_crc = _recv_frame(self.request)
                    except FrameCorrupt:
                        # a corrupt REQUEST cannot be trusted for a
                        # reply (id/op unreadable): drop the connection
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
                            # begin/block frames are unacknowledged in
                            # the protocol; the commit gets the verdict
                            if msg.get("phase") not in ("begin", "block"):
                                self._refuse(msg, "kv_migrate",
                                             HANDOFF_ITEM, adopted=False)
                        elif op == "reload":
                            self._refuse(msg, "hot-swap reload",
                                         PREDICT_ITEM, reload_failed=True)
                        elif op == "version":
                            self._reply(msg, {
                                "ok": True,
                                "model_spec": outer.model_spec,
                                "version": outer.version})
                        elif op == "llm_stats":
                            self._reply(msg, {
                                "stats": outer.llm_engine.stats()})
                        elif op == "stats":
                            self._refuse(msg, "the predict door's stage "
                                         "timers (stats)", PREDICT_ITEM)
                        elif op == "debug_dump":
                            self._refuse(msg, "the flight recorder's "
                                         "debug_dump", OBS_ITEM)
                        elif op == "chaos":
                            self._refuse(msg, "the wire chaos op",
                                         OBS_ITEM)
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

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingServer":
        self._threads = [
            threading.Thread(target=self._server.serve_forever,
                             daemon=True, name="zoo-serving-door")]
        for t in self._threads:
            t.start()
        return self

    def drain(self, snapshot_path: str = None) -> bool:
        """Graceful shutdown (the SIGTERM path): stop taking new work,
        flush the metrics snapshot (``snapshot_path`` or
        ``$ZOO_OBS_SNAPSHOT``), then :meth:`stop`, whose engine stop
        ends every live stream with outcome ``cancelled`` — the HA
        client resumes each one on another replica, as it does behind
        a JAX replica. Returns True: the JAX drain waits, within
        ``timeout``/``ZOO_SERVE_DRAIN_TIMEOUT_S``, only for accepted
        predict requests, which this door does not take; that budget
        comes with the predict door (ROADMAP A.3b)."""
        self._draining.set()
        path = snapshot_path or knob_value("ZOO_OBS_SNAPSHOT")
        if path:
            try:
                _write_snapshot(path)
            except OSError as e:
                import logging
                logging.getLogger(__name__).warning(
                    "drain: metrics snapshot flush failed: %s", e)
        self.stop()
        return True

    def install_drain_handler(self, signals=None,
                              snapshot_path: str = None):
        """Route SIGTERM (default) to :meth:`drain` on a helper thread.
        Main-thread only; returns False elsewhere."""
        import signal as _signal
        sigs = signals or (_signal.SIGTERM,)
        try:
            for s in sigs:
                _signal.signal(s, lambda *_: threading.Thread(
                    target=self.drain,
                    kwargs={"snapshot_path": snapshot_path},
                    daemon=True, name="zoo-serving-drain").start())
            return True
        except ValueError:  # not the main thread
            return False

    def stop(self):
        """Close the door: new generates are shed retryable, the engine
        stops (every live stream ends ``cancelled`` and returns its KV
        blocks), and every open connection is shut down, so a client
        blocked on a stream sees a transport error at once."""
        self._stop.set()
        self._draining.set()
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
