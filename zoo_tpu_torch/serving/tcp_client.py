"""The serving TCP client (counterpart of
``zoo_tpu/serving/tcp_client.py``).

``_Connection`` is one RPC/stream connection to a
:class:`ServingServer` door of either package: reconnects under a
:class:`RetryPolicy`, CRC frames negotiated per connection, request ids
echoed and checked. ``TCPInputQueue``/``TCPOutputQueue`` are the
predict-side API (``enqueue``/``predict``/``query``, the reference's
``InputQueue``/``OutputQueue`` shape). ``_stamp_trace`` puts the
thread's adopted request trace (:func:`~zoo_tpu_torch.obs.tracing.
trace_context`) on every outgoing frame that carries none.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid
from typing import Dict, Optional

import numpy as np

from zoo_tpu_torch.obs.tracing import ambient_trace_id, current_span_id
from zoo_tpu_torch.serving.server import _recv_frame, _send_msg
from zoo_tpu_torch.util.integrity import wire_crc_enabled
from zoo_tpu_torch.util.resilience import (
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    fault_point,
)


def _stamp_trace(msg: Dict) -> Dict:
    """Propagate the thread's adopted request trace onto the frame: a
    caller already inside a ``trace_context`` gets wire propagation for
    free; explicit ``trace`` fields (the HA client's) win. No ambient
    context = no stamp: the wire never carries the process-wide trace
    id."""
    if "trace" not in msg:
        tid = ambient_trace_id()
        if tid is not None:
            msg["trace"] = tid
            ps = current_span_id()
            if ps is not None:
                msg["pspan"] = ps
    return msg


class _Connection:
    """One RPC connection with reconnect-and-retry.

    Transient transport failures (server restarting, connection reset
    mid-RPC) are retried under ``retry`` with exponential backoff,
    re-dialing a fresh socket each attempt; server-side *application*
    errors come back as normal responses and are never retried here.

    Every predict gets a client-stamped request id that the server
    echoes: retries re-send the SAME id (the server's dedup cache makes
    them idempotent — a reconnect after a mid-RPC reset never executes
    the model twice), and any response frame carrying a DIFFERENT id
    (a stale attempt's reply still buffered on a reused connection) is
    discarded instead of being mismatched to the wrong caller. A
    :class:`Deadline` passed to :meth:`rpc` is re-stamped into each
    attempt's frame as the remaining ``deadline_ms`` budget and bounds
    the socket wait, so a dead server costs the budget, never a hang."""

    def __init__(self, host: str, port: int, tls: bool = False,
                 cafile: str = None, verify: bool = True,
                 retry: Optional[RetryPolicy] = None):
        self._host, self._port = host, port
        self._tls, self._cafile, self._verify = tls, cafile, verify
        self._retry = retry or RetryPolicy(max_attempts=3,
                                           base_delay=0.05, max_delay=1.0)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        # wire integrity (docs/serving_ha.md): whether we WANT CRC
        # trailers (ZOO_WIRE_CRC) and whether this connection's peer
        # has proven it speaks them (sticky per connection: the first
        # CRC-framed reply flips it, and a reconnect resets it — the
        # respawned peer may be an older build)
        self._crc_want = wire_crc_enabled()
        self._crc_on = False
        # reconnect-after-respawn jitter: consecutive re-dials after a
        # POISONED drop (reset, refused, corrupt frame — reset again on
        # the first successful exchange) index into the retry policy's
        # jittered backoff so N clients re-dialing a freshly respawned
        # replica spread out instead of stampeding it. A deliberate
        # close() (pool hygiene) never pays the jitter.
        self._reopen_streak = 0
        self._poisoned = False
        self._open()

    def _open(self, reconnect: bool = False):
        if reconnect and self._poisoned:
            # thundering-herd protection: every client of a respawned
            # replica would otherwise re-dial the instant its socket
            # died. The SAME backoff math the retry policy uses (full
            # jitter, capped) desynchronizes them; the first dial of a
            # fresh _Connection — and a reopen after a clean close —
            # pays nothing.
            self._reopen_streak += 1
            delay = self._retry.backoff(min(self._reopen_streak, 6))
            if delay > 0:
                time.sleep(delay)
        sock = socket.create_connection((self._host, self._port))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._tls:
            import ssl
            ctx = ssl.create_default_context(cafile=self._cafile)
            if not self._verify:
                # EXPLICIT opt-out only (self-signed dev certs):
                # encryption without server authentication — never
                # inferred from a missing cafile
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            sock = ctx.wrap_socket(sock, server_hostname=self._host)
        self._sock = sock
        self._crc_on = False  # re-learn: the peer may have changed

    def _drop(self, poisoned: bool = True):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            if poisoned:
                self._poisoned = True

    def _rpc_once(self, msg: Dict,
                  deadline: Optional[Deadline] = None) -> Dict:
        fault_point("serving.request", op=msg.get("op"))
        with self._lock:
            if deadline is not None and deadline.expired():
                # terminal, not retryable: another attempt can only
                # arrive even later
                raise DeadlineExceeded(
                    "request deadline expired before send")
            if self._sock is None:
                self._open(reconnect=True)
            try:
                if deadline is not None:
                    # re-stamp the REMAINING budget per attempt (a retry
                    # has less time than the first try had) and bound
                    # the socket wait by it — plus a small grace so the
                    # server's own "expired" reply wins the race over a
                    # raw socket timeout when both fire together
                    msg["deadline_ms"] = deadline.remaining_ms()
                    self._sock.settimeout(deadline.remaining() + 0.25)
                else:
                    self._sock.settimeout(None)
                if self._crc_want and not self._crc_on:
                    # piggybacked integrity negotiation: the field asks
                    # a CRC-capable server to answer with CRC frames
                    # (old servers ignore it and answer plain)
                    msg["crc"] = 1
                _send_msg(self._sock, msg, crc=self._crc_on)
                # chaos seam: a reset AFTER the request reached the
                # server (the retry must dedup, never double-execute)
                fault_point("serving.client.recv", id=msg.get("id"))
                while True:
                    resp, had_crc = _recv_frame(self._sock)
                    if had_crc:
                        self._crc_on = True  # peer speaks CRC: upgrade
                    if resp is None:
                        self._drop()
                        raise ConnectionError("serving connection closed")
                    rid = msg.get("id")
                    if rid is not None and \
                            resp.get("id") not in (None, rid):
                        # a stale attempt's frame (hedge loser / timed-
                        # out retry) still queued on this stream —
                        # discard, never hand it to the wrong caller
                        continue
                    # the link is good again: no jitter on future
                    # clean reopens
                    self._reopen_streak = 0
                    self._poisoned = False
                    return resp
            except OSError:
                self._drop()  # poisoned stream: next attempt re-dials
                raise

    def stream(self, msg: Dict,
               deadline: Optional[Deadline] = None,
               idle_timeout: float = 120.0):
        """One request, MANY response frames (the llm ``generate`` op):
        yields each frame until a terminal one (``done`` / ``shed`` /
        bare ``error``). No transparent retry — a broken stream raises
        and the HA layer resumes on another replica with
        ``resume_from``. ``idle_timeout`` bounds the gap BETWEEN frames
        when no deadline was propagated."""
        msg = _stamp_trace(dict(msg))
        fault_point("serving.request", op=msg.get("op"))
        with self._lock:
            if deadline is not None and deadline.expired():
                raise DeadlineExceeded(
                    "stream deadline expired before send")
            if self._sock is None:
                self._open(reconnect=True)
            try:
                if deadline is not None:
                    msg["deadline_ms"] = deadline.remaining_ms()
                    self._sock.settimeout(deadline.remaining() + 0.25)
                else:
                    self._sock.settimeout(idle_timeout)
                if self._crc_want and not self._crc_on:
                    msg["crc"] = 1
                _send_msg(self._sock, msg, crc=self._crc_on)
                fault_point("serving.client.recv", id=msg.get("id"))
                while True:
                    if deadline is not None:
                        self._sock.settimeout(
                            max(0.0, deadline.remaining()) + 0.25)
                    resp, had_crc = _recv_frame(self._sock)
                    if had_crc:
                        self._crc_on = True
                    if resp is None:
                        self._drop()
                        raise ConnectionError(
                            "serving connection closed mid-stream")
                    rid = msg.get("id")
                    if rid is not None and \
                            resp.get("id") not in (None, rid):
                        continue  # stale frame from a prior request
                    self._reopen_streak = 0
                    self._poisoned = False
                    yield resp
                    if resp.get("done") or resp.get("shed") or (
                            "error" in resp and "seq" not in resp):
                        return
            except OSError:
                self._drop()
                raise

    def rpc(self, msg: Dict,
            deadline: Optional[Deadline] = None) -> Dict:
        # own copy: the auto-stamped id (and per-attempt deadline_ms)
        # must never leak into the caller's dict — a reused dict would
        # carry a stale id into its NEXT request and silently replay the
        # previous answer from the server's dedup cache
        msg = _stamp_trace(dict(msg))
        if msg.get("op") == "predict" and "id" not in msg:
            msg["id"] = uuid.uuid4().hex
        return self._retry.call(self._rpc_once, msg, deadline)

    def close(self):
        self._drop(poisoned=False)  # deliberate: no reconnect jitter


class TCPInputQueue:
    def __init__(self, host: str = "127.0.0.1", port: int = 8980,
                 tls: bool = False, cafile: str = None,
                 verify: bool = True):
        """``tls=True`` encrypts the connection; the server cert is
        verified against ``cafile`` (or the system store). Pass
        ``verify=False`` ONLY for self-signed dev certs."""
        self._conn = _Connection(host, port, tls=tls, cafile=cafile,
                                 verify=verify)
        self._results: Dict[str, np.ndarray] = {}

    def enqueue(self, uri: str, **data) -> None:
        """Enqueue one record (reference: ``InputQueue.enqueue(uri, t=...)``);
        the single tensor value is the model input."""
        if len(data) != 1:
            raise ValueError("enqueue expects exactly one named tensor")
        (_, value), = data.items()
        arr = np.asarray(value)
        resp = self._conn.rpc({"op": "predict", "uri": uri,
                               "data": arr[None] if arr.ndim > 0 and
                               self._needs_batch(arr) else arr})
        if "error" in resp:
            raise RuntimeError(resp["error"])
        self._results[uri] = resp["result"]

    @staticmethod
    def _needs_batch(arr: np.ndarray) -> bool:
        return True  # single-record enqueue always adds the batch dim

    def predict(self, x: np.ndarray,
                deadline_ms: Optional[float] = None,
                model_version: Optional[str] = None) -> np.ndarray:
        """Synchronous batch predict (reference: ``InputQueue.predict``).

        ``deadline_ms``: optional end-to-end budget propagated to the
        server, which enforces it at admission, batch formation and
        reply (docs/serving_ha.md); an exhausted budget raises.
        ``model_version`` pins the request to one registry version —
        a replica serving a different version bounces it retryable
        (docs/model_lifecycle.md; single-endpoint clients surface that
        as an error, the HA client fails over instead)."""
        msg = {"op": "predict", "uri": "_sync_", "data": np.asarray(x)}
        if model_version is not None:
            msg["model_version"] = model_version
        resp = self._conn.rpc(msg, deadline=Deadline.from_ms(deadline_ms))
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp["result"]

    def version(self) -> Dict:
        """The replica's lifecycle identity:
        ``{"version": "vN" | None, "model_spec": ...}``."""
        return self._conn.rpc({"op": "version"})

    def pop_result(self, uri: str) -> Optional[np.ndarray]:
        return self._results.pop(uri, None)

    def stats(self) -> Dict:
        return self._conn.rpc({"op": "stats"})

    def close(self):
        self._conn.close()


class TCPOutputQueue:
    """Result fetch API (reference: ``OutputQueue.query``). With the TCP
    front door responses come back on the request connection, so this wraps
    the same client-side result store."""

    def __init__(self, input_queue: TCPInputQueue):
        self._iq = input_queue

    def query(self, uri: str) -> Optional[np.ndarray]:
        return self._iq.pop_result(uri)
