"""Trace spans: per-process JSONL event log + cross-host trace ids
(counterpart of ``zoo_tpu/obs/tracing.py``, whole).

:func:`span` is a context manager marking one timed region::

    with span("ckpt.save", step=120):
        ...

Each span emits two JSONL records into the process's trace file — a
``B`` (begin) event and an ``E`` (end) event carrying the monotonic
duration and error flag — with a ``span`` id, its ``parent`` span id
(spans nest per thread), and the process-wide ``trace`` id. One training
step or serving request can therefore be followed across hosts: the
coordinator mints a trace id and :func:`share_trace_id` propagates it to
every process over the ``torch.distributed`` default store, so all
hosts' trace files stitch on the shared id.

Tracing is off until a sink exists: call :func:`trace_to` or set
``$ZOO_TRACE_DIR``. A disabled :func:`span` costs one global check and a
no-op context manager — safe to leave in hot paths.

Request-scoped tracing: a serving client mints
one trace id per logical request and it rides the wire; the server
adopts it with :func:`trace_context`, so every span recorded while
handling that request — on any process of the fleet — carries the
REQUEST's trace id instead of the process-wide one, and
``zoo_tpu_torch.obs.timeline`` joins the per-process JSONL files back into
one per-request timeline. :func:`emit_span` / :func:`emit_event` write
complete ("X") and instant ("I") events with an EXPLICIT trace id for
code that works on behalf of many requests at once (the LLM engine's
scheduler thread, the batcher) where thread-local nesting cannot apply.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import threading
import time
import uuid
from typing import Iterator, List, Optional

from zoo_tpu_torch.obs.coordination import (
    coordination_store,
    process_topology,
    store_get,
)

__all__ = [
    "span", "trace_to", "stop_tracing", "tracing_enabled",
    "current_trace_id", "set_trace_id", "share_trace_id",
    "read_trace", "TRACE_DIR_ENV",
    "trace_context", "ambient_trace_id", "current_span_id",
    "new_trace_id", "emit_span", "emit_event", "active_spans",
    "iter_jsonl", "trace_file_path",
]

logger = logging.getLogger(__name__)

TRACE_DIR_ENV = "ZOO_TRACE_DIR"

_lock = threading.Lock()
_sink = None            # type: Optional[_TraceLog]
_env_checked = False
_trace_id: Optional[str] = None
_tls = threading.local()  # .stack: span-id stack per thread
#                           .trace: request trace-id override per thread
# spans begun but not yet ended, across every thread — what a crash
# flight-recorder bundle captures as "where was this process when it
# died". Only mutated while a sink exists (span() returns early when
# tracing is off), so the disabled hot path never touches it.
_live_spans: dict = {}
_live_lock = threading.Lock()


class _TraceLog:
    """Append-only JSONL writer for one process's trace events."""

    def __init__(self, dir_path: str):
        os.makedirs(dir_path, exist_ok=True)
        self.path = os.path.join(
            dir_path,
            f"trace-{socket.gethostname()}-{os.getpid()}.jsonl")
        self._f = open(self.path, "a", encoding="utf-8")
        self._wlock = threading.Lock()

    def write(self, event: dict):
        line = json.dumps(event, separators=(",", ":"), default=str)
        try:
            with self._wlock:
                self._f.write(line + "\n")
                self._f.flush()
        except (OSError, ValueError) as e:
            # telemetry must never fail the instrumented operation (a
            # full disk, or stop_tracing() racing a span in another
            # thread) — and an error raised from span()'s finally would
            # even MASK the operation's own exception
            logger.debug("trace write dropped: %s", e)

    def close(self):
        with self._wlock:
            try:
                self._f.close()
            except OSError:
                pass


def trace_to(dir_path: str) -> str:
    """Start writing span events under ``dir_path``; returns the trace
    file path for this process."""
    global _sink
    with _lock:
        if _sink is not None:
            _sink.close()
        _sink = _TraceLog(dir_path)
        return _sink.path


def stop_tracing():
    global _sink, _env_checked
    with _lock:
        if _sink is not None:
            _sink.close()
        _sink = None
        _env_checked = True  # an explicit stop beats the env default


def _active_sink() -> "Optional[_TraceLog]":
    global _sink, _env_checked
    if _sink is not None:
        return _sink
    if _env_checked:
        return None
    with _lock:
        if _sink is None and not _env_checked:
            _env_checked = True
            d = os.environ.get(TRACE_DIR_ENV)
            if d:
                try:
                    _sink = _TraceLog(d)
                except OSError as e:  # bad dir must not kill the caller
                    logger.warning("cannot open trace dir %s: %s", d, e)
        return _sink


def tracing_enabled() -> bool:
    return _active_sink() is not None


def trace_file_path() -> Optional[str]:
    """This process's trace file path (None while tracing is off)."""
    sink = _active_sink()
    return sink.path if sink is not None else None


# ------------------------------------------------------------- trace ids

def new_trace_id() -> str:
    """A fresh request-scoped trace id (what a serving client mints per
    logical request before putting it on the wire)."""
    return uuid.uuid4().hex


def current_trace_id() -> str:
    """The ACTIVE trace id: the thread's adopted request trace inside a
    :func:`trace_context`, else this process's own id (minted on first
    use)."""
    tid = getattr(_tls, "trace", None)
    if tid is not None:
        return tid
    global _trace_id
    with _lock:
        if _trace_id is None:
            _trace_id = uuid.uuid4().hex
        return _trace_id


def ambient_trace_id() -> Optional[str]:
    """The thread's adopted REQUEST trace id, or None outside any
    :func:`trace_context` (never mints; the wire stamps only explicit
    request traces, not the ambient process id)."""
    return getattr(_tls, "trace", None)


def current_span_id() -> Optional[str]:
    """The innermost open span id on this thread (for parenting a
    remote child over the wire), or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


@contextlib.contextmanager
def trace_context(trace_id: Optional[str],
                  parent_span: Optional[str] = None) -> Iterator[None]:
    """Adopt ``trace_id`` for this thread: every :func:`span` inside
    carries the request's trace id (and parents under ``parent_span``,
    the caller's span id from the wire) instead of the process-wide
    trace. ``trace_id=None`` is a no-op passthrough, so wire handlers
    can wrap unconditionally."""
    if trace_id is None:
        yield
        return
    prev = getattr(_tls, "trace", None)
    _tls.trace = str(trace_id)
    st = _stack()
    pushed = parent_span is not None
    if pushed:
        st.append(str(parent_span))
    try:
        yield
    finally:
        if pushed:
            st.pop()
        _tls.trace = prev


def set_trace_id(trace_id: str):
    global _trace_id
    with _lock:
        _trace_id = str(trace_id)


_share_generation = 0
_share_gen_lock = threading.Lock()


def share_trace_id(timeout_s: float = 30.0) -> str:
    """Adopt one cluster-wide trace id (collective: call on every
    process). Rank 0 publishes its trace id through the process group's
    store; everyone else blocks for it and adopts it, so all hosts' span
    events stitch into one distributed trace. No process group: just
    returns the local id."""
    rank, world = process_topology()
    if world == 1:
        return current_trace_id()
    store = coordination_store()
    if store is None:
        raise RuntimeError(
            "share_trace_id needs the torch.distributed default store "
            "(init_process_group) in multi-process mode")
    global _share_generation
    with _share_gen_lock:
        _share_generation += 1
        gen = _share_generation
    key = f"zoo:obs:trace:{gen}"
    if rank == 0:
        store.set(key, current_trace_id())
    tid = store_get(store, key, timeout_s)
    set_trace_id(tid)
    return tid


# ----------------------------------------------------------------- spans

def _stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[str]]:
    """Timed, nested trace region; yields the span id (None when tracing
    is off). Exceptions propagate; the end event records ``ok: false``."""
    sink = _active_sink()
    if sink is None:
        yield None
        return
    sid = uuid.uuid4().hex[:16]
    st = _stack()
    parent = st[-1] if st else None
    ev = {"ev": "B", "name": name, "trace": current_trace_id(),
          "span": sid, "parent": parent, "pid": os.getpid(),
          "ts": time.time()}
    if attrs:
        ev["attrs"] = attrs
    sink.write(ev)
    with _live_lock:
        _live_spans[sid] = ev
    st.append(sid)
    t0 = time.perf_counter()
    ok = True
    try:
        yield sid
    except BaseException:
        ok = False
        raise
    finally:
        st.pop()
        with _live_lock:
            _live_spans.pop(sid, None)
        sink.write({"ev": "E", "name": name,
                    "trace": ev["trace"], "span": sid,
                    "ts": time.time(),
                    "dur_s": time.perf_counter() - t0, "ok": ok})


def active_spans() -> List[dict]:
    """Begin events of every span currently OPEN in this process (any
    thread) — the "where was it" a flight-recorder bundle captures."""
    with _live_lock:
        return list(_live_spans.values())


def emit_span(name: str, ts: float, dur_s: float,
              trace: Optional[str] = None,
              parent: Optional[str] = None, ok: bool = True,
              span_id: Optional[str] = None,
              **attrs) -> Optional[str]:
    """Write one COMPLETE ("X") span event: started at wall ``ts``,
    lasted ``dur_s``. For recorders that time a region themselves on
    behalf of a specific request (the engine's scheduler working a
    stream, a client attempt thread) where a nested :func:`span` cannot
    carry the right identity. ``trace=None`` falls back to the active
    trace id. Returns the span id (None while tracing is off)."""
    sink = _active_sink()
    if sink is None:
        return None
    sid = span_id if span_id is not None else uuid.uuid4().hex[:16]
    ev = {"ev": "X", "name": name,
          "trace": trace if trace is not None else current_trace_id(),
          "span": sid, "parent": parent, "pid": os.getpid(),
          "ts": ts, "dur_s": float(dur_s), "ok": bool(ok)}
    if attrs:
        ev["attrs"] = attrs
    sink.write(ev)
    return sid


def emit_event(name: str, trace: Optional[str] = None,
               parent: Optional[str] = None, **attrs) -> Optional[str]:
    """Write one INSTANT ("I") event (admission, preemption, a shed —
    things with a moment but no duration). Same identity rules as
    :func:`emit_span`."""
    sink = _active_sink()
    if sink is None:
        return None
    sid = uuid.uuid4().hex[:16]
    ev = {"ev": "I", "name": name,
          "trace": trace if trace is not None else current_trace_id(),
          "span": sid, "parent": parent, "pid": os.getpid(),
          "ts": time.time()}
    if attrs:
        ev["attrs"] = attrs
    sink.write(ev)
    return sid


def iter_jsonl(path: str) -> Iterator[dict]:
    """Yield every parseable JSON object from a JSONL file, skipping
    torn or truncated lines. A crash mid-write is an EXPECTED event for
    trace files and flight-recorder spills (a SIGKILL can land between
    any two bytes), so a half-written tail, an interleaved torn line,
    or invalid UTF-8 from a partial flush must never take the readable
    prefix down with it. A missing/unreadable file yields nothing."""
    try:
        f = open(path, encoding="utf-8", errors="replace")
    except OSError:
        return
    with f:
        while True:
            try:
                line = f.readline()
            except (OSError, ValueError):
                return  # unreadable remainder: keep what we have
            if not line:
                return
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue  # torn write: skip, keep the rest
            if isinstance(obj, dict):
                yield obj


def read_trace(dir_path: str) -> List[dict]:
    """Load every span event under ``dir_path`` (all hosts' files),
    sorted by wall timestamp — the offline-analysis read-back. Torn or
    truncated lines (a replica killed mid-write) are skipped, never
    raised."""
    events: List[dict] = []
    if not os.path.isdir(dir_path):
        return events
    for fname in sorted(os.listdir(dir_path)):
        if not (fname.startswith("trace-") and fname.endswith(".jsonl")):
            continue
        events.extend(iter_jsonl(os.path.join(dir_path, fname)))
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events
