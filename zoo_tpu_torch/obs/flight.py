"""Crash flight recorder: a bounded ring of recent structured events
plus a postmortem bundle dump (counterpart of ``zoo_tpu/obs/flight.py``,
whole).

A serving replica that dies takes its last seconds of state — queue
depths, shed reasons, breaker flips, the streams it was decoding — to
the grave; the logs say *that* it died, never *what it was doing*.
This module is the black box:

* :func:`record_event` appends one structured event (``kind`` + fields)
  to a bounded per-process ring (``ZOO_OBS_FLIGHT_CAP``, default 512;
  0 disables). Producers across the stack feed it: engine tick
  summaries and stream lifecycles, admission sheds with their reason,
  circuit-breaker transitions, retry give-ups, SLO breach flips.
* When ``$ZOO_OBS_POSTMORTEM_DIR`` is set (a :class:`ReplicaGroup`
  sets it per replica), every event is ALSO appended to a
  ``flight-<pid>.jsonl`` spill file and flushed — so even a SIGKILL,
  which no handler can catch, leaves the ring's contents on disk up to
  the last flushed event; the supervisor packages that spill into a
  bundle afterwards (:meth:`ReplicaGroup.harvest_postmortems`).
* :func:`dump_bundle` writes the full postmortem — ring contents,
  metrics-registry snapshot, resolved ``ZOO_*`` config, the spans open
  at death, the last SLO verdict — as one atomic JSON file.
  :func:`install_crash_handlers` arms it on unhandled-exception exit
  and fatal-but-catchable signals (chaining whatever handler was
  already installed, e.g. the serving drain); the training guardian
  calls it on its rc-75 preemption exit, and the serving wire exposes
  it live as ``op=debug_dump``.

Stdlib + :mod:`zoo_tpu_torch.obs` only — every layer may import this.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

from zoo_tpu_torch.obs.metrics import counter, get_registry
from zoo_tpu_torch.obs.tracing import active_spans, iter_jsonl

__all__ = [
    "FlightRecorder", "flight_recorder", "record_event",
    "dump_bundle", "install_crash_handlers", "read_spill",
    "FLIGHT_CAP_ENV", "POSTMORTEM_DIR_ENV",
]

logger = logging.getLogger(__name__)

FLIGHT_CAP_ENV = "ZOO_OBS_FLIGHT_CAP"
POSTMORTEM_DIR_ENV = "ZOO_OBS_POSTMORTEM_DIR"

_events_total = counter(
    "zoo_flight_events_total", "Events recorded into the flight ring, "
    "by kind", labels=("kind",))
_dumps_total = counter(
    "zoo_flight_dumps_total", "Postmortem bundles written, by reason",
    labels=("reason",))
_kind_children: Dict[str, object] = {}  # signal-safe label-child cache


def _config_snapshot() -> Dict[str, str]:
    """The resolved knob surface: every ZOO_* / CUDA_* / PYTORCH_* env
    var — what an operator needs to know about how the dead process was
    configured."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(("ZOO_", "CUDA_", "PYTORCH_", "TORCH_"))}


class FlightRecorder:
    """One process's ring buffer + spill + bundle writer."""

    def __init__(self, capacity: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(FLIGHT_CAP_ENV, "512"))
            except ValueError:
                capacity = 512
        self.capacity = max(0, capacity)
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.capacity or 1)
        # REENTRANT: the crash handlers call record()/dump() from a
        # signal frame that may have interrupted this very thread
        # mid-record (the spill write is a wide window); a plain Lock
        # would deadlock the process right when the postmortem matters
        self._lock = threading.RLock()
        self._dump_seq = 0
        if spill_dir is None:
            spill_dir = os.environ.get(POSTMORTEM_DIR_ENV)
        self.spill_dir = spill_dir
        self.spill_path: Optional[str] = None
        self._spill_f = None
        if spill_dir and self.capacity:
            try:
                os.makedirs(spill_dir, exist_ok=True)
                self.spill_path = os.path.join(
                    spill_dir, f"flight-{os.getpid()}.jsonl")
                self._spill_f = open(self.spill_path, "a",
                                     encoding="utf-8")
            except OSError as e:  # a bad dir must not kill the worker
                logger.warning("flight spill disabled: %s", e)
                self._spill_f = None

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(self, kind: str, **fields):
        """Append one event (never raises; telemetry must not fail the
        instrumented operation)."""
        if not self.capacity:
            return
        ev = {"ts": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)
        # per-kind child cached OUTSIDE the metrics family lock: the
        # crash handler records from a signal frame, and re-entering
        # the family's plain Lock mid-interrupt would deadlock; a dict
        # get is atomic under the GIL (install_crash_handlers pre-warms
        # its kinds so the handler never takes the creation path)
        child = _kind_children.get(kind)
        if child is None:
            child = _kind_children.setdefault(
                kind, _events_total.labels(kind=kind))
        child.inc()
        f = self._spill_f
        if f is not None:
            try:
                # chaos seam: a full spill dir (disk-full gray failure)
                # must degrade to dropped spill lines, never kill the
                # instrumented operation — the storm arms this site
                # with an OSError to prove it (lazy import: this module
                # sits below resilience in the layering)
                from zoo_tpu_torch.util.resilience import fault_point
                fault_point("flight.spill")
                with self._lock:
                    f.write(json.dumps(ev, separators=(",", ":"),
                                       default=str) + "\n")
                    f.flush()
            except (OSError, ValueError, ImportError) as e:
                # ImportError: interpreter teardown mid-record — the
                # spill line is lost, the process must not care
                logger.debug("flight spill write dropped: %s", e)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def snapshot_bundle(self, reason: str) -> Dict:
        """The postmortem payload: ring + metrics + config + open spans
        + last SLO verdict. Also what the wire ``op=debug_dump`` serves
        live."""
        try:
            metrics = get_registry().snapshot()
        except Exception as e:  # noqa: BLE001 — a bundle with no
            # metrics still beats no bundle
            metrics = {"error": repr(e)}
        try:
            from zoo_tpu_torch.obs.slo import last_status
            slo = last_status()
        except Exception:  # noqa: BLE001
            slo = None
        return {"reason": reason, "ts": time.time(),
                "host": socket.gethostname(), "pid": os.getpid(),
                "argv": list(sys.argv),
                "ring": self.events(),
                "metrics": metrics,
                "config": _config_snapshot(),
                "active_spans": active_spans(),
                "slo": slo}

    def dump(self, reason: str,
             dir_path: Optional[str] = None) -> Optional[str]:
        """Write the bundle atomically (tmp + rename) into ``dir_path``
        (default: the spill dir / ``$ZOO_OBS_POSTMORTEM_DIR``). Returns
        the path, or None when no directory is configured or the write
        failed — dumping is best-effort by contract: it runs on the way
        DOWN and must never mask the original failure."""
        dir_path = dir_path or self.spill_dir \
            or os.environ.get(POSTMORTEM_DIR_ENV)
        if not dir_path:
            return None
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        path = os.path.join(
            dir_path,
            f"postmortem-{socket.gethostname()}-{os.getpid()}-{seq}.json")
        try:
            os.makedirs(dir_path, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.snapshot_bundle(reason), f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001
            logger.warning("postmortem dump failed: %s", e)
            return None
        _dumps_total.labels(reason=reason).inc()
        return path

    def close(self):
        f, self._spill_f = self._spill_f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass


# ------------------------------------------------------------ singleton

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-global recorder (created on first use from the env;
    :func:`reset_for_tests` rebuilds it after env changes)."""
    global _recorder
    r = _recorder
    if r is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
            r = _recorder
    return r


def reset_for_tests():
    global _recorder, _handlers_installed
    with _recorder_lock:
        if _recorder is not None:
            _recorder.close()
        _recorder = None
    _handlers_installed = False


def record_event(kind: str, **fields):
    """Module-level shorthand every producer calls."""
    flight_recorder().record(kind, **fields)


def dump_bundle(reason: str,
                dir_path: Optional[str] = None) -> Optional[str]:
    return flight_recorder().dump(reason, dir_path)


def read_spill(path: str) -> List[dict]:
    """Parse one spill file, torn-tail tolerant (the producer may have
    been SIGKILLed mid-write)."""
    return list(iter_jsonl(path))


# -------------------------------------------------------- crash handlers

_handlers_installed = False


def install_crash_handlers(dir_path: Optional[str] = None,
                           signals: Optional[tuple] = None) -> bool:
    """Dump a bundle on the ways a process can die that CAN be caught:
    unhandled exception (``sys.excepthook``) and fatal-but-catchable
    signals (default SIGTERM + SIGINT). Existing handlers are CHAINED,
    not replaced — the serving drain handler still drains, the default
    Int/Term disposition still kills. SIGKILL cannot be caught by
    design; the continuously-flushed spill file is its postmortem.
    Main-thread only for the signal half; returns False elsewhere."""
    global _handlers_installed
    if _handlers_installed:
        return True
    rec = flight_recorder()
    if not rec.enabled:
        return False

    # pre-warm the label children the handlers will inc, so the signal
    # frame never takes the metrics family's (non-reentrant) creation
    # lock
    for k in ("fatal_signal", "unhandled_exception"):
        _kind_children.setdefault(k, _events_total.labels(kind=k))

    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            rec.record("unhandled_exception", error=repr(exc),
                       type=exc_type.__name__)
            rec.dump("unhandled_exception", dir_path)
        except Exception:  # noqa: BLE001 — never mask the real crash
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook

    import signal as _signal
    sigs = signals if signals is not None else (
        _signal.SIGTERM, _signal.SIGINT)
    try:
        for s in sigs:
            prev = _signal.getsignal(s)

            def handler(signum, frame, _prev=prev):
                try:
                    rec.record("fatal_signal", signum=int(signum))
                    rec.dump(f"signal-{int(signum)}", dir_path)
                except Exception:  # noqa: BLE001
                    pass
                if callable(_prev):
                    _prev(signum, frame)
                elif _prev == _signal.SIG_DFL:
                    # re-deliver with the default disposition so the
                    # exit code still says "killed by signal"
                    _signal.signal(signum, _signal.SIG_DFL)
                    _signal.raise_signal(signum)

            _signal.signal(s, handler)
    except ValueError:  # not the main thread: excepthook half only
        _handlers_installed = True
        return False
    _handlers_installed = True
    return True
