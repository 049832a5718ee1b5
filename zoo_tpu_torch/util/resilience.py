"""Shared resilience core: deadlines, retries, circuit breaking, fault
injection and heartbeat liveness (counterpart of
``zoo_tpu/util/resilience.py``; its ``ChaosSchedule`` storm comes later).

* :class:`RetryPolicy` — bounded exponential backoff with full jitter and
  an overall wall-clock deadline; the serving TCP client redials under it.
* :class:`CircuitBreaker` — CLOSED → OPEN → HALF_OPEN state machine for
  load shedding: after ``failure_threshold`` consecutive failures callers
  are rejected immediately until ``recovery_timeout`` passes and a probe
  succeeds.
* :class:`FaultInjector` — a process-local registry of named fault sites
  (``inject("serving.request", exc=ConnectionError("boom"), times=2)``).
  Production code marks its seams with :func:`fault_point`; tests arm
  them. When no fault is armed a site costs one dict lookup.
* Heartbeat-file liveness — :func:`touch_heartbeat` /
  :func:`start_heartbeat_thread` let a supervised worker prove it is
  alive, so ``ProcessMonitor`` can treat a hung worker as crashed.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, Type

from zoo_tpu_torch.obs.metrics import counter, gauge
# re-export: FrameCorrupt is transport-layer by nature (a corrupt frame
# is handled exactly like a reset) and every consumer of the retry and
# breaker machinery must catch it
from zoo_tpu_torch.util.integrity import FrameCorrupt  # noqa: F401

logger = logging.getLogger(__name__)

_retry_attempts = counter(
    "zoo_retry_attempts_total", "RetryPolicy attempts executed "
    "(including each call's first try)")
_retry_giveups = counter(
    "zoo_retry_giveups_total", "Retry budgets exhausted (RetryError raised)")
_breaker_transitions = counter(
    "zoo_breaker_transitions_total",
    "Circuit-breaker state transitions, labelled by the state entered",
    labels=("state",))
_breakers_open = gauge(
    "zoo_breaker_open", "Circuit breakers currently open (or probing "
    "half-open) in this process")
_fault_trips = counter(
    "zoo_fault_injections_total", "Armed fault-site firings",
    labels=("site",))

__all__ = [
    "RetryPolicy", "RetryError",
    "Deadline", "DeadlineExceeded",
    "CircuitBreaker", "CircuitOpenError", "FrameCorrupt",
    "FaultInjector", "InjectedFault", "inject", "clear_faults",
    "fault_point", "default_injector",
    "touch_heartbeat", "heartbeat_age", "start_heartbeat_thread",
    "HEARTBEAT_FILE_ENV", "HEARTBEAT_INTERVAL_ENV",
    "env_float", "env_int",
]


def env_float(name: str, default: float) -> float:
    """``$name`` as a float; unset, empty or malformed -> ``default``
    (malformed values warn)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("bad %s=%r; using %s", name, raw, default)
        return default


def env_int(name: str, default: int) -> int:
    return int(env_float(name, default))


class DeadlineExceeded(RuntimeError):
    """A propagated request deadline expired before the work completed.
    Terminal: another attempt can only arrive even later."""


class Deadline:
    """An absolute deadline on the local monotonic clock."""

    __slots__ = ("at",)

    def __init__(self, seconds: float):
        self.at = time.monotonic() + float(seconds)

    @classmethod
    def from_ms(cls, ms) -> Optional["Deadline"]:
        """Budget in milliseconds -> Deadline; ``None`` stays None.
        ``ms <= 0`` is an already-expired deadline."""
        if ms is None:
            return None
        return cls(float(ms) / 1000.0)

    def remaining(self) -> float:
        """Seconds left (negative once expired)."""
        return self.at - time.monotonic()

    def remaining_ms(self) -> float:
        return max(0.0, 1000.0 * self.remaining())

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

class RetryError(RuntimeError):
    """Retry budget (attempts or deadline) exhausted; ``__cause__`` is the
    last underlying failure."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


class RetryPolicy:
    """Bounded exponential backoff with full jitter and a deadline.

    ``max_attempts``: total tries including the first. ``deadline``:
    overall wall-clock budget in seconds measured from the start of
    :meth:`call` — no attempt starts after it has passed, so a dead peer
    costs at most ``deadline`` (plus one socket timeout), never an
    unbounded hang. ``retry_on``: only these exception types are retried;
    anything else propagates immediately (a ``KeyError`` — wrong shard —
    must not burn the budget meant for flaky networks).

    ``sleep`` and ``rng`` are injectable so tests assert backoff math
    without real sleeping.
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, deadline: Optional[float] = None,
                 jitter: bool = True,
                 retry_on: Tuple[Type[BaseException], ...] = (
                     ConnectionError, TimeoutError, OSError),
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] = random.random):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.deadline = deadline
        self.jitter = jitter
        self.retry_on = retry_on
        self._sleep = sleep
        self._rng = rng

    def backoff(self, attempt: int) -> float:
        """Delay after the ``attempt``-th failure (attempt counts from 1)."""
        raw = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        return raw * self._rng() if self.jitter else raw

    def call(self, fn: Callable[..., Any], *args, **kwargs) -> Any:
        start = time.monotonic()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            _retry_attempts.inc()
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                last = e
                if attempt >= self.max_attempts:
                    break
                delay = self.backoff(attempt)
                if self.deadline is not None and \
                        time.monotonic() - start + delay > self.deadline:
                    _retry_giveups.inc()
                    raise RetryError(
                        f"deadline {self.deadline}s exhausted after "
                        f"{attempt} attempt(s): {e!r}", attempt) from e
                logger.debug("retry %d/%d in %.3fs after %r", attempt,
                             self.max_attempts, delay, e)
                self._sleep(delay)
        _retry_giveups.inc()
        raise RetryError(
            f"gave up after {self.max_attempts} attempt(s): {last!r}",
            self.max_attempts) from last


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitOpenError(RuntimeError):
    """Call rejected without being attempted: the breaker is open."""


class CircuitBreaker:
    """CLOSED → OPEN → HALF_OPEN load-shedding state machine.

    CLOSED: calls flow; ``failure_threshold`` *consecutive* failures trip
    the breaker. OPEN: every call is rejected for ``recovery_timeout``
    seconds — the cheap fast-fail that keeps a request queue from piling
    up behind a dead backend. HALF_OPEN: up to ``half_open_max`` probe
    calls are admitted PER PROBE WINDOW; one success closes the breaker,
    one failure reopens it. A probe that never reports back (its caller
    died, or its request expired unexecuted) does NOT wedge the breaker:
    after another ``recovery_timeout`` with no verdict, the probe quota
    refreshes for a new window — without that, one vanished probe left
    the breaker rejecting every call forever. Thread-safe; ``clock`` is
    injectable for tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 recovery_timeout: float = 30.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.recovery_timeout = float(recovery_timeout)
        self.half_open_max = int(half_open_max)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED          # guarded-by: _lock
        self._failures = 0                 # guarded-by: _lock
        self._opened_at = 0.0              # guarded-by: _lock
        self._probes = 0                   # guarded-by: _lock
        self._half_open_at = 0.0           # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self):
        now = self._clock()
        if self._state == self.OPEN and \
                now - self._opened_at >= self.recovery_timeout:
            self._state = self.HALF_OPEN
            self._probes = 0
            self._half_open_at = now
            _breaker_transitions.labels(state=self.HALF_OPEN).inc()
        elif self._state == self.HALF_OPEN and \
                now - self._half_open_at >= self.recovery_timeout:
            # every admitted probe vanished without a verdict (caller
            # died, request dropped unexecuted): open a fresh probe
            # window instead of staying wedged shut forever — the
            # quota stays <= half_open_max per window either way
            self._probes = 0
            self._half_open_at = now

    def allow(self) -> bool:
        """May a call proceed right now? (HALF_OPEN admits probes.)"""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and \
                    self._probes < self.half_open_max:
                self._probes += 1
                return True
            return False

    def record_success(self):
        with self._lock:
            self._failures = 0
            if self._state != self.CLOSED:
                logger.info("circuit breaker closing after probe success")
                _breaker_transitions.labels(state=self.CLOSED).inc()
                _breakers_open.dec()
            self._state = self.CLOSED

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or \
                    self._failures >= self.failure_threshold:
                if self._state != self.OPEN:
                    logger.warning(
                        "circuit breaker OPEN after %d consecutive "
                        "failure(s); shedding load for %.1fs",
                        self._failures, self.recovery_timeout)
                    _breaker_transitions.labels(state=self.OPEN).inc()
                    if self._state == self.CLOSED:
                        # CLOSED->OPEN only: a reopening HALF_OPEN
                        # breaker is already counted in the gauge
                        _breakers_open.inc()
                self._state = self.OPEN
                self._opened_at = self._clock()

    def call(self, fn: Callable[..., Any], *args, **kwargs) -> Any:
        if not self.allow():
            with self._lock:  # snapshot for the message, not a race
                failures = self._failures
            raise CircuitOpenError(
                f"circuit open ({failures} consecutive failures); "
                f"retry after {self.recovery_timeout}s")
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """Default exception raised by an armed fault site."""


class _Fault:
    __slots__ = ("exc", "action", "times", "p", "fired")

    def __init__(self, exc, action, times, p):
        self.exc = exc
        self.action = action
        self.times = times  # None = unlimited
        self.p = p
        self.fired = 0


class FaultInjector:
    """Process-local registry of named fault sites.

    Production code marks a seam with ``injector.fire("shard.fetch")``
    (via the module-level :func:`fault_point`); tests arm it::

        with inject("shard.fetch", exc=ConnectionError("flaky"), times=2):
            ...   # first two fetch attempts raise, third succeeds

    ``action`` is an arbitrary callable run at the site instead of (or
    before) raising — chaos tests use it to SIGKILL the process mid-save.
    ``times=N`` disarms the site after N firings; ``p`` fires
    probabilistically. Unarmed sites cost a single dict lookup.

    **Deterministic replay**: probabilistic (``p < 1``) firings draw from
    the injector's OWN ``random.Random``, seeded from ``seed=`` or
    ``$ZOO_FAULT_SEED`` — so a chaos run that found a bug replays the
    exact same fault schedule (same arm order + same seed = same trips).
    :meth:`reseed` restarts the sequence mid-process. Unseeded injectors
    keep fresh entropy per process, like before.
    """

    def __init__(self, seed: Optional[int] = None):
        self._lock = threading.Lock()
        self._sites: Dict[str, _Fault] = {}
        if seed is None:
            env = os.environ.get("ZOO_FAULT_SEED")
            seed = int(env) if env else None
        self.fault_seed = seed
        self._rng = random.Random(seed)

    def reseed(self, seed: Optional[int] = None):
        """Restart the fault schedule (``seed=None`` re-reads
        ``$ZOO_FAULT_SEED``, falling back to fresh entropy)."""
        if seed is None:
            env = os.environ.get("ZOO_FAULT_SEED")
            seed = int(env) if env else None
        self.fault_seed = seed
        self._rng = random.Random(seed)
        return self

    def inject(self, site: str,
               exc: Optional[BaseException] = None,
               times: Optional[int] = None,
               action: Optional[Callable[..., None]] = None,
               p: float = 1.0) -> "_Armed":
        if exc is None and action is None:
            exc = InjectedFault(f"injected fault at {site!r}")
        with self._lock:
            self._sites[site] = _Fault(exc, action, times, p)
        return _Armed(self, site)

    def clear(self, site: Optional[str] = None):
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def fired(self, site: str) -> int:
        with self._lock:
            f = self._sites.get(site)
            return f.fired if f else 0

    def fire(self, site: str, **ctx):
        """Called from production code at a named seam; no-op unless a
        test armed this site."""
        if not self._sites:  # fast path: nothing armed anywhere
            return
        with self._lock:
            f = self._sites.get(site)
            if f is None:
                return
            if f.times is not None and f.fired >= f.times:
                return
            if f.p < 1.0 and self._rng.random() >= f.p:
                return
            f.fired += 1
            exc, action = f.exc, f.action
        _fault_trips.labels(site=site).inc()
        if action is not None:
            action(site=site, **ctx)
        if exc is not None:
            raise exc


class _Armed:
    """Context-manager handle for one armed site (clears on exit; the
    firing count stays readable afterwards)."""

    def __init__(self, injector: FaultInjector, site: str):
        self._injector = injector
        self.site = site
        self._final: Optional[int] = None

    @property
    def fired(self) -> int:
        if self._final is not None:
            return self._final
        return self._injector.fired(self.site)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._final = self._injector.fired(self.site)
        self._injector.clear(self.site)
        return False


default_injector = FaultInjector()


def inject(site: str, **kwargs) -> _Armed:
    return default_injector.inject(site, **kwargs)


def clear_faults(site: Optional[str] = None):
    default_injector.clear(site)


def fault_point(site: str, **ctx):
    """The instrumentation hook production code places at a seam."""
    default_injector.fire(site, **ctx)


# ---------------------------------------------------------------------------
# heartbeat liveness
# ---------------------------------------------------------------------------

HEARTBEAT_FILE_ENV = "ZOO_HEARTBEAT_FILE"
HEARTBEAT_INTERVAL_ENV = "ZOO_HEARTBEAT_INTERVAL"


def touch_heartbeat(path: Optional[str] = None):
    """Stamp the heartbeat file (mtime + a ``time.monotonic()`` payload).
    ``path`` defaults to ``$ZOO_HEARTBEAT_FILE``; silently a no-op when
    neither is set, so worker code can call it unconditionally.

    The payload is the monotonic clock, not wall time: CLOCK_MONOTONIC
    is system-wide on Linux, so the supervising process on the same host
    computes ages immune to NTP steps — a 30 s clock correction used to
    read as a 30 s-stale heartbeat and could kill a healthy worker."""
    path = path or os.environ.get(HEARTBEAT_FILE_ENV)
    if not path:
        return
    try:
        # write-then-replace: a reader must never see a half-written
        # stamp (a truncated float would parse as an ancient beat and
        # read as a hang)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(repr(time.monotonic()))
        os.replace(tmp, path)
    except OSError as e:  # a missing dir must not kill the worker
        logger.debug("heartbeat touch failed: %s", e)


def heartbeat_age(path: str) -> Optional[float]:
    """Seconds since the heartbeat file was last stamped; None when the
    file does not exist yet (worker still booting). Prefers the
    monotonic payload :func:`touch_heartbeat` writes; an empty or
    foreign file (plain ``touch``) falls back to wall-clock mtime."""
    try:
        with open(path) as f:
            stamp = float(f.read().strip())
        now = time.monotonic()
        if 0.0 <= stamp <= now:  # a stamp from before a reboot is junk
            return now - stamp
    except (OSError, ValueError):
        pass
    try:
        return max(0.0, time.time() - os.stat(path).st_mtime)
    except OSError:
        return None


def start_heartbeat_thread(path: Optional[str] = None,
                           interval: Optional[float] = None
                           ) -> Optional[threading.Thread]:
    """Background daemon stamping the heartbeat file every ``interval``
    seconds. Defaults come from ``$ZOO_HEARTBEAT_FILE`` /
    ``$ZOO_HEARTBEAT_INTERVAL``; returns None (no thread) when no file is
    configured — ``init_orca_context`` calls this unconditionally and
    supervised workers opt in through the env their launcher sets.

    Liveness, not progress: a worker stuck inside one XLA dispatch still
    heartbeats. Pair with application-level progress checks where one
    step hanging forever matters.
    """
    path = path or os.environ.get(HEARTBEAT_FILE_ENV)
    if not path:
        return None
    with _beating_lock:
        if path in _beating:  # idempotent: one thread per file
            return _beating[path]
    interval = interval if interval is not None else \
        float(os.environ.get(HEARTBEAT_INTERVAL_ENV, "1.0"))

    def _beat():
        while True:
            touch_heartbeat(path)
            time.sleep(interval)

    t = threading.Thread(target=_beat, daemon=True,
                         name="zoo-heartbeat")
    with _beating_lock:
        _beating[path] = t
    t.start()
    return t


_beating: Dict[str, threading.Thread] = {}
_beating_lock = threading.Lock()
