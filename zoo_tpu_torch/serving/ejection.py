"""Gray-failure ejection: latency/error outlier scoring for replicas
(counterpart of ``zoo_tpu/serving/ejection.py``, whole).

A replica can be *alive* — passing ``/healthz``, accepting connections,
answering pings — and still be the worst thing in the fleet: a thermal-
throttled host, a dying disk stalling its page cache, a neighbor
saturating its NIC. Crash detection (breakers, supervisors) never sees
it; every Nth request simply takes 50x longer. This module is the
latency-aware membership layer the HA client routes with:

* every replica seat gets a :class:`ReplicaScore` — an EWMA of its
  client-observed attempt latency plus an EWMA error rate, fed by the
  :class:`~zoo_tpu_torch.serving.ha_client.HAServingClient` on every attempt
  (predict latency, generate time-to-first-frame, transport errors);
* the :class:`EjectionController` compares each seat against the
  MEDIAN of its healthy peers (outlier-vs-group, the Tail-at-Scale
  framing — an absolute threshold would misfire every time the model
  or batch size changes): a sustained outlier walks a state machine

      ACTIVE → PROBATION → EJECTED → (backoff) → PROBATION → ACTIVE

  - **probation**: routed away from (tail of the plan, so only
    failover/hedge traffic lands there) but still *probed* — every
    ``ZOO_EJECT_PROBE_S`` one live request is deliberately planned
    onto it as a canary, which is what lets a recovered seat prove
    itself with real traffic (a ping would lie: the gray failure is in
    the model path, not the accept loop);
  - **ejected**: out of the rotation entirely (used only when every
    other seat failed); re-admission is timer-driven with exponential
    backoff per consecutive ejection (``ZOO_EJECT_READMIT_S`` base),
    landing back in probation where canaries decide.

Knobs (``ZOO_EJECT_*``, docs/fault_tolerance.md): the whole feature
(``ZOO_EJECT``, default on), the outlier factor vs the group median
(``ZOO_EJECT_FACTOR``), the absolute floor below which nothing is an
outlier (``ZOO_EJECT_MIN_MS`` — microsecond jitter on a loopback bench
must never eject), the EWMA smoothing (``ZOO_EJECT_EWMA_ALPHA``), the
evidence bar (``ZOO_EJECT_MIN_SAMPLES``), the sustained-degradation
window before ejection (``ZOO_EJECT_PROBATION_S``), the canary cadence
(``ZOO_EJECT_PROBE_S``), the re-admission backoff
(``ZOO_EJECT_READMIT_S`` / ``_MAX_S``), and the error-rate trigger
(``ZOO_EJECT_ERROR_RATE``).

``clock`` is injectable so the state machine is unit-testable
without sleeping.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

from zoo_tpu_torch.obs.metrics import counter, gauge
from zoo_tpu_torch.util.resilience import _flight, env_float, env_int

__all__ = ["ReplicaScore", "EjectionController", "EjectionConfig",
           "ACTIVE", "PROBATION", "EJECTED"]

ACTIVE, PROBATION, EJECTED = "active", "probation", "ejected"

_transitions = counter(
    "zoo_serve_ejections_total",
    "Gray-failure membership transitions performed by HA clients in "
    "this process (probation = outlier routed away from; ejected = "
    "sustained outlier removed from rotation; probe = ejected seat "
    "re-admitted to probation for canarying; readmitted = seat proved "
    "itself healthy again)", labels=("event",))
_ejected_gauge = gauge(
    "zoo_serve_replicas_ejected",
    "Replica seats currently EJECTED from this process's HA-client "
    "rotation for sustained gray degradation")
_probation_gauge = gauge(
    "zoo_serve_replicas_probation",
    "Replica seats currently on PROBATION (routed away from, canaried "
    "with live requests) in this process's HA-client rotation")


class EjectionConfig:
    """Every ejection knob, parsed once (constructor args win over
    ``ZOO_EJECT_*`` env)."""

    def __init__(self, enabled: Optional[bool] = None,
                 factor: Optional[float] = None,
                 min_ms: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 alpha: Optional[float] = None,
                 probation_s: Optional[float] = None,
                 probe_interval_s: Optional[float] = None,
                 readmit_base_s: Optional[float] = None,
                 readmit_max_s: Optional[float] = None,
                 error_rate: Optional[float] = None):
        import os
        if enabled is None:
            enabled = os.environ.get("ZOO_EJECT", "1") not in (
                "0", "false", "off")
        self.enabled = bool(enabled)
        self.factor = factor if factor is not None else \
            env_float("ZOO_EJECT_FACTOR", 3.0)
        self.min_ms = min_ms if min_ms is not None else \
            env_float("ZOO_EJECT_MIN_MS", 25.0)
        self.min_samples = min_samples if min_samples is not None else \
            env_int("ZOO_EJECT_MIN_SAMPLES", 5)
        self.alpha = alpha if alpha is not None else \
            env_float("ZOO_EJECT_EWMA_ALPHA", 0.35)
        self.probation_s = probation_s if probation_s is not None else \
            env_float("ZOO_EJECT_PROBATION_S", 1.5)
        self.probe_interval_s = probe_interval_s \
            if probe_interval_s is not None else \
            env_float("ZOO_EJECT_PROBE_S", 0.5)
        self.readmit_base_s = readmit_base_s \
            if readmit_base_s is not None else \
            env_float("ZOO_EJECT_READMIT_S", 1.0)
        self.readmit_max_s = readmit_max_s \
            if readmit_max_s is not None else \
            env_float("ZOO_EJECT_READMIT_MAX_S", 30.0)
        self.error_rate = error_rate if error_rate is not None else \
            env_float("ZOO_EJECT_ERROR_RATE", 0.6)


class ReplicaScore:
    """One seat's rolling health: EWMA latency (ms) + EWMA error rate
    + the membership state the controller walks it through."""

    __slots__ = ("name", "ewma_ms", "err", "n", "state", "state_since",
                 "last_probe", "eject_count", "readmit_at", "role",
                 "occupancy", "_lock")

    def __init__(self, name: str, clock: Callable[[], float] =
                 time.monotonic):
        self.name = name
        self.ewma_ms: Optional[float] = None
        self.err = 0.0
        self.n = 0
        self.state = ACTIVE
        self.state_since = clock()
        self.last_probe = 0.0
        self.eject_count = 0
        self.readmit_at = 0.0
        # disaggregation routing signals (docs/disaggregated_serving.md):
        # the seat's advertised role (prefill/decode/mixed, learned from
        # reply frames) and its decode occupancy — busy slots / total
        # slots from llm_stats, EWMA-smoothed so one poll of a
        # momentarily full seat doesn't starve it
        self.role: Optional[str] = None
        self.occupancy: Optional[float] = None
        self._lock = threading.Lock()

    def record(self, dt_s: float, alpha: float = 0.35):
        """One successful attempt's client-observed latency."""
        ms = float(dt_s) * 1000.0
        with self._lock:
            self.ewma_ms = ms if self.ewma_ms is None else \
                (1.0 - alpha) * self.ewma_ms + alpha * ms
            self.err *= (1.0 - alpha)
            self.n += 1

    def record_error(self, alpha: float = 0.35):
        """One transport-level failure (reset, refused, corrupt frame,
        retry give-up). Deadline expiries and overload sheds are NOT
        errors — the budget ran out / the seat is honest about being
        full; charging them would eject a merely busy replica."""
        with self._lock:
            self.err = (1.0 - alpha) * self.err + alpha
            self.n += 1

    def note_role(self, role: Optional[str]):
        """Learn the seat's advertised replica role (every reply frame
        carries it once the server knows its engine's role)."""
        if role is not None:
            with self._lock:
                self.role = str(role)

    def note_occupancy(self, frac: float, alpha: float = 0.5):
        """One decode-occupancy observation (busy/total slots, 0..1)."""
        frac = min(1.0, max(0.0, float(frac)))
        with self._lock:
            self.occupancy = frac if self.occupancy is None else \
                (1.0 - alpha) * self.occupancy + alpha * frac

    def snapshot(self) -> Dict:
        return {"name": self.name, "state": self.state,
                "ewma_ms": self.ewma_ms, "err": round(self.err, 4),
                "n": self.n, "eject_count": self.eject_count,
                "role": self.role,
                "occupancy": None if self.occupancy is None
                else round(self.occupancy, 3)}


class EjectionController:
    """The group-level decision layer: owns the scores' state
    transitions and the canary cadence. One per
    :class:`HAServingClient`."""

    def __init__(self, config: Optional[EjectionConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or EjectionConfig()
        self.clock = clock
        # reentrant: evaluate() holds it across a whole pass and _move
        # re-enters for the event log
        self._lock = threading.RLock()
        # (ts, event, seat) transition log, bounded — what the bench's
        # detect-to-eject measurement and postmortems read
        self.events: List[tuple] = []

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    def new_score(self, name: str) -> ReplicaScore:
        return ReplicaScore(name, clock=self.clock)

    # -- transitions -------------------------------------------------------
    def _move(self, s: ReplicaScore, state: str, event: str, now: float):
        s.state = state
        s.state_since = now
        _transitions.labels(event=event).inc()
        _flight(f"replica_{event}", seat=s.name,
                ewma_ms=None if s.ewma_ms is None
                else round(s.ewma_ms, 2),
                err=round(s.err, 3))
        with self._lock:
            self.events.append((now, event, s.name))
            del self.events[:-256]

    def evaluate(self, scores: List[ReplicaScore]):
        """Re-classify every seat. Called per plan (cheap: a handful of
        float compares for a handful of seats); idempotent between
        fresh samples."""
        if not self.cfg.enabled or len(scores) < 2:
            return
        with self._lock:
            self._evaluate_locked(scores)

    def _evaluate_locked(self, scores: List[ReplicaScore]):
        cfg, now = self.cfg, self.clock()
        active = [s for s in scores if s.state == ACTIVE]
        base = [s.ewma_ms for s in active
                if s.n >= cfg.min_samples and s.ewma_ms is not None]
        # the outlier bar: a multiple of the healthy peers' median,
        # floored so sub-ms loopback jitter can never look like gray
        # failure. No healthy baseline (group just booted, or everyone
        # is degraded) => only the error-rate trigger can act.
        threshold = max(cfg.min_ms, cfg.factor * statistics.median(base)) \
            if base else None

        def degraded(s: ReplicaScore) -> bool:
            slow = (threshold is not None and s.ewma_ms is not None
                    and s.ewma_ms > threshold)
            return slow or s.err > cfg.error_rate

        for s in scores:
            if s.state == ACTIVE:
                # never probation the LAST active seat on latency alone:
                # with nobody to compare against the median is itself
                if s.n >= cfg.min_samples and degraded(s) and \
                        (len(active) >= 2 or s.err > cfg.error_rate):
                    self._move(s, PROBATION, "probation", now)
                    s.last_probe = now
            elif s.state == PROBATION:
                recovered = (
                    s.n >= cfg.min_samples and not degraded(s)
                    and s.err <= cfg.error_rate / 2.0
                    and (threshold is None or s.ewma_ms is None
                         or s.ewma_ms <= 0.7 * threshold))
                if recovered:
                    s.eject_count = 0
                    self._move(s, ACTIVE, "readmitted", now)
                elif degraded(s) and \
                        now - s.state_since >= cfg.probation_s:
                    s.eject_count += 1
                    backoff = min(
                        cfg.readmit_base_s * (2 ** (s.eject_count - 1)),
                        cfg.readmit_max_s)
                    s.readmit_at = now + backoff
                    self._move(s, EJECTED, "ejected", now)
            elif s.state == EJECTED:
                if now >= s.readmit_at:
                    # back to probation for canarying, with the score
                    # RESET: re-admission (and any re-ejection) must
                    # rest on fresh canary evidence — judging the probe
                    # window on the stale pre-ejection EWMA would
                    # re-eject a seat whose fault has long cleared
                    s.n = 0
                    s.ewma_ms = None
                    s.err *= 0.5
                    s.last_probe = 0.0
                    self._move(s, PROBATION, "probe", now)
        _ejected_gauge.set(
            sum(1 for s in scores if s.state == EJECTED))
        _probation_gauge.set(
            sum(1 for s in scores if s.state == PROBATION))

    def take_canary(self, s: ReplicaScore) -> bool:
        """Whether THIS request should be the probation seat's live
        probe (at most one per ``probe_interval_s`` per seat)."""
        if not self.cfg.enabled or s.state != PROBATION:
            return False
        now = self.clock()
        with self._lock:
            if now - s.last_probe >= self.cfg.probe_interval_s:
                s.last_probe = now
                return True
        return False

    def state_of(self, s: ReplicaScore) -> str:
        return s.state if self.cfg.enabled else ACTIVE
