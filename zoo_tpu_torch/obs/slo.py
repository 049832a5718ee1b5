"""SLO watchdog: rolling-window burn-rate evaluation over the metrics
registry (counterpart of ``zoo_tpu/obs/slo.py``, whole).

The registry knows everything — ttft and inter-token histograms, the
per-outcome request counters, shed tallies, KV-block gauges, the
speculative accept counters — but nothing watches it; an operator
discovers a latency SLO burn from angry users. This watchdog closes
that loop in-process: every ``interval`` seconds it snapshots the
registry, keeps a rolling window of snapshots, evaluates each armed
rule over the WINDOW DELTA (so a breach reflects the last N seconds,
not the process's whole life), and publishes:

* ``zoo_slo_burn_rate{slo=...}`` — measured / objective for ceilings,
  objective / measured for floors; > 1 means the budget is burning;
* ``zoo_slo_breach{slo=...}``    — 0/1, with hysteresis-free edge
  events recorded into the flight ring (``slo_breach`` /
  ``slo_clear``) so a postmortem bundle shows when the burn started;
* :func:`last_status` — the machine-readable verdict the exporter's
  ``/healthz`` attaches (so :meth:`ReplicaGroup.healthz` sees it with
  no extra wiring) and a promotion gate can veto promotions on.

Built-in rules arm from the ``ZOO_SLO_*`` env (unset/0 = rule off —
the watchdog costs nothing it wasn't asked for):

=============================  ===========================================
``ZOO_SLO_TTFT_P99_S``         p99 time-to-first-token ceiling (seconds)
``ZOO_SLO_INTER_TOKEN_P99_S``  p99 inter-token gap ceiling (seconds)
``ZOO_SLO_ERROR_RATE``         served-request error-rate ceiling (0..1)
``ZOO_SLO_SHED_RATE``          admission shed-rate ceiling (0..1)
``ZOO_SLO_TENANT_SHED_RATE``   PER-TENANT shed-rate ceiling (0..1) —
                               publishes ``zoo_tenant_burn_rate``
``ZOO_SLO_KV_UTIL``            KV-block pool utilization ceiling (0..1)
``ZOO_SLO_SPEC_ACCEPT_FLOOR``  speculative accept-rate FLOOR (0..1)
``ZOO_SLO_WINDOW_S``           rolling window (default 60 s)
``ZOO_SLO_INTERVAL_S``         evaluation period (default 5 s)
``ZOO_SLO_FAIL_HEALTHZ``       1 = a breach turns ``/healthz`` 503
=============================  ===========================================

Quantiles are bucket-bound estimates from the histogram's cumulative
counts over the window — the same numbers a Prometheus
``histogram_quantile`` would report, computed locally.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from zoo_tpu_torch.obs.flight import record_event
from zoo_tpu_torch.obs.metrics import MetricsRegistry, gauge, get_registry
from zoo_tpu_torch.util import resilience as _res  # env_float only; no cycle:
#                                resilience imports obs.metrics, not us

__all__ = [
    "SLORule", "SLOWatchdog", "default_rules", "last_status",
    "quantile_from_counts",
]

logger = logging.getLogger(__name__)

_burn = gauge(
    "zoo_slo_burn_rate",
    "Measured / objective for ceiling SLOs (objective / measured for "
    "floors) over the rolling window; > 1 = the error budget is "
    "burning", labels=("slo",))
_breach = gauge(
    "zoo_slo_breach", "1 while the SLO is in breach over the rolling "
    "window, else 0", labels=("slo",))
_evals = gauge(
    "zoo_slo_rules_armed", "SLO rules the watchdog is evaluating")
# multi-tenant QoS: tenant-scoped burn rates,
# one series per tenant seen in the window — a greedy tenant burning
# its own shed budget shows up HERE without moving the fleet gauge
_tenant_burn = gauge(
    "zoo_tenant_burn_rate",
    "Per-tenant burn rate (measured / objective) for tenant-scoped "
    "SLOs over the rolling window; > 1 = that tenant's error budget "
    "is burning", labels=("tenant", "slo"))


def quantile_from_counts(bounds: List[float], counts: List[int],
                         q: float) -> Optional[float]:
    """Bucket-bound quantile estimate from a cumulative-able histogram
    delta: the upper edge of the bucket the q-th observation falls in
    (+Inf tail reports the last finite bound — a conservative floor).
    None when the window saw no observations."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0
    for i, n in enumerate(counts):
        cum += n
        if cum >= rank:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


class SLORule:
    """One objective: ``fn(window_delta, latest_snapshot) -> measured``
    (None = no data this window) against ``objective``. ``floor=True``
    breaches when measured < objective instead of >."""

    def __init__(self, name: str, fn: Callable, objective: float,
                 floor: bool = False):
        self.name = name
        self.fn = fn
        self.objective = float(objective)
        self.floor = floor

    def evaluate(self, delta: Dict, latest: Dict
                 ) -> Tuple[Optional[float], Optional[float]]:
        """(measured, burn_rate); (None, None) with no data."""
        measured = self.fn(delta, latest)
        if measured is None:
            return None, None
        if self.floor:
            burn = (self.objective / measured) if measured > 0 \
                else float("inf")
        else:
            burn = measured / self.objective if self.objective > 0 \
                else float("inf")
        return measured, burn


# ------------------------------------------------- snapshot arithmetic

def _series(snapshot: Dict, kind: str, name: str) -> List[Dict]:
    return [e for e in snapshot.get(kind, ()) if e.get("name") == name]


def _counter_sum(snapshot: Dict, name: str, **labels) -> float:
    return sum(e.get("value", 0.0) for e in
               _series(snapshot, "counters", name)
               if all(e.get("labels", {}).get(k) == v
                      for k, v in labels.items()))


def _gauge_sum(snapshot: Dict, name: str) -> Optional[float]:
    vals = [e.get("value", 0.0) for e in _series(snapshot, "gauges",
                                                 name)]
    return sum(vals) if vals else None


def _hist_counts(snapshot: Dict, name: str
                 ) -> Optional[Tuple[List[float], List[int]]]:
    entries = _series(snapshot, "histograms", name)
    if not entries:
        return None
    bounds = entries[0]["bounds"]
    counts = [0] * (len(bounds) + 1)
    for e in entries:  # label children merge (same fixed bounds)
        if e.get("bounds") == bounds:
            for i, n in enumerate(e.get("counts", ())):
                counts[i] += n
    return bounds, counts


def _window_delta(old: Dict, new: Dict) -> Dict:
    """new - old for counters and histogram counts (gauges ride the
    latest snapshot, not the delta)."""
    out = {"counters": [], "histograms": []}
    old_c = {(e["name"], tuple(sorted(e.get("labels", {}).items()))):
             e.get("value", 0.0) for e in old.get("counters", ())}
    for e in new.get("counters", ()):
        key = (e["name"], tuple(sorted(e.get("labels", {}).items())))
        out["counters"].append(
            {"name": e["name"], "labels": e.get("labels", {}),
             "value": max(0.0, e.get("value", 0.0) - old_c.get(key,
                                                               0.0))})
    old_h = {(e["name"], tuple(sorted(e.get("labels", {}).items()))):
             e.get("counts", []) for e in old.get("histograms", ())}
    for e in new.get("histograms", ()):
        key = (e["name"], tuple(sorted(e.get("labels", {}).items())))
        prev = old_h.get(key, [0] * len(e.get("counts", [])))
        counts = [max(0, a - b) for a, b in
                  zip(e.get("counts", []), prev)] \
            if len(prev) == len(e.get("counts", [])) \
            else list(e.get("counts", []))
        out["histograms"].append(
            {"name": e["name"], "labels": e.get("labels", {}),
             "bounds": e.get("bounds", []), "counts": counts})
    return out


# --------------------------------------------------------- built-ins

def _p99_rule(hist_name: str):
    def fn(delta: Dict, latest: Dict) -> Optional[float]:
        hc = _hist_counts(delta, hist_name)
        if hc is None:
            return None
        return quantile_from_counts(hc[0], hc[1], 0.99)
    return fn


def _error_rate(delta: Dict, latest: Dict) -> Optional[float]:
    errors = _counter_sum(delta, "zoo_serving_requests_total",
                          outcome="error") + \
        _counter_sum(delta, "zoo_llm_streams_total", outcome="error")
    total = _counter_sum(delta, "zoo_serving_requests_total") + \
        _counter_sum(delta, "zoo_llm_streams_total")
    return errors / total if total > 0 else None


def _shed_rate(delta: Dict, latest: Dict) -> Optional[float]:
    sheds = _counter_sum(delta, "zoo_serve_shed_total")
    total = _counter_sum(delta, "zoo_serving_requests_total")
    return sheds / total if total > 0 else None


def _kv_util(delta: Dict, latest: Dict) -> Optional[float]:
    used = _gauge_sum(latest, "zoo_llm_kv_blocks_used")
    free = _gauge_sum(latest, "zoo_llm_kv_blocks_free")
    if used is None or free is None or used + free <= 0:
        return None
    return used / (used + free)


def _spec_accept(delta: Dict, latest: Dict) -> Optional[float]:
    proposed = _counter_sum(delta, "zoo_llm_spec_proposed_tokens_total")
    if proposed <= 0:
        return None  # nothing drafted this window: no verdict
    return _counter_sum(
        delta, "zoo_llm_spec_accepted_tokens_total") / proposed


def default_rules() -> List[SLORule]:
    """Rules armed by the ``ZOO_SLO_*`` env (unset/<=0 = off)."""
    rules: List[SLORule] = []
    specs = (
        ("ttft_p99", "ZOO_SLO_TTFT_P99_S",
         _p99_rule("zoo_llm_ttft_seconds"), False),
        ("inter_token_p99", "ZOO_SLO_INTER_TOKEN_P99_S",
         _p99_rule("zoo_llm_inter_token_seconds"), False),
        ("error_rate", "ZOO_SLO_ERROR_RATE", _error_rate, False),
        ("shed_rate", "ZOO_SLO_SHED_RATE", _shed_rate, False),
        ("kv_util", "ZOO_SLO_KV_UTIL", _kv_util, False),
        ("spec_accept", "ZOO_SLO_SPEC_ACCEPT_FLOOR", _spec_accept,
         True),
    )
    for name, env, fn, floor in specs:
        objective = _res.env_float(env, 0.0)
        if objective > 0:
            rules.append(SLORule(name, fn, objective, floor=floor))
    return rules


# ----------------------------------------------------------- watchdog

_last_status: Optional[Dict] = None
_status_lock = threading.Lock()


def last_status() -> Optional[Dict]:
    """The most recent watchdog verdict in this process (None before
    any evaluation) — what ``/healthz`` attaches and the promotion
    gate consults."""
    with _status_lock:
        return _last_status


def _set_status(status: Optional[Dict]):
    global _last_status
    with _status_lock:
        _last_status = status


class SLOWatchdog:
    """``SLOWatchdog().start()`` evaluates until ``stop()`` (a daemon
    thread; also drivable synchronously via :meth:`evaluate` for
    tests). With no armed rules :meth:`start` is a no-op returning
    self, so callers can arm it unconditionally."""

    def __init__(self, rules: Optional[List[SLORule]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 window_s: Optional[float] = None,
                 interval_s: Optional[float] = None):
        self.rules = default_rules() if rules is None else list(rules)
        self.registry = registry or get_registry()
        self.window_s = window_s if window_s is not None else \
            _res.env_float("ZOO_SLO_WINDOW_S", 60.0)
        self.interval_s = interval_s if interval_s is not None else \
            _res.env_float("ZOO_SLO_INTERVAL_S", 5.0)
        self._snaps: "collections.deque" = collections.deque()
        self._breached: Dict[str, bool] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # tenant-scoped shed-rate ceiling:
        # evaluated per tenant over the window, published as
        # zoo_tenant_burn_rate{tenant, slo="shed_rate"}
        self.tenant_shed_objective = _res.env_float(
            "ZOO_SLO_TENANT_SHED_RATE", 0.0)
        _evals.set(len(self.rules) +
                   (1 if self.tenant_shed_objective > 0 else 0))

    def evaluate(self) -> Dict:
        """One evaluation pass: snapshot, window-delta, every rule.
        Returns (and publishes) the status dict."""
        now = time.monotonic()
        snap = self.registry.snapshot()
        self._snaps.append((now, snap))
        while len(self._snaps) > 2 and \
                now - self._snaps[0][0] > self.window_s:
            self._snaps.popleft()
        oldest = self._snaps[0][1]
        delta = _window_delta(oldest, snap)
        status: Dict = {"ok": True, "breaches": [], "rules": {},
                        "window_s": round(now - self._snaps[0][0], 3),
                        "ts": time.time()}
        for rule in self.rules:
            measured, burn = rule.evaluate(delta, snap)
            entry: Dict = {"objective": rule.objective,
                           "floor": rule.floor}
            breached = False
            if measured is not None:
                entry["measured"] = measured
                entry["burn_rate"] = burn
                breached = burn is not None and burn > 1.0
                _burn.labels(slo=rule.name).set(
                    burn if burn != float("inf") else 1e9)
            entry["breached"] = breached
            status["rules"][rule.name] = entry
            _breach.labels(slo=rule.name).set(1.0 if breached else 0.0)
            if breached:
                status["breaches"].append(rule.name)
                status["ok"] = False
            was = self._breached.get(rule.name, False)
            if breached != was:
                self._breached[rule.name] = breached
                record_event("slo_breach" if breached else "slo_clear",
                             slo=rule.name, measured=measured,
                             objective=rule.objective)
                (logger.warning if breached else logger.info)(
                    "SLO %s %s: measured=%r objective=%r",
                    rule.name, "BREACHED" if breached else "cleared",
                    measured, rule.objective)
        if self.tenant_shed_objective > 0:
            self._evaluate_tenants(delta, status)
        _set_status(status)
        return status

    def _evaluate_tenants(self, delta: Dict, status: Dict):
        """Per-tenant shed-rate burn over the window delta: one
        verdict per tenant that admitted or shed anything, with the
        same breach edge events (``slo_breach`` with the tenant-keyed
        rule name) the fleet rules record."""
        status["tenants"] = {}
        tenants = sorted({
            e.get("labels", {}).get("tenant")
            for e in delta.get("counters", ())
            if e.get("name") in ("zoo_tenant_shed_total",
                                 "zoo_tenant_admitted_total")
            and e.get("labels", {}).get("tenant")})
        for t in tenants:
            sheds = _counter_sum(delta, "zoo_tenant_shed_total",
                                 tenant=t)
            admitted = _counter_sum(delta, "zoo_tenant_admitted_total",
                                    tenant=t)
            total = sheds + admitted
            if total <= 0:
                continue
            measured = sheds / total
            burn = measured / self.tenant_shed_objective
            _tenant_burn.labels(tenant=t, slo="shed_rate").set(burn)
            breached = burn > 1.0
            status["tenants"][t] = {
                "shed_rate": measured, "burn_rate": burn,
                "objective": self.tenant_shed_objective,
                "breached": breached}
            name = f"tenant_shed_rate[{t}]"
            if breached:
                status["breaches"].append(name)
                status["ok"] = False
            was = self._breached.get(name, False)
            if breached != was:
                self._breached[name] = breached
                record_event("slo_breach" if breached else "slo_clear",
                             slo=name, measured=measured,
                             objective=self.tenant_shed_objective)
                (logger.warning if breached else logger.info)(
                    "SLO %s %s: measured=%r objective=%r",
                    name, "BREACHED" if breached else "cleared",
                    measured, self.tenant_shed_objective)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception as e:  # noqa: BLE001 — the watchdog must
                # outlive a malformed snapshot; log and keep watching
                logger.warning("slo evaluation failed: %s", e)

    def start(self) -> "SLOWatchdog":
        if (not self.rules and self.tenant_shed_objective <= 0) \
                or self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="zoo-slo-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
