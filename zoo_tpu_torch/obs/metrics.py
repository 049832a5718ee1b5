"""Process-global metrics registry: Counter / Gauge / Histogram
(counterpart of ``zoo_tpu/obs/metrics.py``, whole).

A named-metric registry in the Prometheus data model: monotonic
counters, set-anywhere gauges, fixed-exponential-bucket histograms,
label support, and the text exposition format. The serving door, the
clients, ejection and the supervisor all count through it. Spans, the
flight ring and the exporters that serve ``/metrics`` come with ROADMAP
A.6 (observability).

Hot-path contract: recording into a metric of a *disabled* registry is a
single attribute check and an early return; an enabled record is one
short critical section. Instrumented modules create their metric objects
at import time and cache label children, so the steady state never
touches the registry dict. This module depends on the stdlib only —
every layer of the serving stack imports it, so it sits below all of
them.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "StatTimer",
    "MetricsRegistry", "DEFAULT_BUCKETS",
    "get_registry", "counter", "gauge", "histogram",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# exponential latency buckets: 100 µs .. ~105 s, ratio 2 (the fixed-bucket
# shape lets per-worker histograms bucket-merge exactly in the aggregator)
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * (2 ** i) for i in range(21))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    # Prometheus text format: integers without a trailing .0 keep the
    # output stable for counters; everything else uses repr (full
    # precision, parses back exactly)
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """One (family, label-values) time series."""

    __slots__ = ("_registry", "_lock", "labels_kv")

    def __init__(self, registry: "MetricsRegistry",
                 labels_kv: Tuple[Tuple[str, str], ...]):
        self._registry = registry
        self._lock = threading.Lock()
        self.labels_kv = labels_kv


class Counter(_Metric):
    """Monotonic counter. ``inc()`` is the hot path: one enabled-check,
    one lock, one add."""

    __slots__ = ("_value",)

    def __init__(self, registry, labels_kv):
        super().__init__(registry, labels_kv)
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if not self._registry._enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value (queue depth, open breakers, bench axes)."""

    __slots__ = ("_value",)

    def __init__(self, registry, labels_kv):
        super().__init__(registry, labels_kv)
        self._value = 0.0

    def set(self, value: float):
        if not self._registry._enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        if not self._registry._enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket distribution (Prometheus cumulative-``le`` layout).

    ``bounds`` are the inclusive upper edges; one implicit ``+Inf``
    bucket catches the tail. Buckets are fixed at family creation so the
    multihost aggregator can merge per-worker histograms count-by-count.
    """

    __slots__ = ("bounds", "_counts", "_sum", "_count")

    def __init__(self, registry, labels_kv,
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, labels_kv)
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float):
        if not self._registry._enabled:
            return
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def snapshot_value(self) -> Dict:
        with self._lock:
            return {"bounds": list(self.bounds),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._count}


class StatTimer:
    """Running avg/max/min stats for one named stage or phase.

    The single class behind both of the former copies — serving's
    ``StageTimer`` and profiling's ``PhaseTimer`` (reference
    ``Timer.scala:22-60``); both old import paths re-export it. Pass
    ``histogram=`` to mirror every ``record`` into a registry
    :class:`Histogram` child, which is how the serving stage timers and
    the step profiler publish into the shared registry without changing
    their local-stats API.
    """

    __slots__ = ("n", "total", "max", "min", "_hist")

    def __init__(self, histogram: Optional[Histogram] = None):
        self.n = 0
        self.total = 0.0
        self.max = 0.0
        self.min = float("inf")
        self._hist = histogram

    def record(self, dt: float):
        self.n += 1
        self.total += dt
        self.max = max(self.max, dt)
        self.min = min(self.min, dt)
        if self._hist is not None:
            self._hist.observe(dt)

    def stats(self) -> Dict[str, float]:
        return {"count": self.n,
                "avg_ms": 1000 * self.total / max(self.n, 1),
                "max_ms": 1000 * self.max,
                "min_ms": 0.0 if self.n == 0 else 1000 * self.min}


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A named metric family: type + help + one child per label-value
    combination (the no-label family has exactly one child, keyed ())."""

    def __init__(self, registry, name: str, kind: str, help: str,
                 label_names: Tuple[str, ...],
                 buckets: Optional[Sequence[float]]):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: Dict[Tuple[str, ...], _Metric] = {}
        self._lock = threading.Lock()
        if not label_names:
            self._default = self._make(())
        else:
            self._default = None

    def _make(self, values: Tuple[str, ...]) -> _Metric:
        kv = tuple(zip(self.label_names, values))
        if self.kind == "histogram":
            child = Histogram(self.registry, kv,
                              self.buckets or DEFAULT_BUCKETS)
        else:
            child = _TYPES[self.kind](self.registry, kv)
        self._children[values] = child
        return child

    def labels(self, **kv: str) -> _Metric:
        """The child for these label values (created on first use).
        Cache the returned child on hot paths — this does a dict lookup
        under a lock."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(kv)}")
        values = tuple(str(kv[k]) for k in self.label_names)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make(values)
            return child

    def children(self) -> List[_Metric]:
        with self._lock:
            return list(self._children.values())

    # convenience: a label-less family proxies the single child so the
    # common case reads `requests.inc()` not `requests.labels().inc()`
    def __getattr__(self, item):
        default = self.__dict__.get("_default")
        if default is not None:
            return getattr(default, item)
        raise AttributeError(
            f"{self.name} has labels {self.label_names}; "
            f"use .labels(...).{item}")


class MetricsRegistry:
    """Ordered, thread-safe collection of metric families.

    ``counter``/``gauge``/``histogram`` are get-or-create: a second call
    with the same name returns the existing family (so independent
    modules can share one series) and raises on type/label mismatch.
    ``disable()`` turns every record into a near-free no-op — the
    knob the < 1 µs hot-path bound is measured against.
    """

    def __init__(self, enabled: bool = True):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        self._enabled = bool(enabled)

    # -- lifecycle ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        """Stop recording (existing values freeze; rendering still works)."""
        self._enabled = False

    # -- family creation ---------------------------------------------------
    def _get_or_create(self, name: str, kind: str, help: str,
                       labels: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        label_names = tuple(labels)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != label_names:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, not "
                        f"{kind}{label_names}")
                return fam
            fam = _Family(self, name, kind, help, label_names, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._get_or_create(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._get_or_create(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._get_or_create(name, "histogram", help, labels, buckets)

    # -- output ------------------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-able dump of every series — the wire format the multihost
        aggregator merges and the JSONL snapshot writer persists."""
        out = {"counters": [], "gauges": [], "histograms": []}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for child in fam.children():
                entry = {"name": fam.name, "labels": dict(child.labels_kv)}
                if fam.kind == "histogram":
                    entry.update(child.snapshot_value())
                    out["histograms"].append(entry)
                else:
                    entry["value"] = child.value
                    out["counters" if fam.kind == "counter"
                        else "gauges"].append(entry)
        return out

    def render_prometheus(self) -> str:
        """The registry in Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for child in fam.children():
                base = "".join(
                    f'{k}="{_escape_label(v)}",'
                    for k, v in child.labels_kv)
                if fam.kind != "histogram":
                    sel = f"{{{base[:-1]}}}" if base else ""
                    lines.append(f"{fam.name}{sel} {_fmt(child.value)}")
                    continue
                snap = child.snapshot_value()
                cum = 0
                for bound, n in zip(snap["bounds"], snap["counts"]):
                    cum += n
                    lines.append(
                        f'{fam.name}_bucket{{{base}le="{_fmt(bound)}"}} '
                        f"{cum}")
                cum += snap["counts"][-1]
                lines.append(
                    f'{fam.name}_bucket{{{base}le="+Inf"}} {cum}')
                sel = f"{{{base[:-1]}}}" if base else ""
                lines.append(f"{fam.name}_sum{sel} {_fmt(snap['sum'])}")
                lines.append(f"{fam.name}_count{sel} {snap['count']}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------- default
# One process-global registry: instrumented modules register at import
# time and every exporter/aggregator reads the same view (the reference's
# per-component Timers had no such shared sink).

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> _Family:
    return _default_registry.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> _Family:
    return _default_registry.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
    return _default_registry.histogram(name, help, labels, buckets)
