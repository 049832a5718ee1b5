"""Training-loop tracing and per-phase step timers (counterpart of
``zoo_tpu/common/profiling.py``).

:func:`trace` opens a ``torch.profiler`` window (host and, on a card,
CUDA activity) and writes its Chrome trace under the given directory;
:mod:`zoo_tpu_torch.common.xplane` reads it back as a per-kernel
device-time breakdown.

:class:`StepProfiler` is the host-side half: named-phase wall-clock
stats (data wait, device step, evaluation) reset each epoch and pushed
as scalars into the model's train summary. With ``sync=True`` (the
default) the train loop synchronizes the device after every step, so
``step`` measures the device's step rather than its launch: that is the
point, and it costs the overlap of launch and compute, so it is opt-in
(``model.set_profile(...)``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, Iterator, Optional

from zoo_tpu_torch.obs.metrics import StatTimer, histogram

__all__ = ["PhaseTimer", "StepProfiler", "NullProfiler", "trace",
           "trace_files"]

PhaseTimer = StatTimer

_phase_seconds = histogram(
    "zoo_step_phase_seconds",
    "Training-loop per-phase wall time (data wait / reshard / step / eval)",
    labels=("phase",))

TRACE_SUFFIX = ".pt.trace.json"


class StepProfiler:
    """Named-phase wall-clock profiler for the training loop.

    Phases ``KerasNet.fit`` records: ``data`` (the host's wait on the
    staged input pipeline), ``step`` (one train step; synchronized when
    ``sync=True``), ``eval`` (the validation pass). Other phases are
    fine. ``device`` is the device the step runs on (its stream is what
    ``sync`` waits for)."""

    def __init__(self, trace_dir: Optional[str] = None,
                 trace_epochs: int = 1, sync: bool = True, device=None):
        self.timers: Dict[str, PhaseTimer] = {}
        self.cumulative: Dict[str, PhaseTimer] = {}
        self.trace_dir = trace_dir
        self.trace_epochs = int(trace_epochs)
        self.sync = sync
        self.device = device
        self.traces: list = []
        self._epoch = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def synchronize(self) -> None:
        """Wait for the device's queued work when ``sync`` is on (a
        no-op off CUDA)."""
        import torch

        if not self.sync:
            return
        dev = torch.device(self.device) if self.device is not None else None
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def record(self, name: str, dt: float):
        self.timers.setdefault(name, PhaseTimer()).record(dt)
        cum = self.cumulative.get(name)
        if cum is None:
            # mirrored into the shared registry, so phase times show on
            # /metrics beside the serving and checkpoint timers
            cum = self.cumulative[name] = PhaseTimer(
                histogram=_phase_seconds.labels(phase=name))
        cum.record(dt)

    def timed_iter(self, it: Iterator, name: str = "data") -> Iterator:
        """Yield from ``it``, recording the host's wait for each item."""
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.record(name, time.perf_counter() - t0)
            yield item

    @contextlib.contextmanager
    def epoch_trace(self):
        """A :func:`trace` window over the first ``trace_epochs`` epochs
        when ``trace_dir`` is set, nothing afterwards (traces are large);
        also resets the per-epoch timers."""
        self.timers = {}
        self._epoch += 1
        if self.trace_dir and self._epoch <= self.trace_epochs:
            with trace(self.trace_dir) as files:
                yield
            self.traces.extend(files)
        else:
            yield

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Whole-run per-phase stats (they survive the epoch resets)."""
        return {name: t.stats() for name, t in self.cumulative.items()}

    def epoch_scalars(self) -> Dict[str, float]:
        """Average ms per phase over the epoch, then reset the epoch's
        timers."""
        out = {f"{name.capitalize()}TimeMs": t.stats()["avg_ms"]
               for name, t in self.timers.items()}
        self.timers = {}
        return out


class NullProfiler:
    """The training loop's profiler when profiling is off: every hook of
    :class:`StepProfiler` that ``fit`` calls, doing nothing."""

    sync = False
    device = None

    def phase(self, name: str):
        return contextlib.nullcontext()

    def epoch_trace(self):
        return contextlib.nullcontext()

    def timed_iter(self, it: Iterator, name: str = "data") -> Iterator:
        return it

    def synchronize(self) -> None:
        pass

    def epoch_scalars(self) -> Dict[str, float]:
        return {}


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` window over the block: host activity, and
    CUDA activity where a card is present. On exit its Chrome trace is
    written to ``log_dir/<host>_<pid>.<ms>.pt.trace.json``; the context
    value is a list that then holds that path. ``torch.profiler``
    windows do not nest: do not open one inside another."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    files: list = []
    with torch.profiler.profile(activities=acts) as prof:
        yield files
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{int(time.time() * 1e3)}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    files.append(path)


def trace_files(log_dir: str) -> list:
    """The Chrome traces :func:`trace` wrote under ``log_dir``, oldest
    first."""
    out = []
    for dirpath, _, names in os.walk(log_dir):
        out += [os.path.join(dirpath, n) for n in names
                if n.endswith(TRACE_SUFFIX)]
    return sorted(out, key=os.path.getmtime)
