"""Staged ingest: overlap fetch, slicing and the copy to the card
(counterpart of ``zoo_tpu/orca/data/ingest.py``).

:func:`staged_pipeline` chains the legs of the ingest path into
:class:`~zoo_tpu_torch.orca.data.cache.DoubleBufferedIterator` stages,
one daemon thread a stage, so stage ``i`` of item ``k`` runs while stage
``i-1`` prepares item ``k+1``. Every stage records its busy time into
the ``zoo_shard_pipeline_stage_seconds{stage=...}`` histogram, and a
:class:`PipelineStats` accumulates per-stage busy seconds: the overlap
ratio is their sum over the pipeline's wall time (1.0 serial, above 1.0
overlapped).

:class:`StagingBufferPool` is the host half of ``fit``'s feed: the slice
stage writes each superbatch into one of a few preallocated host
buffers (``np.take(..., out=)``), and the put stage copies it to the
device and hands the buffer back. On a CUDA device the buffers are
pinned and the copy is asynchronous on a copy stream of its own; the
buffer goes back only after the copy's event has completed (the JAX
feed's ``block_until_ready`` before ``recycle``), and the staged tensors
are recorded on the consumer's stream so the caching allocator never
hands their memory to a later copy while a step still reads them. On
the CPU ``tensor.to("cpu")`` would alias the buffer, so the put stage
copies there.

Used by the host-fed loop of ``KerasNet.fit``
(``pipeline/api/keras/engine/topology.py``): a slice stage and a
device-put stage, so the step on superbatch ``k`` overlaps the copy of
``k+1`` and the slicing of ``k+2``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from zoo_tpu_torch.common import knobs
from zoo_tpu_torch.common.device import set_thread_device
from zoo_tpu_torch.obs.metrics import gauge, histogram
from zoo_tpu_torch.orca.data.cache import DoubleBufferedIterator, device_put

__all__ = ["PipelineStats", "StagedPipeline", "staged_pipeline",
           "async_device_ingest", "ReadaheadController",
           "StagingBufferPool", "narrowed_dtype"]

logger = logging.getLogger(__name__)

_stage_seconds = histogram(
    "zoo_shard_pipeline_stage_seconds",
    "Busy time per ingest pipeline stage (fetch / decode / slice / "
    "device put)", labels=("stage",))


class PipelineStats:
    """Per-stage busy seconds and the wall clock of one pipeline.

    ``overlap_ratio()`` = the stages' busy time over the wall time since
    the pipeline started: ~1.0 for a serial pipeline, more for each
    stage hidden under another. Thread-safe: stages record from their own
    threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.busy: Dict[str, float] = {}
        self.items: Dict[str, int] = {}
        self._t0 = time.perf_counter()
        self._t_end: Optional[float] = None

    def record(self, stage: str, dt: float):
        with self._lock:
            self.busy[stage] = self.busy.get(stage, 0.0) + dt
            self.items[stage] = self.items.get(stage, 0) + 1

    def finish(self):
        """Pin the wall clock (idempotent: the first call wins)."""
        if self._t_end is None:
            self._t_end = time.perf_counter()

    def wall(self) -> float:
        return (self._t_end or time.perf_counter()) - self._t0

    def busy_total(self) -> float:
        with self._lock:
            return sum(self.busy.values())

    def overlap_ratio(self) -> float:
        wall = self.wall()
        if wall <= 0:
            return float("nan")
        return self.busy_total() / wall


def _timed_source(source: Iterable[Any], stats: Optional[PipelineStats]):
    """The time spent blocked on the raw source's ``next()``, recorded as
    the ``source`` stage (the fetch leg when the source is a streaming
    fetch)."""
    it = iter(source)
    child = _stage_seconds.labels(stage="source")
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        dt = time.perf_counter() - t0
        child.observe(dt)
        if stats is not None:
            stats.record("source", dt)
        yield item


class StagedPipeline:
    """A chain of double-buffered stages over ``source``.

    Iterating yields fully staged items. ``close()`` (or leaving the
    context manager) stops every stage thread, outermost first, and
    joins each for up to ``join_timeout`` seconds, so an early-exiting
    consumer leaves no stage thread running; a thread still inside a
    stage function after that is left to the caller's generation fence
    (:meth:`StagingBufferPool.reset`)."""

    def __init__(self, source: Iterable[Any],
                 stages: List[Tuple[str, Optional[Callable[[Any], Any]]]],
                 depth: int = 2, stats: Optional[PipelineStats] = None,
                 join_timeout: float = 5.0):
        self.stats = stats
        self.join_timeout = join_timeout
        self._iters: List[DoubleBufferedIterator] = []
        it: Iterable[Any] = _timed_source(source, self.stats)
        for name, fn in stages:
            it = DoubleBufferedIterator(it, stage_fn=self._timed(name, fn),
                                        depth=depth)
            self._iters.append(it)
        self._tail = it

    def _timed(self, name: str, fn: Optional[Callable[[Any], Any]]):
        stats = self.stats
        child = _stage_seconds.labels(stage=name)

        def run(item):
            t0 = time.perf_counter()
            out = fn(item) if fn is not None else item
            dt = time.perf_counter() - t0
            child.observe(dt)
            if stats is not None:
                stats.record(name, dt)
            return out

        return run

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._tail)
        except StopIteration:
            if self.stats is not None:
                self.stats.finish()
            raise

    def close(self) -> bool:
        """Stop and join the stage threads; True when all have ended."""
        # outermost first: stop consumers before their producers
        for it in reversed(self._iters):
            it.close()
        deadline = time.perf_counter() + self.join_timeout
        ended = all([it.join(max(0.0, deadline - time.perf_counter()))
                     for it in reversed(self._iters)])
        if self.stats is not None:
            self.stats.finish()
        return ended

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def staged_pipeline(source: Iterable[Any],
                    stages: List[Tuple[str,
                                       Optional[Callable[[Any], Any]]]],
                    depth: int = 2,
                    stats: Optional[PipelineStats] = None
                    ) -> StagedPipeline:
    """Chain ``stages`` = [(name, fn or None), ...] over ``source``.

    Each stage gets its own thread and a bounded queue of ``depth``
    items. A stage with ``fn=None`` only prefetches: it gives a slow
    source its own thread so the stages after it overlap it."""
    return StagedPipeline(source, stages, depth=depth, stats=stats)


_readahead_gauge = gauge(
    "zoo_shard_readahead",
    "Live readahead knob values chosen by the adaptive controller",
    labels=("knob",))


class ReadaheadController:
    """Steer ``config.concurrency`` and ``config.multiget`` (any object
    with the two attributes) toward the point where the fetch leg hides
    under the later stages.

    The signal is the ``source`` stage's share of the pipeline's wall
    time since the last decision (deltas, not totals):

    * share > ``high``: the pipeline starves on fetch. Double the
      concurrency first, then the multi-get chunk.
    * share < ``low``: fetch is hidden with room to spare. Step the
      concurrency down by one, then halve the chunk toward its floor
      (x2 up, -1 down: the walk does not oscillate).

    ``on_chunk`` is called from fetch threads (thread-safe) and decides
    once every ``window`` chunks. The trail is kept on ``decisions`` and
    exported through the ``zoo_shard_readahead`` gauge."""

    def __init__(self, config, stats: Optional[PipelineStats] = None,
                 min_chunk: int = 4, max_chunk: int = 256,
                 min_concurrency: int = 1, max_concurrency: int = 32,
                 window: int = 4, high: float = 0.55, low: float = 0.25):
        self.config = config
        self.stats = stats
        self.min_chunk, self.max_chunk = min_chunk, max_chunk
        self.min_concurrency = min_concurrency
        self.max_concurrency = max_concurrency
        self.window = max(1, window)
        self.high, self.low = high, low
        self.decisions: List[Tuple[int, int]] = []
        self._lock = threading.Lock()
        self._chunks = 0
        self._last_wall = 0.0
        self._last_src = 0.0

    def on_chunk(self, ngids: int, nbytes: int, seconds: float):
        with self._lock:
            self._chunks += 1
            if self._chunks % self.window:
                return
            self._decide()

    def _decide(self):
        st = self.stats
        if st is None:
            return
        wall = st.wall()
        src = st.busy.get("source", 0.0)
        dw = wall - self._last_wall
        ds = src - self._last_src
        if dw <= 0:
            return
        self._last_wall, self._last_src = wall, src
        share = ds / dw
        cfg = self.config
        if share > self.high:
            if cfg.concurrency < self.max_concurrency:
                cfg.concurrency = min(self.max_concurrency,
                                      cfg.concurrency * 2)
            elif cfg.multiget < self.max_chunk:
                cfg.multiget = min(self.max_chunk, cfg.multiget * 2)
            else:
                return
        elif share < self.low:
            if cfg.concurrency > self.min_concurrency:
                cfg.concurrency -= 1
            elif cfg.multiget > self.min_chunk:
                cfg.multiget = max(self.min_chunk, cfg.multiget // 2)
            else:
                return
        else:
            return
        self.decisions.append((cfg.concurrency, cfg.multiget))
        _readahead_gauge.labels(knob="concurrency").set(cfg.concurrency)
        _readahead_gauge.labels(knob="multiget").set(cfg.multiget)
        logger.debug("readahead: source share %.2f -> concurrency=%d "
                     "multiget=%d", share, cfg.concurrency, cfg.multiget)


# ------------------------------------------------- staged host buffers


def narrowed_dtype(dtype) -> np.dtype:
    """The dtype a batch has on the device: 64-bit floats and ints
    narrowed to 32 bits, as the JAX package's ``device_put`` narrows
    them."""
    dt = np.dtype(dtype)
    if dt == np.float64:
        return np.dtype(np.float32)
    if dt == np.int64:
        return np.dtype(np.int32)
    return dt


class StagingBufferPool:
    """Rotating preallocated host buffers for the host-fed superbatch
    feed.

    The slice stage writes each superbatch into one of ``nbufs`` buffers
    (:meth:`take`, ``np.take(..., out=)`` at the narrowed dtype); the put
    stage copies it to the device (:meth:`to_device`) and returns the
    buffer with :meth:`recycle` once the copy has read it, so the copy
    of superbatch ``k`` overlaps the slicing of ``k+1`` into another
    buffer. FIFO: one slice thread and one put thread hand items over in
    order, so ``recycle()`` frees the oldest outstanding buffer.
    ``nbufs`` must exceed the items in flight (slice 1, each queue
    ``depth``, put 1: 3 at depth 1).

    With ``pin=True`` (a CUDA device) the buffers are pinned host
    tensors (``pin_memory=True``); ``create_seconds`` is what allocating
    them took. :meth:`reset` starts a new generation: calls carrying an
    older token (a stage thread of a torn-down pipeline) get plain
    copies and never touch the pool."""

    def __init__(self, arrs, rows: int, nbufs: int = 4, pin: bool = False):
        import torch

        t0 = time.perf_counter()
        self.dtypes = [narrowed_dtype(a.dtype) for a in arrs]
        self._tensors = [
            [torch.from_numpy(np.empty(0, dt)).new_empty(
                (rows,) + a.shape[1:], pin_memory=pin)
             for a, dt in zip(arrs, self.dtypes)] for _ in range(nbufs)]
        self._slots = [[t.numpy() for t in slot] for slot in self._tensors]
        self.create_seconds = time.perf_counter() - t0
        self.pinned = pin
        self._free: "queue.Queue" = queue.Queue()
        for i in range(nbufs):
            self._free.put(i)
        self._inflight: List[int] = []
        self._lock = threading.Lock()
        self._gen = 0
        self._streams: Dict[Any, Any] = {}
        self.rows = rows

    @staticmethod
    def maybe_create(arrs, rows: int, nbufs: int = 4,
                     max_bytes: int = 2 << 30, device=None
                     ) -> Optional["StagingBufferPool"]:
        """A pool for ``arrs`` on ``device`` (pinned on a CUDA device),
        or None: ``ZOO_FEED_STAGING=off``, no rows, an object or
        non-array input, a dtype torch has no tensor for, or buffers
        above ``max_bytes`` in all."""
        import torch

        mode = str(knobs.value("ZOO_FEED_STAGING")).lower()
        if mode in ("0", "off"):
            return None
        if rows <= 0 or not arrs:
            return None
        if any(not isinstance(a, np.ndarray) or a.dtype.hasobject
               for a in arrs):
            return None
        row_bytes = sum(int(np.prod(a.shape[1:], dtype=np.int64))
                        * narrowed_dtype(a.dtype).itemsize for a in arrs)
        if row_bytes * rows * nbufs > max_bytes:
            return None  # the pool would dwarf the dataset's own copies
        pin = torch.device(device or "cpu").type == "cuda"
        try:
            return StagingBufferPool(arrs, rows, nbufs=nbufs, pin=pin)
        except TypeError:   # a dtype torch cannot hold
            return None

    def tensors(self) -> List[List[Any]]:
        """The pool's host tensors, slot by slot."""
        return self._tensors

    def take(self, arrs, idx, gen: Optional[int] = None,
             timeout: float = 30.0) -> List[np.ndarray]:
        """``arrs[i][idx]`` written into the next free buffer, returned
        as views of ``len(idx)`` rows (a ragged tail uses a prefix);
        ``idx`` must index rows that exist. A superseded ``gen`` gets
        plain narrowed copies instead."""
        with self._lock:
            superseded = gen is not None and gen != self._gen
        idx = np.asarray(idx)
        if superseded:
            return self._plain(arrs, idx)
        try:
            slot = self._free.get(timeout=timeout)
        except queue.Empty:
            raise RuntimeError(
                f"staging buffer pool starved for {timeout:g}s: the "
                "device_put stage stopped recycling (stuck copy?)"
            ) from None
        n = len(idx)
        out = []
        for a, buf in zip(arrs, self._slots[slot]):
            view = buf[:n]
            # mode="clip": "raise" buffers ``out`` through a temporary
            # (a second copy of the superbatch); the feed's indices are a
            # permutation of the rows, always in range
            np.take(a, idx, axis=0, out=view, mode="clip")
            out.append(view)
        with self._lock:
            if gen is not None and gen != self._gen:
                # reset() ran while we held the slot: give it straight
                # back and the zombie caller throwaway copies
                self._free.put(slot)
                return self._plain(arrs, idx)
            self._inflight.append(slot)
        return out

    def _plain(self, arrs, idx) -> List[np.ndarray]:
        return [a[idx].astype(dt, copy=False)
                for a, dt in zip(arrs, self.dtypes)]

    def _copy_stream(self, dev):
        import torch

        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def to_device(self, sliced: List[np.ndarray], device, consumer=None,
                  gen: Optional[int] = None) -> List[Any]:
        """Copy the views :meth:`take` returned to ``device``, recycle
        their buffer and return the tensors.

        On a CUDA device each view is copied with ``copy_(...,
        non_blocking=True)`` on the pool's copy stream; the calling
        thread waits for the event recorded after the copies before the
        buffer is recycled, so the tensors are complete when returned.
        Each is recorded on ``consumer`` (default: the device's current
        stream), so the caching allocator keeps its memory until the
        consumer's work on it is done. On the CPU each view is cloned
        (``to("cpu")`` would alias the buffer)."""
        import torch

        dev = torch.device(device)
        if dev.type != "cuda":
            out = [torch.from_numpy(v).clone() for v in sliced]
            self.recycle(gen=gen)
            return out
        consumer = consumer or torch.cuda.current_stream(dev)
        stream = self._copy_stream(dev)
        with torch.cuda.stream(stream):
            out = []
            for v in sliced:
                src = torch.from_numpy(v)
                dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
                dst.copy_(src, non_blocking=True)
                out.append(dst)
            event = torch.cuda.Event()
            event.record(stream)
        for t in out:
            t.record_stream(consumer)
        event.synchronize()
        self.recycle(gen=gen)
        return out

    def recycle(self, gen: Optional[int] = None):
        """The oldest outstanding buffer's copy has completed: give it
        back to the slice stage. A superseded ``gen`` is a no-op, so a
        zombie put thread never frees the new generation's buffer
        mid-copy."""
        with self._lock:
            if gen is not None and gen != self._gen:
                return
            slot = self._inflight.pop(0) if self._inflight else None
        if slot is not None:
            self._free.put(slot)

    def reset(self) -> int:
        """Free every outstanding buffer and start a new generation (an
        epoch boundary, or after a teardown mid-epoch); returns its
        token."""
        with self._lock:
            stale, self._inflight = self._inflight, []
            self._gen += 1
            gen = self._gen
        for slot in stale:
            self._free.put(slot)
        return gen


def async_device_ingest(shards: Iterable[Any], put_fn=None,
                        depth: int = 2,
                        stats: Optional[PipelineStats] = None,
                        device=None) -> StagedPipeline:
    """Iterate ``shards`` with the copy to the device one item ahead.

    ``put_fn`` defaults to :func:`~zoo_tpu_torch.orca.data.cache.
    device_put` onto ``device`` (default: the context's device, else the
    current CUDA device). The source is drained on a prefetch thread and
    the copy runs on a second stage thread (whose current CUDA device is
    ``device``), so the consumer's compute, the copy and the source's
    own work overlap."""
    if put_fn is None:
        from zoo_tpu_torch.common.context import context_device
        from zoo_tpu_torch.common.device import resolve_device

        dev = resolve_device(context_device() if device is None else device)

        def put_fn(item, _dev=dev):
            set_thread_device(_dev)
            return device_put(item, _dev)
    return staged_pipeline(iter(shards),
                           [("fetch", None), ("device_put", put_fn)],
                           depth=depth, stats=stats)
