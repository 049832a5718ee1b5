"""Tiered training-data cache and the double-buffered device feeder
(counterpart of ``zoo_tpu/orca/data/cache.py``).

The reference's FeatureSet caches training samples in DRAM, Optane
PMEM, off-heap buffers or disk (tier picked by
``OrcaContext.train_data_store``). Here the beyond-DRAM tier is a
spill file on local disk kept by the C++ buffer manager of
:mod:`zoo_tpu_torch.native` (a Python dict and file where the library
cannot be built; the route is recorded, never silent).

:class:`DoubleBufferedIterator` is the host-to-device leg: a background
thread stages item i+1 (cache read, unpickle, and with ``device=`` the
copy to the card, :func:`device_put`) while the consumer runs item i.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import queue
import tempfile
import threading
import weakref
from typing import Any, Iterable, Iterator, Optional

import numpy as np

from zoo_tpu_torch import native as _native
from zoo_tpu_torch.common.context import ZooContext
from zoo_tpu_torch.common.device import set_thread_device

__all__ = ["TieredSampleCache", "CachedDataset", "DoubleBufferedIterator",
           "device_put"]


def _dram_budget_for(store: str, total_hint: Optional[int]) -> int:
    """The reference's tier string as a DRAM byte budget: DRAM -> no
    limit; DISK_n -> the dataset is ~n x DRAM, keep 1/n of the bytes
    resident."""
    store = store.upper()
    if store == "DRAM":
        return -1
    if store.startswith("DISK"):
        try:
            n = int(store.split("_", 1)[1])
        except (IndexError, ValueError):
            n = 2
        if total_hint:
            return max(1, total_hint // max(n, 1))
        return 512 * 1024 * 1024 // max(n, 1)
    raise ValueError(f"unknown train_data_store {store!r}")


class TieredSampleCache:
    """Append-only blob cache with a DRAM budget and a disk spill.

    ``put`` pickles a sample or batch and returns its index; ``get``
    returns it. ``route`` says which buffer manager holds it
    (``native`` or ``python``)."""

    def __init__(self, store: Optional[str] = None,
                 dram_budget: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 total_bytes_hint: Optional[int] = None):
        store = store or ZooContext.train_data_store
        self._budget = (dram_budget if dram_budget is not None
                        else _dram_budget_for(store, total_bytes_hint))
        self._spill_dir = spill_dir or tempfile.gettempdir()
        self._spill_path = os.path.join(
            self._spill_dir, f"zoo_cache_{os.getpid()}_{id(self):x}.bin")
        self._lib = _native.load()
        self.route = _native.record_route("cache", self._lib is not None)
        self._lock = threading.Lock()
        if self._lib is not None:
            self._h = self._lib.zoo_cache_create(self._budget,
                                                 self._spill_path.encode())
        else:
            self._h = None
            self._ram: dict = {}
            self._disk_index: dict = {}
            self._dram_used = 0
            self._spill_f = None

    def put(self, obj: Any) -> int:
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if self._h is not None:
            buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
            idx = self._lib.zoo_cache_put(self._h, buf, len(blob))
            if idx < 0:
                raise IOError("cache put failed (spill tier unavailable?)")
            return int(idx)
        with self._lock:
            idx = len(self._ram) + len(self._disk_index)
            fits = self._budget < 0 or \
                self._dram_used + len(blob) <= self._budget
            if fits:
                self._ram[idx] = blob
                self._dram_used += len(blob)
            else:
                if self._spill_f is None:
                    self._spill_f = open(self._spill_path, "w+b")
                self._spill_f.seek(0, os.SEEK_END)
                off = self._spill_f.tell()
                self._spill_f.write(blob)
                self._disk_index[idx] = (off, len(blob))
            return idx

    def get(self, idx: int) -> Any:
        if self._h is not None:
            n = self._lib.zoo_cache_len(self._h, idx)
            if n < 0:
                raise IndexError(idx)
            buf = (ctypes.c_uint8 * n)()
            got = self._lib.zoo_cache_get(self._h, idx, buf, n)
            if got != n:
                raise IOError(f"cache get failed for {idx}")
            return pickle.loads(bytes(buf))
        with self._lock:
            if idx in self._ram:
                return pickle.loads(self._ram[idx])
            if idx in self._disk_index:
                off, n = self._disk_index[idx]
                self._spill_f.seek(off)
                return pickle.loads(self._spill_f.read(n))
        raise IndexError(idx)

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.zoo_cache_count(self._h))
        with self._lock:
            return len(self._ram) + len(self._disk_index)

    def dram_used(self) -> int:
        if self._h is not None:
            return int(self._lib.zoo_cache_dram_used(self._h))
        with self._lock:
            return self._dram_used

    def spilled(self) -> bool:
        """Whether any blob went to the disk tier."""
        return os.path.exists(self._spill_path) and \
            os.path.getsize(self._spill_path) > 0

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self.get(i)

    def close(self):
        if self._h is not None:
            self._lib.zoo_cache_destroy(self._h)
            self._h = None
            self._lib = None
        elif getattr(self, "_spill_f", None) is not None:
            self._spill_f.close()
            try:
                os.unlink(self._spill_path)
            except OSError:
                pass
            self._spill_f = None

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:
            pass


class CachedDataset:
    """An iterable of batches cached once, then replayed epoch after
    epoch from the tiered store (the ``FeatureSet.cache()`` pattern)."""

    def __init__(self, batches: Iterable[Any], **cache_kwargs):
        self._cache = TieredSampleCache(**cache_kwargs)
        for b in batches:
            self._cache.put(b)

    @property
    def cache(self) -> TieredSampleCache:
        return self._cache

    def __len__(self):
        return len(self._cache)

    def __iter__(self):
        return iter(self._cache)

    def close(self):
        self._cache.close()


def device_put(tree, device):
    """Every numpy array (or CPU tensor) leaf of ``tree`` (a list, tuple
    or dict of them) as a tensor on ``device``, 64-bit narrowed to 32 as
    the JAX package's ``device_put`` narrows it."""
    import torch

    if isinstance(tree, dict):
        return {k: device_put(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_put(v, device) for v in tree)
    t = tree if isinstance(tree, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(tree))
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.int()
    return t.to(device)


class DoubleBufferedIterator:
    """Wrap an iterator; a daemon thread keeps ``depth`` items staged
    ahead, each through ``stage_fn`` when given, else, with ``device``
    given, copied there by :func:`device_put` (the thread's current CUDA
    device is ``device``'s)."""

    _END = object()

    def __init__(self, it: Iterable[Any], stage_fn=None, depth: int = 2,
                 device=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err_box: list = []
        self._stop = threading.Event()
        if stage_fn is None and device is not None:
            def stage_fn(item, _dev=device):
                return device_put(item, _dev)
        # the producer closure must not capture self, or the live thread
        # would keep the iterator reachable and the finalizer never fire
        q, stop, err_box, end = self._q, self._stop, self._err_box, self._END

        def run():
            if device is not None:
                set_thread_device(device)
            try:
                for item in it:
                    staged = stage_fn(item) if stage_fn else item
                    # a bounded put that gives up once the consumer
                    # closed us, so an early exit cannot strand the
                    # producer (and its staged batch) forever
                    while not stop.is_set():
                        try:
                            q.put(staged, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate into the consumer
                err_box.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(end, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()
        # a consumer that drops the iterator without close() must not
        # strand the producer retrying its puts
        weakref.finalize(self, self._stop.set)

    def close(self):
        """Stop the producer and drop staged items."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the producer thread to end (after :meth:`close`, or
        once the source is exhausted); True when it has."""
        self._t.join(timeout)
        return not self._t.is_alive()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        # after close() the queue may be drained already (close() eats
        # the END marker): never park on a stopped producer
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if item is self._END:
            self._stop.set()
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        return item


