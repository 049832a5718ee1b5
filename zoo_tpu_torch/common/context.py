"""Global configuration flags and the per-process runtime context
(counterpart of ``zoo_tpu/common/context.py``).

``ZooContext`` holds the process-global knobs the port's modules read
(``pandas_read_backend``, ``shard_size``, ``train_data_store``,
``debug_nans``), as class properties that validate what is
set. ``RuntimeContext`` is what ``init_orca_context`` returns: the
cluster mode, the platform (``"gpu"`` for a CUDA device and ``"cpu"``
for the CPU, the JAX names, so code that reads it reads the same), the
device list, the device mesh (:mod:`zoo_tpu_torch.parallel.mesh`), the
process count and index, and the host-side worker count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Optional

from zoo_tpu_torch.common import knobs

logger = logging.getLogger(__name__)


class _ClassPropertyMeta(type):
    """Metaclass providing validated class-level properties."""

    _pandas_read_backend = "pandas"
    _shard_size = None
    _train_data_store = "DRAM"
    _debug_nans = False

    @property
    def pandas_read_backend(cls) -> str:
        """``"pandas"`` or ``"arrow"``: the parser of
        :func:`zoo_tpu_torch.orca.data.pandas.read_csv`."""
        return cls._pandas_read_backend

    @pandas_read_backend.setter
    def pandas_read_backend(cls, value: str):
        value = value.lower()
        if value not in ("pandas", "arrow"):
            raise ValueError(
                "pandas_read_backend must be 'pandas' or 'arrow', got " + value)
        _ClassPropertyMeta._pandas_read_backend = value

    @property
    def shard_size(cls) -> Optional[int]:
        """Target rows per XShards partition when reading tabular data
        (None: one shard a file, or ``num_shards``)."""
        return cls._shard_size

    @shard_size.setter
    def shard_size(cls, value: Optional[int]):
        if value is not None and int(value) <= 0:
            raise ValueError("shard_size must be positive or None")
        _ClassPropertyMeta._shard_size = None if value is None else int(value)

    @property
    def train_data_store(cls) -> str:
        """Memory tier for cached training data: ``DRAM`` or ``DISK_n``."""
        return cls._train_data_store

    @train_data_store.setter
    def train_data_store(cls, value: str):
        v = value.upper()
        if v != "DRAM" and not v.startswith("DISK"):
            raise ValueError("train_data_store must be 'DRAM' or 'DISK_n'")
        _ClassPropertyMeta._train_data_store = v

    @property
    def debug_nans(cls) -> bool:
        """NaN-check mode. When True, autograd's anomaly detection is on
        (a backward that produces a NaN raises at the operation that made
        it) and every ``fit`` raises ``FloatingPointError`` on a
        non-finite epoch loss."""
        return cls._debug_nans

    @debug_nans.setter
    def debug_nans(cls, value: bool):
        import torch

        _ClassPropertyMeta._debug_nans = bool(value)
        torch.autograd.set_detect_anomaly(bool(value))


class ZooContext(metaclass=_ClassPropertyMeta):
    """Process-global configuration knobs (set as class attributes)."""


@dataclasses.dataclass
class RuntimeContext:
    """What ``init_orca_context`` returns: the devices an Estimator
    places its model on, the mesh over them, and host-side worker
    parallelism for input pipelines."""

    cluster_mode: str
    platform: str            # "gpu" or "cpu"
    devices: tuple           # torch.device entries
    mesh: "object"           # zoo_tpu_torch.parallel.mesh.Mesh
    num_processes: int
    process_index: int
    cores: int               # host-side data-worker parallelism
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        return self.mesh.shape.get(name, 1)


_lock = threading.Lock()
_runtime_context: Optional[RuntimeContext] = None
_thread_ctx = threading.local()


def _set_runtime_context(ctx: Optional[RuntimeContext]):
    global _runtime_context
    with _lock:
        _runtime_context = ctx


@contextlib.contextmanager
def runtime_context_scope(ctx: RuntimeContext):
    """Thread-local override: code in this thread sees ``ctx`` from
    :func:`get_runtime_context` while the scope is active (each
    concurrent AutoML trial runs under its own sub-context)."""
    prev = getattr(_thread_ctx, "override", None)
    _thread_ctx.override = ctx
    try:
        yield ctx
    finally:
        _thread_ctx.override = prev


def get_runtime_context(required: bool = True) -> Optional[RuntimeContext]:
    """The current :class:`RuntimeContext`; raises if
    ``init_orca_context`` has not been called and ``required``. A
    thread-local override (:func:`runtime_context_scope`) wins over the
    process-global context."""
    override = getattr(_thread_ctx, "override", None)
    if override is not None:
        return override
    if _runtime_context is None and required:
        raise RuntimeError(
            "No runtime context. Call "
            "zoo_tpu_torch.orca.init_orca_context() first.")
    return _runtime_context


def context_device():
    """The first device of the live context, or None without one: the
    default of an entry point's ``device=`` (an explicit ``device=``
    still wins)."""
    ctx = get_runtime_context(required=False)
    return ctx.devices[0] if ctx is not None and ctx.devices else None


def default_cores() -> int:
    import os

    env = knobs.value("ZOO_NUM_CORES")
    if env:
        return int(env)
    return max(1, os.cpu_count() or 1)
