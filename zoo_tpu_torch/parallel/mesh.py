"""Device-mesh layout (counterpart of the layout half of
``zoo_tpu/parallel/mesh.py``).

A mesh names the parallelism axes over a device list:

- ``data``  — data parallel (batch axis)
- ``fsdp``  — ZeRO-3 style parameter sharding (combines with ``data``)
- ``model`` — tensor parallel
- ``seq``   — sequence/context parallel (ring attention)
- ``expert`` — expert parallel (MoE token all-to-all)
- ``pipe``  — pipeline parallel

:class:`Mesh` is the port's own small object: ``shape`` (an ordered
axis-to-size map), ``size``, ``axis_names`` and ``devices`` (an array of
``torch.device``). The port places a model on one device; the shardings
of a mesh over more than one (``batch_sharding``,
``fsdp_param_sharding`` and the rest) belong with the sharding plans of
ROADMAP A.14: on a one-device mesh they are the identity, on a larger
one they raise, naming it.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from zoo_tpu_torch.common import knobs

DEFAULT_AXES = ("data", "fsdp", "model", "seq", "expert", "pipe")

_MULTI_DEVICE = ("a mesh over more than one device needs the sharding "
                 "plans and torch.distributed, which are not ported to "
                 "zoo_tpu_torch yet (ROADMAP A.14)")


class Mesh:
    """Named axes over a device array (``devices.shape`` is the axes'
    sizes, in ``axis_names`` order)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(
            zip(self.axis_names, (int(s) for s in devices.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({dict(self.shape)!r})"


def mesh_axes_from_env() -> Optional[Dict[str, int]]:
    """Mesh layout from the ``ZOO_MESH_<AXIS>`` knobs (e.g.
    ``ZOO_MESH_DATA=-1``): the deployment-wide default
    ``init_orca_context`` applies when the caller passes no
    ``mesh_axes``. None when no knob is set (the data-parallel
    default)."""
    axes: Dict[str, int] = {}
    for name in DEFAULT_AXES:
        v = knobs.value(f"ZOO_MESH_{name.upper()}")
        if v:
            axes[name] = int(v)
    return axes or None


def publish_mesh_metrics(mesh: Mesh) -> None:
    """Export ``zoo_mesh_axis_size{axis=...}`` gauges for the live mesh
    (every axis, size-1 ones too: a scrape can tell "axis unused" from
    "axis missing")."""
    from zoo_tpu_torch.obs.metrics import gauge
    g = gauge("zoo_mesh_axis_size",
              "Device-mesh axis sizes of the active runtime context",
              labels=("axis",))
    for name in mesh.axis_names:
        g.labels(axis=name).set(float(mesh.shape.get(name, 1)))


def _factor_shape(n_devices: int, axis_sizes: Dict[str, int],
                  axis_names: Sequence[str]) -> Tuple[int, ...]:
    """Resolve a full mesh shape: explicitly sized axes keep their size,
    at most one ``-1`` axis absorbs the remaining devices, others
    default 1."""
    shape = []
    wildcard = None
    used = 1
    for i, name in enumerate(axis_names):
        size = axis_sizes.get(name, 1)
        if size != -1 and size <= 0:
            raise ValueError(f"mesh axis {name!r} must have positive size "
                             f"or -1, got {size}")
        if size == -1:
            if wildcard is not None:
                raise ValueError("only one mesh axis may be -1")
            wildcard = i
            shape.append(1)
        else:
            shape.append(int(size))
            used *= int(size)
    if n_devices % used != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by requested axes {axis_sizes}")
    if wildcard is not None:
        shape[wildcard] = n_devices // used
    elif used != n_devices:
        raise ValueError(
            f"mesh axes {axis_sizes} cover {used} devices but {n_devices} present")
    return tuple(shape)


def build_mesh(devices, axis_sizes: Optional[Dict[str, int]] = None,
               axis_names: Sequence[str] = None) -> Mesh:
    """A :class:`Mesh` over ``devices`` (``torch.device`` entries).
    ``axis_sizes`` maps axis name -> size; one axis may be ``-1`` to
    absorb all remaining devices. Default: data parallel over every
    device."""
    devices = list(devices)
    axis_names = tuple(axis_names or DEFAULT_AXES)
    axis_sizes = dict(axis_sizes or {"data": -1})
    for name in axis_sizes:
        if name not in axis_names:
            raise ValueError(f"unknown mesh axis {name!r}; known: {axis_names}")
    shape = _factor_shape(len(devices), axis_sizes, axis_names)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dimension is sharded over: data plus fsdp."""
    return tuple(a for a in ("data", "fsdp")
                 if a in mesh.axis_names and mesh.shape.get(a, 1) > 1)


def _one_device(mesh: Mesh) -> None:
    if mesh.size > 1:
        raise NotImplementedError(_MULTI_DEVICE)


def batch_sharding(mesh: Mesh, ndim: int = 2):
    """The placement of a batch tensor: the mesh's one device (on a
    larger mesh, ROADMAP A.14)."""
    _one_device(mesh)
    return mesh.devices.reshape(-1)[0]


stacked_batch_sharding = batch_sharding


def replicated_sharding(mesh: Mesh):
    _one_device(mesh)
    return mesh.devices.reshape(-1)[0]


def fsdp_param_sharding(mesh: Mesh, shape: Tuple[int, ...],
                        axis: str = "fsdp"):
    _one_device(mesh)
    return mesh.devices.reshape(-1)[0]


def pick_divisible_dim(shape: Tuple[int, ...], size: int,
                       taken=()) -> Optional[int]:
    """Largest dim of ``shape`` divisible by ``size`` and not in
    ``taken``."""
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if i not in taken and d % size == 0 and d > best_size:
            best, best_size = i, d
    return best


def validate_batch_size(batch_size: int, mesh: Mesh) -> int:
    """``batch_size % (data axes size) == 0``; returns the per-shard
    batch."""
    denom = 1
    for a in data_axes(mesh):
        denom *= mesh.shape[a]
    if batch_size % denom != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by the number of "
            f"data-parallel shards ({denom})")
    return batch_size // denom
