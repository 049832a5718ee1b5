"""One-line bootstrap of the runtime context (counterpart of
``zoo_tpu/orca/common.py``).

``init_orca_context`` picks the device set (the current CUDA device
unless ``devices=`` names others; ``devices=["cpu"]`` runs every plain
version on the CPU), builds the mesh over it, starts the heartbeat a
supervised worker is asked for, and registers ``stop_orca_context`` to
run at exit. Every Estimator and Keras entry point that is given no
``device=`` then places its model on the context's device.

The port runs one process on one device. A world above one (more than
one process, ``num_nodes > 1``, or a mesh over more than one device)
needs ``torch.distributed`` and the sharding plans of ROADMAP A.14, and
raises, naming it. The cluster modes the JAX package accepts are
accepted, and on one host they behave as ``"local"``.
"""

from __future__ import annotations

import atexit
import logging
from typing import Dict, Optional, Sequence

from zoo_tpu_torch.common import knobs
from zoo_tpu_torch.common.context import (
    RuntimeContext,
    ZooContext,
    _set_runtime_context,
    default_cores,
    get_runtime_context,
)

logger = logging.getLogger(__name__)

_CLUSTER_MODES = ("local", "tpu", "yarn", "k8s", "standalone",
                  "spark-submit", "yarn-client", "yarn-cluster")


class OrcaContext(ZooContext):
    """Process-global Orca config flags (the knobs of
    :class:`~zoo_tpu_torch.common.context.ZooContext`), read as
    ``from zoo_tpu_torch.orca import OrcaContext``."""

    @staticmethod
    def get_ray_context():
        """The active :class:`~zoo_tpu_torch.ray.RayContext`."""
        from zoo_tpu_torch.ray import RayContext
        return RayContext.get(initialize=False)

    @staticmethod
    def get_spark_context():
        raise RuntimeError(
            "no SparkContext exists in zoo_tpu_torch (no JVM); data enters "
            "as XShards or numpy")

    @staticmethod
    def get_spark_session():
        OrcaContext.get_spark_context()


def _maybe_init_distributed(cluster_mode: str, num_nodes: int = 1):
    """A world above one is ROADMAP A.14 (``torch.distributed`` across
    processes): ``ZOO_NUM_PROCESSES`` above 1 or ``num_nodes > 1``
    raises, naming it. One process needs no distributed runtime."""
    if cluster_mode == "local":
        return
    world = knobs.value("ZOO_NUM_PROCESSES") or 1
    if int(world) > 1 or num_nodes > 1:
        raise RuntimeError(
            f"cluster_mode={cluster_mode!r} with num_nodes={num_nodes} "
            f"and a world of {world} process(es) needs torch.distributed "
            "across processes, which is not ported to zoo_tpu_torch yet "
            "(ROADMAP A.14)")


def _as_device(d):
    import torch

    from zoo_tpu_torch.common.device import resolve_device
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _platform(dev) -> str:
    return "gpu" if dev.type == "cuda" else dev.type


def init_orca_context(cluster_mode: str = "local",
                      cores: Optional[int] = None,
                      memory: Optional[str] = None,
                      num_nodes: int = 1,
                      mesh_axes: Optional[Dict[str, int]] = None,
                      axis_names: Optional[Sequence[str]] = None,
                      devices=None,
                      **kwargs) -> RuntimeContext:
    """Create (or return) the global :class:`RuntimeContext`.

    ``cores`` sizes the host-side input-pipeline worker pool (default
    ``ZOO_NUM_CORES``, else the CPU count); ``memory`` is recorded, not
    enforced. ``devices``: torch devices or their names (default: the
    current CUDA device; raises without one). ``mesh_axes`` (e.g.
    ``{"data": -1}``) names the layout; with none, the ``ZOO_MESH_*``
    knobs give it, and axes that do not fit the device list fall back to
    the data-parallel default with a warning. A second call with other
    arguments raises; call :func:`stop_orca_context` first."""
    from zoo_tpu_torch.parallel.mesh import (
        DEFAULT_AXES,
        _MULTI_DEVICE,
        _factor_shape,
        build_mesh,
        mesh_axes_from_env,
        publish_mesh_metrics,
    )
    from zoo_tpu_torch.util.resilience import start_heartbeat_thread

    cluster_mode = cluster_mode.lower()
    if cluster_mode not in _CLUSTER_MODES:
        raise ValueError(f"unsupported cluster_mode: {cluster_mode}")
    if cluster_mode == "local" and num_nodes > 1:
        raise ValueError(
            f"num_nodes={num_nodes} requires a multi-host cluster_mode; "
            "cluster_mode='local' is single-host by definition")
    devs = [_as_device(d) for d in devices] if devices is not None else None
    init_args = (cluster_mode, mesh_axes,
                 tuple(axis_names) if axis_names else None,
                 tuple(devs) if devs is not None else None)

    existing = get_runtime_context(required=False)
    if existing is not None:
        same = existing.extra.get("_init_args") == init_args
        default_call = (cluster_mode == "local" and not mesh_axes
                        and not axis_names and devices is None)
        if not (same or default_call):
            raise RuntimeError(
                "init_orca_context called twice with different arguments; "
                "call stop_orca_context() first to rebuild")
        logger.warning("init_orca_context called twice; returning existing "
                       "context")
        return existing

    _maybe_init_distributed(cluster_mode, num_nodes)
    # a supervised worker is handed a heartbeat file through the env;
    # no-op otherwise
    start_heartbeat_thread()

    if devs is None:
        devs = [_as_device(None)]
    if len(devs) > 1:
        raise ValueError(f"{len(devs)} devices given: {_MULTI_DEVICE}")
    if mesh_axes is not None and any(int(s) > 1
                                     for s in mesh_axes.values()):
        raise ValueError(f"mesh_axes={mesh_axes} on {len(devs)} "
                         f"device(s): {_MULTI_DEVICE}")
    if mesh_axes is None:
        env_axes = mesh_axes_from_env()
        if env_axes:
            try:
                _factor_shape(len(devs), dict(env_axes),
                              tuple(axis_names or DEFAULT_AXES))
                mesh_axes = dict(env_axes)
            except ValueError as e:
                logger.warning(
                    "ZOO_MESH_* axes %s do not fit the %d device(s) of "
                    "this context (%s); using the data-parallel default",
                    env_axes, len(devs), e)
    mesh = build_mesh(devs, axis_sizes=mesh_axes, axis_names=axis_names)
    publish_mesh_metrics(mesh)

    ctx = RuntimeContext(
        cluster_mode=cluster_mode,
        platform=_platform(devs[0]),
        devices=tuple(devs),
        mesh=mesh,
        num_processes=1,
        process_index=0,
        cores=cores or default_cores(),
        extra={"memory": memory, "num_nodes": num_nodes,
               "_init_args": init_args, **kwargs},
    )
    _set_runtime_context(ctx)
    atexit.register(stop_orca_context)
    logger.info("Orca context: mode=%s platform=%s devices=%d mesh=%s",
                cluster_mode, ctx.platform, ctx.num_devices,
                dict(mesh.shape))
    return ctx


def stop_orca_context():
    """Tear down the global context (also registered to run at exit).
    Models keep their tensors; nothing else runs to be stopped."""
    if get_runtime_context(required=False) is not None:
        _set_runtime_context(None)
        logger.info("Orca context stopped")
