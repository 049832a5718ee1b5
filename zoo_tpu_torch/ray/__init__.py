"""``RayContext`` (counterpart of ``zoo_tpu/ray/__init__.py``): the
original booted Ray raylets inside Spark executors. The port has no
Spark executors to nest Ray into; this class keeps scripts that create
one importable and maps its two lifecycle calls: where a real Ray
install is present, ``init`` starts or connects a local Ray, and
without one it raises, saying that ``init_orca_context()`` alone is
enough for the port's estimators and its AutoML search.
"""

from __future__ import annotations

from typing import Optional


class RayContext:
    _active: Optional["RayContext"] = None

    def __init__(self, sc=None, redis_port=None, password=None,
                 object_store_memory=None, verbose=False, env=None,
                 extra_params=None, num_ray_nodes=None,
                 ray_node_cpu_cores=None, **_ignored):
        self.sc = sc
        self.object_store_memory = object_store_memory
        self.num_ray_nodes = num_ray_nodes
        self.initialized = False
        RayContext._active = self

    @classmethod
    def get(cls, initialize: bool = True) -> "RayContext":
        ctx = cls._active or cls()
        if initialize and not ctx.initialized:
            ctx.init()
        return ctx

    def init(self, driver_cores: int = 0):
        try:
            import ray
        except ImportError as e:
            raise RuntimeError(
                "RayContext.init: no ray in this environment. The port's "
                "estimators and its AutoML search "
                "(zoo_tpu_torch.automl.search) run on the runtime context: "
                "init_orca_context() alone is enough for those. Install "
                "ray only if your own code calls ray.* APIs directly."
            ) from e
        if not ray.is_initialized():  # pragma: no cover - needs ray
            kwargs = {}
            if self.object_store_memory:
                kwargs["object_store_memory"] = _to_bytes(
                    self.object_store_memory)
            ray.init(**kwargs)
        self.initialized = True
        return self

    def stop(self):
        if self.initialized:  # pragma: no cover - needs ray
            import ray
            ray.shutdown()
            self.initialized = False


def _to_bytes(mem) -> int:
    if isinstance(mem, int):
        return mem
    s = str(mem).lower().strip()
    mult = 1
    for suffix, m in (("g", 1 << 30), ("m", 1 << 20), ("k", 1 << 10),
                      ("b", 1)):
        if s.endswith(suffix):
            s, mult = s[:-len(suffix)], m
            break
    return int(float(s) * mult)
