"""One serving replica process (spawned by
:class:`zoo_tpu_torch.serving.ha.ReplicaGroup`; counterpart of
``zoo_tpu/serving/replica.py``).

``python -m zoo_tpu_torch.serving.replica --model m.zoo --device cpu
--port 8980`` loads the model spec on ``--device`` (default: the current
CUDA device; raises without a card): a ``registry:<root>:<ref>`` spec is
resolved HERE, at boot, so a replica respawned mid-rolling-update comes
up on the currently aliased version; a ``llama:`` spec mounts the
streaming engine (a ``synthllm:`` spec the same engine over the
deterministic host-only stand-in), any other spec the predict door
(:func:`zoo_tpu_torch.serving.ha.load_serving_model`), and ``a+b``
mounts both when every fragment is a ``synthetic:``, ``synthllm:`` or
``llama:`` spec.
The engine's disaggregation role comes from the spec's ``role=`` or
``ZOO_LLM_ROLE`` (which :class:`~zoo_tpu_torch.serving.ha.ReplicaGroup`
sets per seat), its tenants from ``ZOO_TENANT_CONFIG``; the door reads
the same tenant registry.
The flight recorder opens first (its spill under
``$ZOO_OBS_POSTMORTEM_DIR``, which the group sets per replica) and
records ``replica_boot``; the SLO watchdog starts (a no-op unless a
``ZOO_SLO_*`` objective is armed). It then starts a
:class:`ServingServer` behind a circuit breaker, the ``/metrics`` +
``/healthz`` exporter on ``--metrics-port`` (-1 disables), the
heartbeat thread the supervisor watches, a SIGTERM drain handler and
the crash handlers chained in front of it, prints ``REPLICA READY host:port [metrics=port]`` and
blocks until drained. On a CUDA device it loads the kernels of what it
serves before it reports ready, so a replica whose kernels cannot be
built or loaded fails at boot, loudly.

Kept OUT of the package ``__init__`` so ``python -m`` never
double-imports the module.
"""

from __future__ import annotations

import argparse
import sys
import time

#: the CUDA kernels of the served LLM path: every decode tick, the bucket
#: prefill from ZOO_LLAMA_FLASH_MIN_SEQ tokens, chunked prefill and the
#: speculative verify pass
SERVING_KERNELS = ("paged_decode", "flash_attention", "paged_prefill")
#: the kernel libraries of a served Keras model: the float and int8
#: implicit-GEMM convs and the int8 GEMMs of a quantized Dense
PREDICT_KERNELS = ("conv2d", "quant_matmul")


def load_serving_kernels(device, names=SERVING_KERNELS) -> None:
    """Build (or reuse the build directory's) and load the kernel
    libraries ``names`` for a CUDA ``device``; raises when one cannot be
    loaded."""
    if device.type != "cuda" or not names:
        return
    from zoo_tpu_torch.ops.kernels import _build
    try:
        _build.build(names)
        for name in names:
            _build.library(name)
    except Exception as e:
        raise RuntimeError(
            f"replica on {device}: the serving kernels "
            f"{', '.join(names)} could not be built or loaded "
            f"({e}); refusing to serve") from e


def serve_replica(ns) -> int:
    import faulthandler
    import signal as _sig

    # live stack dumps on demand: `kill -USR1 <replica pid>` writes
    # every thread's Python stack to the replica log
    faulthandler.register(_sig.SIGUSR1)
    from zoo_tpu_torch.obs.exporters import MetricsExporter
    from zoo_tpu_torch.obs.flight import (
        flight_recorder,
        install_crash_handlers,
        record_event,
    )
    from zoo_tpu_torch.obs.slo import SLOWatchdog
    from zoo_tpu_torch.serving.ha import SYNTHETIC_PREFIX, load_serving_model
    from zoo_tpu_torch.serving.llm.spec import (
        SYNTH_LLM_PREFIX,
        build_llm_engine,
        is_llm_spec,
    )
    from zoo_tpu_torch.serving.registry import (
        ModelRegistry,
        is_registry_spec,
        parse_registry_spec,
    )
    from zoo_tpu_torch.serving.server import ServingServer
    from zoo_tpu_torch.util.resilience import (
        CircuitBreaker,
        start_heartbeat_thread,
    )

    start_heartbeat_thread()  # no-op unless the supervisor set the env
    # black box first: the spill opens before the model load, so a boot
    # crash leaves remains too
    flight_recorder()
    record_event("replica_boot", model=ns.model, port=ns.port)
    watchdog = SLOWatchdog().start()
    model = engine = version = None
    resolved = []

    def device():
        """An explicit ``--device`` is resolved on first need:
        ``synthetic:`` and ``synthllm:`` specs run no tensor, so a
        replica of those alone never imports torch and respawns in well
        under a second."""
        if not resolved:
            from zoo_tpu_torch.common.device import resolve_device
            resolved.append(resolve_device(ns.device))
        return resolved[0]

    if ns.device is None:
        device()   # the current CUDA device, or raise: no quiet CPU

    def _mount(inner: str):
        """An llm spec mounts the paged-KV engine behind the door (an
        llm version change goes through a replica restart, which the
        alias resolution covers); anything else the predict path."""
        nonlocal model, engine
        if inner.startswith(SYNTH_LLM_PREFIX):
            engine = build_llm_engine(inner)
        elif is_llm_spec(inner):
            load_serving_kernels(device(), SERVING_KERNELS)
            engine = build_llm_engine(inner, device=device())
        elif inner.startswith(SYNTHETIC_PREFIX):
            model = load_serving_model(inner, batch_size=ns.batch_size)
        else:
            load_serving_kernels(device(), PREDICT_KERNELS)
            model = load_serving_model(inner, batch_size=ns.batch_size,
                                       device=device())

    if is_registry_spec(ns.model):
        # the pin keeps registry GC off the version during the load
        root, ref = parse_registry_spec(ns.model)
        reg = ModelRegistry(root)
        with reg.pin(ref) as pinned:
            version, inner = reg.model_spec(pinned)
            _mount(inner)
    else:
        # split "a+b" ONLY when every fragment bears a known spec
        # prefix: a model PATH may legally contain '+'
        parts = ns.model.split("+")
        combinable = len(parts) > 1 and all(
            is_llm_spec(p) or p.startswith(SYNTHETIC_PREFIX)
            for p in parts)
        for part in (parts if combinable else [ns.model]):
            _mount(part)
    server = ServingServer(
        model, host=ns.host, port=ns.port, batch_size=ns.batch_size,
        max_wait_ms=ns.max_wait_ms, llm_engine=engine,
        version=version, model_spec=ns.model,
        breaker=CircuitBreaker(failure_threshold=5,
                               recovery_timeout=5.0)).start()
    exporter = None
    if ns.metrics_port >= 0:
        exporter = MetricsExporter(host=ns.host,
                                   port=ns.metrics_port).start()
    server.install_drain_handler()
    # after the drain handler, so SIGTERM dumps the postmortem bundle
    # and THEN chains into the drain; unhandled exceptions dump too
    install_crash_handlers()
    print(f"REPLICA READY {server.host}:{server.port}"
          + (f" metrics={exporter.port}" if exporter else ""),
          flush=True)
    try:
        while not server._stop.is_set():
            time.sleep(0.2)
    except KeyboardInterrupt:
        server.drain(timeout=10.0)
    watchdog.stop()
    if exporter is not None:
        exporter.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zoo_tpu_torch.serving.replica",
        description="one serving replica (spawned by ReplicaGroup)")
    ap.add_argument("--model", required=True,
                    help="a model file of the port, or a registry:*, "
                         "synthetic:*, synthllm:* or llama:* spec")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="obs /metrics + /healthz door (-1 disables)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the model (default: the "
                         "current CUDA device)")
    return serve_replica(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
