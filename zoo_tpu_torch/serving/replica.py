"""One serving replica process (spawned by
:class:`zoo_tpu_torch.serving.ha.ReplicaGroup`; counterpart of
``zoo_tpu/serving/replica.py``).

``python -m zoo_tpu_torch.serving.replica --model llama:tiny --device
cpu --metrics-port -1 --port 8980`` builds the ``llama:`` spec's engine
on ``--device`` (default: the current CUDA device; raises without a
card), starts a :class:`ServingServer` behind a circuit breaker, the
heartbeat thread the supervisor watches and a SIGTERM drain handler,
prints ``REPLICA READY host:port`` and blocks until drained. On a CUDA
device it loads the serving path's kernels before it reports ready, so a
replica whose kernels cannot be built or loaded fails at boot, loudly.

Predict and ``registry:`` specs wait for ROADMAP A.3b; the ``/metrics``
and ``/healthz`` exporter (``--metrics-port``, which must be ``-1``
until then), the flight recorder and the SLO watchdog wait for A.6.
Kept OUT of the package ``__init__`` so ``python -m`` never
double-imports the module.
"""

from __future__ import annotations

import argparse
import sys
import time

#: the CUDA kernels of the served path: every decode tick, the bucket
#: prefill from ZOO_LLAMA_FLASH_MIN_SEQ tokens, chunked prefill and the
#: speculative verify pass
SERVING_KERNELS = ("paged_decode", "flash_attention", "paged_prefill")


def load_serving_kernels(device) -> None:
    """Build (or reuse the build directory's) and load the serving
    kernels for a CUDA ``device``; raises when one cannot be loaded."""
    if device.type != "cuda":
        return
    from zoo_tpu_torch.ops.kernels import _build
    try:
        _build.build(SERVING_KERNELS)
        for name in SERVING_KERNELS:
            _build.library(name)
    except Exception as e:
        raise RuntimeError(
            f"replica on {device}: the serving kernels "
            f"{', '.join(SERVING_KERNELS)} could not be built or loaded "
            f"({e}); refusing to serve") from e


def serve_replica(ns) -> int:
    import faulthandler
    import signal as _sig

    # live stack dumps on demand: `kill -USR1 <replica pid>` writes
    # every thread's Python stack to the replica log
    faulthandler.register(_sig.SIGUSR1)
    if ns.metrics_port != -1:
        raise NotImplementedError(
            f"--metrics-port {ns.metrics_port}: the /metrics and /healthz "
            "exporter waits for ROADMAP A.6 (observability) in the port; "
            "pass --metrics-port -1")
    from zoo_tpu_torch.common.device import resolve_device
    from zoo_tpu_torch.serving.ha import resolve_model_spec
    from zoo_tpu_torch.serving.llm.spec import build_llm_engine, is_llm_spec
    from zoo_tpu_torch.serving.server import ServingServer
    from zoo_tpu_torch.util.resilience import (
        CircuitBreaker,
        start_heartbeat_thread,
    )

    start_heartbeat_thread()  # no-op unless the supervisor set the env
    if not is_llm_spec(ns.model):
        resolve_model_spec(ns.model)  # raises
    device = resolve_device(ns.device)
    load_serving_kernels(device)
    engine = build_llm_engine(ns.model, device=device)
    server = ServingServer(
        None, host=ns.host, port=ns.port, llm_engine=engine,
        model_spec=ns.model,
        breaker=CircuitBreaker(failure_threshold=5,
                               recovery_timeout=5.0)).start()
    server.install_drain_handler()
    print(f"REPLICA READY {server.host}:{server.port}", flush=True)
    try:
        while not server._stop.is_set():
            time.sleep(0.2)
    except KeyboardInterrupt:
        server.drain()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zoo_tpu_torch.serving.replica",
        description="one serving replica (spawned by ReplicaGroup)")
    ap.add_argument("--model", required=True, help="a llama:* spec")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="obs /metrics + /healthz door; must be -1 (the "
                         "exporter waits for ROADMAP A.6)")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the "
                         "current CUDA device)")
    return serve_replica(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
