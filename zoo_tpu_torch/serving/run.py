"""The Cluster Serving launcher (own copy of ``zoo_tpu/serving/run.py``,
the reference's ``cluster-serving-start`` and its ``config.yaml``).

``python -m zoo_tpu_torch.serving.run --model m.zoo [--config
config.yaml] [--device cpu]`` loads the model into an
``InferenceModel`` (on the current CUDA device unless ``--device``
names another; on a card the model's kernels are built or loaded
before the first request), starts the serving job against Redis (an
external one, or the embedded RESP server) and the HTTP front end, and
serves until SIGINT/SIGTERM: then it closes the front door, lets the
job finish its batch, and flushes the ``ZOO_OBS_SNAPSHOT`` metrics.

``--encrypted`` reads a model file encrypted at rest, the key material
from ``--model-secret``/``--model-salt`` or ``ZOO_MODEL_SECRET`` /
``ZOO_MODEL_SALT`` (the mode from ``--model-enc-mode`` or
``ZOO_MODEL_ENC_MODE``); a plain model is never sent down that branch
by an environment variable alone. ``--tcp-replicas N`` serves over the
TCP door through a ``ReplicaGroup`` of N replica processes instead;
each loads the model itself, so it refuses ``--encrypted`` rather than
ignore it.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading
import time

from zoo_tpu_torch.common.knobs import value as knob_value


def _load_config(path):
    """Minimal config.yaml reader (flat ``key: value`` pairs under the
    reference's section names; no yaml dependency)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if ":" in line:
                k, v = line.split(":", 1)
                if v.strip():
                    out[k.strip()] = v.strip().strip("'\"")
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m zoo_tpu_torch.serving.run")
    ap.add_argument("--model", required=False,
                    help="a model file of the port (KerasNet.save)")
    ap.add_argument("--config", help="reference-style config.yaml "
                                     "(modelPath/redis/.. keys)")
    ap.add_argument("--device", default=None,
                    help="torch device of the model (default: the current "
                         "CUDA device; cpu runs the plain PyTorch path)")
    ap.add_argument("--redis-host", default="localhost")
    ap.add_argument("--redis-port", type=int, default=6379)
    ap.add_argument("--http-port", type=int, default=10020)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--concurrent-num", type=int, default=4)
    ap.add_argument("--quantize", action="store_true",
                    help="int8, in the mode ZOO_INT8_MODE gives")
    ap.add_argument("--redis-mode", default="auto",
                    choices=["auto", "external", "embedded"],
                    help="external: wait for a real Redis (up to "
                         "--redis-wait s, then fail); embedded: always "
                         "boot the in-process RESP server; auto: probe "
                         "briefly, then fall back to embedded")
    ap.add_argument("--redis-wait", type=float, default=60.0)
    ap.add_argument("--tcp-replicas", type=int, default=0,
                    help="HA mode: serve over the TCP door via a "
                         "ReplicaGroup of N supervised replica processes "
                         "instead of the Redis pipeline; each replica "
                         "loads the model itself")
    ap.add_argument("--tcp-port", type=int, default=0,
                    help="base TCP port for --tcp-replicas (replica i "
                         "serves tcp-port+i; 0 = ephemeral ports, printed "
                         "at startup)")
    ap.add_argument("--tcp-max-restarts", type=int, default=3,
                    help="per-replica respawn budget in HA mode")
    ap.add_argument("--registry", default=None,
                    help="serve from a versioned model registry root: "
                         "replicas resolve --alias at boot and hot-swap "
                         "via ReplicaGroup.rolling_update; shorthand for "
                         "--model registry:<root>:<alias>")
    ap.add_argument("--alias", default="prod",
                    help="registry alias to serve (with --registry; "
                         "default prod)")
    ap.add_argument("--encrypted", action="store_true",
                    help="the model file is encrypted at rest; key "
                         "material comes from --model-secret/--model-salt "
                         "or ZOO_MODEL_SECRET/ZOO_MODEL_SALT")
    ap.add_argument("--model-secret", default=None)
    ap.add_argument("--model-salt", default=None)
    ap.add_argument("--model-enc-mode", default=None,
                    choices=["cbc", "gcm"],
                    help="cipher mode of the encrypted model "
                         "(ZOO_MODEL_ENC_MODE; default cbc)")
    return ap


def _stop_on_signals(stop: threading.Event):
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())


def _serve_ha(ns) -> int:
    """HA mode: the replicas load the model themselves (one process
    each, supervised and respawned on a fixed port); this process is
    only the group supervisor: no Redis, no HTTP front end."""
    from zoo_tpu_torch.obs.flight import install_crash_handlers
    from zoo_tpu_torch.serving.ha import ReplicaGroup
    ports = [ns.tcp_port + i for i in range(ns.tcp_replicas)] \
        if ns.tcp_port else None
    group = ReplicaGroup(ns.model, num_replicas=ns.tcp_replicas,
                         ports=ports, batch_size=ns.batch_size,
                         max_restarts=ns.tcp_max_restarts,
                         device=ns.device)
    group.start()
    print("serving-ha: endpoints "
          + ",".join(f"{h}:{p}" for h, p in group.endpoints()), flush=True)
    stop = threading.Event()
    _stop_on_signals(stop)
    install_crash_handlers()
    stop.wait()
    # replicas drain on their own SIGTERM; harvest after the stop, which
    # is what makes each replica dump its final postmortem bundle
    group.stop()
    group.harvest_postmortems()
    return 0


def _redis(ns):
    """(host, port, embedded server or None): a real Redis may come up
    after this process (compose orders start, not readiness), so it is
    probed with retries before any fallback."""
    from zoo_tpu_torch.serving.redis_embedded import EmbeddedRedis

    def reachable() -> bool:
        try:
            with socket.create_connection((ns.redis_host, ns.redis_port),
                                          timeout=1):
                return True
        except OSError:
            return False

    if ns.redis_mode != "embedded":
        wait = ns.redis_wait if ns.redis_mode == "external" else 3.0
        deadline = time.time() + wait
        while not reachable() and time.time() < deadline:
            time.sleep(0.5)
        if reachable():
            return ns.redis_host, ns.redis_port, None
        if ns.redis_mode == "external":
            return None
    embedded = EmbeddedRedis(host="127.0.0.1", port=ns.redis_port).start()
    print(f"embedded RESP server on :{embedded.port}", flush=True)
    return "127.0.0.1", embedded.port, embedded


def _load_model(ap, ns):
    from zoo_tpu_torch.common.device import resolve_device
    from zoo_tpu_torch.pipeline.inference.inference_model import (
        InferenceModel,
    )
    from zoo_tpu_torch.serving.replica import (
        PREDICT_KERNELS,
        load_serving_kernels,
    )

    device = resolve_device(ns.device)
    im = InferenceModel(supported_concurrent_num=ns.concurrent_num)
    if os.path.isdir(ns.model):
        try:
            im.load_tf(ns.model, batch_size=ns.batch_size)
        except NotImplementedError as e:
            ap.error(f"{ns.model} is a directory: {e}")
    load_serving_kernels(device, PREDICT_KERNELS)
    if ns.encrypted or ns.model_secret is not None:
        # decrypted in memory only; the key material arrives by flags or
        # the environment, and only an explicit opt-in takes this branch
        secret = ns.model_secret or knob_value("ZOO_MODEL_SECRET")
        salt = ns.model_salt or knob_value("ZOO_MODEL_SALT")
        if not secret:
            ap.error("--encrypted needs --model-secret or ZOO_MODEL_SECRET")
        mode = ns.model_enc_mode or knob_value("ZOO_MODEL_ENC_MODE")
        if mode not in ("cbc", "gcm"):
            ap.error(f"invalid cipher mode {mode!r} (cbc|gcm)")
        return im.load_encrypted(ns.model, secret, salt or "", mode=mode,
                                 batch_size=ns.batch_size,
                                 quantize=ns.quantize, device=device)
    return im.load(ns.model, batch_size=ns.batch_size, quantize=ns.quantize,
                   device=device)


def main(argv=None) -> int:
    ap = _parser()
    ns = ap.parse_args(argv)
    if ns.config:
        cfg = _load_config(ns.config)
        ns.model = ns.model or cfg.get("modelPath") or cfg.get("path")
        ns.redis_host = cfg.get("redisHost", ns.redis_host)
        ns.redis_port = int(cfg.get("redisPort", ns.redis_port))
        ns.batch_size = int(cfg.get("batchSize", ns.batch_size))
    if ns.registry:
        if ns.model:
            ap.error("--registry and --model are mutually exclusive "
                     "(--registry IS the model source)")
        ns.model = f"registry:{ns.registry}:{ns.alias}"
        if ns.tcp_replicas <= 0:
            ap.error("--registry needs the HA TCP mode (--tcp-replicas "
                     "N): hot-swap reload lives on the replica wire")
    if not ns.model:
        ap.error("--model (or a config with modelPath, or --registry) "
                 "is required")
    if ns.tcp_replicas > 0:
        if ns.encrypted or ns.model_secret is not None:
            ap.error("--encrypted is not served with --tcp-replicas: each "
                     "replica loads a plain model file itself")
        return _serve_ha(ns)

    from zoo_tpu_torch.serving.client import InputQueue
    from zoo_tpu_torch.serving.cluster_serving import ClusterServing, FrontEnd

    t0 = time.perf_counter()
    redis = _redis(ns)
    if redis is None:
        print(f"no Redis at {ns.redis_host}:{ns.redis_port} after "
              f"{ns.redis_wait:.0f}s", file=sys.stderr)
        return 1
    host, port, embedded = redis
    im = _load_model(ap, ns)
    serving = ClusterServing(model=im, redis_host=host, redis_port=port,
                             batch_size=ns.batch_size).start()
    fe = FrontEnd(serving, InputQueue(host=host, port=port),
                  host="0.0.0.0", port=ns.http_port).start()
    print(f"serving: redis {host}:{port}  http {fe.host}:{fe.port}  "
          f"device {im._device}  boot {time.perf_counter() - t0:.2f}s",
          flush=True)

    stop = threading.Event()
    _stop_on_signals(stop)
    stop.wait()
    # graceful drain: close the HTTP front door first (no new work
    # enters), let the job finish its batch in flight (stop() joins the
    # consumer), then flush the final metrics snapshot
    fe.stop()
    serving.stop()
    if embedded is not None:
        embedded.stop()
    snap = knob_value("ZOO_OBS_SNAPSHOT")
    if snap:
        try:
            from zoo_tpu_torch.obs.exporters import write_snapshot
            write_snapshot(snap)
        except Exception as e:  # noqa: BLE001 — the flush is best-effort
            print(f"metrics snapshot flush failed: {e}", file=sys.stderr)
    print(f"serving: drained, {serving.records_out} records answered",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
