"""Serving replica groups: N supervised ``ServingServer`` processes
(counterpart of ``zoo_tpu/serving/ha.py``).

A :class:`ReplicaGroup` launches N replicas of the SAME ``llama:`` spec
on per-replica ports (``python -m zoo_tpu_torch.serving.replica``) and
supervises them with
:class:`zoo_tpu_torch.orca.bootstrap.ProcessMonitor`: a dead replica is
respawned on its original port, heartbeat files catch hangs. The client
half — round-robin, failover and hedging over the group's endpoints — is
:class:`zoo_tpu_torch.serving.ha_client.HAServingClient`.

What waits, each for its ROADMAP item: predict models, ``registry:``
specs, ``rolling_update`` and version info (A.3b, the predict door and
the model registry); per-seat ``prefill``/``decode`` roles (A.5); the
``/healthz`` probe, which needs the metrics exporter, the postmortem
harvest and the wire chaos op (A.6).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from zoo_tpu_torch.util.resilience import Deadline, RetryPolicy

PREDICT_ITEM = "ROADMAP A.3b (the predict door and the model registry)"
OBS_ITEM = "ROADMAP A.6 (observability)"


def resolve_model_spec(spec: str) -> Tuple[object, Optional[str]]:
    """``(model, version)`` of a predict replica spec. A ``llama:`` spec
    is not a predict model: it mounts the streaming engine, resolved by
    the replica process itself. Every predict spec (``synthetic:*``,
    ``registry:*``, model files) waits for ROADMAP A.3b."""
    from zoo_tpu_torch.serving.llm.spec import is_llm_spec
    if is_llm_spec(spec):
        raise ValueError(
            f"{spec!r} is an llm spec (streaming generate, not "
            "predict); build it with "
            "zoo_tpu_torch.serving.llm.build_llm_engine, or pass it as a "
            "ReplicaGroup model to serve it")
    raise NotImplementedError(
        f"predict model specs ({spec!r}) wait for {PREDICT_ITEM} in the "
        "port; it serves llama:* specs")


def _free_ports(n: int) -> List[int]:
    """n distinct free ports, all bound while drawing so no duplicates."""
    import socket as _socket
    socks = [_socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class ReplicaGroup:
    """Launch and supervise ``num_replicas`` serving processes of one
    ``llama:`` spec.

    Ports are fixed at construction (drawn fresh unless ``ports`` is
    given), so a replica that crashes is respawned on its ORIGINAL port
    — clients keep a stable endpoint list across restarts and simply
    fail over while the seat is empty. ``max_restarts`` is the
    per-replica respawn budget (:class:`ProcessMonitor` semantics, with
    quarantine past it); ``heartbeat_timeout`` enables hung-replica
    detection. ``device`` is passed on to every replica (``--device``;
    ``None`` = the replica's current CUDA device, which raises without
    a card)."""

    def __init__(self, model: str, num_replicas: int = 3,
                 host: str = "127.0.0.1",
                 ports: Optional[Sequence[int]] = None,
                 max_restarts: int = 3, log_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 heartbeat_timeout: Optional[float] = None,
                 roles: Optional[Sequence[str]] = None,
                 device: Optional[str] = None):
        from zoo_tpu_torch.orca.bootstrap import (
            ProcessMonitor,
            WorkerProcess,
        )
        from zoo_tpu_torch.serving.llm.spec import is_llm_spec

        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if not is_llm_spec(model):
            resolve_model_spec(model)   # raises, naming why
        if roles is not None and len(roles) != num_replicas:
            raise ValueError(
                f"roles has {len(roles)} entries for "
                f"{num_replicas} replicas")
        if roles is not None and any(r != "mixed" for r in roles):
            raise NotImplementedError(
                "prefill/decode replica roles wait for ROADMAP A.5 "
                "(disaggregation) in the port; every seat serves 'mixed'")
        self.roles = list(roles) if roles is not None else None
        self.model = model
        self.host = host
        self.device = device
        self.num_replicas = int(num_replicas)
        if ports is not None and len(ports) != self.num_replicas:
            raise ValueError(
                f"ports has {len(ports)} entries for "
                f"{self.num_replicas} replicas")
        self.ports = list(ports) if ports is not None \
            else _free_ports(self.num_replicas)
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        workers = []
        for i, port in enumerate(self.ports):
            wenv = dict(os.environ)
            wenv.update(env or {})
            wenv["PYTHONPATH"] = root + os.pathsep + \
                wenv.get("PYTHONPATH", "")
            if self.roles is not None:
                wenv["ZOO_LLM_ROLE"] = self.roles[i]
            hb = os.path.join(log_dir, f"replica-{i}.hb") if log_dir \
                else None
            cmd = [sys.executable, "-m", "zoo_tpu_torch.serving.replica",
                   "--model", model, "--host", host,
                   "--port", str(port), "--metrics-port", "-1"]
            if device is not None:
                cmd += ["--device", str(device)]
            workers.append(WorkerProcess(
                cmd=cmd, env=wenv, name=f"serving-replica-{i}",
                log_dir=log_dir, heartbeat_file=hb))
        # quarantine=True: a seat that exhausts max_restarts is parked
        # (backoff re-admission probes) instead of tearing down the
        # whole group — its healthy siblings keep serving
        self._monitor = ProcessMonitor(
            workers, max_restarts=max_restarts,
            heartbeat_timeout=heartbeat_timeout, quarantine=True)
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def start(self, timeout: float = 120.0) -> "ReplicaGroup":
        """Spawn every replica and block until each one answers a TCP
        ``ping`` (readiness: the model is built and the door is open).
        ``timeout`` covers the whole group."""
        from zoo_tpu_torch.serving.tcp_client import _Connection
        from zoo_tpu_torch.util.resilience import RetryError

        self._monitor.start()
        self._started = True
        deadline = time.monotonic() + timeout
        for i, port in enumerate(self.ports):
            while True:
                try:
                    conn = _Connection(
                        self.host, port,
                        retry=RetryPolicy(max_attempts=1))
                    resp = conn.rpc({"op": "ping"})
                    conn.close()
                    if resp.get("ok"):
                        break
                except (OSError, RetryError):
                    # refused (still booting) or connected-then-died
                    # (killed mid-boot; the supervisor is respawning it)
                    pass
                if time.monotonic() > deadline:
                    self.stop()
                    raise TimeoutError(
                        f"replica {i} ({self.host}:{port}) not ready "
                        f"after {timeout:.0f}s")
                time.sleep(0.05)
        return self

    def stop(self):
        if self._started:
            self._monitor.stop()

    # -- topology ----------------------------------------------------------
    def endpoints(self) -> List[Tuple[str, int]]:
        """The stable ``(host, port)`` list clients round-robin over —
        unchanged across replica restarts."""
        return [(self.host, p) for p in self.ports]

    def client(self, **kwargs):
        """An :class:`HAServingClient` over this group's endpoints."""
        from zoo_tpu_torch.serving.ha_client import HAServingClient
        return HAServingClient(self.endpoints(), **kwargs)

    # -- health ------------------------------------------------------------
    def healthz(self, timeout: float = 2.0):
        raise NotImplementedError(
            f"the /healthz probe needs the metrics exporter, which waits "
            f"for {OBS_ITEM} in the port; probe replicas with ping "
            "(ReplicaGroup._rpc(i, {'op': 'ping'}, timeout))")

    def restarts(self) -> int:
        return sum(w.restarts for w in self._monitor.workers)

    def quarantined(self) -> List[str]:
        """Seats currently parked in quarantine."""
        return self._monitor.quarantined()

    def alive(self) -> List[str]:
        return self._monitor.alive()

    def kill_replica(self, i: int, sig: Optional[int] = None):
        """SIGKILL replica ``i`` (chaos hook): the supervisor respawns
        it on the same port within its restart budget while clients
        fail over."""
        import signal as _signal
        w = self._monitor.workers[i]
        if w.proc is not None and w.proc.poll() is None:
            os.kill(w.proc.pid, sig or _signal.SIGKILL)

    def _rpc(self, i: int, msg: Dict, timeout: float) -> Dict:
        from zoo_tpu_torch.serving.tcp_client import _Connection
        conn = _Connection(self.host, self.ports[i],
                           retry=RetryPolicy(max_attempts=1))
        try:
            return conn.rpc(dict(msg), deadline=Deadline(timeout))
        finally:
            conn.close()

    # -- model lifecycle ---------------------------------------------------
    def rolling_update(self, version=None, **_kwargs) -> Dict:
        raise NotImplementedError(
            f"rolling_update waits for {PREDICT_ITEM} in the port")
