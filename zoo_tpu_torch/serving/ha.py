"""Serving replica groups: N supervised ``ServingServer`` processes
(counterpart of ``zoo_tpu/serving/ha.py``).

A :class:`ReplicaGroup` launches N replicas of the SAME model spec on
per-replica ports (``python -m zoo_tpu_torch.serving.replica``),
supervises them with
:class:`zoo_tpu_torch.orca.bootstrap.ProcessMonitor` (a dead replica is
respawned on its original port, heartbeat files catch hangs), and
exposes the ``/healthz`` door of each replica's metrics exporter, so a
probe sees what the supervisor sees. A group booted from a
``registry:<root>:<alias>`` spec hot-swaps versions with
:meth:`ReplicaGroup.rolling_update`, which rolls back on any failure.
The client half — round-robin, failover and hedging over the group's
endpoints — is :class:`zoo_tpu_torch.serving.ha_client.HAServingClient`.

Model specs (:func:`resolve_model_spec`): ``synthetic:<kind>[:delay_ms]``
(``synthetic:double:5`` → y = 2x after 5 ms; the chaos smokes' stand-in),
``registry:<root>[:<ref>]`` (the versioned model registry), a model file
of the port (``KerasNet.save``), and ``llama:*`` (the streaming engine,
mounted by the replica process itself).

``ReplicaGroup(roles=[...])`` gives each seat its ``ZOO_LLM_ROLE``
(``prefill``/``decode``/``mixed``), kept across a respawn. With a
``log_dir`` every replica spills its flight ring under
``<log_dir>/flight/replica-<i>`` (``ZOO_OBS_POSTMORTEM_DIR``), and
:meth:`ReplicaGroup.harvest_postmortems` packages a dead replica's
remains into ``<log_dir>/postmortems``; :meth:`ReplicaGroup.chaos_rpc`
arms a fault site inside a replica over the wire ``chaos`` op. What
waits for its ROADMAP item: TF SavedModel directories (A.16).
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from zoo_tpu_torch.obs.metrics import counter, gauge, histogram
from zoo_tpu_torch.util.resilience import Deadline, RetryPolicy

_replicas_healthy = gauge(
    "zoo_serve_replicas_healthy",
    "Serving replicas whose /healthz answered ok at the last probe")
_replica_restarts = gauge(
    "zoo_serve_replica_restarts",
    "Total replica respawns performed by this ReplicaGroup's supervisor")
_replicas_quarantined = gauge(
    "zoo_serve_replicas_quarantined",
    "Replica seats that exhausted their restart budget and are parked "
    "in quarantine (probed back on an exponential-backoff timer) — a "
    "nonzero value means the group is serving short-handed and a "
    "postmortem bundle is waiting in the log dir")
_rolling_updates = counter(
    "zoo_serve_rolling_update_total",
    "Rolling updates driven by this ReplicaGroup, by outcome "
    "(ok / rolled_back — rolled_back = a replica failed "
    "load/verify/warm or regressed its post-swap probe and the WHOLE "
    "group was returned to the incumbent version)",
    labels=("outcome",))
_rolling_update_seconds = histogram(
    "zoo_serve_rolling_update_seconds",
    "Wall time of one whole-group rolling update (drain + swap + probe "
    "across every replica)")

SYNTHETIC_PREFIX = "synthetic:"


class SyntheticModel:
    """Stand-in model for chaos tests and transport benches.

    ``synthetic:double[:delay_ms]`` → y = 2x after an optional per-batch
    delay. Deterministic, so a client can verify every response
    (``out == 2 * in``) while replicas are being SIGKILLed under it.
    ``synthetic:broken[:delay_ms]`` loads fine but raises on every
    predict — the stand-in for a published model whose weights are
    garbage, used to exercise warm-failure rollback in rolling
    updates."""

    def __init__(self, factor: float = 2.0, delay_ms: float = 0.0,
                 broken: bool = False):
        self.factor = factor
        self.delay = delay_ms / 1000.0
        self.broken = broken

    @classmethod
    def parse(cls, spec: str) -> "SyntheticModel":
        parts = spec[len(SYNTHETIC_PREFIX):].split(":")
        kind = parts[0] or "double"
        if kind not in ("double", "broken"):
            raise ValueError(
                f"unknown synthetic model {spec!r} (supported: "
                "synthetic:double[:delay_ms], "
                "synthetic:broken[:delay_ms])")
        delay_ms = float(parts[1]) if len(parts) > 1 else 0.0
        return cls(2.0, delay_ms, broken=(kind == "broken"))

    def predict(self, x, batch_size=None):
        if self.delay:
            time.sleep(self.delay)
        if self.broken:
            raise RuntimeError(
                "synthetic:broken model: every inference fails (bad "
                "candidate stand-in)")
        return np.asarray(x) * self.factor


def load_serving_model(spec: str, batch_size: int = 8, device=None):
    """A model from a replica spec: ``synthetic:*``,
    ``registry:<root>:<ref>`` (the versioned model registry) or a model
    file of the port. ``llama:*`` specs are NOT predict models — they
    mount the streaming engine and are resolved by the replica process
    itself. ``device``: where a model file's params go (default: the
    current CUDA device)."""
    return resolve_model_spec(spec, batch_size=batch_size,
                              device=device)[0]


def resolve_model_spec(spec: str, batch_size: int = 8, device=None
                       ) -> Tuple[object, Optional[str]]:
    """``(model, version)`` — ``version`` is the resolved ``"vN"`` for
    ``registry:*`` specs (the alias is re-read NOW, so a respawned
    replica boots on the currently aliased version) and ``None``
    otherwise. The version stays pinned against registry GC for the
    duration of the load. A model file loads through
    :meth:`InferenceModel.load` on ``device``; a directory payload (a
    TF SavedModel) waits for ROADMAP A.16."""
    from zoo_tpu_torch.serving.registry import (
        ModelRegistry,
        is_registry_spec,
        parse_registry_spec,
    )
    if is_registry_spec(spec):
        root, ref = parse_registry_spec(spec)
        reg = ModelRegistry(root)
        with reg.pin(ref) as version:
            _, inner = reg.model_spec(version)
            return load_serving_model(inner, batch_size=batch_size,
                                      device=device), version
    from zoo_tpu_torch.serving.llm.spec import is_llm_spec
    if is_llm_spec(spec):
        raise ValueError(
            f"{spec!r} is an llm spec (streaming generate, not "
            "predict); build it with "
            "zoo_tpu_torch.serving.llm.build_llm_engine, or pass it as a "
            "ReplicaGroup model to serve it")
    if spec.startswith(SYNTHETIC_PREFIX):
        return SyntheticModel.parse(spec), None
    if os.path.isdir(spec):
        raise NotImplementedError(
            f"{spec!r} is a directory (a TF SavedModel); loading one "
            "needs the TF graph bridge, which waits for ROADMAP A.16 in "
            "the port")
    from zoo_tpu_torch.pipeline.inference.inference_model import (
        InferenceModel,
    )
    im = InferenceModel(supported_concurrent_num=2)
    im.load(spec, batch_size=batch_size, device=device)
    return im, None


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


class RollingUpdateError(RuntimeError):
    """A rolling update failed; the group has been rolled back to (or
    never left) the incumbent version — it is not mixed-version."""


class ReplicaGroup:
    """Launch and supervise ``num_replicas`` serving processes of one
    model.

    Ports are fixed at construction (drawn fresh unless ``ports`` is
    given), so a replica that crashes is respawned on its ORIGINAL port
    — clients keep a stable endpoint list across restarts and simply
    fail over while the seat is empty. Each replica additionally serves
    the obs door (``/metrics`` + ``/healthz``) on its own metrics port;
    :meth:`healthz` probes them and publishes the
    ``zoo_serve_replicas_healthy`` gauge.

    ``max_restarts`` is the per-replica respawn budget
    (:class:`ProcessMonitor` semantics); ``heartbeat_timeout`` enables
    hung-replica detection on top of crash detection."""

    def __init__(self, model: str, num_replicas: int = 3,
                 host: str = "127.0.0.1",
                 ports: Optional[Sequence[int]] = None,
                 batch_size: int = 8, max_wait_ms: float = 5.0,
                 max_restarts: int = 3, log_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 heartbeat_timeout: Optional[float] = None,
                 roles: Optional[Sequence[str]] = None,
                 device: Optional[str] = None):
        """``roles``: per-seat disaggregation roles, e.g. ``["prefill",
        "decode"]``, injected as each replica's ``ZOO_LLM_ROLE`` so a
        respawned seat keeps its role (``None`` = every seat
        ``mixed``). ``device`` is passed on to every replica
        (``--device``; ``None`` = the replica's current CUDA device,
        which raises without a card)."""
        from zoo_tpu_torch.orca.bootstrap import (
            ProcessMonitor,
            WorkerProcess,
        )

        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if roles is not None and len(roles) != num_replicas:
            raise ValueError(
                f"roles has {len(roles)} entries for "
                f"{num_replicas} replicas")
        self.roles = list(roles) if roles is not None else None
        self.model = model
        self.host = host
        self.device = device
        # registry-backed groups know their root + alias, which is what
        # rolling_update / auto-rollback steer
        self.registry_root: Optional[str] = None
        self.alias: Optional[str] = None
        from zoo_tpu_torch.serving.registry import (
            ModelRegistry,
            is_registry_spec,
            parse_registry_spec,
        )
        if is_registry_spec(model):
            self.registry_root, ref = parse_registry_spec(model)
            if ModelRegistry._as_version(ref) is None and ref != "latest":
                self.alias = ref
        self.num_replicas = int(num_replicas)
        if ports is not None and len(ports) != self.num_replicas:
            raise ValueError(
                f"ports has {len(ports)} entries for "
                f"{self.num_replicas} replicas")
        drawn = _free_ports(2 * self.num_replicas)
        self.ports = list(ports) if ports is not None \
            else drawn[:self.num_replicas]
        self.metrics_ports = drawn[self.num_replicas:]
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        workers = []
        for i, (port, mport) in enumerate(zip(self.ports,
                                              self.metrics_ports)):
            wenv = dict(os.environ)
            wenv.update(env or {})
            wenv["PYTHONPATH"] = root + os.pathsep + \
                wenv.get("PYTHONPATH", "")
            if self.roles is not None:
                wenv["ZOO_LLM_ROLE"] = self.roles[i]
            hb = os.path.join(log_dir, f"replica-{i}.hb") if log_dir \
                else None
            if log_dir:
                # per-replica flight-recorder dir: the replica spills its
                # event ring there continuously (a SIGKILL cannot be
                # caught: the spill IS its postmortem) and dumps full
                # bundles there on catchable deaths
                wenv["ZOO_OBS_POSTMORTEM_DIR"] = os.path.join(
                    log_dir, "flight", f"replica-{i}")
            cmd = [sys.executable, "-m", "zoo_tpu_torch.serving.replica",
                   "--model", model, "--host", host,
                   "--port", str(port), "--metrics-port", str(mport),
                   "--batch-size", str(batch_size),
                   "--max-wait-ms", str(max_wait_ms)]
            if device is not None:
                cmd += ["--device", str(device)]
            workers.append(WorkerProcess(
                cmd=cmd, env=wenv, name=f"serving-replica-{i}",
                log_dir=log_dir, heartbeat_file=hb))
        # quarantine=True: a seat that exhausts max_restarts is parked
        # (flight event + zoo_serve_replicas_quarantined gauge +
        # backoff re-admission probes) instead of tearing down the whole group — its healthy
        # siblings keep serving while the clients fail over around the
        # empty seat
        self._monitor = ProcessMonitor(
            workers, max_restarts=max_restarts,
            heartbeat_timeout=heartbeat_timeout, quarantine=True)
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def start(self, timeout: float = 120.0) -> "ReplicaGroup":
        """Spawn every replica and block until each one answers a TCP
        ``ping`` (readiness, not just liveness — the model is loaded and
        the batcher is running). ``timeout`` covers the whole group;
        synthetic models are ready in well under a second."""
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
                    # — keep polling until the group timeout
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
    def healthz(self, timeout: float = 2.0) -> List[Optional[Dict]]:
        """Probe every replica's ``/healthz`` door; ``None`` for a
        replica that did not answer. Publishes the
        ``zoo_serve_replicas_healthy`` gauge and the restart tally.
        The body carries each replica's last SLO-watchdog verdict when
        one is running (``"slo"``). Also sweeps dead replicas'
        flight-recorder remains into the group's postmortem dir
        (best-effort, same cadence as the probes)."""
        try:
            self.harvest_postmortems()
        except Exception:  # noqa: BLE001 — probing must never fail on
            pass           # a harvest hiccup
        out: List[Optional[Dict]] = []
        for i, mport in enumerate(self.metrics_ports):
            try:
                with urllib.request.urlopen(
                        f"http://{self.host}:{mport}/healthz",
                        timeout=timeout) as resp:
                    out.append(json.loads(resp.read().decode()))
            except Exception:  # noqa: BLE001 — a down replica is data
                w = self._monitor.workers[i]
                # EVERY seat accounts: a quarantined one answers with
                # an explicit verdict instead of a bare None, so the
                # probe (and the postmortem reading it) can tell "seat
                # parked after exhausting its restart budget" from
                # "seat mid-respawn"
                out.append({"ok": False, "quarantined": True,
                            "restarts": w.restarts}
                           if w.quarantined else None)
        _replicas_healthy.set(
            sum(1 for h in out if h is not None and h.get("ok")))
        _replica_restarts.set(self.restarts())
        _replicas_quarantined.set(len(self._monitor.quarantined()))
        return out

    def restarts(self) -> int:
        return sum(w.restarts for w in self._monitor.workers)

    def quarantined(self) -> List[str]:
        """Seats currently parked in quarantine (also published as the
        ``zoo_serve_replicas_quarantined`` gauge on every healthz
        sweep)."""
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

    def chaos_rpc(self, i: int, site: str, delay_ms: float = None,
                  error: str = None, p: float = 1.0, times: int = None,
                  clear: bool = False, timeout: float = 5.0) -> Dict:
        """Arm (or clear) a fault site INSIDE replica ``i`` over the
        wire ``chaos`` op — the remote half of the deterministic chaos
        harness. The replica refuses unless
        its env carries ``ZOO_CHAOS_ALLOW=1`` (pass it via ``env=`` at
        group construction, as the chaos smokes do)."""
        msg: Dict = {"op": "chaos", "site": site}
        if clear:
            msg["clear"] = 1
        else:
            if delay_ms is not None:
                msg["delay_ms"] = float(delay_ms)
            if error is not None:
                msg["error"] = error
            if times is not None:
                msg["times"] = int(times)
            msg["p"] = float(p)
        resp = self._rpc(i, msg, timeout)
        if not resp.get("ok"):
            raise RuntimeError(
                f"chaos op on replica {i} refused: {resp.get('error')}")
        return resp

    # -- postmortem harvest ------------------------------------------------
    def _flight_dir(self, i: int) -> Optional[str]:
        if not self.log_dir:
            return None
        return os.path.join(self.log_dir, "flight", f"replica-{i}")

    def postmortem_dir(self) -> Optional[str]:
        """Where harvested bundles land: ``<log_dir>/postmortems``."""
        if not self.log_dir:
            return None
        return os.path.join(self.log_dir, "postmortems")

    def harvest_postmortems(self) -> List[str]:
        """Collect dead replicas' flight-recorder output into the group
        dir. Two kinds of remains: full postmortem bundles (dumped on
        catchable deaths — unhandled exception, SIGTERM, rc-75
        preemption) are moved as-is; orphan spill files (``flight-
        <pid>.jsonl`` whose pid is not the live replica — the SIGKILL
        case, where no handler could run) are packaged into a bundle
        with whatever events were flushed before death, torn tail
        skipped. Idempotent; returns the new bundle paths. Requires a
        ``log_dir`` (no dir = recorder was never armed)."""
        out_dir = self.postmortem_dir()
        if out_dir is None:
            return []
        from zoo_tpu_torch.obs.flight import read_spill
        harvested: List[str] = []
        for i in range(self.num_replicas):
            fdir = self._flight_dir(i)
            if not fdir or not os.path.isdir(fdir):
                continue
            w = self._monitor.workers[i]
            live_pid = w.proc.pid if w.proc is not None and \
                w.proc.poll() is None else None
            for fname in sorted(os.listdir(fdir)):
                src = os.path.join(fdir, fname)
                if fname.startswith("postmortem-") and \
                        fname.endswith(".json"):
                    os.makedirs(out_dir, exist_ok=True)
                    dst = os.path.join(out_dir,
                                       f"replica-{i}-{fname}")
                    try:
                        os.replace(src, dst)
                        harvested.append(dst)
                    except OSError:
                        pass
                    continue
                if not (fname.startswith("flight-") and
                        fname.endswith(".jsonl")):
                    continue
                try:
                    pid = int(fname[len("flight-"):-len(".jsonl")])
                except ValueError:
                    continue
                if pid == live_pid:
                    continue  # the live replica's own spill
                ring = read_spill(src)
                bundle = {"reason": "harvested", "pid": pid,
                          "replica": i, "ts": time.time(),
                          "note": "process died without dumping (e.g. "
                                  "SIGKILL); ring reconstructed from "
                                  "the continuous spill, torn tail "
                                  "skipped",
                          "ring": ring}
                os.makedirs(out_dir, exist_ok=True)
                dst = os.path.join(
                    out_dir, f"replica-{i}-postmortem-pid{pid}.json")
                try:
                    tmp = dst + ".tmp"
                    with open(tmp, "w", encoding="utf-8") as f:
                        json.dump(bundle, f, default=str)
                    os.replace(tmp, dst)
                    os.remove(src)
                    harvested.append(dst)
                except OSError:
                    pass
        return harvested

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

    # -- model lifecycle ---------------------------------------------------
    def registry(self):
        """The :class:`ModelRegistry` this group serves from; raises
        for non-registry model specs."""
        from zoo_tpu_torch.serving.registry import ModelRegistry
        if self.registry_root is None:
            raise RuntimeError(
                "this group does not serve from a model registry "
                f"(model spec {self.model!r}); boot it from a "
                "registry:<root>:<alias> spec to use the lifecycle API")
        return ModelRegistry(self.registry_root)

    def _rpc(self, i: int, msg: Dict, timeout: float) -> Dict:
        from zoo_tpu_torch.serving.tcp_client import _Connection
        conn = _Connection(self.host, self.ports[i],
                           retry=RetryPolicy(max_attempts=1))
        try:
            return conn.rpc(dict(msg), deadline=Deadline(timeout))
        finally:
            conn.close()

    def version_info(self, timeout: float = 5.0) -> List[Optional[Dict]]:
        """Per-replica ``{"version": "vN", "model_spec": ...}`` (None
        for a replica that did not answer) — the ground truth a
        rolling update verifies against."""
        out: List[Optional[Dict]] = []
        for i in range(self.num_replicas):
            try:
                out.append(self._rpc(i, {"op": "version"}, timeout))
            except Exception:  # noqa: BLE001 — a down replica is data
                out.append(None)
        return out

    def _metrics_counter(self, i: int, name: str,
                         timeout: float = 2.0) -> Dict[str, float]:
        """``{label-signature: value}`` for one counter family scraped
        off replica ``i``'s /metrics door (empty when unreachable)."""
        out: Dict[str, float] = {}
        try:
            with urllib.request.urlopen(
                    f"http://{self.host}:{self.metrics_ports[i]}/metrics",
                    timeout=timeout) as resp:
                text = resp.read().decode()
        except Exception:  # noqa: BLE001
            return out
        for m in re.finditer(
                rf"^{re.escape(name)}(\{{[^}}]*\}})? ([0-9.eE+-]+)$",
                text, re.M):
            out[m.group(1) or ""] = float(m.group(2))
        return out

    def _probe_replica(self, i: int, version: Optional[str],
                       settle: float, max_error_rate: float,
                       timeout: float):
        """Post-swap health gate: the replica must (1) answer its
        ``/healthz`` door ok and report the target version, then
        (2) survive a ``settle``-second live-traffic window without its
        served error rate regressing past ``max_error_rate`` — the
        check that catches a model that loads and warms but then fails
        (or garbage-errors) on real requests."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://{self.host}:{self.metrics_ports[i]}"
                        "/healthz", timeout=2.0) as resp:
                    hz = json.loads(resp.read().decode())
                if hz.get("ok"):
                    info = self._rpc(i, {"op": "version"}, 2.0)
                    if version is None or info.get("version") == version:
                        break
            except Exception:  # noqa: BLE001 — keep probing
                pass
            if time.monotonic() > deadline:
                raise RollingUpdateError(
                    f"replica {i} did not probe healthy on {version} "
                    f"within {timeout:.0f}s after the swap")
            time.sleep(0.1)
        before = self._metrics_counter(i, "zoo_serving_requests_total")
        time.sleep(max(0.0, settle))
        after = self._metrics_counter(i, "zoo_serving_requests_total")
        delta = {k: after.get(k, 0.0) - before.get(k, 0.0)
                 for k in after}
        errors = sum(v for k, v in delta.items() if "error" in k)
        # EXECUTED requests only: sheds (breaker-open included) must
        # not dilute the rate, or a fully broken model whose breaker
        # opened mid-window would pass the probe on shed volume
        total = errors + sum(v for k, v in delta.items()
                             if '"ok"' in k and v > 0)
        if total >= 2 and errors / total > max_error_rate:
            raise RollingUpdateError(
                f"replica {i} error rate regressed after swapping to "
                f"{version}: {errors:.0f}/{total:.0f} requests errored "
                f"in the {settle:.1f}s probe window "
                f"(bound {max_error_rate:.0%})")

    def _swap_one(self, i: int, spec: str, version: Optional[str],
                  timeout: float):
        """Hot-swap ONE replica to ``spec`` and return only when it
        serves ``version``. A transport loss mid-reload (the replica
        was SIGKILLed under us) is NOT a failure: the supervisor
        respawns the seat, and a registry-spec replica re-resolves its
        alias at boot — we wait for it and verify the version, retrying
        the reload when the respawn came up on something older."""
        deadline = time.monotonic() + timeout
        attempt_reload = True
        while True:
            if attempt_reload:
                try:
                    resp = self._rpc(i, {"op": "reload", "spec": spec,
                                         "version": version},
                                     max(1.0, deadline - time.monotonic()))
                    if resp.get("ok"):
                        return
                    raise RollingUpdateError(
                        f"replica {i} rejected the swap to {version}: "
                        f"{resp.get('error')}")
                except RollingUpdateError:
                    raise
                except Exception:  # noqa: BLE001 — transport loss:
                    # killed/respawning mid-reload; fall through to the
                    # respawn-verify path
                    attempt_reload = False
            try:
                info = self._rpc(i, {"op": "version"}, 2.0)
                if version is None or info.get("version") == version:
                    return
                # seat is back but on an older version (respawned
                # before the alias moved, or boot raced the kill):
                # drive the reload again
                attempt_reload = True
            except Exception:  # noqa: BLE001 — still respawning
                pass
            if time.monotonic() > deadline:
                raise RollingUpdateError(
                    f"replica {i} never came up on {version} within "
                    f"{timeout:.0f}s (killed mid-reload and respawn "
                    "didn't land?)")
            time.sleep(0.1)

    def rolling_update(self, version=None, *,
                       drain_timeout: Optional[float] = None,
                       settle: float = 0.5,
                       max_error_rate: float = 0.5,
                       reload_timeout: float = 120.0) -> Dict:
        """Zero-downtime group-wide hot-swap to registry ``version``
        (default: whatever the group's alias currently resolves to —
        the normal call order is *move the alias, then roll*).

        One replica at a time: reload (load + verify + warm beside the
        old model, atomic flip), then a ``/healthz`` + error-rate probe
        — the HA client's failover/hedging makes each per-replica swap
        invisible to callers. ANY failure (load/verify/warm rejection,
        a replica that never comes back, a probe regression) triggers
        **automatic rollback**: the alias is returned to the incumbent
        version, every already-swapped replica is reloaded back, and
        :class:`RollingUpdateError` is raised — the group is never left
        mixed-version after completion, in either direction.

        ``drain_timeout`` (default ``$ZOO_SERVE_DRAIN_TIMEOUT_S``) is
        the per-replica budget for in-flight work around the swap — the
        same knob :meth:`ServingServer.drain` honors, so slow LLM
        streams get the same protection in both paths."""
        from zoo_tpu_torch.serving.server import drain_timeout as _dt
        reg = self.registry()
        if drain_timeout is None:
            drain_timeout = _dt()
        if version is None:
            if self.alias is None:
                raise RollingUpdateError(
                    "rolling_update needs an explicit version for a "
                    "non-aliased registry spec")
            version = reg.alias_version(self.alias)
            if version is None:
                raise RollingUpdateError(
                    f"alias {self.alias!r} does not exist in "
                    f"{self.registry_root}")
        version, _path = reg.resolve(version)  # verify BEFORE touching
        target_spec = f"registry:{self.registry_root}:{version}"
        info = self.version_info()
        incumbents = [d.get("version") for d in info
                      if d is not None and d.get("version") not in
                      (None, version)]
        incumbent = incumbents[0] if incumbents else None
        swapped: List[int] = []
        t0 = time.perf_counter()
        failure: Optional[Exception] = None
        try:
            for i in range(self.num_replicas):
                cur = info[i].get("version") if info[i] else None
                if cur == version:
                    continue  # already serving the target
                self._swap_one(i, target_spec, version,
                               reload_timeout + drain_timeout)
                swapped.append(i)
                self._probe_replica(i, version, settle, max_error_rate,
                                    timeout=drain_timeout + 30.0)
        except Exception as e:  # noqa: BLE001 — every failure rolls back
            failure = e
        if failure is None:
            _rolling_updates.labels(outcome="ok").inc()
            _rolling_update_seconds.observe(time.perf_counter() - t0)
            return {"version": version, "swapped": len(swapped),
                    "seconds": round(time.perf_counter() - t0, 3)}
        # -- auto-rollback: leave the group 100% on the incumbent ----------
        if incumbent is None:
            _rolling_updates.labels(outcome="rolled_back").inc()
            raise RollingUpdateError(
                f"rolling update to {version} failed with no known "
                "incumbent version to roll back to") from failure
        # alias first, so any supervisor respawn during the rollback
        # boots on the incumbent, not the bad candidate
        if self.alias is not None and \
                reg.alias_version(self.alias) == version:
            reg.set_alias(self.alias, incumbent)
        # roll back every replica ACTUALLY on the target, not just the
        # ones _swap_one returned for: a reload whose reply was lost
        # (deadline expired mid-load, connection dropped) may have
        # flipped server-side after _swap_one gave up on it
        on_target = {i for i, d in enumerate(self.version_info())
                     if d is not None and d.get("version") == version}
        rb_spec = f"registry:{self.registry_root}:{incumbent}"
        for i in sorted(set(swapped) | on_target):
            try:
                self._swap_one(i, rb_spec, incumbent, reload_timeout)
            except Exception:  # noqa: BLE001 — last resort: respawn
                # picks the (restored) alias up from the registry
                self.kill_replica(i)
                try:
                    self._swap_one(i, rb_spec, incumbent, reload_timeout)
                except Exception:  # noqa: BLE001
                    pass
        final = [d.get("version") if d else None
                 for d in self.version_info()]
        _rolling_updates.labels(outcome="rolled_back").inc()
        _rolling_update_seconds.observe(time.perf_counter() - t0)
        raise RollingUpdateError(
            f"rolling update to {version} failed and was rolled back "
            f"to {incumbent} (replica versions now {final}): {failure}"
        ) from failure
