"""Worker-process supervision (counterpart of
``zoo_tpu/orca/bootstrap.py``: ``WorkerProcess``, ``ProcessMonitor``
and ``free_port``; the multi-process cluster launch and elastic
scale-down come with ROADMAP A.14, parallelism).

* :class:`ProcessMonitor` — spawn N workers, watch them, restart on
  crash (bounded), tear the whole group down when any worker fails
  fatally or the parent exits — or, in ``quarantine`` mode (what the
  serving ``ReplicaGroup`` uses), park a seat that exhausted its budget
  and probe it back on a backoff timer. Children get ``PR_SET_PDEATHSIG``
  (SIGKILLed by the kernel if the supervisor dies) and their own process
  group for clean group kills.
* Heartbeat files (``ZOO_HEARTBEAT_FILE``) let the monitor treat a hung
  worker as crashed.
"""

from __future__ import annotations

import atexit
import ctypes
import logging
import os
import signal
import socket
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

from zoo_tpu_torch.obs.metrics import counter
from zoo_tpu_torch.util.resilience import (
    HEARTBEAT_FILE_ENV,
    _flight,
    heartbeat_age,
)

logger = logging.getLogger(__name__)

#: a worker's deliberate checkpoint-and-exit after a preemption signal
#: (the training guardian's exit code): completion, never a crash
PREEMPT_EXIT_CODE = 75


class WorkersPreempted(RuntimeError):
    """Every worker exited with :data:`PREEMPT_EXIT_CODE` — a
    preemption-triggered coordinated checkpoint, not a crash. The
    supervisor should relaunch at the SAME world size and let the job
    resume from the checkpoint (resume-don't-retry)."""


_worker_restarts = counter(
    "zoo_worker_restarts_total",
    "Supervised workers respawned after a crash or hang")
_workers_hung = counter(
    "zoo_worker_hung_total",
    "Supervised workers killed for a stale heartbeat")
_worker_quarantines = counter(
    "zoo_worker_quarantine_total",
    "Quarantine-mode transitions performed by supervisors in this "
    "process (quarantined = a worker exhausted its restart budget and "
    "was parked instead of killing the group; probe = a backoff-timed "
    "respawn attempt; readmitted = a probe survived the heal window "
    "and the seat returned to normal supervision)",
    labels=("event",))


_PR_SET_PDEATHSIG = 1


def _child_preexec():
    """Run in the child between fork and exec: new session (own process
    group for clean group-kill) and kernel-level orphan protection."""
    os.setsid()
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    except Exception:
        pass  # non-Linux: atexit kill still covers the common case


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class WorkerProcess:
    """One supervised worker (reference: a ray start subprocess tracked by
    ``ProcessInfo``)."""

    def __init__(self, cmd: Sequence[str], env: Dict[str, str],
                 name: str, log_dir: Optional[str] = None,
                 heartbeat_file: Optional[str] = None):
        self.cmd = list(cmd)
        self.env = dict(env)
        self.name = name
        self.log_dir = log_dir
        self.heartbeat_file = heartbeat_file
        if heartbeat_file:
            self.env[HEARTBEAT_FILE_ENV] = heartbeat_file
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self._log_fh = None
        self.heartbeat_spawn_mtime: Optional[float] = None
        # quarantine-mode state (docs/fault_tolerance.md): set by a
        # ProcessMonitor(quarantine=True) when this worker exhausts its
        # restart budget — parked, probed on a backoff timer, readmitted
        # after a probe survives the heal window
        self.quarantined = False
        self.quarantine_until = 0.0
        self.quarantine_backoff = 0.0
        self.quarantines = 0
        self.last_spawn_monotonic: Optional[float] = None

    def spawn(self):
        if self._log_fh:  # restart: release the previous run's handle
            self._log_fh.close()
            self._log_fh = None
        if self.heartbeat_file:
            # stamp at spawn so staleness is measured from launch even if
            # the worker never gets far enough to beat on its own; record
            # the stamp so the monitor can tell "never beat yet (still
            # booting — import jax alone can take many seconds)" from
            # "beat, then went silent (hung)"
            from zoo_tpu_torch.util.resilience import touch_heartbeat
            touch_heartbeat(self.heartbeat_file)
            try:
                self.heartbeat_spawn_mtime = \
                    os.stat(self.heartbeat_file).st_mtime
            except OSError:
                self.heartbeat_spawn_mtime = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            self._log_fh = open(
                os.path.join(self.log_dir, f"{self.name}.log"), "ab")
            out = err = self._log_fh
        else:
            out = err = None
        self.proc = subprocess.Popen(
            self.cmd, env=self.env, stdout=out, stderr=err,
            preexec_fn=_child_preexec)
        self.last_spawn_monotonic = time.monotonic()
        return self.proc

    @property
    def returncode(self) -> Optional[int]:
        return self.proc.poll() if self.proc else None

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            try:  # group-kill: the worker may have forked its own helpers
                os.killpg(self.proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(self.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                self.proc.wait()
        if self._log_fh:  # close even for self-exited workers
            self._log_fh.close()
            self._log_fh = None


class ProcessMonitor:
    """Spawn + supervise a set of workers (reference ``ProcessMonitor``
    ``ray/process.py:90``: tracks pids, raises when a member dies, cleans
    the rest up).

    ``max_restarts``: per-worker crash budget. Within budget a crashed
    worker is respawned; past it the whole group is torn down and
    :meth:`wait` raises. Exit code 0 counts as completion, not a crash.

    ``heartbeat_timeout``: optional hung-worker detection. Workers whose
    :class:`WorkerProcess` carries a ``heartbeat_file`` (stamped by
    ``touch_heartbeat`` / the ``init_orca_context`` heartbeat thread) are
    SIGKILLed and charged against the restart budget when the file goes
    stale for longer than this many seconds — a worker stuck in a dead
    collective is a crash the same as one that exited nonzero.

    ``quarantine``: what happens when ONE worker exhausts its restart
    budget. ``False`` (default — training semantics): the whole group
    is torn down and :meth:`wait` raises, because a gang-scheduled job
    cannot run short a rank. ``True`` (serving semantics, what
    :class:`~zoo_tpu_torch.serving.ha.ReplicaGroup` passes): the crash-looping
    worker is QUARANTINED — parked with a flight-ring event instead of
    silently burning the group — while its siblings keep serving; a
    probe respawn is attempted on an exponential-backoff timer
    (``ZOO_QUARANTINE_PROBE_S`` base, ``ZOO_QUARANTINE_PROBE_MAX_S``
    cap), and a probe that stays alive for ``ZOO_QUARANTINE_HEAL_S``
    re-admits the seat with a fresh restart budget.
    """

    def __init__(self, workers: List[WorkerProcess], max_restarts: int = 0,
                 poll_interval: float = 0.2,
                 heartbeat_timeout: Optional[float] = None,
                 heartbeat_boot_grace: float = 120.0,
                 quarantine: bool = False):
        from zoo_tpu_torch.util.resilience import env_float
        self.workers = workers
        self.max_restarts = int(max_restarts)
        self.poll_interval = poll_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.quarantine = bool(quarantine)
        self.quarantine_probe_s = env_float("ZOO_QUARANTINE_PROBE_S",
                                            5.0)
        self.quarantine_probe_max_s = env_float(
            "ZOO_QUARANTINE_PROBE_MAX_S", 60.0)
        self.quarantine_heal_s = env_float("ZOO_QUARANTINE_HEAL_S", 30.0)
        # until a worker has beaten ON ITS OWN at least once it is
        # booting, not hung — a cold `import jax` alone can outlast a
        # tight heartbeat_timeout; the boot window gets the larger bound
        self.heartbeat_boot_grace = max(heartbeat_boot_grace,
                                        heartbeat_timeout or 0.0)
        self._failed: Optional[str] = None
        self._preempted = False
        self._stop = threading.Event()
        self._lock = threading.Lock()  # serializes respawn vs teardown
        self._thread: Optional[threading.Thread] = None
        atexit.register(self.stop)

    def start(self) -> "ProcessMonitor":
        for w in self.workers:
            w.spawn()
            logger.info("spawned %s (pid %d)", w.name, w.proc.pid)
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="zoo-process-monitor")
        self._thread.start()
        return self

    def _crash_reason(self, w: WorkerProcess) -> Optional[str]:
        """A crash description for worker ``w``, or None while healthy.
        Hung workers (stale heartbeat) are killed here so the respawn /
        teardown path treats them exactly like a nonzero exit."""
        rc = w.returncode
        if rc is not None:
            # PREEMPT_EXIT_CODE is a deliberate checkpoint-and-exit
            # (training guardian, docs/fault_tolerance.md): completion,
            # never a crash — no respawn, no restart-budget charge
            return None if rc in (0, PREEMPT_EXIT_CODE) \
                else f"exited rc={rc}"
        if self.heartbeat_timeout and w.heartbeat_file:
            age = heartbeat_age(w.heartbeat_file)
            try:
                mtime = os.stat(w.heartbeat_file).st_mtime
            except OSError:
                mtime = None
            booted = (mtime is not None
                      and w.heartbeat_spawn_mtime is not None
                      and mtime > w.heartbeat_spawn_mtime)
            limit = self.heartbeat_timeout if booted \
                else self.heartbeat_boot_grace
            if age is not None and age > limit:
                logger.warning(
                    "%s heartbeat stale (%.1fs > %.1fs%s); killing the "
                    "hung worker", w.name, age, limit,
                    "" if booted else ", boot grace")
                _workers_hung.inc()
                w.kill()
                return (f"hung (heartbeat stale {age:.1f}s > "
                        f"{limit}s limit)")
        return None

    def _probe_beating(self, w: WorkerProcess) -> bool:
        """Whether a live quarantine probe has proven PROGRESS, not
        just liveness: with heartbeat monitoring armed, the probe must
        have beaten on its own since the spawn and be fresh — a probe
        wedged at boot must never read as healed (it would be
        re-admitted with a fresh budget, hung-killed, re-quarantined,
        and churn forever)."""
        if not (self.heartbeat_timeout and w.heartbeat_file):
            return True  # no heartbeat contract: alive is the bar
        age = heartbeat_age(w.heartbeat_file)
        try:
            mtime = os.stat(w.heartbeat_file).st_mtime
        except OSError:
            return False
        booted = (w.heartbeat_spawn_mtime is not None
                  and mtime > w.heartbeat_spawn_mtime)
        return booted and age is not None and \
            age <= self.heartbeat_timeout

    def _watch_quarantined(self, w: WorkerProcess):
        """One poll of a quarantined seat: probe respawns on the
        backoff timer, re-admission after a probe survives the heal
        window. Never touches the group."""
        now = time.monotonic()
        if w.returncode is None and w.last_spawn_monotonic is not None:
            if now - w.last_spawn_monotonic >= self.quarantine_heal_s:
                if not self._probe_beating(w):
                    # alive past the heal window but HUNG: the probe
                    # failed — kill it; the dead-seat branch below
                    # schedules the next (longer) backoff
                    logger.warning(
                        "%s quarantine probe is alive but not beating "
                        "— hung probe killed, staying quarantined",
                        w.name)
                    w.kill()
                    return
                # the probe held AND made progress: the seat is a real
                # replica again, with a fresh restart budget
                w.quarantined = False
                w.restarts = 0
                w.quarantine_backoff = 0.0
                _worker_quarantines.labels(event="readmitted").inc()
                _flight("replica_unquarantined", worker=w.name,
                        quarantines=w.quarantines)
                logger.warning(
                    "%s survived its quarantine probe for %.0fs; "
                    "re-admitted with a fresh restart budget",
                    w.name, self.quarantine_heal_s)
            return
        if w.returncode is None:
            return  # probe still running inside the heal window
        if now < w.quarantine_until:
            return  # dead, waiting out the backoff
        with self._lock:
            if self._stop.is_set():
                return
            # each failed probe doubles the next wait (capped): a seat
            # with a genuinely broken substrate converges to one cheap
            # respawn a minute instead of a crash loop
            w.quarantine_backoff = min(
                max(self.quarantine_probe_s, 2 * w.quarantine_backoff),
                self.quarantine_probe_max_s)
            w.quarantine_until = now + w.quarantine_backoff
            _worker_quarantines.labels(event="probe").inc()
            _flight("replica_quarantine_probe", worker=w.name,
                    next_backoff_s=w.quarantine_backoff)
            logger.info("%s quarantine probe respawn (next backoff "
                        "%.1fs)", w.name, w.quarantine_backoff)
            w.spawn()

    def _watch(self):
        while not self._stop.is_set():
            for w in self.workers:
                if w.quarantined:
                    self._watch_quarantined(w)
                    continue
                reason = self._crash_reason(w)
                if reason is None:
                    continue
                if w.restarts < self.max_restarts:
                    with self._lock:
                        if self._stop.is_set():
                            return  # teardown won the race: no respawn
                        w.restarts += 1
                        _worker_restarts.inc()
                        logger.warning(
                            "%s %s; restart %d/%d", w.name, reason,
                            w.restarts, self.max_restarts)
                        w.spawn()
                elif self.quarantine:
                    # serving semantics: the seat exhausted its budget
                    # — park it LOUDLY (flight event + counter; the
                    # gauge rides ReplicaGroup.healthz) instead of the
                    # old silent permanent death, and keep probing it
                    # back on a backoff timer while the rest of the
                    # group serves on
                    with self._lock:
                        if self._stop.is_set():
                            return
                        w.quarantined = True
                        w.quarantines += 1
                        # a RE-quarantine (a seat whose earlier probe
                        # "healed" then failed again) continues the
                        # backoff ladder instead of resetting to the
                        # base — only a genuine readmission clears it
                        w.quarantine_backoff = min(
                            max(self.quarantine_probe_s,
                                2 * w.quarantine_backoff),
                            self.quarantine_probe_max_s)
                        w.quarantine_until = (time.monotonic()
                                              + w.quarantine_backoff)
                        _worker_quarantines.labels(
                            event="quarantined").inc()
                        _flight("replica_quarantined", worker=w.name,
                                reason=reason, restarts=w.restarts,
                                probe_backoff_s=w.quarantine_backoff)
                        logger.error(
                            "%s %s with no restart budget left "
                            "(%d/%d) — QUARANTINED; probing back every "
                            "%.1fs (doubling, cap %.0fs)",
                            w.name, reason, w.restarts,
                            self.max_restarts, w.quarantine_backoff,
                            self.quarantine_probe_max_s)
                else:
                    with self._lock:
                        if self._stop.is_set():
                            return  # deliberate stop(), not a crash
                        self._failed = (
                            f"{w.name} {reason} with no restart "
                            f"budget left "
                            f"({w.restarts}/{self.max_restarts})")
                        logger.error("%s — tearing the group down",
                                     self._failed)
                        self._stop.set()
                        for other in self.workers:
                            other.kill()
                    return
            rcs = [w.returncode for w in self.workers]
            if all(rc is not None and rc in (0, PREEMPT_EXIT_CODE)
                   for rc in rcs):
                if PREEMPT_EXIT_CODE in rcs:
                    self._preempted = True
                self._stop.set()
                return
            time.sleep(self.poll_interval)

    def wait(self, timeout: Optional[float] = None):
        """Block until every worker exits 0; raise on fatal failure.
        Raises :class:`WorkersPreempted` when the group completed via a
        coordinated preemption checkpoint (exit :data:`PREEMPT_EXIT_CODE`)
        so the caller relaunches-and-resumes instead of scaling down."""
        deadline = time.time() + timeout if timeout is not None else None
        while True:
            if self._failed:
                raise RuntimeError(self._failed)
            rcs = [w.returncode for w in self.workers]
            if all(rc is not None and rc in (0, PREEMPT_EXIT_CODE)
                   for rc in rcs):
                if PREEMPT_EXIT_CODE in rcs:
                    raise WorkersPreempted(
                        f"{rcs.count(PREEMPT_EXIT_CODE)}/{len(rcs)} "
                        "worker(s) exited via the preemption checkpoint "
                        "protocol; relaunch and resume")
                return
            if self._stop.is_set():
                # the watch thread assigns _failed BEFORE setting _stop;
                # re-check so a failure set between our two reads is not
                # mistaken for a deliberate stop()
                if self._failed:
                    raise RuntimeError(self._failed)
                if self._preempted:
                    raise WorkersPreempted(
                        "workers exited via the preemption checkpoint "
                        "protocol; relaunch and resume")
                return  # deliberate stop(): termination, not failure
            if deadline is not None and time.time() > deadline:
                self.stop()
                raise TimeoutError(
                    f"workers still running after {timeout}s")
            time.sleep(self.poll_interval)

    def alive(self) -> List[str]:
        return [w.name for w in self.workers if w.returncode is None]

    def quarantined(self) -> List[str]:
        """Names of workers currently parked in quarantine — every
        seat accounted for, none silently missing."""
        return [w.name for w in self.workers if w.quarantined]

    def stop(self):
        with self._lock:  # no respawn may interleave with the kills
            self._stop.set()
            for w in self.workers:
                w.kill()
