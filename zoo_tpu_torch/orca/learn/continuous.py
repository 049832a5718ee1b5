"""Continuous training, shadow evaluation and promotion: the online-
learning loop over the port's registry and replica groups (counterpart
of ``zoo_tpu/orca/learn/continuous.py``).

* :class:`PromotionGate`: a candidate version serves shadow traffic
  first. A sample of live requests is mirrored to the canary, and its
  error rate, latency and (with ground truth) loss are compared with
  the incumbent's over a window. Only a candidate that holds up moves
  the ``prod`` alias; the in-process SLO watchdog can veto.
* :class:`ContinuousTrainingLoop`: one turn: retrain on the latest
  window (a run the training guard gives up on, ``TrainingDiverged``,
  is demoted and nothing is published), publish the artifact as an
  immutable registry version on the ``canary`` alias, run the gate, and
  on a pass move ``prod`` before any replica swaps, then drive
  :meth:`~zoo_tpu_torch.serving.ha.ReplicaGroup.rolling_update` (which
  rolls back on a failed swap).
* :func:`chronos_train_fn`: a ``train_fn`` that fits a fresh Chronos
  forecaster of the port on each window and returns its model file.

Importable without torch: the trainer (``train_fn``) is where torch
runs, injected by the caller.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from zoo_tpu_torch.obs.metrics import counter, gauge
from zoo_tpu_torch.util.resilience import env_float, env_int, fault_point

logger = logging.getLogger(__name__)

__all__ = ["PromotionGate", "GateDecision", "ContinuousTrainingLoop",
           "chronos_train_fn"]

_promotions = counter(
    "zoo_promotion_total",
    "Shadow-eval promotion decisions, by outcome (promoted / rejected "
    "= the canary regressed and the prod alias did not move / demoted "
    "= training itself diverged and nothing was published)",
    labels=("outcome",))
_gate_error_rate = gauge(
    "zoo_promotion_canary_error_rate",
    "Canary error rate over the last completed shadow-eval window")
_gate_latency_ratio = gauge(
    "zoo_promotion_canary_latency_ratio",
    "Canary p50 latency / incumbent p50 latency over the last window")
_gate_loss_ratio = gauge(
    "zoo_promotion_canary_loss_ratio",
    "Canary loss / incumbent loss over the last window (ground-truth "
    "samples only; 0 when none were seen)")


class GateDecision:
    """Outcome of one shadow-eval window."""

    def __init__(self, promoted: bool, reason: str, stats: Dict):
        self.promoted = promoted
        self.reason = reason
        self.stats = stats

    def __repr__(self):
        verdict = "PROMOTE" if self.promoted else "REJECT"
        return f"GateDecision({verdict}: {self.reason})"


class PromotionGate:
    """Shadow-eval gate between a canary version and the incumbent.

    ``incumbent`` / ``canary`` are ``x -> prediction`` callables —
    typically ``HAServingClient.predict`` against the live group and a
    version-pinned (or dedicated canary replica) client. Live traffic
    flows through :meth:`offer`, which always answers from the
    INCUMBENT (the caller's users never see the canary) and mirrors a
    ``sample`` fraction to the canary, recording both sides' latency,
    errors, and — when the caller supplies ground truth — loss. Once
    ``window`` mirrored samples accumulated, :meth:`decision` compares:

    * canary error rate > ``max_error_rate``  → reject
    * canary p50 latency > ``max_latency_ratio`` × incumbent p50 → reject
    * canary loss > ``max_loss_ratio`` × incumbent loss (+ epsilon)
      → reject
    * otherwise → promote.

    Knob defaults come from the ``ZOO_GATE_*`` env. The canary call sits
    behind ``fault_point("serving.canary")`` so chaos tests can inject
    a regressed canary without a genuinely bad model."""

    def __init__(self, incumbent: Callable, canary: Callable, *,
                 candidate: str,
                 registry=None, alias: str = "prod",
                 canary_alias: str = "canary",
                 sample: Optional[float] = None,
                 window: Optional[int] = None,
                 max_error_rate: Optional[float] = None,
                 max_latency_ratio: Optional[float] = None,
                 max_loss_ratio: Optional[float] = None,
                 loss_fn: Optional[Callable] = None,
                 rng: Optional[np.random.RandomState] = None,
                 slo_veto: bool = True):
        self._incumbent = incumbent
        self._canary = canary
        self.candidate = candidate
        # SLO veto: when the in-process SLO
        # watchdog reports an active burn-rate breach at decision
        # time, the gate refuses to promote — never move the prod
        # alias while the serving fleet is already missing its
        # objectives. No watchdog running = no veto.
        self.slo_veto = bool(slo_veto)
        self.registry = registry
        self.alias = alias
        self.canary_alias = canary_alias
        self.sample = sample if sample is not None else \
            env_float("ZOO_GATE_SAMPLE", 0.25)
        self.window = window if window is not None else \
            env_int("ZOO_GATE_WINDOW", 32)
        self.max_error_rate = max_error_rate if max_error_rate \
            is not None else env_float("ZOO_GATE_MAX_ERROR_RATE", 0.02)
        self.max_latency_ratio = max_latency_ratio \
            if max_latency_ratio is not None \
            else env_float("ZOO_GATE_MAX_LATENCY_RATIO", 3.0)
        self.max_loss_ratio = max_loss_ratio if max_loss_ratio \
            is not None else env_float("ZOO_GATE_MAX_LOSS_RATIO", 1.2)
        self._loss = loss_fn or (
            lambda y_true, y_pred: float(np.mean(
                (np.asarray(y_pred, np.float64) -
                 np.asarray(y_true, np.float64)) ** 2)))
        self._rng = rng or np.random.RandomState()
        self._mirrored = 0
        self._canary_errors = 0
        self._inc_lat: List[float] = []
        self._can_lat: List[float] = []
        self._inc_loss: List[float] = []
        self._can_loss: List[float] = []

    # -- traffic -----------------------------------------------------------
    def offer(self, x, y_true=None):
        """One live request: answered by the incumbent (errors
        propagate to the caller — the gate never changes what users
        see), mirrored to the canary with probability ``sample``."""
        t0 = time.perf_counter()
        result = self._incumbent(x)  # incumbent errors are the
        #                              caller's problem, not the gate's
        inc_dt = time.perf_counter() - t0
        if self._rng.random_sample() >= self.sample:
            return result
        self._mirrored += 1
        self._inc_lat.append(inc_dt)
        if y_true is not None:
            self._inc_loss.append(self._loss(y_true, result))
        t1 = time.perf_counter()
        try:
            # the chaos seam: fault-injected canary failures measure
            # the gate's rollback path without a genuinely bad model
            fault_point("serving.canary", candidate=self.candidate)
            shadow = self._canary(x)
        except Exception as e:  # noqa: BLE001 — a canary failure is
            # DATA (it counts against promotion), never user-visible
            self._canary_errors += 1
            logger.debug("canary mirror failed: %r", e)
            return result
        self._can_lat.append(time.perf_counter() - t1)
        if y_true is not None:
            self._can_loss.append(self._loss(y_true, shadow))
        return result

    def ready(self) -> bool:
        return self._mirrored >= self.window

    # -- verdict -----------------------------------------------------------
    def stats(self) -> Dict:
        p50 = lambda xs: float(np.percentile(xs, 50)) if xs else 0.0  # noqa: E731
        inc_p50, can_p50 = p50(self._inc_lat), p50(self._can_lat)
        inc_loss = float(np.mean(self._inc_loss)) if self._inc_loss \
            else None
        can_loss = float(np.mean(self._can_loss)) if self._can_loss \
            else None
        return {
            "mirrored": self._mirrored,
            "canary_errors": self._canary_errors,
            "canary_error_rate": self._canary_errors /
            max(1, self._mirrored),
            "incumbent_p50_s": inc_p50,
            "canary_p50_s": can_p50,
            "latency_ratio": (can_p50 / inc_p50) if inc_p50 > 0 else 1.0,
            "incumbent_loss": inc_loss,
            "canary_loss": can_loss,
        }

    def decision(self) -> GateDecision:
        s = self.stats()
        _gate_error_rate.set(s["canary_error_rate"])
        _gate_latency_ratio.set(s["latency_ratio"])
        if s["mirrored"] < self.window:
            return GateDecision(False, "window not filled "
                                f"({s['mirrored']}/{self.window})", s)
        if self.slo_veto:
            try:
                from zoo_tpu_torch.obs.slo import last_status
                slo = last_status()
            except Exception:  # noqa: BLE001 — no watchdog, no veto
                slo = None
            if slo is not None and not slo.get("ok", True):
                s["slo"] = slo
                return GateDecision(
                    False, "SLO watchdog reports an active breach "
                    f"({', '.join(slo.get('breaches', []))}); "
                    "refusing to promote into a burning fleet", s)
        if s["canary_error_rate"] > self.max_error_rate:
            return GateDecision(
                False, f"canary error rate {s['canary_error_rate']:.1%} "
                f"> bound {self.max_error_rate:.1%}", s)
        if s["latency_ratio"] > self.max_latency_ratio:
            return GateDecision(
                False, f"canary p50 {s['canary_p50_s'] * 1e3:.1f}ms is "
                f"{s['latency_ratio']:.2f}x the incumbent "
                f"(bound {self.max_latency_ratio:.2f}x)", s)
        if s["incumbent_loss"] is not None and \
                s["canary_loss"] is not None:
            bound = self.max_loss_ratio * s["incumbent_loss"] + 1e-9
            _gate_loss_ratio.set(
                s["canary_loss"] / max(s["incumbent_loss"], 1e-12))
            if s["canary_loss"] > bound:
                return GateDecision(
                    False, f"canary loss {s['canary_loss']:.5f} > "
                    f"{self.max_loss_ratio:.2f}x incumbent "
                    f"{s['incumbent_loss']:.5f}", s)
        return GateDecision(True, "canary within bounds on error rate, "
                            "latency and loss", s)

    def run(self, traffic, promote: bool = True) -> GateDecision:
        """Drive ``traffic`` (an iterable of ``x`` or ``(x, y_true)``)
        through :meth:`offer` until the window fills, then decide. With
        ``promote=True`` and a registry, a PASS atomically moves the
        ``prod`` alias to the candidate — the only path that ever moves
        it — and a FAIL drops the ``canary`` alias (the candidate
        version stays in the registry for forensics, unaliased)."""
        for item in traffic:
            if isinstance(item, tuple):
                self.offer(*item)
            else:
                self.offer(item)
            if self.ready():
                break
        verdict = self.decision()
        _promotions.labels(
            outcome="promoted" if verdict.promoted else "rejected").inc()
        if self.registry is not None and promote:
            if verdict.promoted:
                self.registry.set_alias(self.alias, self.candidate)
                logger.info("promotion gate PASSED: %s -> %s (%s)",
                            self.alias, self.candidate, verdict.reason)
            else:
                if self.registry.alias_version(self.canary_alias) == \
                        self.candidate:
                    self.registry.drop_alias(self.canary_alias)
                logger.warning("promotion gate REJECTED %s: %s",
                               self.candidate, verdict.reason)
        return verdict


class ContinuousTrainingLoop:
    """One crank of the online-learning lifecycle per :meth:`step`:

    retrain → publish → canary → shadow-eval → promote → rolling swap,
    with the two failure exits the paper's always-on serving story
    needs: a DIVERGED retrain (the TrainingGuard escalated past its
    rollback budget) demotes the candidate before anything is
    published, and a REJECTED shadow-eval leaves ``prod`` untouched.

    ``train_fn(window) -> artifact`` runs the actual training and
    returns either a filesystem path (model file / SavedModel dir,
    published as payload) or a model spec string (published as a
    ``MODEL`` pointer — how model-free tests exercise the loop).
    ``gate_factory(candidate) -> PromotionGate`` builds the gate once
    the candidate is staged on the canary alias (the caller decides
    where canary traffic is served — a pinned A/B slice of the live
    group or a dedicated canary replica)."""

    def __init__(self, train_fn: Callable, registry, *,
                 group=None,
                 gate_factory: Optional[Callable] = None,
                 alias: str = "prod", canary_alias: str = "canary"):
        self.train_fn = train_fn
        self.registry = registry
        self.group = group
        self.gate_factory = gate_factory
        self.alias = alias
        self.canary_alias = canary_alias

    def step(self, window, traffic=None) -> Dict:
        """Returns ``{"outcome": "promoted" | "rejected" | "demoted" |
        "rolled_back", "version": ..., ...}``."""
        from zoo_tpu_torch.orca.learn.guard import TrainingDiverged
        t0 = time.perf_counter()
        try:
            artifact = self.train_fn(window)
        except TrainingDiverged as e:
            # the guard burned its rollback budget: this window's data
            # produced a diverging model — publish NOTHING; prod keeps
            # serving the incumbent
            _promotions.labels(outcome="demoted").inc()
            logger.warning("continuous step: training diverged, "
                           "candidate demoted before publish: %s", e)
            return {"outcome": "demoted", "version": None,
                    "error": str(e)}
        if isinstance(artifact, str) and os.path.exists(artifact):
            version = self.registry.publish(artifact,
                                            alias=self.canary_alias)
        else:
            version = self.registry.publish(spec=str(artifact),
                                            alias=self.canary_alias)
        out = {"version": version,
               "train_seconds": round(time.perf_counter() - t0, 3)}
        if self.gate_factory is None:
            # no gate configured: direct promotion (a dev/backfill
            # loop); production wires a gate
            self.registry.set_alias(self.alias, version)
            out["outcome"] = "promoted"
        else:
            gate = self.gate_factory(version)
            verdict = gate.run(traffic or ())
            out["gate"] = verdict.stats
            out["reason"] = verdict.reason
            if not verdict.promoted:
                out["outcome"] = "rejected"
                return out
            out["outcome"] = "promoted"
        # the alias MUST point at the promoted version before any
        # replica swaps (a gate built without registry= skips its own
        # alias move): a supervisor respawn mid-rolling-update
        # re-resolves the alias at boot, and a stale alias would bring
        # it up on the old version — a silently mixed group
        if self.registry.alias_version(self.alias) != version:
            self.registry.set_alias(self.alias, version)
        if self.group is not None:
            from zoo_tpu_torch.serving.ha import RollingUpdateError
            try:
                out["rolling"] = self.group.rolling_update(version)
            except RollingUpdateError as e:
                # the gate passed but a live replica failed the swap —
                # rolling_update already returned the group AND the
                # alias to the incumbent
                out["outcome"] = "rolled_back"
                out["error"] = str(e)
        return out


def chronos_train_fn(forecaster_factory: Callable, *,
                     epochs: int = 1, batch_size: int = 32,
                     out_dir: Optional[str] = None) -> Callable:
    """A :class:`ContinuousTrainingLoop` ``train_fn`` that fits a fresh
    Chronos forecaster of the port on each streaming window and returns
    its model file (servable by any replica through
    ``InferenceModel.load``). The forecaster trains through the guarded
    step, so a poison window raises ``TrainingDiverged`` into the loop's
    demotion path instead of publishing a NaN model."""
    import tempfile

    def train(window):
        f = forecaster_factory()
        f.fit(window, epochs=epochs, batch_size=batch_size)
        d = out_dir or tempfile.mkdtemp(prefix="zoo-continuous-")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "model.zoo")
        f.model.save(path)
        return path

    return train
