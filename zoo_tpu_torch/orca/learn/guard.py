"""Training guardian: step-level numeric health, rollback, preemption
(counterpart of ``zoo_tpu/orca/learn/guard.py``).

Three layers, the cheap fix tried before the expensive one before the
catastrophic one:

1. **In-step health guard** — the train step checks ``isfinite(loss)``
   and the gradient sum of squares on the device. On a bad step params,
   the whole optimizer state (its device count included) and the
   BatchNorm stats pass through unchanged (``torch.where``-folded and
   the fused optimizer kernels' ``ok`` predicate — no host sync, no
   branch); a device-side ``(bad, streak)`` counter pair is read only
   at superbatch boundaries. Offending windows are quarantined to a
   JSONL journal plus obs counters.
2. **Divergence rollback** — ``max_skips`` consecutive skipped steps, or
   a window loss beyond ``spike_factor``× the rolling-window median,
   restores the last verified :class:`CheckpointManager` step (optional
   LR backoff on resume), bounded by ``rollback_budget`` before raising
   :class:`TrainingDiverged`.
3. **Preemption-safe exit** — SIGTERM (or the ``$ZOO_PREEMPT`` signal)
   requests checkpoint-and-exit at the next step boundary; the process
   exits :data:`PREEMPT_EXIT_CODE` (75, EX_TEMPFAIL), which a supervisor
   treats as resume-don't-retry.

The port trains one process on one card: the JAX package's exchange of
restore capability and preemption agreement across processes has no
counterpart yet (ROADMAP A.14), and :func:`_world` refuses a
``torch.distributed`` world above one.

This module must import WITHOUT torch (``zoo_tpu_torch/scripts/
check_guard.py`` drives the escalation ladder torch-free); everything
device-side imports torch lazily.

Knobs (``common/knobs.py``, the JAX package's names and defaults; all
overridable per-instance via :class:`GuardConfig`):

=============================  =============================================
``ZOO_GUARD``                  "0" disables the guard estimators attach
``ZOO_GUARD_MAX_SKIPS``        consecutive skipped steps before rollback (8)
``ZOO_GUARD_SPIKE_FACTOR``     window-loss spike multiple vs rolling median
                               triggering rollback (10.0)
``ZOO_GUARD_WINDOW``           rolling-loss window length in boundaries (32)
``ZOO_GUARD_MIN_WINDOW``       boundaries before spike detection arms (5)
``ZOO_GUARD_ROLLBACK_BUDGET``  rollbacks before TrainingDiverged (3)
``ZOO_GUARD_LR_BACKOFF``       LR multiplier applied on rollback resume (0.5)
``ZOO_GUARD_CHECK_EVERY``      read the device counter every N boundaries (1)
``ZOO_GUARD_MAX_GNORM``        optional hard gradient-norm ceiling (off)
``ZOO_GUARD_QUARANTINE``       JSONL journal path (default
                               <model_dir>/guard/quarantine.jsonl)
``ZOO_PREEMPT``                preemption signal name ("SIGTERM"; "0"/"none"
                               disables the handler)
=============================  =============================================
"""

from __future__ import annotations

import json
import logging
import os
import signal as _signal
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.obs.metrics import counter, gauge

logger = logging.getLogger(__name__)

#: Exit code of a preemption-triggered graceful exit (EX_TEMPFAIL): a
#: supervisor treats it as "checkpointed, relaunch me and resume" —
#: never as a crash.
PREEMPT_EXIT_CODE = 75

_nonfinite_steps = counter(
    "zoo_guard_nonfinite_steps_total",
    "Training steps skipped by the in-step health guard (non-finite loss "
    "or gradient norm; params/opt state passed through unchanged)")
_rollbacks = counter(
    "zoo_guard_rollbacks_total",
    "Divergence rollbacks: restores from the last verified checkpoint "
    "triggered by skip streaks or loss spikes")
_preempt_ckpts = counter(
    "zoo_guard_preempt_checkpoints_total",
    "Coordinated checkpoint-and-exit sequences completed after a "
    "preemption signal")
_diverged = counter(
    "zoo_guard_diverged_total",
    "Fits abandoned with TrainingDiverged (rollback budget exhausted or "
    "no checkpoint to restore)")
_rolling_loss = gauge(
    "zoo_guard_rolling_loss",
    "Mean per-step training loss over the guard's most recent boundary "
    "window (skipped steps excluded)")


class TrainingDiverged(RuntimeError):
    """The guard's escalation ladder is exhausted: skip didn't help,
    the rollback budget is spent (or there is nothing to restore), and
    the loss is still not trainable."""


class EpochRolledBack(RuntimeError):
    """A mid-epoch guard rollback wiped every step of the epoch: the
    restored state has made no progress and there is no honest loss to
    report. The Estimator's retry perimeter treats this like any other
    recoverable failure — restore the latest verified checkpoint and
    retrain the lost epoch (the epoch counter did not advance) — while
    bare ``model.fit`` callers see a loud typed failure instead of a
    fabricated loss value."""


class Preempted(SystemExit):
    """Raised after a preemption-triggered checkpoint. Subclasses
    ``SystemExit`` with :data:`PREEMPT_EXIT_CODE`, so a worker script
    needs no handling at all — letting it propagate exits the process
    with the code a supervisor recognizes as resume-don't-retry.
    ``except Exception`` retry perimeters never swallow it."""

    def __init__(self, step: int):
        super().__init__(PREEMPT_EXIT_CODE)
        self.step = int(step)



class GuardConfig:
    """Escalation-ladder knobs; every field defaults from its
    ``ZOO_GUARD_*`` knob so supervised workers configure through their
    launcher."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_skips: Optional[int] = None,
                 spike_factor: Optional[float] = None,
                 window: Optional[int] = None,
                 min_window: Optional[int] = None,
                 rollback_budget: Optional[int] = None,
                 lr_backoff: Optional[float] = None,
                 check_every: Optional[int] = None,
                 max_grad_norm: Optional[float] = None,
                 preempt_signal: Optional[str] = None):
        def knob(name, given, cast):
            return cast(knob_value(name) if given is None else given)
        self.enabled = knob("ZOO_GUARD", enabled, bool)
        self.max_skips = knob("ZOO_GUARD_MAX_SKIPS", max_skips, int)
        self.spike_factor = knob("ZOO_GUARD_SPIKE_FACTOR", spike_factor,
                                 float)
        self.window = knob("ZOO_GUARD_WINDOW", window, int)
        self.min_window = knob("ZOO_GUARD_MIN_WINDOW", min_window, int)
        self.rollback_budget = knob("ZOO_GUARD_ROLLBACK_BUDGET",
                                    rollback_budget, int)
        self.lr_backoff = knob("ZOO_GUARD_LR_BACKOFF", lr_backoff, float)
        self.check_every = max(1, knob("ZOO_GUARD_CHECK_EVERY",
                                       check_every, int))
        self.max_grad_norm = (knob_value("ZOO_GUARD_MAX_GNORM")
                              if max_grad_norm is None else max_grad_norm)
        sig = (knob_value("ZOO_PREEMPT") if preempt_signal is None
               else preempt_signal)
        self.preempt_signal = None if str(sig).lower() in (
            "", "0", "none", "off") else str(sig)


def _world() -> Tuple[int, int]:
    """(process_count, process_index): (1, 0), the one process the port
    trains in. Reads ``sys.modules`` instead of importing, so the
    torch-free script path stays torch-free; a ``torch.distributed``
    world above one raises, since the guard's cross-process exchange is
    not ported (ROADMAP A.14)."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch is not None \
        else None
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "the training guard runs in one process: its cross-process "
            "restore-capability and preemption agreement are not ported "
            "to zoo_tpu_torch yet (ROADMAP A.14); torch.distributed has "
            f"a world of {dist.get_world_size()}")
    return 1, 0


class TrainingGuard:
    """Host-side controller of the three guard layers.

    The fit loop owns the device state (a ``{"bad", "streak"}`` 0-dim
    int32 pair on the training device created by :meth:`device_init`,
    advanced inside every guarded step by :meth:`gstate_update`) and
    calls :meth:`on_boundary` at superbatch boundaries with its
    host-read values. The guard decides ``None`` (keep going),
    ``"rollback"`` (call :meth:`rollback`, splice the returned state
    in), or ``"preempt"`` (call :meth:`preempt_checkpoint`, which saves
    and raises :class:`Preempted`).

    ``save_fn``/``restore_fn`` come from the owning estimator:
    ``save_fn()`` snapshots its current train state through its
    :class:`CheckpointManager`; ``restore_fn()`` returns
    ``(state_dict, aux)`` from the last verified step. Either may be
    None (no ``model_dir``): layers 1 and 3 still work; layer 2 then
    escalates straight to :class:`TrainingDiverged`.
    """

    def __init__(self, config: Optional[GuardConfig] = None,
                 save_fn: Optional[Callable[[], None]] = None,
                 restore_fn: Optional[Callable[[], Tuple[Any, Any]]] = None,
                 quarantine_path: Optional[str] = None,
                 name: str = "fit"):
        self.config = config or GuardConfig()
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.quarantine_path = quarantine_path or \
            knob_value("ZOO_GUARD_QUARANTINE")
        self.name = name
        # host-visible tallies (tests/scripts read these);
        # nonfinite_steps is CUMULATIVE across fits — the device counter
        # restarts at zero each fit/rollback, tracked by _bad_seen
        self.nonfinite_steps = 0
        self._bad_seen = 0
        self.rollbacks = 0
        self.preempt_checkpoints = 0
        self._window: deque = deque(maxlen=max(2, self.config.window))
        self._lock = threading.Lock()
        # preemption machinery
        self._preempt_flag = threading.Event()
        self._prev_handler = None
        self._installed_signum = None
        self._install_depth = 0
        self._boundary_calls = 0

    # -- wiring ------------------------------------------------------------
    @classmethod
    def from_env(cls, **kwargs) -> Optional["TrainingGuard"]:
        """A guard configured from ``ZOO_GUARD_*``, or None when
        ``ZOO_GUARD=0`` — estimators attach this by default."""
        cfg = kwargs.pop("config", None) or GuardConfig()
        if not cfg.enabled:
            return None
        return cls(config=cfg, **kwargs)

    def bind(self, save_fn=None, restore_fn=None, quarantine_path=None):
        """(Re)attach the checkpoint callbacks."""
        if save_fn is not None:
            self.save_fn = save_fn
        if restore_fn is not None:
            self.restore_fn = restore_fn
        if quarantine_path is not None and self.quarantine_path is None:
            self.quarantine_path = quarantine_path
        return self

    @property
    def active(self) -> bool:
        return self.config.enabled

    @property
    def preempt_requested(self) -> bool:
        return self._preempt_flag.is_set()

    # -- device-side pieces (lazy torch) ----------------------------------
    def device_init(self, device):
        """Fresh ``{"bad", "streak"}`` 0-dim int32 counters on
        ``device`` (fills, not host copies)."""
        import torch
        return {"bad": torch.zeros((), dtype=torch.int32, device=device),
                "streak": torch.zeros((), dtype=torch.int32,
                                      device=device)}

    def health_fold(self, ok, new_tree, old_tree):
        """``torch.where``-fold two identically structured dict trees on
        the 0-dim predicate ``ok`` — the no-host-sync skip primitive."""
        import torch
        if isinstance(new_tree, dict):
            return {k: self.health_fold(ok, new_tree[k], old_tree[k])
                    for k in new_tree}
        return torch.where(ok, new_tree, old_tree)

    def gstate_update(self, gstate, ok):
        """Advance the device counter pair for one step."""
        import torch
        return {"bad": gstate["bad"] + (~ok).to(torch.int32),
                "streak": torch.where(ok, torch.zeros_like(
                    gstate["streak"]), gstate["streak"] + 1)}

    @staticmethod
    def grad_sq_sum(grads):
        """The gradients' global sum of squares in f32, one multi-tensor
        reduction (``torch._foreach_norm``, then the squares summed):
        the quantity the health predicate and L2 clipping both read."""
        import torch
        leaves = list(grads)
        if not leaves:
            return None
        norms = torch._foreach_norm([g.float() for g in leaves])
        return torch.stack(norms).square().sum()

    def grad_norm_ok(self, loss, grads=None, sq_sum=None):
        """The in-step health predicate, a 0-dim bool device tensor:
        finite loss AND finite gradient sum of squares (AND under the
        optional hard ceiling). Pass the leaves as ``grads`` or their
        :meth:`grad_sq_sum` as ``sq_sum``."""
        import torch
        if sq_sum is None and grads is not None:
            sq_sum = self.grad_sq_sum(grads)
        ok = torch.isfinite(loss)
        if sq_sum is not None:
            ok = ok & torch.isfinite(sq_sum)
            if self.config.max_grad_norm:
                ok = ok & (sq_sum <= self.config.max_grad_norm ** 2)
        return ok

    # -- fit lifecycle ----------------------------------------------------
    def begin_fit(self):
        """Called by the fit loop before the first step. Signal-handler
        install is the guard OWNER's job (the estimator's fit entry, via
        :meth:`install_signal_handler`) — once per outer fit, not once
        per epoch. A preemption request survives across fits: the whole
        job exits once it is honored."""
        self._boundary_calls = 0
        self._bad_seen = 0  # fresh device counters accompany each fit
        _world()

    def end_fit(self):
        self.uninstall_signal_handler()

    # -- signal handling ---------------------------------------------------
    def _signum(self) -> Optional[int]:
        name = self.config.preempt_signal
        if not name:
            return None
        if name.isdigit():
            return int(name)
        return getattr(_signal, name if name.startswith("SIG")
                       else "SIG" + name, None)

    def install_signal_handler(self):
        """Idempotent (depth-counted); silently skipped off the main
        thread — a concurrent-AutoML trial fit must not fight over
        process signals."""
        signum = self._signum()
        if signum is None:
            return
        self._install_depth += 1
        if self._install_depth > 1:
            return
        try:
            self._prev_handler = _signal.signal(
                signum, lambda s, f: self.request_preempt())
            self._installed_signum = signum
        except ValueError:  # not the main thread
            self._prev_handler = None
            self._installed_signum = None

    def uninstall_signal_handler(self):
        self._install_depth = max(0, self._install_depth - 1)
        if self._install_depth == 0 and self._installed_signum is not None:
            try:
                _signal.signal(self._installed_signum,
                               self._prev_handler or _signal.SIG_DFL)
            except ValueError:
                pass
            self._installed_signum = None

    def request_preempt(self):
        """Ask for checkpoint-and-exit at the next step boundary (the
        signal handler's body; tests call it directly)."""
        if not self._preempt_flag.is_set():
            logger.warning(
                "%s: preemption requested — checkpoint-and-exit at the "
                "next step boundary", self.name)
        self._preempt_flag.set()

    # -- the boundary decision --------------------------------------------
    def on_boundary(self, bad_total: int, streak: int,
                    window_loss: float, window_steps: int,
                    global_step: int, epoch: int = 0,
                    batch_hint: Optional[Tuple[int, int]] = None
                    ) -> Optional[str]:
        """One superbatch boundary. ``bad_total``/``streak`` are the
        host-read device counters; ``window_loss`` is the (sanitized —
        skipped steps contribute 0) loss sum since the previous boundary
        over ``window_steps`` steps. Returns None, ``"rollback"`` or
        ``"preempt"``."""
        self._boundary_calls += 1
        # bad_total restarts at zero each fit/rollback (fresh device
        # counters); _bad_seen is the per-incarnation baseline, while
        # nonfinite_steps accumulates across the guard's whole life
        delta = bad_total - self._bad_seen
        self._bad_seen = bad_total
        if delta > 0:
            _nonfinite_steps.inc(delta)
            self.nonfinite_steps += delta
            self._journal({
                "event": "nonfinite_steps", "epoch": int(epoch),
                "global_step": int(global_step), "bad_in_window": delta,
                "bad_total": self.nonfinite_steps, "streak": int(streak),
                "batch_lo": None if batch_hint is None
                else int(batch_hint[0]),
                "batch_hi": None if batch_hint is None
                else int(batch_hint[1]),
            })
            logger.warning(
                "%s: skipped %d non-finite step(s) in the last window "
                "(total %d, streak %d) at step %d", self.name, delta,
                self.nonfinite_steps, streak, global_step)
        good = window_steps - delta
        mean = None
        if good > 0:
            mean = window_loss / good
            _rolling_loss.set(mean)
        spike = (mean is not None and len(self._window) >=
                 self.config.min_window and
                 mean > self.config.spike_factor *
                 max(self._rolling_median(), 1e-12))
        if mean is not None and not spike:
            self._window.append(mean)
        if self._preempt_step(global_step):
            return "preempt"
        if streak >= self.config.max_skips:
            logger.error(
                "%s: %d consecutive steps skipped (>= max_skips=%d) — "
                "escalating to rollback", self.name, streak,
                self.config.max_skips)
            return "rollback"
        if spike:
            logger.error(
                "%s: window loss %.6g spiked beyond %gx the rolling "
                "median %.6g — escalating to rollback", self.name, mean,
                self.config.spike_factor, self._rolling_median())
            return "rollback"
        return None

    def _rolling_median(self) -> float:
        vals = sorted(self._window)
        if not vals:
            return 0.0
        mid = len(vals) // 2
        return vals[mid] if len(vals) % 2 else \
            0.5 * (vals[mid - 1] + vals[mid])

    # -- layer 2: rollback -------------------------------------------------
    def rollback(self) -> Tuple[Any, Any, float]:
        """Restore the last verified snapshot. Returns ``(state, aux,
        lr_scale)``; raises :class:`TrainingDiverged` when the budget is
        spent or there is no checkpoint to restore."""
        can = self.restore_fn is not None
        if not can or self.rollbacks >= self.config.rollback_budget:
            _diverged.inc()
            self._journal({"event": "diverged",
                           "rollbacks": self.rollbacks,
                           "budget": self.config.rollback_budget,
                           "restorable": bool(can)})
            raise TrainingDiverged(
                f"{self.name}: training diverged and the guard is out of "
                f"options (rollbacks {self.rollbacks}/"
                f"{self.config.rollback_budget}, "
                f"restore {'un' if not can else ''}available)")
        try:
            state, aux = self.restore_fn()
        except Exception as e:  # noqa: BLE001 — no snapshot ≡ no ladder
            _diverged.inc()
            self._journal({"event": "diverged", "restore_error": repr(e)})
            raise TrainingDiverged(
                f"{self.name}: rollback restore failed ({e!r})") from e
        self.rollbacks += 1
        _rollbacks.inc()
        lr_scale = self.config.lr_backoff if self.config.lr_backoff \
            and self.config.lr_backoff != 1.0 else 1.0
        self._window.clear()
        self._bad_seen = 0  # fresh device counters follow the restore
        self._journal({"event": "rollback", "n": self.rollbacks,
                       "lr_scale": lr_scale,
                       "restored_step": state.get("epoch")
                       if isinstance(state, dict) else None})
        logger.warning(
            "%s: rollback %d/%d restored last verified checkpoint "
            "(lr x%g on resume)", self.name, self.rollbacks,
            self.config.rollback_budget, lr_scale)
        return state, aux, lr_scale

    # -- layer 3: preemption ----------------------------------------------
    def _preempt_step(self, global_step: int) -> bool:
        """True once a preemption was requested: one process decides
        alone (the JAX package's cross-host agreement on the checkpoint
        step is ROADMAP A.14)."""
        _world()
        return self._preempt_flag.is_set()

    def preempt_checkpoint(self, save_cb: Optional[Callable[[], None]]
                           = None, step: int = 0):
        """Checkpoint once (through ``save_cb`` or ``save_fn``), journal
        it, dump a flight-recorder bundle, then raise
        :class:`Preempted`."""
        _, pid = _world()
        saver = save_cb or self.save_fn
        saved = False
        if saver is not None:
            saver()
            saved = True
        else:
            logger.warning(
                "%s: preempted with no checkpoint callback configured — "
                "exiting without a fresh snapshot (resume falls back to "
                "the previous one)", self.name)
        if saved:
            self.preempt_checkpoints += 1
            _preempt_ckpts.inc()
        self._journal({"event": "preempt_checkpoint", "step": int(step),
                       "saved": saved, "rank": pid})
        # flight-recorder postmortem on the way out: the rc-75 exit is
        # deliberate, but the bundle (recent events + metrics + config)
        # explains the preemption window afterwards. Best effort — a
        # dump failure must never block the exit protocol.
        try:
            from zoo_tpu_torch.obs.flight import dump_bundle, record_event
            record_event("preempt_exit", step=int(step), saved=saved,
                         rank=pid)
            dump_bundle("preempt-rc75")
        except Exception:  # noqa: BLE001
            pass
        logger.warning(
            "%s: preemption checkpoint at step %d complete; exiting "
            "with code %d (resume-don't-retry)", self.name, step,
            PREEMPT_EXIT_CODE)
        raise Preempted(step)

    # -- journal -----------------------------------------------------------
    def _journal(self, record: Dict):
        """Append one event to the quarantine/transition JSONL. Never
        raises — a journal failure must not take training down with it
        (numpy scalars from restored checkpoints coerce via default=)."""
        path = self.quarantine_path
        if not path:
            return
        record = {"ts": time.time(), "guard": self.name, **record}
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with self._lock, open(path, "a") as f:
                f.write(json.dumps(
                    record,
                    default=lambda o: o.item()
                    if hasattr(o, "item") else repr(o)) + "\n")
        except Exception as e:  # noqa: BLE001 — best-effort forensics
            logger.debug("guard journal write failed: %s", e)
