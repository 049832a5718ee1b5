#!/usr/bin/env python
"""Smoke-check the training guardian's escalation ladder END TO END —
NaN-inject → skip → rollback → finish — against a synthetic training
loop over the port (copy of ``scripts/check_guard.py`` on
``zoo_tpu_torch``), deliberately **torch-free** (asserted!) so a
subprocess run costs milliseconds: the guard's host controller (window
stats, streak escalation, rollback budget, preemption state machine,
quarantine journal, obs counters) is pure Python by design; only the
in-step fold helpers touch torch, and the real-model path is covered by
``tests/test_torch_guard.py``.

The simulated run:

1. trains fine for a few windows (loss decays),
2. a :class:`FaultInjector` site poisons a bounded run of steps → the
   per-step health check "skips" them (bad counter + streak, exactly the
   values the device counters would read back),
3. the streak crosses ``max_skips`` → the guard restores the last
   verified snapshot (stub save/restore over an in-memory dict) with LR
   backoff,
4. the fault schedule ends → training resumes from the snapshot and
   converges,
5. a second phase exercises the loss-SPIKE trigger, the rollback-budget
   exhaustion (→ ``TrainingDiverged``) and the preemption request
   (→ ``Preempted`` carrying exit code 75).

Run directly (``python -m zoo_tpu_torch.scripts.check_guard``) or from
the suite (``tests/test_torch_guard.py`` runs it in a subprocess).
"""

import json
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def check(verbose: bool = True) -> int:
    from zoo_tpu_torch.obs.metrics import get_registry
    from zoo_tpu_torch.orca.learn.guard import (
        PREEMPT_EXIT_CODE,
        GuardConfig,
        Preempted,
        TrainingDiverged,
        TrainingGuard,
    )
    from zoo_tpu_torch.util.resilience import inject

    assert "torch" not in sys.modules, \
        "guard host controller must stay importable without torch"

    qdir = tempfile.mkdtemp(prefix="zoo-guard-smoke-")
    qpath = os.path.join(qdir, "quarantine.jsonl")

    # -- a stub "trainable" + checkpoint store ----------------------------
    snapshots = {}

    class Sim:
        """loss = w decays 10%/good step; a poisoned step yields NaN."""

        def __init__(self):
            self.w = 1.0
            self.step = 0
            self.streak = 0
            self.bad = 0

        def train_window(self, k):
            """k steps; returns (window_loss_sum, steps) as fit would."""
            total = 0.0
            for _ in range(k):
                self.step += 1
                loss = self.w
                try:
                    from zoo_tpu_torch.util.resilience import fault_point
                    fault_point("guard.smoke.batch", step=self.step)
                except _Poison:
                    loss = float("nan")
                if math.isnan(loss):
                    # what the guarded step's fold does: skip the update, count
                    self.bad += 1
                    self.streak += 1
                    continue
                self.streak = 0
                self.w *= 0.9
                total += loss
            return total, k

    class _Poison(RuntimeError):
        pass

    sim = Sim()

    def save():
        snapshots["s"] = {"params": sim.w, "epoch": sim.step}

    def restore():
        sim.w = snapshots["s"]["params"]
        return snapshots["s"], None

    cfg = GuardConfig(enabled=True, max_skips=4, rollback_budget=2,
                      spike_factor=5.0, min_window=3, window=16)
    guard = TrainingGuard(config=cfg, save_fn=save, restore_fn=restore,
                          quarantine_path=qpath, name="smoke")
    guard.begin_fit()
    save()  # the verified starting snapshot

    # -- phase 1: clean -> NaN window -> skip -> rollback -> finish -------
    rolled = False
    with inject("guard.smoke.batch", exc=_Poison("poison"), times=6):
        for window in range(12):
            wl, ws = sim.train_window(4)
            act = guard.on_boundary(
                bad_total=sim.bad, streak=sim.streak, window_loss=wl,
                window_steps=ws, global_step=sim.step, epoch=0,
                batch_hint=(window * 4, window * 4 + 3))
            if act == "rollback":
                state, _aux, lr_scale = guard.rollback()
                # the fit loop re-inits the device counters on rollback
                sim.streak = 0
                sim.bad = 0
                rolled = True
                assert lr_scale == cfg.lr_backoff
            elif act is None and sim.step % 8 == 0:
                save()  # periodic verified snapshot

    assert rolled, "streak of skipped steps must trigger a rollback"
    assert guard.rollbacks == 1
    # nonfinite_steps is CUMULATIVE: 4 pre-rollback + the fault
    # schedule's 2-injection tail after it; training still converges
    # once the schedule runs dry
    assert guard.nonfinite_steps == 6, guard.nonfinite_steps
    assert sim.w < 0.5, \
        f"post-rollback training must converge (w={sim.w})"

    # -- phase 2: spike trigger + budget exhaustion -----------------------
    for _ in range(4):  # refill the rolling window with sane losses
        guard.on_boundary(bad_total=0, streak=0, window_loss=0.4,
                          window_steps=4, global_step=sim.step)
    act = guard.on_boundary(bad_total=0, streak=0,
                            window_loss=0.4 * 4 * 100,  # 100x spike
                            window_steps=4, global_step=sim.step)
    assert act == "rollback", f"spike must trigger rollback, got {act!r}"
    guard.rollback()  # burns the budget (2/2)
    try:
        guard.rollback()
        raise AssertionError("budget exhaustion must raise")
    except TrainingDiverged:
        pass

    # -- phase 3: preemption ----------------------------------------------
    g2 = TrainingGuard(config=cfg, save_fn=save, quarantine_path=qpath,
                       name="smoke-preempt")
    g2.begin_fit()
    g2.request_preempt()
    act = g2.on_boundary(bad_total=0, streak=0, window_loss=0.1,
                         window_steps=4, global_step=sim.step)
    assert act == "preempt"
    try:
        g2.preempt_checkpoint(step=sim.step)
        raise AssertionError("preempt_checkpoint must raise Preempted")
    except Preempted as e:
        assert e.code == PREEMPT_EXIT_CODE == 75
    assert g2.preempt_checkpoints == 1
    assert snapshots["s"]["epoch"] == sim.step

    # -- forensics + metrics ----------------------------------------------
    events = [json.loads(line) for line in open(qpath)]
    kinds = [e["event"] for e in events]
    assert "nonfinite_steps" in kinds and "rollback" in kinds \
        and "diverged" in kinds and "preempt_checkpoint" in kinds, kinds
    quarantined = next(e for e in events
                       if e["event"] == "nonfinite_steps")
    assert quarantined["batch_lo"] is not None \
        and quarantined["bad_in_window"] > 0, quarantined
    snap = get_registry().snapshot()

    def metric(name):
        return sum(c["value"] for c in snap["counters"]
                   if c["name"] == name)

    assert metric("zoo_guard_nonfinite_steps_total") >= 6
    assert metric("zoo_guard_rollbacks_total") >= 2
    assert metric("zoo_guard_preempt_checkpoints_total") >= 1
    assert "torch" not in sys.modules, "smoke stayed torch-free end to end"
    if verbose:
        print(f"nonfinite={metric('zoo_guard_nonfinite_steps_total')} "
              f"rollbacks={metric('zoo_guard_rollbacks_total')} "
              f"preempt_ckpts="
              f"{metric('zoo_guard_preempt_checkpoints_total')} "
              f"journal_events={len(events)}")
        print("GUARD OK (torch-free): NaN-inject -> skip -> rollback -> "
              "finish; spike + budget + preempt verified")
    return 0


if __name__ == "__main__":
    sys.exit(check())
