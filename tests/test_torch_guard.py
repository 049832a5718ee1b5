"""The port's training guard (``zoo_tpu_torch/orca/learn/guard.py``)
against real guarded fits, the counterparts of ``tests/test_guard.py``:
an injected NaN batch is skipped without touching params or optimizer
state (with the same counters and quarantine events as the JAX
package's guard on the same data), a forced divergence rolls back to
the last verified checkpoint and the run still converges, budget
exhaustion raises ``TrainingDiverged`` (never retried), no checkpoint
escalates straight to it, a preemption request produces a checkpoint a
fresh run resumes from, SIGTERM during fit routes to the guard, and
``ZOO_GUARD=0`` turns it off. The fold itself is a bit-exact no-op on
clean data (guarded == unguarded losses and params).
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.orca.learn import guard as jguard
from zoo_tpu.orca.learn.keras import Estimator as JaxEstimator
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from zoo_tpu.util.resilience import inject as jinject

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.orca.learn.guard import (
    PREEMPT_EXIT_CODE,
    GuardConfig,
    Preempted,
    TrainingDiverged,
    TrainingGuard,
)
from zoo_tpu_torch.orca.learn.keras import Estimator
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
from zoo_tpu_torch.pipeline.api.keras.layers import Dense
from zoo_tpu_torch.util.resilience import inject

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _data(n=256, feat=8, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, feat).astype(np.float32)
    w = rs.randn(feat, 1).astype(np.float32)
    return {"x": x, "y": (x @ w).astype(np.float32)}


def _model(seed=0):
    m = Sequential()
    m.add(Dense(16, input_shape=(8,), activation="relu"))
    m.add(Dense(1))
    m.compile(optimizer="adam", loss="mse")
    m.build(torch.Generator().manual_seed(seed), device="cpu")
    return m


def _jax_pair():
    """A JAX model and the port's with its weights."""
    jm = JSeq()
    jm.add(JDense(16, input_shape=(8,), activation="relu"))
    jm.add(JDense(1))
    jm.compile(optimizer="adam", loss="mse")
    jm.build(jax.random.PRNGKey(0), [(None, 8)])
    tm = _model()
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _poison(site=None, arrays=None, idx=None, **_):
    for a in arrays:
        a[:] = np.nan


def _guard(**kw):
    kw.setdefault("preempt_signal", "none")
    return TrainingGuard(config=GuardConfig(enabled=True, **kw))


def _leaves(tree):
    return [np.array(t.detach()) for t in tree_leaves(tree)]


def _events(path):
    return [json.loads(line) for line in open(path)]


def test_guarded_matches_unguarded_on_clean_data():
    """The in-step fold must not perturb healthy training by one ulp:
    where ``ok`` is true the fold returns the unguarded update."""
    data = _data()
    e1 = Estimator.from_keras(_model(), guard=False, device="cpu")
    h1 = e1.fit(data, epochs=3, batch_size=32)
    e2 = Estimator.from_keras(_model(), guard=_guard(), device="cpu")
    h2 = e2.fit(data, epochs=3, batch_size=32)
    assert h1["loss"] == h2["loss"], (h1["loss"], h2["loss"])
    for a, b in zip(_leaves(e1.model.params), _leaves(e2.model.params)):
        assert np.array_equal(a, b)
    for a, b in zip(_leaves(e1.model._opt_state),
                    _leaves(e2.model._opt_state)):
        assert np.array_equal(a, b)


def test_nan_batch_skipped_state_unchanged_and_journaled_as_jax(tmp_path):
    """Layer 1: a poison superbatch mid-fit is folded away — finite
    loss, params and the whole optimizer state (Adam's mu, nu and count)
    exactly as before it, the quarantine journal and the counters
    recording the skip as the JAX guard records it on the same data."""
    data = _data(n=512)
    jm, tm = _jax_pair()
    out = {}
    for name, est, arm in (
            ("jax", JaxEstimator.from_keras(
                jm, model_dir=str(tmp_path / "jax"),
                guard=jguard.TrainingGuard(config=jguard.GuardConfig(
                    enabled=True, max_skips=100,
                    preempt_signal="none"))), jinject),
            ("port", Estimator.from_keras(
                tm, model_dir=str(tmp_path / "port"),
                guard=_guard(max_skips=100), device="cpu"), inject)):
        if name == "jax":
            est._ckpt._ckptr = None
        # 16 batches, one superbatch: the poisoned one is the whole epoch
        est.fit(data, epochs=1, batch_size=32)
        with arm("fit.batch", action=_poison, exc=None, times=1) as armed:
            h = est.fit(data, epochs=1, batch_size=32)
        out[name] = (armed.fired, est._guard.nonfinite_steps, h["loss"],
                     _events(os.path.join(str(tmp_path / name), "guard",
                                          "quarantine.jsonl")))
    (jf, jn, jl, je), (tf, tn, tl, te) = out["jax"], out["port"]
    assert jf == tf == 1
    assert jn == tn > 0
    assert np.isfinite(tl).all() and tl == jl == [0.0]
    keys = ("event", "epoch", "global_step", "bad_in_window", "bad_total",
            "streak")
    assert [{k: e[k] for k in keys} for e in te] == \
        [{k: e[k] for k in keys} for e in je]
    assert te[0]["event"] == "nonfinite_steps" and \
        te[0]["batch_lo"] is not None


def test_poisoned_step_leaves_params_and_optimizer_state_bit_equal():
    """32 batches in two superbatches of 16, the second poisoned: after
    the fit, params, mu, nu and the device count equal, bit for bit,
    those of a fit over the first superbatch alone."""
    data = _data(n=1024)
    x, y = data["x"], data["y"]
    ref = _model()
    ref.set_guard(_guard(max_skips=100))
    ref.fit(x[:512], y[:512], batch_size=32, nb_epoch=1, shuffle=False,
            verbose=0, device="cpu")
    m = _model()
    m.set_guard(_guard(max_skips=100))
    seen = {"n": 0}

    def second(site=None, arrays=None, idx=None, **_):
        seen["n"] += 1
        if seen["n"] == 2:
            _poison(arrays=arrays)

    with inject("fit.batch", action=second, exc=None):
        h = m.fit(x, y, batch_size=32, nb_epoch=1, shuffle=False,
                  verbose=0, device="cpu")
    assert seen["n"] == 2 and np.isfinite(h["loss"]).all()
    assert m._active_guard().nonfinite_steps == 16
    assert int(m._opt_state["count"]) == int(ref._opt_state["count"]) == 16
    for a, b in zip(_leaves(m.params), _leaves(ref.params)):
        assert np.array_equal(a, b)
    for a, b in zip(_leaves(m._opt_state), _leaves(ref._opt_state)):
        assert np.array_equal(a, b)


def test_skipped_step_leaves_batchnorm_stats_unchanged():
    """The BatchNorm running stats fold with the step: a poisoned
    superbatch leaves them (and every other param) bit-equal, while a
    clean one moves them."""
    from zoo_tpu_torch.pipeline.api.keras.layers import BatchNormalization
    m = Sequential()
    m.add(Dense(16, input_shape=(8,)))
    m.add(BatchNormalization())
    m.add(Dense(1))
    m.compile(optimizer="sgd", loss="mse")
    m.build(torch.Generator().manual_seed(0), device="cpu")
    m.set_guard(_guard(max_skips=100))
    data = _data()

    def fit():
        m.fit(data["x"], data["y"], batch_size=32, nb_epoch=1, verbose=0,
              device="cpu")

    def stats():
        return _leaves({k: v["stats"] for k, v in m.params.items()
                        if "stats" in v})

    fit()
    before, stats_before = _leaves(m.params), stats()
    assert stats_before
    with inject("fit.batch", action=_poison, exc=None, times=1):
        fit()
    for a, b in zip(_leaves(m.params), before):
        assert np.array_equal(a, b)
    fit()
    assert not all(np.array_equal(a, b)
                   for a, b in zip(stats(), stats_before))


def test_divergence_rolls_back_and_converges(tmp_path):
    """Layer 2: a streak of poisoned superbatches triggers restore from
    the last verified checkpoint; once the fault schedule ends the run
    converges below its pre-fault loss."""
    data = _data()
    guard = _guard(max_skips=4)
    est = Estimator.from_keras(_model(), model_dir=str(tmp_path),
                               guard=guard, device="cpu")
    h0 = est.fit(data, epochs=1, batch_size=32)
    with inject("fit.batch", action=_poison, exc=None, times=2):
        h = est.fit(data, epochs=4, batch_size=32)
    assert guard.rollbacks >= 1
    assert np.isfinite(h["loss"]).all()
    assert h["loss"][-1] < h0["loss"][0], (h0["loss"], h["loss"])
    events = _events(os.path.join(str(tmp_path), "guard",
                                  "quarantine.jsonl"))
    assert any(e["event"] == "rollback" for e in events)


def test_budget_exhaustion_raises_diverged_not_retried(tmp_path):
    """A permanently poisoned stream exhausts the rollback budget and
    raises TrainingDiverged straight through the estimator's retry
    perimeter."""
    data = _data()
    data["x"][:128] = np.nan  # half the rows: every shuffled batch dies
    guard = _guard(max_skips=4, rollback_budget=2)
    est = Estimator.from_keras(_model(), model_dir=str(tmp_path),
                               guard=guard, device="cpu")
    with pytest.raises(TrainingDiverged):
        est.fit(data, epochs=8, batch_size=32)
    assert guard.rollbacks == 2  # budget spent, then gave up


def test_no_checkpoint_escalates_to_diverged():
    """Without a model_dir there is nothing to roll back to: the ladder
    skips straight from streak to TrainingDiverged."""
    data = _data()
    data["x"][:] = np.nan
    guard = _guard(max_skips=4)
    est = Estimator.from_keras(_model(), guard=guard, device="cpu")
    with pytest.raises(TrainingDiverged):
        est.fit(data, epochs=2, batch_size=32)
    assert guard.rollbacks == 0


def test_preempt_checkpoints_and_resumes(tmp_path):
    """Layer 3: a preemption request checkpoints at the next step
    boundary and exits with the resume-don't-retry code; a fresh run
    resumes from that snapshot and completes."""
    data = _data()
    guard = _guard()
    est = Estimator.from_keras(_model(), model_dir=str(tmp_path),
                               guard=guard, device="cpu")
    est.fit(data, epochs=1, batch_size=32)
    guard.request_preempt()
    with pytest.raises(Preempted) as ei:
        est.fit(data, epochs=5, batch_size=32)
    assert ei.value.code == PREEMPT_EXIT_CODE == 75
    assert guard.preempt_checkpoints == 1
    assert issubclass(Preempted, SystemExit)
    saved = _leaves(est.model.params)

    est2 = Estimator.from_keras(_model(seed=5), model_dir=str(tmp_path),
                                device="cpu")
    est2.load_orca_checkpoint(path=str(tmp_path))
    for a, b in zip(_leaves(est2.model.params), saved):
        assert np.array_equal(a, b)
    h = est2.fit(data, epochs=2, batch_size=32)
    assert np.isfinite(h["loss"]).all()


def test_sigterm_routes_to_guard_during_fit(tmp_path):
    """During a guarded fit SIGTERM means checkpoint-and-exit(75), and
    the previous handler is restored afterwards."""
    data = _data()
    before = signal.getsignal(signal.SIGTERM)
    guard = TrainingGuard(config=GuardConfig(enabled=True,
                                             preempt_signal="SIGTERM"))
    est = Estimator.from_keras(_model(), model_dir=str(tmp_path),
                               guard=guard, device="cpu")
    est.fit(data, epochs=1, batch_size=32)
    kicked = {}

    def kick(site=None, arrays=None, idx=None, **_):
        if not kicked:
            kicked["x"] = True
            os.kill(os.getpid(), signal.SIGTERM)

    with inject("fit.batch", action=kick, exc=None, times=1):
        with pytest.raises(Preempted):
            est.fit(data, epochs=5, batch_size=32)
    assert guard.preempt_checkpoints == 1
    assert signal.getsignal(signal.SIGTERM) == before


def test_guard_disabled_by_env(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_GUARD", "0")
    est = Estimator.from_keras(_model(), model_dir=str(tmp_path),
                               device="cpu")
    assert est._guard is None
    assert est.model._active_guard() is None


def test_guard_refuses_a_distributed_world(monkeypatch):
    """The cross-process exchange is not ported: a torch.distributed
    world above one is refused by name."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    with pytest.raises(NotImplementedError, match="A.14"):
        _guard().begin_fit()


def test_check_guard_copy_runs_in_a_subprocess():
    """The port's ``check_guard`` smoke, torch-free end to end."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m",
                        "zoo_tpu_torch.scripts.check_guard"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "GUARD OK (torch-free)" in r.stdout
