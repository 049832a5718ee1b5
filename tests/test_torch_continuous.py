"""The port's continuous-training loop against the JAX package's: the
promotion gate decides as JAX's gate on the same scripted traffic (a
good canary, failing canaries through the ``serving.canary`` fault seam,
a slow one on a scripted clock, a wrong one against ground truth, an
unfilled window, an SLO veto), with the same stats and the same alias
moves; the loop demotes a diverged candidate, promotes without a gate,
leaves ``prod`` on a rejection, moves the alias before any replica
swaps, and reports a failed rolling update as ``rolled_back``, as JAX's
does; the Chronos loop runs end to end on the CPU (two turns, the second
gated, loaded back from the registry), and a poisoned window is demoted
with ``prod`` unchanged; the lifecycle smoke's copy passes in a
subprocess.

Tolerance: the gate's stats are equal (the same scripted clock and
losses computed in float64 on the same arrays).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from zoo_tpu.obs import slo as jax_slo
from zoo_tpu.orca.learn import continuous as J
from zoo_tpu.orca.learn.guard import TrainingDiverged as JaxDiverged
from zoo_tpu.serving.ha import RollingUpdateError as JaxRollingUpdateError
from zoo_tpu.serving.registry import ModelRegistry as JaxRegistry
from zoo_tpu.util import resilience as jax_res

from zoo_tpu_torch.obs import slo as port_slo
from zoo_tpu_torch.orca.learn import continuous as T
from zoo_tpu_torch.orca.learn.guard import TrainingDiverged
from zoo_tpu_torch.serving.ha import RollingUpdateError
from zoo_tpu_torch.serving.registry import ModelRegistry
from zoo_tpu_torch.util import resilience as port_res

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SIDES = {"jax": (J, JaxRegistry, jax_res, jax_slo, JaxDiverged,
                  JaxRollingUpdateError),
          "port": (T, ModelRegistry, port_res, port_slo, TrainingDiverged,
                   RollingUpdateError)}


class _Clock:
    """A scripted ``perf_counter``: each model call advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _traffic(n, seed, shift=0.0):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        x = rs.randn(1, 4).astype(np.float32) + shift
        yield x, x * 2.0


def _model(clock, factor=2.0, dt=0.001, fail_every=0):
    calls = [0]

    def predict(x):
        calls[0] += 1
        clock.t += dt
        if fail_every and calls[0] % fail_every == 0:
            raise RuntimeError("canary 500")
        return np.asarray(x) * factor
    return predict


_CASES = {
    # name: (canary kwargs, gate kwargs, traffic length, fault times)
    "good": ({}, {}, 64, 0),
    "fault_seam": ({}, {}, 100, 4),
    "failing": ({"fail_every": 5}, {}, 100, 0),
    "slow": ({"dt": 0.01}, {"max_latency_ratio": 2.0}, 60, 0),
    "wrong": ({"factor": 2.5}, {"max_loss_ratio": 1.1}, 60, 0),
    "unfilled": ({}, {"window": 80}, 30, 0),
    "slo_veto": ({}, {}, 64, 0),
}


def _gate_run(side, case, tmp_path, monkeypatch):
    mod, Registry, res, slo, _, _ = _SIDES[side]
    canary_kw, gate_kw, n, fault_times = _CASES[case]
    gate_kw = dict(gate_kw)
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    reg = Registry(str(tmp_path / side))
    v1 = reg.publish(spec="synthetic:double:0", alias="prod")
    v2 = reg.publish(spec="synthetic:double:0", alias="canary")
    slo._set_status({"ok": False, "breaches": ["ttft_p99"]}
                    if case == "slo_veto" else None)
    res.clear_faults()
    try:
        if fault_times:
            res.inject("serving.canary", exc=RuntimeError("injected"),
                       times=fault_times)
        gate = mod.PromotionGate(
            _model(clock), _model(clock, **canary_kw), candidate=v2,
            registry=reg, sample=1.0, window=gate_kw.pop("window", 24),
            rng=np.random.RandomState(0), **gate_kw)
        verdict = gate.run(_traffic(n, 3, shift=1.0))
    finally:
        res.clear_faults()
        slo._set_status(None)
        monkeypatch.undo()
    return verdict, reg.aliases(), v1, v2


@pytest.mark.parametrize("case", sorted(_CASES))
def test_gate_decides_as_jax(case, tmp_path, monkeypatch):
    jv, jaliases, _, _ = _gate_run("jax", case, tmp_path, monkeypatch)
    tv, taliases, v1, v2 = _gate_run("port", case, tmp_path, monkeypatch)
    assert tv.promoted == jv.promoted
    assert tv.reason == jv.reason
    assert tv.stats == jv.stats
    assert taliases == jaliases
    assert taliases.get("prod") == (v2 if tv.promoted else v1)
    assert tv.promoted == (case == "good"), tv


class _Group:
    """A stand-in replica group: records the prod alias it saw when the
    rolling update started, and fails it when told to."""

    def __init__(self, reg, error=None):
        self.reg, self.error, self.seen = reg, error, []

    def rolling_update(self, version):
        self.seen.append(self.reg.alias_version("prod"))
        if self.error is not None:
            raise self.error("replica 1 failed its warm-up")
        return {"updated": 3}


@pytest.mark.parametrize("case", ["diverged", "direct", "rejected",
                                  "rolled", "rolled_back"])
def test_loop_turn_as_jax(case, tmp_path):
    outs = {}
    for side in ("jax", "port"):
        mod, Registry, _, _, Diverged, RollErr = _SIDES[side]
        reg = Registry(str(tmp_path / side))
        reg.publish(spec="synthetic:double:0", alias="prod")

        def train(window):
            if case == "diverged":
                raise Diverged("loss spiked 10x over the rolling median")
            return "synthetic:double:0"

        def gate_factory(candidate):
            clock = _Clock()
            return mod.PromotionGate(
                _model(clock), _model(clock, factor=3.0), candidate=candidate,
                registry=None, sample=1.0, window=8,
                rng=np.random.RandomState(0))

        group = None
        if case.startswith("rolled"):
            group = _Group(reg, RollErr if case == "rolled_back" else None)
        loop = mod.ContinuousTrainingLoop(
            train, reg, group=group,
            gate_factory=gate_factory if case == "rejected" else None)
        out = loop.step(window=None, traffic=list(_traffic(16, 1)))
        outs[side] = (out["outcome"], out.get("version"), reg.versions(),
                      reg.aliases(), group and group.seen,
                      out.get("reason"))
    assert outs["port"] == outs["jax"]
    outcome, version, versions, aliases, seen, _ = outs["port"]
    want = {"diverged": "demoted", "direct": "promoted",
            "rejected": "rejected", "rolled": "promoted",
            "rolled_back": "rolled_back"}[case]
    assert outcome == want
    if case == "diverged":
        assert versions == [1] and aliases["prod"] == "v1"
    if case.startswith("rolled"):
        # the alias moved to the candidate before any replica swapped
        assert seen == [version]


def _window(n, past, feat, rs):
    x = rs.randn(n, past, feat).astype(np.float32)
    y = x[:, -1:, :1] * 0.5 + x[:, -1:, 1:] * 0.5
    return x, y


def test_chronos_loop_end_to_end_and_poisoned_window(tmp_path):
    from zoo_tpu_torch.chronos.forecaster.lstm_forecaster import (
        LSTMForecaster,
    )
    from zoo_tpu_torch.serving.ha import resolve_model_spec

    past, feat = 8, 2
    rs = np.random.RandomState(0)
    reg = ModelRegistry(str(tmp_path / "registry"))
    train_fn = T.chronos_train_fn(
        lambda: LSTMForecaster(past_seq_len=past, input_feature_num=feat,
                               output_feature_num=1, hidden_dim=8,
                               device="cpu"),
        epochs=2, batch_size=32, out_dir=str(tmp_path / "artifacts"))
    # turn 1: an empty registry, no incumbent: direct promotion
    out1 = T.ContinuousTrainingLoop(train_fn, reg).step(
        _window(96, past, feat, rs))
    assert out1["outcome"] == "promoted" and out1["version"] == "v1"
    _, artifact = reg.model_spec("prod")
    assert artifact.endswith("model.zoo")

    # turn 2: the candidate gated against the incumbent, both loaded
    # back from the registry (the replica load path)
    def gate_factory(candidate):
        inc = resolve_model_spec(f"registry:{reg.root}:prod",
                                 device="cpu")[0]
        can = resolve_model_spec(f"registry:{reg.root}:{candidate}",
                                 device="cpu")[0]
        return T.PromotionGate(
            lambda x: inc.predict(x), lambda x: can.predict(x),
            candidate=candidate, registry=reg, sample=1.0, window=12,
            max_latency_ratio=50.0, rng=np.random.RandomState(1))

    loop = T.ContinuousTrainingLoop(train_fn, reg, gate_factory=gate_factory)
    xs, ys = _window(32, past, feat, rs)
    traffic = [(xs[i:i + 1], ys[i:i + 1].reshape(1, -1))
               for i in range(len(xs))]
    out2 = loop.step(_window(96, past, feat, rs), traffic)
    assert out2["outcome"] == "promoted", out2
    assert out2["version"] == "v2" and reg.alias_version("prod") == "v2"
    assert out2["gate"]["mirrored"] >= 12
    # turn 3: a poisoned window diverges under the guard: demoted,
    # nothing published, prod unchanged
    x, y = _window(256, past, feat, rs)
    x[:] = np.nan
    out3 = loop.step((x, y), traffic)
    assert out3["outcome"] == "demoted" and out3["version"] is None
    assert reg.versions() == [1, 2] and reg.alias_version("prod") == "v2"


@pytest.mark.lifecycle
@pytest.mark.timeout(200)
def test_check_lifecycle_copy_runs_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "zoo_tpu_torch.scripts.check_lifecycle",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=180, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "LIFECYCLE OK" in r.stdout
