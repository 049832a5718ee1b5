"""The port's AutoML (``zoo_tpu_torch.automl``: the samplers, TPE, the
stopper, ASHA, the local search engine, ``Evaluator``) and AutoTS
(``zoo_tpu_torch.chronos.autots``) against the JAX package's, on the
CPU. The samplers' draws, the TPE proposals and the ASHA decisions are
the same numpy code on the same ``RandomState`` seeds: exactly equal.
The engines give JAX's trials and best configuration on a seeded
objective; AutoTS gives JAX's best configuration, its ARIMA metric
within 1e-6 relative and its LSTM metric within 1e-4 relative (the
trials' models start from the JAX ``fit``'s weights, dropout off so the
layer names do not matter).
"""

import os
import pickle
import threading

import jax
import numpy as np
import pandas as pd
import pytest

from zoo_tpu.automl import hp as jhp
from zoo_tpu.automl import search as jsearch
from zoo_tpu.automl import tpe as jtpe
from zoo_tpu.automl.common.metrics import Evaluator as JEvaluator
from zoo_tpu.chronos.autots import AutoTSEstimator as JAutoTS
from zoo_tpu.chronos.autots import TSPipeline as JPipeline
from zoo_tpu.chronos.autots.model.auto_arima import AutoARIMA as JAutoARIMA
from zoo_tpu.chronos.data import TSDataset as JTS

from zoo_tpu_torch.automl import hp, search, tpe
from zoo_tpu_torch.automl.common.metrics import Evaluator
from zoo_tpu_torch.chronos.autots import AutoTSEstimator, TSPipeline
from zoo_tpu_torch.chronos.autots.model import AutoARIMA, AutoProphet
from zoo_tpu_torch.chronos.data import TSDataset
from zoo_tpu_torch.orca.learn.ckpt import CheckpointRefused

from test_torch_chronos import _jax_initial_weights  # noqa: F401

jax.config.update("jax_platforms", "cpu")


def _space(h):
    return {"a": h.uniform(-2.0, 3.0), "lr": h.loguniform(1e-4, 1e-1),
            "q": h.quniform(0.0, 10.0, 0.5), "n": h.randint(1, 9),
            "c": h.choice(["x", "y", "z"]), "g": h.grid_search([1, 2]),
            "k": 7}


def _objective(cfg):
    """A seeded deterministic objective over :func:`_space`."""
    return {"mse": (cfg["a"] - 1.0) ** 2 + abs(np.log10(cfg["lr"]) + 2)
            + 0.01 * cfg["q"] + 0.1 * cfg["n"]
            + {"x": 0.3, "y": 0.0, "z": 0.5}[cfg["c"]] + 0.05 * cfg["g"]}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_samplers_draw_jaxs_values(seed):
    ours, theirs = _space(hp), _space(jhp)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(20):
        for k, v in ours.items():
            if isinstance(v, hp.Sampler):
                a, b = v.sample(r1), theirs[k].sample(r2)
                assert a == b and type(a) is type(b), k
    assert ours["g"].is_grid() and ours["g"].grid() == [1, 2]
    with pytest.raises(NotImplementedError):
        hp.uniform(0, 1).grid()


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_tpe_proposes_jaxs_configs(seed, mode):
    ours = tpe.TPESampler(_space(hp), mode=mode, n_startup=4)
    theirs = jtpe.TPESampler(_space(jhp), mode=mode, n_startup=4)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    history = []
    for _ in range(12):
        a, b = ours.suggest(r1, history), theirs.suggest(r2, history)
        assert a == b
        history.append((a, _objective(a)["mse"]))
    history.append(({"a": 0.0}, float("nan")))  # unfinished: ignored
    assert ours.suggest(r1, history) == theirs.suggest(r2, history)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_asha_and_the_stopper_decide_as_jax(mode):
    a = search.ASHAScheduler(max_t=27, grace_period=1, reduction_factor=3,
                             mode=mode)
    b = jsearch.ASHAScheduler(max_t=27, grace_period=1, reduction_factor=3,
                              mode=mode)
    assert a.rungs == b.rungs == [1, 3, 9, 27]
    rs = np.random.RandomState(5)
    for step in range(1, 12):
        for trial in range(6):
            m = float(rs.rand())
            assert a.on_result(trial, step, m) == b.on_result(trial, step, m)
    for kw in (dict(metric_threshold=0.5, mode=mode), dict(max_steps=3)):
        s, t = search.TrialStopper(**kw), jsearch.TrialStopper(**kw)
        for step, m in ((1, 0.7), (2, 0.4), (3, 0.9), (4, 0.1)):
            assert s(step, m) == t(step, m)


@pytest.mark.parametrize("alg", ["random", "tpe"])
@pytest.mark.parametrize("n_parallel", [1, 2])
def test_local_engine_gives_jaxs_trials_and_best(alg, n_parallel):
    results = []
    for mod, h in ((search, hp), (jsearch, jhp)):
        eng = mod.LocalSearchEngine(n_parallel=n_parallel)
        eng.compile(_objective, _space(h), n_sampling=5, metric="mse",
                    mode="min", seed=3, search_alg=alg)
        trials = eng.run()
        results.append(([(t.trial_id, t.config, t.metric) for t in trials],
                        eng.get_best_trial().config))
    assert results[0] == results[1]
    assert len(results[0][0]) == (10 if alg == "random" else 5)


def test_local_engine_reports_stop_trials_as_jax():
    """A trial that takes a ``reporter`` is cut at ASHA's rungs and by the
    stopper; the threads share one scheduler."""
    def trial(cfg, reporter=None):
        m = float("inf")
        for step in range(1, 10):
            m = cfg["a"] ** 2 / step
            if reporter(step, m):
                break
        return {"mse": m, "steps": step}

    out = []
    for mod, h in ((search, hp), (jsearch, jhp)):
        eng = mod.LocalSearchEngine(stopper=mod.TrialStopper(max_steps=6),
                                    scheduler="asha")
        eng.compile(trial, {"a": h.grid_search([0.5, 1.0, 2.0, 3.0, 4.0])},
                    metric="mse")
        out.append([(t.config, t.artifacts["steps"], t.metric)
                    for t in eng.run()])
    assert out[0] == out[1]
    lock, seen = threading.Lock(), []

    def tracked(cfg):
        with lock:
            seen.append(threading.current_thread().name)
        return {"mse": cfg["a"]}

    eng = search.LocalSearchEngine(n_parallel=2)
    eng.compile(tracked, {"a": hp.grid_search(list(range(8)))})
    eng.run()
    assert eng.get_best_trial().config == {"a": 0} and len(seen) == 8
    assert eng._sub_contexts() == []


def test_search_engine_choices_and_refusals():
    assert isinstance(search.make_search_engine(),
                      search.LocalSearchEngine)   # no ray here
    with pytest.raises(ImportError):
        search.RayTuneSearchEngine()
    with pytest.raises(ValueError, match="search_alg"):
        search.LocalSearchEngine().compile(_objective, {}, search_alg="bo")
    with pytest.raises(ValueError, match="scheduler"):
        search.LocalSearchEngine().compile(_objective, {}, scheduler="pbt")
    with pytest.raises(RuntimeError, match="run"):
        search.LocalSearchEngine().get_best_trial()


@pytest.mark.parametrize("metric", ["mse", "rmse", "mae", "smape", "r2"])
def test_evaluator_matches_jax(metric):
    rs = np.random.RandomState(0)
    t, p = rs.randn(20, 3), rs.randn(20, 3)
    for mo in ("raw_values", "uniform_average", None):
        np.testing.assert_array_equal(
            Evaluator.evaluate(metric, t, p, multioutput=mo),
            JEvaluator.evaluate(metric, t, p, multioutput=mo))
    np.testing.assert_array_equal(Evaluator.evaluate(metric, t[:, 0],
                                                     p[:, 0]),
                                  JEvaluator.evaluate(metric, t[:, 0],
                                                      p[:, 0]))
    with pytest.raises(ValueError, match="multioutput"):
        Evaluator.evaluate(metric, t, p, multioutput="variance")


# ------------------------------------------------------------------ AutoTS

def _series(n=160, seed=0):
    """``examples/autots_forecasting.py``'s series, shortened."""
    rs = np.random.RandomState(seed)
    t = np.arange(n)
    v = (np.sin(t * 2 * np.pi / 24) + 0.3 * np.sin(t * 2 * np.pi / 168)
         + 0.1 * rs.randn(n)).astype(np.float32)
    return pd.DataFrame({"datetime": pd.date_range("2024-01-01", periods=n,
                                                   freq="h"), "value": v})


def _datasets(cls, df, cut=120):
    return (cls.from_pandas(df.iloc[:cut], "datetime", "value"),
            cls.from_pandas(df.iloc[cut:].reset_index(drop=True),
                            "datetime", "value"))


def test_autots_lstm_search_gives_jaxs_best(_jax_initial_weights):
    df = _series()
    space = lambda h: {"hidden_dim": h.choice([3, 5]),  # noqa: E731
                       "lr": h.loguniform(1e-3, 1e-2), "dropout": 0.0}
    fit = dict(epochs=2, batch_size=16, n_sampling=3, seed=2)
    jp = JAutoTS("lstm", space(jhp), past_seq_len=6).fit(
        *_datasets(JTS, df), **fit)
    tp = AutoTSEstimator("lstm", space(hp), past_seq_len=6).fit(
        *_datasets(TSDataset, df), device="cpu", **fit)
    assert tp.best_config == jp.best_config
    _, val = _datasets(TSDataset, df)
    _, jval = _datasets(JTS, df)
    got, want = tp.evaluate(val, ["mse"]), jp.evaluate(jval, ["mse"])
    assert got["mse"] == pytest.approx(want["mse"], rel=1e-4)


def test_autots_arima_search_gives_jaxs_best():
    df = _series(120)
    space = lambda h: {"p": h.grid_search([1, 2]),  # noqa: E731
                       "q": h.grid_search([0, 1]), "d": 0}
    jp = JAutoTS("arima", space(jhp)).fit(*_datasets(JTS, df, 100))
    tp = AutoTSEstimator("arima", space(hp)).fit(
        *_datasets(TSDataset, df, 100))
    assert tp.best_config == jp.best_config
    np.testing.assert_allclose(tp.predict(None), jp.predict(None),
                               rtol=1e-6)
    a, b = AutoARIMA(p=hp.grid_search([1, 2]), q=1, seasonal=False), \
        JAutoARIMA(p=jhp.grid_search([1, 2]), q=1, seasonal=False)
    y = df["value"].to_numpy(np.float64)
    a.fit(y)
    b.fit(y)
    assert a.get_best_config() == b.get_best_config()
    np.testing.assert_allclose(a.get_best_model().predict(5),
                               b.get_best_model().predict(5), rtol=1e-6)
    with pytest.raises(ImportError, match="prophet"):
        AutoProphet()
    with pytest.raises(ValueError, match="TSDataset"):
        AutoTSEstimator("lstm").fit(np.zeros((4, 2)), device="cpu")


def test_tspipeline_load_reads_only_what_it_is_told_to(tmp_path):
    """A scaled pipeline loads with its scaler's class named, and
    predicts as it did; without the name, or with a file naming any
    other callable, it is refused (the JAX package unpickles whatever
    the file names). The JAX package reads the port's pipeline, and the
    port a JAX one."""
    from sklearn.preprocessing import StandardScaler

    df = _series(100)
    train, val = _datasets(TSDataset, df, 80)
    train.scale(StandardScaler())
    val.scale(train.scaler, fit=False)
    pipe = AutoTSEstimator("tcn", {"num_channels": [3], "dropout": 0.0},
                           past_seq_len=6, future_seq_len=2).fit(
        train, epochs=1, batch_size=8, device="cpu")
    path = str(tmp_path / "p")
    pipe.save(path)
    with pytest.raises(CheckpointRefused, match="scaler_classes"):
        TSPipeline.load(path, device="cpu")
    back = TSPipeline.load(path, device="cpu",
                           scaler_classes=(StandardScaler,))
    np.testing.assert_array_equal(back.predict(val), pipe.predict(val))
    assert isinstance(back.scaler, StandardScaler)
    np.testing.assert_array_equal(back.scaler.mean_, train.scaler.mean_)
    jback = JPipeline.load(path)
    _, jval = _datasets(JTS, df, 80)
    jval.scale(train.scaler, fit=False)
    np.testing.assert_allclose(jback.predict(jval), pipe.predict(val),
                               atol=1e-5)
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    with open(os.path.join(bad, "meta.pkl"), "wb") as f:
        pickle.dump({"scaler": os.system}, f)
    with pytest.raises(CheckpointRefused, match="posix.system|os.system"):
        TSPipeline.load(bad, device="cpu")
    # an ARIMA pipeline of the JAX package, in the port
    jarima = JAutoTS("arima", {"p": 1, "q": 1}).fit(
        _datasets(JTS, df, 80)[0])
    jpath = str(tmp_path / "j")
    jarima.save(jpath)
    np.testing.assert_allclose(TSPipeline.load(jpath).predict(None),
                               jarima.predict(None), rtol=1e-12)
