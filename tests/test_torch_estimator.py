"""The port's Orca Keras Estimator against the JAX package's: the NCF
flagship (small config) and an MLP trained through both estimators with
the default guard, EveryEpoch checkpoints and validation data give the
same per-epoch losses, ``val_*`` series and ``evaluate`` results and the
same checkpoint steps; an exception injected in epoch 2 is retried from
the verified checkpoint and lands bit-equal to an uninterrupted run;
``load_orca_checkpoint(version=)`` resumes a chosen step; a stale
``model_dir`` is refused; ``loss_weights`` and multi-output ``evaluate``
on a two-head functional Model match; DataFrame input with
``feature_cols``/``label_cols`` is read without pandas in the port.

Tolerances: f32 losses, ``val_*`` and ``evaluate`` within rtol 1e-4
(``test_torch_keras.py``'s bar); params within 1e-4 absolute; the retry
and resume checks are bit-equal (the same CPU arithmetic replayed).
"""

import importlib.util
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.orca.learn.keras import Estimator as JaxEstimator
from zoo_tpu.pipeline.api.keras.engine.topology import Input as JInput
from zoo_tpu.pipeline.api.keras.engine.topology import Model as JModel
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.recommendation import NeuralCF
from zoo_tpu_torch.orca.learn.ckpt import CheckpointManager
from zoo_tpu_torch.orca.learn.keras import Estimator
from zoo_tpu_torch.pipeline.api.keras import Input, Model, Sequential
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
from zoo_tpu_torch.pipeline.api.keras.layers import Dense
from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
from zoo_tpu_torch.util.resilience import inject

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _flagship():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._flagship(small=True)


def _ncf_pair():
    jm = _flagship()
    jm.build(jax.random.PRNGKey(0), [(None, 2)])
    tm = NeuralCF(user_count=64, item_count=64, class_num=5, user_embed=8,
                  item_embed=8, hidden_layers=(16, 8), mf_embed=8)
    tm.compile(optimizer=Adam(lr=0.001),
               loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _ncf_data(n=288, seed=0):
    rs = np.random.RandomState(seed)
    x = np.stack([rs.randint(0, 64, n), rs.randint(0, 64, n)],
                 axis=1).astype(np.int32)
    return x, rs.randint(0, 5, n).astype(np.int32)


def _mlp_pair():
    jm = JSeq()
    jm.add(JDense(16, input_shape=(8,), activation="relu"))
    jm.add(JDense(1))
    jm.compile(optimizer="adam", loss="mse", metrics=["mae"])
    jm.build(jax.random.PRNGKey(1), [(None, 8)])
    tm = Sequential()
    tm.add(Dense(16, input_shape=(8,), activation="relu"))
    tm.add(Dense(1))
    tm.compile(optimizer="adam", loss="mse", metrics=["mae"])
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _mlp_data(n=288, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    return x, (x @ rs.randn(8, 1)).astype(np.float32)


def _port_model():
    m = Sequential()
    m.add(Dense(16, input_shape=(8,), activation="relu"))
    m.add(Dense(1))
    m.compile(optimizer="adam", loss="mse")
    m.build(torch.Generator().manual_seed(0), device="cpu")
    return m


def _leaves(tree):
    return [np.array(t.detach()) for t in tree_leaves(tree)]


def _close(got, want, name):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("which", ["ncf", "mlp"])
def test_fit_matches_the_jax_estimator(which, tmp_path):
    jm, tm = _ncf_pair() if which == "ncf" else _mlp_pair()
    x, y = _ncf_data() if which == "ncf" else _mlp_data()
    data, val = {"x": x[:256], "y": y[:256]}, (x[256:], y[256:])
    je = JaxEstimator.from_keras(jm, model_dir=str(tmp_path / "jax"))
    je._ckpt._ckptr = None   # the pickle codec, the port's
    te = Estimator.from_keras(tm, model_dir=str(tmp_path / "port"),
                              device="cpu")
    want = je.fit(data, epochs=3, batch_size=32, validation_data=val)
    got = te.fit(data, epochs=3, batch_size=32, validation_data=val)
    _close(got, want, which)
    assert len(got["loss"]) == 3 and any(k.startswith("val_") for k in got)
    _close(te.evaluate({"x": x, "y": y}, batch_size=64),
           je.evaluate({"x": x, "y": y}, batch_size=64), which + " evaluate")
    np.testing.assert_allclose(te.predict(x[:40], batch_size=16),
                               np.asarray(je.predict(x[:40], batch_size=16)),
                               atol=1e-4)
    assert te._ckpt.all_steps() == je._ckpt.all_steps() == [0, 1, 2, 3]
    for tag in ("Loss", "Throughput"):
        assert [s for s, _ in te.get_train_summary(tag)] == \
            [s for s, _ in je.get_train_summary(tag)]
    for k in got:
        if k.startswith("val_"):
            read = te.get_validation_summary(k[4:])
            np.testing.assert_allclose([v for _, v in read], got[k],
                                       rtol=1e-6)
    for a, b in zip(tree_leaves(tm.params),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-4)


def test_dataframe_input_with_feature_and_label_cols(tmp_path):
    """A DataFrame's feature columns stack into the single input, as in
    the JAX package; the port reads it duck-typed (``columns``,
    ``to_numpy``)."""
    jm, tm = _mlp_pair()
    x, y = _mlp_data()
    cols = [f"f{i}" for i in range(8)]
    df = pd.DataFrame({c: x[:, i] for i, c in enumerate(cols)})
    df["label"] = y[:, 0]
    train, val = df.iloc[:256], df.iloc[256:]
    je = JaxEstimator.from_keras(jm, guard=False)
    te = Estimator.from_keras(tm, guard=False, device="cpu")
    kw = dict(epochs=2, batch_size=32, feature_cols=cols,
              label_cols=["label"], validation_data=val)
    _close(te.fit(train, **kw), je.fit(train, **kw), "dataframe")


def test_retry_after_an_injected_exception_is_bit_equal(tmp_path):
    """An exception at the first superbatch of epoch 2: the estimator
    restores the epoch-1 checkpoint, retrains, and ends bit-equal to an
    uninterrupted run from the same start."""
    x, y = _mlp_data()
    data = {"x": x[:256], "y": y[:256]}
    straight = Estimator.from_keras(_port_model(),
                                    model_dir=str(tmp_path / "a"),
                                    device="cpu")
    straight.fit(data, epochs=3, batch_size=32)
    est = Estimator.from_keras(_port_model(), model_dir=str(tmp_path / "b"),
                               device="cpu")
    est.fit(data, epochs=1, batch_size=32)
    with inject("fit.batch", exc=RuntimeError("injected"), times=1) as armed:
        h = est.fit(data, epochs=2, batch_size=32)
    assert armed.fired == 1 and len(h["loss"]) == 2 and est._epoch == 3
    for a, b in zip(_leaves(est.model.params),
                    _leaves(straight.model.params)):
        assert np.array_equal(a, b)
    for a, b in zip(_leaves(est.model._opt_state),
                    _leaves(straight.model._opt_state)):
        assert np.array_equal(a, b)


def test_failures_propagate_without_a_checkpoint_dir():
    x, y = _mlp_data()
    est = Estimator.from_keras(_port_model(), device="cpu")
    with inject("fit.batch", exc=RuntimeError("injected"), times=1):
        with pytest.raises(RuntimeError, match="injected"):
            est.fit({"x": x, "y": y}, epochs=1, batch_size=32)


def test_load_orca_checkpoint_version(tmp_path):
    x, y = _mlp_data()
    data = {"x": x[:256], "y": y[:256]}
    est = Estimator.from_keras(_port_model(), model_dir=str(tmp_path),
                               device="cpu")
    est.fit(data, epochs=2, batch_size=32)
    at2 = _leaves(est.model.params), _leaves(est.model._opt_state)
    est.fit(data, epochs=1, batch_size=32)
    fresh = Estimator.from_keras(_port_model(), model_dir=str(tmp_path),
                                 device="cpu")
    fresh.load_orca_checkpoint(str(tmp_path), version=2)
    assert fresh._epoch == 2
    for got, want in zip((_leaves(fresh.model.params),
                          _leaves(fresh.model._opt_state)), at2):
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    assert fresh.model._opt_state["count"].dtype == torch.int32
    # one more epoch from step 2 lands where the first run's third did
    fresh.fit(data, epochs=1, batch_size=32)
    for a, b in zip(_leaves(fresh.model.params), _leaves(est.model.params)):
        assert np.array_equal(a, b)
    latest = Estimator.from_keras(_port_model(), device="cpu")
    latest.load_orca_checkpoint(str(tmp_path))
    assert latest._epoch == 3


def test_stale_model_dir_is_refused(tmp_path):
    x, y = _mlp_data()
    data = {"x": x[:256], "y": y[:256]}
    Estimator.from_keras(_port_model(), model_dir=str(tmp_path),
                         device="cpu").fit(data, epochs=3, batch_size=32)
    est = Estimator.from_keras(_port_model(), model_dir=str(tmp_path),
                               device="cpu")
    with inject("fit.batch", exc=RuntimeError("injected"), times=1):
        with pytest.raises(RuntimeError, match="previous run"):
            est.fit(data, epochs=1, batch_size=32)


def test_from_bigdl_compiles_and_wraps(tmp_path):
    m = Sequential()
    m.add(Dense(1, input_shape=(8,)))
    est = Estimator.from_bigdl(model=m, loss="mse", optimizer="sgd",
                               model_dir=str(tmp_path), device="cpu")
    x, y = _mlp_data()
    assert np.isfinite(est.fit({"x": x, "y": y}, epochs=1,
                               batch_size=32)["loss"]).all()
    with pytest.raises(ValueError, match="compiled"):
        Estimator.from_bigdl(model=Sequential().add(Dense(1,
                                                          input_shape=(2,))))
    est.save(str(tmp_path / "w.pkl"))
    back = Estimator.from_keras(Sequential().add(Dense(1, input_shape=(8,))),
                                device="cpu").load(str(tmp_path / "w.pkl"))
    for a, b in zip(_leaves(back.model.params), _leaves(m.params)):
        assert np.array_equal(a, b)
    # the step profiler (ported with the staged feed): phases recorded
    # through the estimator, cleared on demand
    assert est.set_profile() is not None
    est.fit({"x": x, "y": y}, epochs=1, batch_size=32)
    assert {"data", "step"} <= set(est.get_profile_stats())
    est.clear_profile()
    assert est.get_profile_stats() == {}


def _two_heads(J):
    Inp, Mdl, Dns = (JInput, JModel, JDense) if J else (Input, Model, Dense)
    inp = Inp(shape=(8,))
    h = Dns(16, activation="relu")(inp)
    return Mdl(inp, [Dns(1)(h), Dns(3, activation="softmax")(h)])


def test_loss_weights_and_multi_output_evaluate_match_jax(tmp_path):
    jm, tm = _two_heads(True), _two_heads(False)
    for m in (jm, tm):
        m.compile(optimizer="sgd",
                  loss=["mse", "sparse_categorical_crossentropy"],
                  loss_weights=[0.3, 1.7])
    jm.build(jax.random.PRNGKey(2), [(None, 8)])
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    rs = np.random.RandomState(5)
    x = rs.randn(256, 8).astype(np.float32)
    y1 = (x[:, :1] * 2.0).astype(np.float32)
    y2 = rs.randint(0, 3, 256).astype(np.int32)
    want = jm.fit(x, [y1, y2], batch_size=32, nb_epoch=2, verbose=0)
    got = tm.fit(x, [y1, y2], batch_size=32, nb_epoch=2, verbose=0,
                 device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    ev_t = tm.evaluate(x, [y1, y2], batch_size=64, device="cpu")
    ev_j = jm.evaluate(x, [y1, y2], batch_size=64)
    _close(ev_t, ev_j, "two heads")
    with pytest.raises(ValueError, match="one loss per output"):
        _two_heads(False).compile("sgd", "mse")
    with pytest.raises(ValueError, match="loss_weights"):
        _two_heads(False).compile("sgd", ["mse", "mse"],
                                  loss_weights=[1.0])
    path = tm.save(str(tmp_path / "two.zoo"))   # MultiLoss is a file part
    assert type(tm.load(path, device="cpu").loss_fn).__name__ == "MultiLoss"


def test_checkpoints_hold_numpy_and_the_device_count(tmp_path):
    x, y = _mlp_data()
    est = Estimator.from_keras(_port_model(), model_dir=str(tmp_path),
                               device="cpu")
    est.fit({"x": x[:256], "y": y[:256]}, epochs=1, batch_size=32)
    mgr = CheckpointManager(os.path.join(str(tmp_path), "ckpts"))
    step, state, aux = mgr.restore_with_aux()
    assert step == 1 and int(state["epoch"]) == 1
    assert all(isinstance(a, np.ndarray) for a in tree_leaves(
        state["params"]))
    assert aux["count"].dtype == np.int32 and int(aux["count"]) == 8
