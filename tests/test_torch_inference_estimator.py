"""The port's inference-only Estimator against the JAX package's: a model
built in JAX and carried into the port (each saved in its own package's
file) predicts the same from arrays, dicts, XShards (XShards of
prediction dicts back), bare-array shards and a two-output model, on the
float route and the int8 route (``ZOO_INT8_MODE=force``); ``from_caffe``
predicts as the Caffe net does; ``fit`` and ``evaluate`` refuse;
``from_tf``/``from_onnx`` name ROADMAP A.16; ``from_openvino`` names the
migrations.

Tolerances: float 1e-5 absolute; int8 1e-5 between the packages (the
same per-channel scales and integer products) and within 3 % of the
float outputs' range, the JAX test's bar.
"""

import jax
import numpy as np
import pytest

from zoo_tpu.common import context as jax_context
from zoo_tpu.orca.data.shard import LocalXShards as JaxShards
from zoo_tpu.orca.learn.inference import Estimator as JaxEstimator
from zoo_tpu.pipeline.api.keras.engine.topology import Input as JInput
from zoo_tpu.pipeline.api.keras.engine.topology import Model as JModel
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.orca.data import XShards
from zoo_tpu_torch.orca.learn.inference import Estimator
from zoo_tpu_torch.pipeline.api.keras import Input, Model, Sequential
from zoo_tpu_torch.pipeline.api.keras.layers import Dense

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _carry(jm, tm):
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    tm._built_shapes = [tuple(s) for s in jm._input_shapes()]
    return tm


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    jm = JSeq(name="inf_est")
    jm.add(JDense(16, activation="relu", input_shape=(8,)))
    jm.add(JDense(3))
    jm.build()
    tm = Sequential(name="inf_est")
    tm.add(Dense(16, activation="relu", input_shape=(8,)))
    tm.add(Dense(3))
    _carry(jm, tm)
    d = tmp_path_factory.mktemp("m")
    jp, tp = str(d / "jax.zoo"), str(d / "port.zoo")
    jm.save(jp)
    tm.save(tp)
    x = np.random.RandomState(0).randn(40, 8).astype(np.float32)
    return jp, tp, x


def _est(saved, **kw):
    jp, tp, _ = saved
    return JaxEstimator.from_model(jp, **kw), Estimator.from_model(
        tp, device="cpu", **kw)


@pytest.mark.parametrize("feed", ["array", "dict", "xshards", "bare_shards"])
def test_predict_equals_jax(saved, feed):
    je, te = _est(saved)
    x = saved[2]
    if feed == "array":
        got, want = te.predict(x, batch_size=16), je.predict(x, batch_size=16)
    elif feed == "dict":
        got, want = te.predict({"x": x}), je.predict({"x": x})
    else:
        data = {"x": x} if feed == "xshards" else x
        tout = te.predict(XShards.partition(data, num_shards=4),
                          batch_size=16)
        jout = je.predict(JaxShards.partition(data, num_shards=4),
                          batch_size=16)
        assert tout.num_partitions() == jout.num_partitions() == 4
        assert all(set(s) == {"prediction"} for s in tout.collect())
        got = np.concatenate([s["prediction"] for s in tout.collect()])
        want = np.concatenate([s["prediction"] for s in jout.collect()])
    assert got.shape == (40, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_int8_route_equals_jax(saved, monkeypatch):
    monkeypatch.setenv("ZOO_INT8_MODE", "force")
    je, te = _est(saved, quantize=True)
    _, tp, x = saved
    assert te.get_model().model._quant_path == "int8"
    got = te.predict(x, batch_size=16)
    np.testing.assert_allclose(got, np.asarray(je.predict(x, batch_size=16)),
                               atol=1e-5)
    ref = Estimator.from_model(tp, device="cpu").predict(x)
    rel = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-9)
    assert rel < 0.03


def test_two_output_model(tmp_path):
    a = JInput(shape=(6,))
    jm = JModel(input=a, output=[JDense(2)(a), JDense(4)(a)])
    jm.build()
    b = Input(shape=(6,))
    tm = _carry(jm, Model(input=b, output=[Dense(2)(b), Dense(4)(b)]))
    jm.save(str(tmp_path / "j.zoo"))
    tm.save(str(tmp_path / "t.zoo"))
    x = np.random.RandomState(1).randn(10, 6).astype(np.float32)
    got = Estimator.from_model(str(tmp_path / "t.zoo"), device="cpu"
                               ).predict(x, batch_size=5)
    want = JaxEstimator.from_model(str(tmp_path / "j.zoo")).predict(
        x, batch_size=5)
    assert isinstance(got, list) and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


def test_from_caffe_predicts_as_the_net(tmp_path):
    from test_torch_caffe_loader import _make_model, _numpy_forward

    path, weights = _make_model(tmp_path)
    x = np.random.RandomState(2).randn(5, 3, 8, 8).astype(np.float32)
    te = Estimator.from_caffe(None, str(path), batch_size=5, device="cpu")
    je = JaxEstimator.from_caffe(None, str(path), batch_size=5)
    got = te.predict(x)
    np.testing.assert_allclose(got, np.asarray(je.predict(x)), atol=1e-6)
    np.testing.assert_allclose(got, _numpy_forward(x, *weights), atol=1e-5)


def test_refusals(saved):
    _, tp, _ = saved
    est = Estimator.from_model(tp, device="cpu")
    with pytest.raises(NotImplementedError, match="cannot fit"):
        est.fit(None, epochs=1)
    with pytest.raises(NotImplementedError, match="predict"):
        est.evaluate(None)
    for fn in (Estimator.from_tf, Estimator.from_onnx):
        with pytest.raises(NotImplementedError, match="ROADMAP A.16"):
            fn("x")
    with pytest.raises(NotImplementedError, match="from_tf") as err:
        Estimator.from_openvino(model_path="x.xml")
    assert "card" in str(err.value) and "TPU" not in str(err.value)
    with pytest.raises(NotImplementedError, match="from_tf"):
        JaxEstimator.from_openvino(model_path="x.xml")
