"""The port's ``AutoEstimator`` against the JAX package's: a grid over a
torch MLP's hidden width through ``from_torch`` (each trial's module
seeded, so both packages start every trial from the same weights), the
same grid through ``from_keras`` (the port's creator carries the JAX
creator's weights), and a TPE search under the ASHA scheduler with
per-epoch reports give the same best config and best metric; the
metric checks and refusals are JAX's.

Tolerance: the best metric rtol 1e-4 (``test_torch_estimator.py``'s bar
for a few f32 epochs).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from zoo_tpu.automl import hp as jhp
from zoo_tpu.common import context as jax_context
from zoo_tpu.orca.automl import AutoEstimator as JaxAuto
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.orca.automl import AutoEstimator, hp
from zoo_tpu_torch.orca.automl.pytorch_utils import DEFAULT_LR, LR_NAME
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.layers import Dense
from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _data(n=96):
    rs = np.random.RandomState(0)
    x = rs.randn(n, 4).astype(np.float32)
    return x, (x @ rs.randn(4, 1) + 0.1).astype(np.float32)


def _torch_creator(config):
    torch.manual_seed(7)
    return nn.Sequential(nn.Linear(4, config["hidden"]), nn.ReLU(),
                         nn.Linear(config["hidden"], 1))


def test_from_torch_grid_equals_jax():
    x, y = _data()
    kw = dict(model_creator=_torch_creator, loss=nn.MSELoss(),
              optimizer=lambda m, cfg: torch.optim.Adam(
                  m.parameters(), lr=cfg.get(LR_NAME, DEFAULT_LR)))
    jauto = JaxAuto.from_torch(**kw)
    tauto = AutoEstimator.from_torch(device="cpu", **kw)
    space = {"hidden": hp.grid_search([4, 12]), "lr": hp.choice([0.02])}
    jspace = {"hidden": jhp.grid_search([4, 12]), "lr": jhp.choice([0.02])}
    jauto.fit({"x": x, "y": y}, epochs=3, batch_size=16,
              search_space=jspace, metric="mse")
    tauto.fit({"x": x, "y": y}, epochs=3, batch_size=16,
              search_space=space, metric="mse")
    assert tauto.get_best_config() == jauto.get_best_config()
    np.testing.assert_allclose(tauto.best_metric, jauto.best_metric,
                               rtol=1e-4)
    best = tauto.get_best_model()
    assert best.torch_model.__class__ is nn.Sequential
    assert best.predict(x[:5]).shape == (5, 1)
    assert str(best.model._params_device()) == "cpu"


def _keras_pair():
    def jax_model(config):
        m = JSeq()
        m.add(JDense(config["hidden"], input_shape=(4,), activation="relu"))
        m.add(JDense(1))
        m.compile(optimizer=JAdam(lr=config["lr"]), loss="mse")
        m.build(jax.random.PRNGKey(config["hidden"]), [(None, 4)])
        return m

    def port_model(config):
        m = Sequential()
        m.add(Dense(config["hidden"], input_shape=(4,), activation="relu"))
        m.add(Dense(1))
        m.compile(optimizer=Adam(lr=config["lr"]), loss="mse")
        m.params = keras_params_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_model(config).params), "cpu")
        return m

    return jax_model, port_model


@pytest.mark.parametrize("search", ["grid", "tpe_asha"])
def test_from_keras_equals_jax(search):
    x, y = _data()
    jax_model, port_model = _keras_pair()
    jauto = JaxAuto.from_keras(model_creator=jax_model)
    tauto = AutoEstimator.from_keras(model_creator=port_model, device="cpu")
    if search == "grid":
        kw = dict(epochs=2, batch_size=16, metric="mse")
        jauto.fit((x, y), search_space={
            "hidden": jhp.grid_search([4, 8]), "lr": 0.01}, **kw)
        tauto.fit((x, y), search_space={
            "hidden": hp.grid_search([4, 8]), "lr": 0.01}, **kw)
    else:
        kw = dict(epochs=3, batch_size=16, metric="mse", n_sampling=3,
                  search_alg="tpe", scheduler="asha", seed=2)
        jauto.fit((x, y), search_space={
            "hidden": jhp.choice([4, 8]), "lr": jhp.choice([0.01, 0.05])},
            **kw)
        tauto.fit((x, y), search_space={
            "hidden": hp.choice([4, 8]), "lr": hp.choice([0.01, 0.05])},
            **kw)
    assert tauto.get_best_config() == jauto.get_best_config()
    np.testing.assert_allclose(tauto.best_metric, jauto.best_metric,
                               rtol=1e-4)


def test_metric_checks_and_refusals():
    x, y = _data(32)
    tauto = AutoEstimator.from_torch(model_creator=_torch_creator,
                                     loss=nn.MSELoss(), device="cpu")
    with pytest.raises(ValueError, match="search_space is required"):
        tauto.fit({"x": x, "y": y})
    with pytest.raises(ValueError, match="not produced by evaluate"):
        tauto.fit({"x": x, "y": y}, search_space={
            "hidden": hp.grid_search([4])}, metric="accuracy")
    # the loss stands in for mse when the torch loss is an MSELoss
    tauto.fit({"x": x, "y": y}, batch_size=16, search_space={
        "hidden": hp.grid_search([4])}, metric="mse")
    assert np.isfinite(tauto.best_metric)
    with pytest.raises(RuntimeError, match="fit"):
        AutoEstimator.from_torch(model_creator=_torch_creator
                                 ).get_best_model()
