"""The port's Keras-2 façade against ``zoo_tpu``'s: each of the 34
factories builds the Keras-1 layer the JAX factory builds (the same
class, so the same params key), and on the JAX layer's weights
(``keras_params_from_jax``) gives its outputs within 1e-5 absolute (f32
sums of at most 36 terms in another order; the recurrent layers run 5
steps)."""

import jax
import numpy as np
import pytest

from zoo_tpu.common import context as jax_context
from zoo_tpu.pipeline.api import keras2 as jk2
from zoo_tpu.pipeline.api.keras import Sequential as JSequential
from zoo_tpu.pipeline.api.keras.engine.topology import Input as JInput
from zoo_tpu.pipeline.api.keras.engine.topology import Model as JModel

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.pipeline.api import keras2 as tk2
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.engine.topology import Input, Model

jax.config.update("jax_platforms", "cpu")

# factory, Keras-2 arguments, input shape (no batch), int inputs
LAYERS = [
    ("Dense", dict(units=5, activation="relu", use_bias=True), (6,), False),
    ("Dense", dict(units=3, use_bias=False,
                   kernel_initializer="he_uniform"), (4, 6), False),
    ("Activation", dict(activation="tanh"), (6,), False),
    ("Dropout", dict(rate=0.3), (6,), False),
    ("Flatten", {}, (3, 4), False),
    ("Embedding", dict(input_dim=10, output_dim=4), (5,), True),
    ("Conv1D", dict(filters=4, kernel_size=3, strides=2, padding="same",
                    activation="relu"), (9, 3), False),
    ("Conv2D", dict(filters=4, kernel_size=(3, 2), strides=(1, 2),
                    padding="valid", data_format="channels_last"),
     (7, 8, 3), False),
    ("Conv2D", dict(filters=2, kernel_size=3, padding="same",
                    data_format="channels_first"), (3, 6, 6), False),
    ("Cropping1D", dict(cropping=(1, 2)), (8, 3), False),
    ("SeparableConv2D", dict(filters=4, kernel_size=3, depth_multiplier=2,
                             data_format="channels_last"), (6, 6, 3),
     False),
    ("MaxPooling1D", dict(pool_size=2), (8, 3), False),
    ("AveragePooling1D", dict(pool_size=3, strides=2), (9, 3), False),
    ("MaxPooling2D", dict(pool_size=(2, 2), data_format="channels_last"),
     (6, 6, 2), False),
    ("AveragePooling2D", dict(pool_size=2, strides=(1, 1),
                              data_format="channels_first"), (2, 5, 5),
     False),
    ("GlobalAveragePooling1D", {}, (6, 3), False),
    ("GlobalMaxPooling1D", {}, (6, 3), False),
    ("GlobalAveragePooling2D", dict(data_format="channels_last"),
     (4, 4, 3), False),
    ("GlobalMaxPooling2D", dict(data_format="channels_first"), (3, 4, 4),
     False),
    ("LocallyConnected1D", dict(filters=3, kernel_size=2), (6, 2), False),
    ("LeakyReLU", dict(alpha=0.2), (6,), False),
    ("ELU", dict(alpha=0.7), (6,), False),
    ("ThresholdedReLU", dict(theta=0.4), (6,), False),
    ("ConvLSTM2D", dict(filters=2, kernel_size=3, return_sequences=True),
     (3, 2, 5, 5), False),
    ("BatchNormalization", dict(momentum=0.9, epsilon=1e-3), (5,), False),
    ("LSTM", dict(units=4, return_sequences=True), (5, 3), False),
    ("GRU", dict(units=4), (5, 3), False),
    ("SimpleRNN", dict(units=4, activation="relu"), (5, 3), False),
]

MERGES = [("Maximum", {}), ("Minimum", {}), ("Average", {}), ("Add", {}),
          ("Concatenate", dict(axis=-1)), ("average", None),
          ("maximum", None), ("minimum", None)]


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def test_every_factory_is_covered():
    names = {n for n, *_ in LAYERS} | {n for n, _ in MERGES}
    assert names == set(jk2.layers.__all__) == set(tk2.layers.__all__)
    assert len(names) == 34


def _x(shape, ints, seed):
    rs = np.random.RandomState(seed)
    if ints:
        return rs.randint(0, 10, (4,) + shape).astype(np.int32)
    return rs.randn(*((4,) + shape)).astype(np.float32)


@pytest.mark.parametrize("i", range(len(LAYERS)),
                         ids=[f"{n}-{i}" for i, (n, *_) in
                              enumerate(LAYERS)])
def test_factory_builds_jaxs_layer_with_its_outputs(i):
    name, kw, shape, ints = LAYERS[i]
    jl = getattr(jk2.layers, name)(input_shape=shape, **kw)
    tl = getattr(tk2.layers, name)(input_shape=shape, **kw)
    assert type(tl).__name__ == type(jl).__name__
    jm, tm = JSequential().add(jl), Sequential().add(tl)
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(i)))
    tm.params = keras_params_from_jax(tree, "cpu")
    x = _x(shape, ints, i)
    want = np.asarray(jm.predict(x))
    got = tm.predict(x, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name,kw", MERGES)
def test_merge_factories_match_jax(name, kw):
    def graph(k2, inp, model):
        a, b = inp(shape=(4,)), inp(shape=(4,))
        f = getattr(k2.layers, name)
        out = f(**kw)([a, b]) if kw is not None else f([a, b])
        return model(input=[a, b], output=out)

    jm = graph(jk2, JInput, JModel)
    tm = graph(tk2, Input, Model)
    assert [type(x).__name__ for x in tm.layers] == \
        [type(x).__name__ for x in jm.layers]
    jm.build()
    tm.build(device="cpu")
    xs = [_x((4,), False, 1), _x((4,), False, 2)]
    np.testing.assert_allclose(tm.predict(xs, device="cpu"),
                               np.asarray(jm.predict(xs)), atol=1e-6)


def test_keras2_arguments_are_refused_as_jax_refuses_them():
    for k2 in (jk2, tk2):
        with pytest.raises(ValueError, match="data_format"):
            k2.layers.Conv2D(2, 3, data_format="nchw")
        with pytest.raises(ValueError, match="channels_first"):
            k2.layers.ConvLSTM2D(2, 3, data_format="channels_last")
        with pytest.raises(ValueError, match="axis"):
            k2.layers.BatchNormalization(axis=1)
