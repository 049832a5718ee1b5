"""The port's ``GANEstimator`` against the JAX package's, on nets shaped
like TF-GAN's MNIST example (a dense and transposed-conv generator with
BatchNorm, a strided-conv discriminator with leaky ReLU) at small
widths: from the same weights, one adversarial iteration (and a two-step
iteration, ``d_steps=2``) gives the same losses and params; two epochs
over three batches follow the same permutation and key chain;
``generate`` draws the same noise; a NaN batch under the guard leaves
the whole state bit-equal and counts as skipped.

Tolerances: losses rtol 1e-5 and params 2e-6 absolute after one
iteration (the noise is JAX's within 3 ulp, then a few layers of f32);
two epochs 1e-4 (BatchNorm on batch moments carries a rounding ~10x a
step; hold steps, not trajectories); ``generate`` 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.orca.learn.gan import GANEstimator as JaxGAN
from zoo_tpu.pipeline.api.keras import layers as JL
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.optimizers import Adam as JAdam

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.orca.learn.gan import GANEstimator
from zoo_tpu_torch.pipeline.api.keras import layers as TL
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
from zoo_tpu_torch.pipeline.api.keras.engine.topology import Sequential
from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

jax.config.update("jax_platforms", "cpu")

NOISE = 8


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _generator(L, Seq):
    g = Seq()
    g.add(L.Dense(32, input_shape=(NOISE,), bias=False))
    g.add(L.BatchNormalization())
    g.add(L.Activation("relu"))
    g.add(L.Dense(4 * 4 * 4, bias=False))
    g.add(L.BatchNormalization())
    g.add(L.Activation("relu"))
    g.add(L.Reshape((4, 4, 4)))
    g.add(L.Deconvolution2D(4, 4, 4, subsample=(2, 2), bias=False,
                            dim_ordering="tf"))
    g.add(L.Cropping2D(((1, 1), (1, 1)), dim_ordering="tf"))
    g.add(L.BatchNormalization())
    g.add(L.Activation("relu"))
    g.add(L.Convolution2D(1, 4, 4, border_mode="same", activation="tanh",
                          dim_ordering="tf"))
    return g


def _discriminator(L, Seq):
    d = Seq()
    d.add(L.Convolution2D(8, 4, 4, subsample=(2, 2), border_mode="same",
                          dim_ordering="tf", input_shape=(8, 8, 1)))
    d.add(L.LeakyReLU(0.01))
    d.add(L.Flatten())
    d.add(L.Dense(16, bias=False))
    d.add(L.BatchNormalization())
    d.add(L.LeakyReLU(0.01))
    d.add(L.Dense(1))
    return d


def _real(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return np.tanh(rs.randn(n, 8, 8, 1)).astype(np.float32)


def _pair(d_steps=1, lr=1e-3):
    """The JAX estimator and the port's over the same weights."""
    jg, jd = _generator(JL, JSeq), _discriminator(JL, JSeq)
    jg.build(jax.random.PRNGKey(0), [(None, NOISE)])
    jd.build(jax.random.PRNGKey(1), [(None, 8, 8, 1)])
    tg, td = _generator(TL, Sequential), _discriminator(TL, Sequential)
    for j, t in ((jg, tg), (jd, td)):
        t.params = keras_params_from_jax(
            jax.tree_util.tree_map(np.asarray, j.params), "cpu")
    jgan = JaxGAN(jg, jd, g_optimizer=JAdam(lr=lr, beta_1=0.5),
                  d_optimizer=JAdam(lr=lr, beta_1=0.5), noise_dim=NOISE,
                  d_steps=d_steps)
    tgan = GANEstimator(tg, td, g_optimizer=Adam(lr=lr, beta_1=0.5),
                        d_optimizer=Adam(lr=lr, beta_1=0.5),
                        noise_dim=NOISE, d_steps=d_steps, device="cpu")
    return jgan, tgan


def _params_close(tnet, jnet, atol):
    jl = jax.tree_util.tree_leaves(jnet.params)
    tl = tree_leaves(tnet.params)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol)


@pytest.mark.parametrize("d_steps", [1, 2])
def test_one_iteration_equals_jax(d_steps):
    jgan, tgan = _pair(d_steps)
    real = _real(16)
    want = jgan.fit(real, epochs=1, batch_size=16, seed=3)
    got = tgan.fit(real, epochs=1, batch_size=16, seed=3)
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    _params_close(tgan.g, jgan.g, 2e-6)
    _params_close(tgan.d, jgan.d, 2e-6)
    # the running stats stay fixed through adversarial training
    stats = [k for k in tgan.g.params if "stats" in tgan.g.params[k]]
    assert stats
    for k in stats:
        for name, t in tgan.g.params[k]["stats"].items():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jgan.g.params[k]["stats"][name]))


def test_two_epochs_follow_jax():
    jgan, tgan = _pair()
    real = _real(40)   # 3 batches of 12, 4 rows dropped each epoch
    want = jgan.fit(real, epochs=2, batch_size=12, seed=5)
    got = tgan.fit(real, epochs=2, batch_size=12, seed=5)
    for k in ("d_loss", "g_loss"):
        assert len(got[k]) == 2
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    _params_close(tgan.g, jgan.g, 1e-4)
    np.testing.assert_allclose(tgan.generate(10, seed=7),
                               np.asarray(jgan.generate(10, seed=7)),
                               atol=1e-4)


def test_generate_equals_jax():
    jgan, tgan = _pair()
    got = tgan.generate(12, seed=11)
    assert got.shape == (12, 8, 8, 1)
    np.testing.assert_allclose(got, np.asarray(jgan.generate(12, seed=11)),
                               atol=1e-5)


def _state_leaves(gan):
    return [t for part in gan._state for t in tree_leaves(part)]


def test_nan_batch_leaves_the_state_bit_equal():
    _, tgan = _pair()
    real = _real(32)
    tgan.fit(real[:16], epochs=1, batch_size=16)
    before = [t.detach().clone() for t in _state_leaves(tgan)]
    poisoned = real[16:].copy()
    poisoned[3, 2, 2, 0] = np.nan
    hist = tgan.fit(poisoned, epochs=1, batch_size=16)
    after = _state_leaves(tgan)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert hist["d_loss"] == [0.0] and hist["g_loss"] == [0.0]
    assert tgan._guard.nonfinite_steps == 1
    # the same batch without the NaN moves the state
    tgan.fit(real[16:], epochs=1, batch_size=16)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, _state_leaves(tgan)))
