"""The port's KNRM against ``zoo_tpu``'s on the same weights
(``keras_params_from_jax``) and the same token ids.

Tolerances. The exact-match kernel has sigma 0.001: its slope at a
cosine c is |c - 1| / sigma^2 times its value, up to about 1 / (sigma
sqrt(e)) ~ 607 at c = 1 - sigma. The cosines differ between the two
frameworks by a few f32 ulps (~1e-7: the norms and the dot products
sum in another order), so one exact-match feature can differ by ~6e-5
per query-document pair and the pooled feature (a sum of log1p over 5
query tokens) by ~1e-4 relative; the other kernels (sigma 0.1) move
10^4 times less. Scores after the linear layer and sigmoid are held
within 1e-5 absolute, pooled features within 1e-4 relative, and a
2-epoch ``fit`` with Adam and binary cross-entropy: per-epoch losses
within rtol 1e-4, every parameter within 1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models.ranking import KNRM as JKNRM
from zoo_tpu.models.ranking.knrm import _KernelPooling as JPooling

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.ranking import KNRM
from zoo_tpu_torch.models.ranking.knrm import _KernelPooling
from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet

jax.config.update("jax_platforms", "cpu")

Q, D, V = 5, 10, 40


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _data(n=32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, V, (n, Q + D)).astype(np.int32)
    # relevant iff the query's first token appears in the document
    y = np.array([[float(x[i, 0] in x[i, Q:])] for i in range(n)],
                 np.float32)
    return x, y


def _pair(kernel_num=11):
    jm = JKNRM(Q, D, V, 16, kernel_num=kernel_num)
    tm = KNRM(Q, D, V, 16, kernel_num=kernel_num)
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(0)))
    tm.params = keras_params_from_jax(tree, "cpu")
    assert [type(a).__name__ for a in jm.layers] == \
        [type(b).__name__ for b in tm.layers]
    assert sorted(tm.params) == sorted(tree)
    return jm, tm


def test_kernel_pooling_matches_jax_near_an_exact_match():
    rs = np.random.RandomState(1)
    sim = rs.uniform(-1, 1, (4, Q, D)).astype(np.float32)
    sim[:, :, :3] = 1.0 - rs.uniform(0, 3e-3, (4, Q, 3))   # exact matches
    want = np.asarray(JPooling(21).call({}, jnp.asarray(sim)))
    got = _KernelPooling(21).call({}, torch.from_numpy(sim)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kernel_num", [11, 21])
def test_forward_matches_jax(kernel_num):
    x, _ = _data()
    jm, tm = _pair(kernel_num)
    np.testing.assert_allclose(tm.predict(x, device="cpu"),
                               np.asarray(jm.predict(x)), atol=1e-5)


def test_fit_matches_jax():
    x, y = _data(64)
    jm, tm = _pair()
    for m in (jm, tm):
        m.compile(optimizer="adam", loss="binary_crossentropy")
    want = jm.fit(x, y, batch_size=16, nb_epoch=2, shuffle=True, seed=2,
                  verbose=0)
    got = tm.fit(x, y, batch_size=16, nb_epoch=2, shuffle=True, seed=2,
                 verbose=0, device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k, p in jax.tree_util.tree_map(np.asarray, jm.params).items():
        for name, v in p.items():
            np.testing.assert_allclose(tm.params[k][name].detach().numpy(),
                                       v, atol=1e-4, err_msg=k + name)


def test_model_file_round_trips(tmp_path):
    x, _ = _data(8)
    _, tm = _pair()
    path = str(tmp_path / "knrm.model")
    tm.save(path)
    back = KerasNet.load(path, device="cpu")
    assert isinstance(back, KNRM)
    np.testing.assert_array_equal(back.predict(x, device="cpu"),
                                  tm.predict(x, device="cpu"))
