"""The port's NCF slice against the JAX package: ``Embedding``,
``Lambda``, ``Adam``, ``NeuralCF`` and the ``Recommender`` helpers.

The JAX package's ``_flagship(small=True)`` (``__graft_entry__.py``)
and the port's ``NeuralCF`` of the same config start from the same
weights (the JAX tree carried over by ``keras_params_from_jax``) and see
the same numpy ids, made as ``bench.py``'s ``bench_ncf`` makes them.

Tolerances: forward probabilities within 1e-6 absolute (f32, the same
products summed in another order over at most 32 terms); one epoch of
``fit`` (8 steps, ``Adam(lr=0.001)``): losses within rtol 1e-5, every
parameter within 1e-6 absolute (Adam's normalized step moves each by
about lr, and carries the ~1e-7 relative gradient differences to
~1e-7 of that); ``Adam`` alone, the same f32 elementwise arithmetic in
the same order: within 1e-7 relative (the bias corrections' powers may
round to another neighbour). Gathers are exact.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models.recommendation import UserItemFeature as JaxFeature
from zoo_tpu.pipeline.api.keras import layers as jlayers
from zoo_tpu.pipeline.api.keras.optimizers import Adam as JaxAdam

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.recommendation import (
    NeuralCF,
    UserItemFeature,
)
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam, get_optimizer

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _flagship(small=True):
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._flagship(small=small)


def _port_flagship():
    """The port's counterpart of ``_flagship(small=True)``."""
    m = NeuralCF(user_count=64, item_count=64, class_num=5, user_embed=8,
                 item_embed=8, hidden_layers=(16, 8), mf_embed=8)
    return m.compile(optimizer=Adam(lr=0.001),
                     loss="sparse_categorical_crossentropy",
                     metrics=["accuracy"])


def _data(n=256, seed=0):
    """``bench_ncf``'s ids and labels at the small config's counts."""
    rs = np.random.RandomState(seed)
    x = np.stack([rs.randint(0, 64, n), rs.randint(0, 64, n)],
                 axis=1).astype(np.int32)
    return x, rs.randint(0, 5, n).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.array(   # a copy: fit updates in place
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.fixture()
def pair():
    jm = _flagship()
    jm.build(jax.random.PRNGKey(0), [(None, 2)])
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = _port_flagship()
    tm.params = keras_params_from_jax(tree, "cpu")
    return jm, tm


def test_flagship_keys_and_forward_match_jax(pair):
    jm, tm = pair
    assert set(tm.params) == set(jm.params)
    assert [type(layer).__name__ for layer in tm.layers] == \
        [type(layer).__name__ for layer in jm.layers]
    x, _ = _data(300)
    want = np.asarray(jm.predict(x, batch_size=128))
    got = tm.predict(x, batch_size=128, device="cpu")
    assert got.shape == want.shape == (300, 5)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_flagship_fit_one_epoch_matches_jax(pair):
    jm, tm = pair
    x, y = _data()
    ref = jm.fit(x, y, batch_size=32, nb_epoch=1, shuffle=True, seed=0,
                 verbose=0)
    got = tm.fit(x, y, batch_size=32, nb_epoch=1, shuffle=True, seed=0,
                 verbose=0, device="cpu")
    assert tm._step == jm._step == 8
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    have = _flat(tm.params)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-6, err_msg=k)
    # the state converts by name too: optax's mu / nu
    mu = _flat(jax.tree_util.tree_map(np.asarray,
                                      jm._opt_state[0].mu))
    mine = _flat(tm._opt_state["mu"])
    for k in mu:
        np.testing.assert_allclose(mine[k], mu[k], atol=1e-7, err_msg=k)
    assert tm._opt_state["count"] == int(jm._opt_state[0].count) == 8
    for name in ("loss", "accuracy"):
        np.testing.assert_allclose(
            tm.evaluate(x, y, batch_size=64, device="cpu")[name],
            jm.evaluate(x, y, batch_size=64)[name], rtol=1e-5)


def test_recommender_helpers_match_jax(pair):
    jm, tm = pair
    rs = np.random.RandomState(4)
    users, items = rs.randint(0, 64, 40), rs.randint(0, 64, 40)
    jp = [JaxFeature(int(u), int(i)) for u, i in zip(users, items)]
    tp = [UserItemFeature(int(u), int(i)) for u, i in zip(users, items)]

    def rows(preds):
        return [(p.user_id, p.item_id, p.prediction) for p in preds]

    for want, got in (
            (jm.predict_user_item_pair(jp),
             tm.predict_user_item_pair(tp, device="cpu")),
            (jm.recommend_for_user(jp, 2),
             tm.recommend_for_user(tp, 2, device="cpu")),
            (jm.recommend_for_item(jp, 1),
             tm.recommend_for_item(tp, 1, device="cpu"))):
        assert rows(got) == rows(want)
        np.testing.assert_allclose([p.probability for p in got],
                                   [p.probability for p in want],
                                   atol=1e-6)


def test_zero_based_ids_and_include_mf_options():
    m = NeuralCF(10, 7, 3, user_embed=4, item_embed=4, hidden_layers=(6,),
                 include_mf=False, zero_based_ids=False)
    params = m.build(device="cpu")
    tables = [p["E"] for p in params.values() if "E" in p]
    assert [t.shape[0] for t in tables] == [11, 8]   # one extra row each
    assert m.predict(np.array([[10, 7]], np.int32),
                     device="cpu").shape == (1, 3)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_embedding_matches_jax_with_ids_past_the_table(dtype):
    """Ids in [-n, n) pick their row (negative from the end); any other
    gives a NaN row and no gradient, as ``jnp.take``'s default mode."""
    rs = np.random.RandomState(1)
    table = rs.randn(6, 4).astype(np.float32)
    ids = np.array([[0, 5, 6], [-1, -6, -7], [3, 3, 100]], np.int32)
    w = rs.randn(3, 3, 4).astype(np.float32)
    jlayer, tlayer = jlayers.Embedding(6, 4), tlayers.Embedding(6, 4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jloss(e):
        out = jlayer.call({"E": e.astype(jdt)}, jnp.asarray(ids))
        return jnp.sum(jnp.where(jnp.isnan(out), 0, out).astype(
            jnp.float32) * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(table))
    e = torch.from_numpy(table).requires_grad_()
    out = tlayer.call({"E": e.to(tdt)}, torch.from_numpy(ids))
    loss = (torch.where(out.isnan(), 0, out).float()
            * torch.from_numpy(w)).sum()
    (tgrad,) = torch.autograd.grad(loss, e)
    assert out.dtype == tdt and out.shape == (3, 3, 4)
    np.testing.assert_array_equal(out.float().detach().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    assert np.isnan(out.float().detach().numpy()[[0, 1, 2], [2, 2, 2]]).all()
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-6)
    assert tlayer.compute_output_shape((None, 3)) == \
        jlayer.compute_output_shape((None, 3)) == (None, 3, 4)
    params = tlayers.Embedding(6, 4, input_length=3).build(
        torch.Generator().manual_seed(0), (None, 3))
    e0 = params["E"]
    assert e0.shape == (6, 4) and float(e0.min()) >= 0.0 and \
        float(e0.max()) < 0.05            # keras-1 "uniform": U[0, 0.05)


def test_embedding_ids_stay_integers_under_mixed_bfloat16():
    m = NeuralCF(300, 300, 2, user_embed=4, item_embed=4,
                 hidden_layers=(4,), mf_embed=4)
    m.compile("adam", "sparse_categorical_crossentropy",
              dtype_policy="mixed_bfloat16")
    x = np.array([[257, 299], [299, 257]], np.int32)   # not bf16-exact
    m.build(device="cpu")
    users = m.params["001_embedding"]["E"]
    xs = m._cast_compute([torch.from_numpy(x)])
    assert xs[0].dtype == torch.int32 and torch.equal(xs[0][:, 0],
                                                      torch.tensor(
                                                          [257, 299],
                                                          dtype=torch.int32))
    row = m.layers[1].call({"E": users}, xs[0][:, 0])
    assert torch.equal(row, users[[257, 299]])


def test_lambda_matches_jax():
    x = np.arange(24, dtype=np.int32).reshape(12, 2)
    fn = lambda t: t[:, 0]                       # noqa: E731
    jl, tl = jlayers.Lambda(fn), tlayers.Lambda(fn)
    np.testing.assert_array_equal(
        tl.call({}, torch.from_numpy(x)).numpy(),
        np.asarray(jl.call({}, jnp.asarray(x))))
    for layer in (jl, tl):           # inferred without output_shape
        assert layer.compute_output_shape((None, 2)) == (None,)
    for f, shape in ((lambda t: t * 2, (None, 3, 4)),
                     (lambda t: t.reshape(t.shape[0], -1), (None, 12))):
        assert tlayers.Lambda(f).compute_output_shape((None, 3, 4)) == \
            jlayers.Lambda(f).compute_output_shape((None, 3, 4)) == shape
    given = tlayers.Lambda(fn, output_shape=(7,))
    assert given.compute_output_shape((None, 2)) == (None, 7)


@pytest.mark.parametrize("decay", [0.0, 0.01])
def test_adam_matches_optax(decay):
    rs = np.random.RandomState(2)
    shapes = {"a": {"W": (5, 3), "b": (3,)}, "c": {"E": (7, 2)}}
    params = jax.tree_util.tree_map(
        lambda s: rs.randn(*s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: (rs.randn(*s) * 10.0 ** rs.randint(-4, 1)).astype(
            np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
        for _ in range(4)]
    tx = JaxAdam(lr=0.01, decay=decay).make()
    jp, st = params, tx.init(params)
    for g in grads:
        u, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, u)
    opt = Adam(lr=0.01, decay=decay)
    tp = keras_params_from_jax(params, "cpu")
    state = opt.init(tp)
    for g in grads:
        tp, state = opt.apply(keras_params_from_jax(g, "cpu"), state, tp)
    assert state["count"] == int(st[0].count) == 4
    for name, mine, theirs in (("params", tp, jp), ("mu", state["mu"],
                                                    st[0].mu),
                               ("nu", state["nu"], st[0].nu)):
        for a, b in zip(tree_leaves(mine),
                        jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-7, atol=1e-12,
                                       err_msg=name)


def test_adam_contract():
    assert isinstance(get_optimizer("adam"), Adam)
    assert get_optimizer("adam").name == "adam"
    assert Adam(learningrate_schedule=lambda s: 1e-3).schedule is not None
    p = {"w": torch.ones(3)}
    opt = Adam()
    state = opt.init(p)
    _, state = opt.apply({"w": torch.zeros(3)}, state, p)
    # a zero gradient moves nothing (no weight decay in Adam)
    assert torch.equal(p["w"], torch.ones(3))
    assert len(tree_leaves(state["mu"])) == 1 and state["count"] == 1


def test_keras_params_from_jax_carries_the_ncf_tree(pair):
    jm, tm = pair
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    have = _flat(tm.params)
    assert set(have) == set(want) and len(want) == 10
    for k in want:
        assert have[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
