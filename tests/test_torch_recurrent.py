"""The port's recurrent layers (``SimpleRNN``, ``LSTM``, ``GRU``,
``Bidirectional``, ``TimeDistributed``) and ``hard_sigmoid`` against
the JAX package: the same numpy inputs, the JAX layer's weights carried
over by ``keras_params_from_jax``, outputs and gradients (in every
weight and in the input).

Tolerances: f32 outputs and gradients within 2e-5 absolute (the
recurrence's products are summed in another order by the two CPU
backends, over up to 9 steps); ``hard_sigmoid`` bit-equal (one add, one
clamp and one division in both). Under ``mixed_bfloat16`` inputs and
weights (the carry stays f32 in both), within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.pipeline.api.keras import layers as jlayers
from zoo_tpu.pipeline.api.keras.engine.base import get_activation_fn as jact

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    get_activation_fn,
    get_initializer,
    tree_leaves,
    tree_map,
)

jax.config.update("jax_platforms", "cpu")

B, T, D, H = 3, 9, 5, 6
TOL = 2e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.array(
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _check(jl, tl, in_shape, x, dtype="float32", tol=TOL):
    """Forward and gradients of ``sum(out * w)`` (w a fixed ramp) in
    every weight and the input, the JAX layer against the port's."""
    jp = jl.build(jax.random.PRNGKey(0), (None,) + in_shape)
    tp = keras_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy = jl.call(jax.tree_util.tree_map(lambda a: a.astype(jdt), jp),
                 jnp.asarray(x, jdt))
    w = np.linspace(-1.0, 1.0, int(np.prod(jy.shape)),
                    dtype=np.float32).reshape(jy.shape)

    def jloss(p, a):
        p = jax.tree_util.tree_map(lambda v: v.astype(jdt), p)
        return (jl.call(p, a.astype(jdt)).astype(jnp.float32) * w).sum()

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl.call(tree_map(lambda t: t.to(tdt), tree), tx.to(tdt))
    assert tuple(ty.shape) == tuple(jy.shape) == tuple(
        d for d in tl.compute_output_shape((B,) + in_shape))
    np.testing.assert_allclose(ty.float().detach().numpy(),
                               np.asarray(jy.astype(jnp.float32)), atol=tol)
    grads = torch.autograd.grad((ty.float() * torch.from_numpy(w)).sum(),
                                tree_leaves(tree) + [tx])
    want = _flat(jax.tree_util.tree_map(np.asarray, jgp))
    have = dict(zip(_flat(tree), grads[:-1]))
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k].numpy(), want[k], atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), atol=tol)


def _x(shape=(B, T, D), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("go_backwards", [False, True])
def test_recurrent_layers_match_jax(cls, return_sequences, go_backwards):
    kw = dict(return_sequences=return_sequences, go_backwards=go_backwards)
    _check(getattr(jlayers, cls)(H, **kw), getattr(tlayers, cls)(H, **kw),
           (T, D), _x())


@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
def test_recurrent_layers_match_jax_under_bf16_weights(cls):
    """bf16 inputs and weights; the f32 carry promotes each ``h @ U``
    to f32 in both packages, so the outputs come back f32."""
    _check(getattr(jlayers, cls)(H, return_sequences=True),
           getattr(tlayers, cls)(H, return_sequences=True), (T, D), _x(),
           dtype="bfloat16", tol=2e-2)


@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
def test_bidirectional_matches_jax(merge_mode, cls):
    _check(jlayers.Bidirectional(getattr(jlayers, cls)(
               H, return_sequences=True), merge_mode=merge_mode),
           tlayers.Bidirectional(getattr(tlayers, cls)(
               H, return_sequences=True), merge_mode=merge_mode),
           (T, D), _x(seed=1))


def test_time_distributed_matches_jax():
    _check(jlayers.TimeDistributed(jlayers.Dense(4, activation="tanh")),
           tlayers.TimeDistributed(tlayers.Dense(4, activation="tanh")),
           (T, D), _x(seed=2))


def test_stacked_lstms_in_a_sequential_match_jax():
    """AnomalyDetector's stack (return_sequences into a last LSTM) as
    one model: the port's predict equals JAX's."""
    from zoo_tpu.pipeline.api.keras import Sequential as JSeq

    from zoo_tpu_torch.pipeline.api.keras import Sequential
    jm, tm = JSeq(), Sequential()
    for m, L in ((jm, jlayers), (tm, tlayers)):
        m.add(L.LSTM(8, return_sequences=True, input_shape=(T, D)))
        m.add(L.GRU(4))
        m.add(L.Dense(1))
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(2), [(None, T, D)]))
    tm.params = keras_params_from_jax(tree, "cpu")
    x = _x((7, T, D), seed=3)
    np.testing.assert_allclose(tm.predict(x, device="cpu"),
                               np.asarray(jm.predict(x)), atol=TOL)


def test_hard_sigmoid_is_jaxs_relu6_form():
    x = np.concatenate([np.linspace(-5, 5, 101, dtype=np.float32),
                        _x().ravel()])
    got = get_activation_fn("hard_sigmoid")(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jact("hard_sigmoid")(x)))
    assert got[0] == 0.0 and got[100] == 1.0 and got[50] == 0.5


def test_bidirectional_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="recurrent"):
        tlayers.Bidirectional(tlayers.Dense(3))
    with pytest.raises(ValueError, match="merge_mode"):
        tlayers.Bidirectional(tlayers.LSTM(3), merge_mode="max")


def test_orthogonal_initializer():
    init = get_initializer("orthogonal")
    g = torch.Generator().manual_seed(0)
    for shape in ((6, 24), (24, 6), (8, 8)):
        q = init(g, shape)
        assert tuple(q.shape) == shape
        small = q.T @ q if shape[0] >= shape[1] else q @ q.T
        np.testing.assert_allclose(small.numpy(),
                                   np.eye(min(shape), dtype=np.float32),
                                   atol=1e-5)
