"""Dropout in the port against the JAX package: ``Dropout``,
``SpatialDropout1D``/``2D``, the dense attention's dropout and BERT's
training forward draw JAX's threefry masks from the same keys, and a
``fit`` draws them at every step of the JAX fit's key chain.

Tolerances: f32 masks, outputs and vjps are bit-equal (the mask is
integer work and the scaling one IEEE division in both). In bf16 the
outputs and vjps are bit-equal too: both divide in f32 by the divisor
rounded to bf16 and round the quotient once; a test names any ulp it
finds apart. The attention and BERT outputs, whose products are summed
in another order, agree within 1e-5 absolute in f32 with the masks
bit-equal. ``fit`` losses as the other f32 fit tests hold them: rtol
1e-4 per epoch, parameters within 1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.ops import attention as jattention
from zoo_tpu.orca.learn import guard as jguard
from zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from zoo_tpu.pipeline.api.keras import layers as jlayers

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.ops import attention as tattention
from zoo_tpu_torch.ops import random as R
from zoo_tpu_torch.ops.kernels import dropout as D
from zoo_tpu_torch.orca.learn.guard import GuardConfig, TrainingGuard
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    layer_rng,
    tree_leaves,
    tree_map,
)

jax.config.update("jax_platforms", "cpu")

KEY_SEEDS = (0, 7, 2024)


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _keys(seed):
    return jax.random.PRNGKey(seed), R.PRNGKey(seed)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().detach().numpy()


def _ulps_apart(a, b):
    """Elements where two bf16 arrays (as f32) differ, for the message."""
    idx = np.flatnonzero(a.ravel() != b.ravel())
    return [(int(i), float(a.ravel()[i]), float(b.ravel()[i]))
            for i in idx[:8]]


def _fwd_vjp(jfn, tfn, x, g, dtype):
    """(JAX out, port out, JAX vjp, port vjp) as f32 numpy."""
    jx = jnp.asarray(x, dtype)
    jy, vjp = jax.vjp(jfn, jx)
    jg = vjp(jnp.asarray(g, dtype))[0]
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    ty = tfn(tx)
    ty.backward(torch.from_numpy(g).to(getattr(torch, dtype)))
    return _f32(jy), _f32(ty), _f32(jg), _f32(tx.grad)


def _assert_bit_equal(want, got, what):
    assert np.array_equal(want, got), f"{what}: apart at " \
        f"{_ulps_apart(want, got)}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", KEY_SEEDS)
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_layer_is_bit_equal_to_jax(dtype, seed, p):
    jk, tk = _keys(seed)
    rs = np.random.RandomState(seed)
    x = rs.randn(5, 7, 9).astype(np.float32)
    g = rs.randn(5, 7, 9).astype(np.float32)
    jl, tl = jlayers.Dropout(p, name="drop"), tlayers.Dropout(p, name="drop")
    out = _fwd_vjp(lambda a: jl.call({}, a, training=True, rng=jk),
                   lambda a: tl.call({}, a, training=True, rng=tk), x, g,
                   dtype)
    _assert_bit_equal(out[0], out[1], f"{dtype} forward")
    _assert_bit_equal(out[2], out[3], f"{dtype} vjp")
    kept = (out[1] != 0).mean()
    assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / x.size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,shape", [
    ("1d", (4, 6, 5)), ("2d_th", (3, 4, 5, 6)), ("2d_tf", (3, 5, 6, 4))])
def test_spatial_dropout_is_bit_equal_to_jax(dtype, kind, shape):
    jk, tk = _keys(11)
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    if kind == "1d":
        jl, tl = (jlayers.SpatialDropout1D(0.4, name="sd"),
                  tlayers.SpatialDropout1D(0.4, name="sd"))
    else:
        order = kind[-2:]
        jl = jlayers.SpatialDropout2D(0.4, dim_ordering=order, name="sd")
        tl = tlayers.SpatialDropout2D(0.4, dim_ordering=order, name="sd")
    out = _fwd_vjp(lambda a: jl.call({}, a, training=True, rng=jk),
                   lambda a: tl.call({}, a, training=True, rng=tk), x, g,
                   dtype)
    _assert_bit_equal(out[0], out[1], f"{kind} {dtype} forward")
    _assert_bit_equal(out[2], out[3], f"{kind} {dtype} vjp")


def test_dropout_layers_are_the_identity_outside_training():
    x3, x4 = torch.randn(3, 4, 5), torch.randn(3, 4, 5, 6)
    for layer, x in ((tlayers.Dropout(0.5), x4),
                     (tlayers.SpatialDropout1D(0.5), x3),
                     (tlayers.SpatialDropout2D(0.5), x4)):
        assert layer.call({}, x) is x
    with pytest.raises(ValueError, match="rng"):
        tlayers.Dropout(0.5).call({}, x4, training=True)


def test_layer_rng_is_jaxs():
    jk, tk = _keys(5)
    from zoo_tpu.pipeline.api.keras.engine.base import layer_rng as jrng
    for name in ("dropout_1", "bert", "text_classifier/dense_9"):
        assert np.array_equal(np.asarray(jrng(jk, name)).astype(np.int64),
                              layer_rng(tk, name).numpy())
    assert layer_rng(None, "x") is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_dropout_matches_jax(dtype):
    """The masks of the probabilities are JAX's; the outputs and the
    gradients in q, k, v agree within 1e-5 in f32 (2e-2 in bf16, whose
    probabilities round before the mask)."""
    jk, tk = _keys(9)
    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(2, 3, 8, 4).astype(np.float32) for _ in range(3))
    do = rs.randn(2, 3, 8, 4).astype(np.float32)

    def jfn(q, k, v):
        return jattention.dot_product_attention(
            q, k, v, dropout_p=0.3, dropout_rng=jk, impl="dense")

    jargs = [jnp.asarray(a, dtype) for a in (q, k, v)]
    jy, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(do, dtype))
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
             for a in (q, k, v)]
    ty = tattention.dot_product_attention(*targs, dropout_p=0.3,
                                          dropout_rng=tk, impl="auto")
    ty.backward(torch.from_numpy(do).to(getattr(torch, dtype)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(ty), _f32(jy), atol=tol)
    for jg, t in zip(jgrads, targs):
        np.testing.assert_allclose(_f32(t.grad), _f32(jg), atol=tol)
    # the mask itself is JAX's, bit for bit
    probs = torch.full((2, 3, 8, 8), 0.125)
    jm = np.asarray(jax.random.bernoulli(jk, 0.7, (2, 3, 8, 8)))
    assert np.array_equal(D.dropout(probs, tk, 0.3).numpy() != 0, jm)
    with pytest.raises(ValueError, match="dropout"):
        tattention.dot_product_attention(*targs, dropout_p=0.3,
                                         dropout_rng=tk, impl="flash")


def _net(seq_cls, layers_mod, guard=None):
    m = seq_cls()
    m.add(layers_mod.Dense(32, input_shape=(8,), activation="relu",
                           name="d1"))
    m.add(layers_mod.Dropout(0.3, name="drop"))
    m.add(layers_mod.Dense(1, name="d2"))
    m.compile(optimizer="adam", loss="mse")
    if guard is not None:
        m.set_guard(guard)
    return m


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.array(
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def test_fit_draws_jaxs_masks_at_every_step_and_on_a_skipped_one():
    """Two epochs of a superbatch of 4 steps, the third batch of each a
    NaN the guard skips: the key chain splits on every step, the
    skipped one too, so every later step's mask is JAX's and the fit
    ends where JAX's ends."""
    rs = np.random.RandomState(0)
    x = rs.randn(128, 8).astype(np.float32)
    y = (x @ rs.randn(8, 1)).astype(np.float32)
    x[64:96] = np.nan                       # batch 2 of 4, unshuffled
    jm = _net(JaxSequential, jlayers, jguard.TrainingGuard(
        config=jguard.GuardConfig(enabled=True, max_skips=100,
                                  preempt_signal="none")))
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(1), [(None, 8)]))
    ref = jm.fit(x, y, batch_size=32, nb_epoch=2, shuffle=False, seed=3,
                 verbose=0)
    tm = _net(Sequential, tlayers, TrainingGuard(config=GuardConfig(
        enabled=True, max_skips=100, preempt_signal="none")))
    tm.params = keras_params_from_jax(tree, "cpu")
    got = tm.fit(x, y, batch_size=32, nb_epoch=2, shuffle=False, seed=3,
                 verbose=0, device="cpu")
    assert tm._step == jm._step == 8
    assert tm._superbatch_group([x, y], 32, 4) == 4
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    want, have = _flat(jax.tree_util.tree_map(np.asarray, jm.params)), \
        _flat(tm.params)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-4, err_msg=k)
    # a different seed draws other masks: the params end elsewhere
    tm2 = _net(Sequential, tlayers, TrainingGuard(config=GuardConfig(
        enabled=True, max_skips=100, preempt_signal="none")))
    tm2.params = keras_params_from_jax(tree, "cpu")
    tm2.fit(x, y, batch_size=32, nb_epoch=2, shuffle=False, seed=4,
            verbose=0, device="cpu")
    assert not np.allclose(_flat(tm2.params)["000_dense/W"],
                           have["000_dense/W"], atol=1e-4)


def test_fit_step_keys_are_the_jax_chain():
    """The keys a fit hands its forward: ``split`` of ``PRNGKey(seed +
    1)`` per step, ``step_rng`` the first half (seen by a recording
    layer)."""
    seen = []

    class Record(tlayers.InputLayer):
        def call(self, params, inputs, *, training=False, rng=None):
            if training:
                seen.append(rng.clone())
            return inputs

    m = Sequential()
    m.add(Record(input_shape=(4,)))
    m.add(tlayers.Dense(1))
    m.compile(optimizer="sgd", loss="mse")
    x = np.ones((12, 4), np.float32)
    m.fit(x, x[:, :1], batch_size=4, nb_epoch=1, shuffle=False, seed=5,
          verbose=0, device="cpu")
    rng = jax.random.PRNGKey(6)
    for key in seen:
        step_rng, rng = jax.random.split(rng)
        assert np.array_equal(np.asarray(step_rng).astype(np.int64),
                              key.numpy())
    assert len(seen) == 3
    # evaluate and predict pass no rng
    seen.clear()
    m.predict(x, device="cpu")
    m.evaluate(x, x[:, :1], device="cpu")
    assert seen == []


def _bert(cls, **kw):
    return cls(vocab=40, seq_len=12, hidden_size=32, n_block=2, n_head=4,
               intermediate_size=64, max_position_len=12,
               hidden_p_drop=0.1, attn_p_drop=0.1, name="bert", **kw)


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_bert_training_forward_at_published_dropout_matches_jax(remat):
    """BERT-tiny at ``hidden_p_drop = attn_p_drop = 0.1``: the training
    forward (dense attention, as ``auto`` picks with dropout) and its
    gradients under each remat mode match JAX's under the same key, and
    the recompute draws the same masks (gradients equal across
    modes)."""
    jk, tk = _keys(21)
    jl = _bert(jlayers.BERT)
    jp = jl.build(jax.random.PRNGKey(3), (None, 12))
    tp = keras_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    ids = np.random.RandomState(2).randint(0, 40, (3, 12)).astype(np.int32)
    w = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
    jy = jl.call(jp, jnp.asarray(ids), training=True, rng=jk)
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: (jl.call(p, jnp.asarray(ids), training=True, rng=jk)
                   * w).sum() / (ids.size * 32))(jp)))
    tl = _bert(tlayers.BERT, remat=remat)
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    ty = tl.call(tree, torch.from_numpy(ids), training=True, rng=tk)
    assert tl.last_attention_impl == "dense"
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum()
                                / (ids.size * 32),
                                tree_leaves(tree), allow_unused=True,
                                materialize_grads=True)
    have = dict(zip(_flat(tree), grads))
    for k, g in have.items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], atol=1e-5,
                                   err_msg=k)
    # without the rng (or at inference) no mask is drawn, as in JAX
    np.testing.assert_allclose(
        tl.call(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(jl.call(jp, jnp.asarray(ids))), atol=1e-5)


def test_the_kernel_route_redraws_the_mask_in_its_backward(monkeypatch):
    """The card's route on the CPU: the autograd function around the
    kernel, its launch swapped for the plain forward. Under each remat
    mode BERT-tiny's outputs and gradients equal the plain route's bit
    for bit: the backward draws each mask again from its saved key, and
    the recompute of ``remat`` from the same keys. The launches counted:
    3 forward sites a block, their 3 backward draws, and the MLP site's
    recompute under ``"dots"`` (the whole block's 3 under ``True``)."""
    def launch(x, key, keep, div, inner, c):
        assert inner == 1 and c == x.numel()
        D.LAUNCHES += 1
        mask = R.bernoulli(key, keep, x.shape)
        return torch.where(mask, (x.float() / div).to(x.dtype),
                           torch.zeros((), dtype=x.dtype))

    _, tk = _keys(13)
    jl = _bert(jlayers.BERT)
    tp = keras_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.build(jax.random.PRNGKey(3), (None, 12))), "cpu")
    ids = torch.from_numpy(
        np.random.RandomState(6).randint(0, 40, (2, 12)).astype(np.int32))

    def run(remat):
        tl = _bert(tlayers.BERT, remat=remat)
        tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
        out = tl.call(tree, ids, training=True, rng=tk)
        grads = torch.autograd.grad(out.square().mean(), tree_leaves(tree),
                                    allow_unused=True,
                                    materialize_grads=True)
        return out.detach(), grads

    plain = run(False)
    monkeypatch.setattr(D, "resolve_dropout_impl", lambda device: "cuda")
    monkeypatch.setattr(D, "_launch", launch)
    monkeypatch.setattr(D, "derive_keys", R.derive)
    for remat, per_block in ((False, 6), (True, 9), ("dots", 7)):
        D.LAUNCHES = 0
        out, grads = run(remat)
        assert D.LAUNCHES == 2 * per_block, remat
        assert torch.equal(out, plain[0]), remat
        for a, b in zip(grads, plain[1]):
            assert torch.equal(a, b), remat


def test_under_jit_xla_multiplies_by_the_reciprocal_an_ulp_apart():
    """The port divides as JAX's eager layer does (bit-equal above).
    Under ``jit`` (JAX's train step) XLA rewrites ``x / keep`` as ``x *
    (1 / keep)``: in f32 some elements land one ulp apart, never more,
    and the masks stay equal; in bf16 the two round alike here."""
    jk, tk = _keys(2)
    x = np.random.RandomState(8).randn(4096).astype(np.float32)
    jl, tl = jlayers.Dropout(0.1, name="d"), tlayers.Dropout(0.1, name="d")
    jitted = np.asarray(jax.jit(
        lambda a: jl.call({}, a, training=True, rng=jk))(x))
    got = tl.call({}, torch.from_numpy(x), training=True, rng=tk).numpy()
    assert np.array_equal(got != 0, jitted != 0)
    ulps = np.abs(got.view(np.int32) - jitted.view(np.int32))
    assert ulps.max() <= 1 and ulps.sum() > 0
