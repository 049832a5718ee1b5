"""The port's image-training slice against the JAX package: a tiny
ResNet's ``fit`` with ``SGD``, ``BatchNormalization`` in training,
``SGD`` against ``optax.sgd``, the metrics and ``evaluate``.

Both sides start from the same weights (the JAX tree carried over by
``keras_params_from_jax``, BatchNorm gamma and beta redrawn from a seed
so BN is not the identity) and fit the same numpy batches: two epochs
shuffled from seed 0. On the CPU the port's convs take the reference
conv, the conv kernel's plain version.

Tolerances, from the readings. f32: the per-epoch losses agreed to
1.5e-5 relative and the parameters and running stats to 2.5e-3 absolute
(1.1 % of a leaf's largest value) after 8 steps: one step agrees to
1e-7, but ``SGD(0.1, 0.9)`` on random labels drives the loss from 2.2
to 6, and that unstable run amplifies the two frameworks' different
summation orders; the test holds losses to rtol 1e-4 and leaves to
5e-3. ``mixed_bfloat16``: one step's update in bf16 lies ~20 % (by
norm, per leaf) from the f32 update in both frameworks alike, so eight
such steps leave nothing to compare leaf by leaf; the test holds the
per-epoch losses to rtol 0.1 (readings 1.8e-2 and 4.5e-2).

One ``mixed_bfloat16`` step is held to the JAX package's leaf by leaf,
two ways. Directly: the norm of port - JAX over the norm of the f32
update, with the JAX step compiled with ``xla_allow_excess_precision``
off, so that XLA rounds each op's result to bf16 as eager PyTorch does
(by default XLA keeps f32 inside a fusion, and the two steps then lie
several times farther apart). Readings: median over the leaves 0.024,
at most 0.060, but for the stem BatchNorm's beta, 0.257: its gradient
sums 1024 positions per channel that nearly cancel, and the two
frameworks' small differences in the activation gradients (PyTorch's
softmax and BatchNorm backward round once where XLA's composition
rounds each op) do not cancel with them. The test holds the median to
0.05, each leaf to 0.1 and the stem's beta to 0.35; BatchNorm's scale
and shift applied in f32 fails the median limit. As a second
witness, the port's distance from the f32 update is held to 1.5x the
JAX package's own plus 0.02 (readings: within 1.2x, but for the head's
bias, 0.005 against 0.003).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models.image import resnet as jresnet
from zoo_tpu.pipeline.api.keras import layers as jlayers
from zoo_tpu.pipeline.api.keras import metrics as jmetrics
from zoo_tpu.pipeline.api.keras.engine import topology as jtopology
from zoo_tpu.pipeline.api.keras.optimizers import SGD as JaxSGD

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.image import resnet as tresnet
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras import metrics as tmetrics
from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD, get_optimizer

jax.config.update("jax_platforms", "cpu")

FIT_TOL = {"float32": (1e-4, 5e-3), "mixed_bfloat16": (0.1, None)}


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.array(   # a copy: fit updates in place
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _redraw_affine(tree, rs):
    """BatchNorm gamma and beta drawn from ``rs``; the running stats
    keep their (0, 1) start, so a step's update is visible."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw_affine(v, rs)
        elif k == "beta":
            out[k] = jnp.asarray((rs.randn(*v.shape) * 0.1)
                                 .astype(np.float32))
        elif k == "gamma":
            out[k] = jnp.asarray(rs.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        else:
            out[k] = v
    return out


def _pair(policy, jopt, topt, metrics=None):
    jm = jresnet.ResNet(10, (1, 1), bottleneck=True,
                        input_shape=(32, 32, 3))
    jm.compile(jopt, "sparse_categorical_crossentropy", metrics=metrics,
               dtype_policy=policy)
    jm.build(jax.random.PRNGKey(0))
    jm.params = _redraw_affine(jm.params, np.random.RandomState(1))
    tm = tresnet.ResNet(10, (1, 1), bottleneck=True,
                        input_shape=(32, 32, 3))
    tm.compile(topt, "sparse_categorical_crossentropy", metrics=metrics,
               dtype_policy=policy)
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _data(n=16, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_tiny_resnet_fit_sgd_matches_jax(policy):
    jm, tm = _pair(policy, JaxSGD(lr=0.1, momentum=0.9),
                   SGD(lr=0.1, momentum=0.9))
    start = _flat(tm.params)
    x, y = _data()
    ref = jm.fit(x, y, batch_size=4, nb_epoch=2, shuffle=True, seed=0,
                 verbose=0)
    got = tm.fit(x, y, batch_size=4, nb_epoch=2, shuffle=True, seed=0,
                 verbose=0, device="cpu")
    loss_tol, param_tol = FIT_TOL[policy]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=loss_tol)
    jf = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    tf = _flat(tm.params)
    assert set(jf) == set(tf) == set(start)
    for k in jf:
        assert tf[k].dtype == np.float32 and np.isfinite(tf[k]).all(), k
        # every leaf moved, the running stats away from (0, 1) too
        assert float(np.abs(tf[k] - start[k]).max()) > 1e-3, k
        if param_tol is not None:
            np.testing.assert_allclose(tf[k], jf[k], rtol=0,
                                       atol=param_tol, err_msg=k)


def test_one_bf16_step_is_as_close_to_f32_as_jax():
    """One ``mixed_bfloat16`` step's update, per leaf, lies no farther
    from the f32 update than the JAX package's bf16 update does (within
    1.5x its distance plus 0.02, by norm)."""
    x, y = _data(4)
    updates = {}
    for policy in ("float32", "mixed_bfloat16"):
        jm, tm = _pair(policy, JaxSGD(lr=0.1, momentum=0.9),
                       SGD(lr=0.1, momentum=0.9))
        start = _flat(tm.params)
        jm.fit(x, y, batch_size=4, nb_epoch=1, shuffle=False, verbose=0)
        tm.fit(x, y, batch_size=4, nb_epoch=1, shuffle=False, verbose=0,
               device="cpu")
        updates[policy] = [
            {k: v - start[k] for k, v in _flat(tree).items()}
            for tree in (jax.tree_util.tree_map(np.asarray, jm.params),
                         tm.params)]
    truth = updates["float32"][0]
    jax_bf16, port_bf16 = updates["mixed_bfloat16"]
    for k, want in truth.items():
        if "/stats/" in k:
            continue
        n = np.linalg.norm(want)
        jax_err = np.linalg.norm(jax_bf16[k] - want) / n
        port_err = np.linalg.norm(port_bf16[k] - want) / n
        assert port_err <= 1.5 * jax_err + 0.02, (k, port_err, jax_err)


def _jax_bf16_update(jm, x, y, lr):
    """The JAX package's first ``SGD(lr)`` step under ``mixed_bfloat16``
    (its train step's loss, ``topology.py:464-476``; the first update is
    ``-lr`` times the gradient), compiled with every op rounded to its
    result's dtype."""
    trainable, state = jtopology._split_state(jm.params)

    def loss_fn(tr):
        preds = jm._forward(
            jtopology._merge_state(jm._cast_compute(tr), state),
            jm._cast_compute([jnp.asarray(x)]), training=True,
            rng=jax.random.PRNGKey(0), collect={})
        return jm.loss_fn(jnp.asarray(y), preds.astype(jnp.float32))
    step = jax.jit(jax.grad(loss_fn)).lower(trainable).compile(
        compiler_options={"xla_allow_excess_precision": False})
    grads = jax.tree_util.tree_map(np.asarray, step(trainable))
    return {k: -lr * v for k, v in _flat(grads).items()}


def test_one_bf16_step_matches_jax_per_leaf():
    """One ``mixed_bfloat16`` step's update, per leaf, against the JAX
    package's bf16 step (tolerances in the module docstring)."""
    x, y = _data(4)
    jm, tm = _pair("float32", JaxSGD(lr=0.1, momentum=0.9),
                   SGD(lr=0.1, momentum=0.9))
    start = _flat(tm.params)
    jm.fit(x, y, batch_size=4, nb_epoch=1, shuffle=False, verbose=0)
    truth = {k: v - start[k] for k, v in _flat(
        jax.tree_util.tree_map(np.asarray, jm.params)).items()}
    jm, tm = _pair("mixed_bfloat16", JaxSGD(lr=0.1, momentum=0.9),
                   SGD(lr=0.1, momentum=0.9))
    want = _jax_bf16_update(jm, x, y, 0.1)
    tm.fit(x, y, batch_size=4, nb_epoch=1, shuffle=False, verbose=0,
           device="cpu")
    got = {k: v - start[k] for k, v in _flat(tm.params).items()
           if "/stats/" not in k}
    assert set(got) == set(want)
    errs = {k: np.linalg.norm(got[k] - want[k]) / np.linalg.norm(truth[k])
            for k in want}
    assert np.median(list(errs.values())) <= 0.05, errs
    for k, e in errs.items():
        limit = 0.35 if k == "001_batchnormalization/beta" else 0.1
        assert e <= limit, (k, e)


def test_fit_differentiates_only_the_trainable_leaves():
    """The running stats take no gradient and no optimizer state; they
    are replaced by the BatchNorm updates after the step."""
    _, tm = _pair("float32", JaxSGD(lr=0.1), SGD(lr=0.1, momentum=0.9))
    x, y = _data(8)
    tm.fit(x, y, batch_size=4, nb_epoch=1, verbose=0, device="cpu")
    stats = [k for k in _flat(tm.params) if "/stats/" in k]
    assert len(stats) == 2 * 9          # 9 BatchNorm layers
    assert tm._opt_state["count"] == 2
    momentum = _flat(tm._opt_state["momentum"])
    assert set(momentum) == set(_flat(tm.params)) - set(stats)
    for k, v in _flat(tm.params).items():
        t = tm.params
        for part in k.split("/"):
            t = t[part]
        assert t.requires_grad == ("/stats/" not in k), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_normalization_training_matches_jax(dtype):
    rs = np.random.RandomState(5)
    x = (rs.randn(4, 5, 5, 6) * 2 + 1).astype(np.float32)
    p = {"gamma": rs.uniform(0.5, 1.5, 6).astype(np.float32),
         "beta": rs.randn(6).astype(np.float32),
         "stats": {"mean": rs.randn(6).astype(np.float32),
                   "var": rs.uniform(0.5, 1.5, 6).astype(np.float32)}}
    jl, tl = jlayers.BatchNormalization(), tlayers.BatchNormalization()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tp = keras_params_from_jax(p, "cpu")
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jl.call(jp, jx, training=True)
    got = tl.call(tp, tx, training=True)
    assert got.dtype == tx.dtype
    # f32: the same moments summed in another order; bf16: one bf16
    # rounding of O(1) outputs, 2**-6 at most
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=tol)
    ref_stats = jl.updated_stats(jp, jx)
    got_stats = tl.updated_stats(tp, tx)
    out, fused_stats = tl.call_and_update(tp, tx)
    assert torch.equal(out, got)
    for k in ("mean", "var"):
        assert got_stats[k].dtype == torch.float32
        np.testing.assert_allclose(got_stats[k].numpy(),
                                   np.asarray(ref_stats[k]), rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(fused_stats[k], got_stats[k])

    # the gradient flows through the batch moments, as jax.grad's does
    g = rs.randn(*x.shape).astype(np.float32)

    def jloss(xx, gamma, beta):
        q = dict(jp, gamma=gamma, beta=beta)
        return jnp.sum(jl.call(q, xx, training=True) * g)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jp["gamma"],
                                            jp["beta"])
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (x, p["gamma"], p["beta"])]
    q = dict(tp, gamma=leaves[1], beta=leaves[2])
    tg = torch.autograd.grad(
        (tl.call(q, leaves[0], training=True) * torch.from_numpy(g)).sum(),
        leaves)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("kw", [dict(lr=0.1, momentum=0.9),
                                dict(lr=0.1, momentum=0.9, decay=0.5),
                                dict(lr=0.05, momentum=0.9, nesterov=True),
                                dict(lr=0.2),
                                dict(lr=0.1, decay=0.1, nesterov=True)],
                         ids=["momentum", "decay", "nesterov", "plain",
                              "decay-nesterov"])
def test_sgd_matches_optax(kw):
    """Three updates of two leaves against the JAX ``SGD``'s optax
    transformation: the same f32 arithmetic, within 1e-6."""
    rs = np.random.RandomState(2)
    params = {"a": rs.randn(7, 5).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = JaxSGD(**kw).make()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    opt = SGD(**kw)
    assert opt.fused == (not kw.get("nesterov", False))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = opt.apply({k: torch.from_numpy(v) for k, v in g.items()},
                               tstate, tp)
    assert tstate["count"] == 3
    for k in params:
        assert float(np.abs(tp[k].numpy() - params[k]).max()) > 1e-2
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


def test_sgd_contract():
    assert isinstance(get_optimizer("sgd"), SGD)
    assert get_optimizer("SGD").lr == 0.01
    assert SGD(learningrate_schedule=lambda step: 0.1).schedule is not None
    opt = SGD(lr=0.1, decay=0.5)
    state = opt.init({"w": torch.zeros(3)})

    def rate(count):
        return float(opt.rate(state, torch.tensor(count, dtype=torch.int32)))

    assert rate(0) == pytest.approx(0.1)
    assert rate(2) == float(np.float32(0.1) / np.float32(2.0))


def _metric_inputs(name, rs):
    if name in ("mae", "mse"):
        return rs.randn(8, 3).astype(np.float32), \
            rs.randn(8, 3).astype(np.float32)
    if name in ("auc", "binary_crossentropy"):
        return (rs.rand(40, 1) > 0.5).astype(np.float32), \
            rs.rand(40, 1).astype(np.float32)
    logits = rs.randn(12, 10).astype(np.float32)
    logits[0, :3] = 5.0                       # a tie: the first max wins
    return rs.randint(0, 10, 12).astype(np.int32), logits


@pytest.mark.parametrize("name", ["accuracy", "sparse_categorical_accuracy",
                                  "top5_accuracy", "mae", "mse",
                                  "binary_crossentropy", "auc"])
def test_metrics_match_jax(name):
    rs = np.random.RandomState(3)
    jm_, tm_ = jmetrics.get_metric(name), tmetrics.get_metric(name)
    assert jm_.name == tm_.name
    totals = []
    for metric, conv in ((jm_, jnp.asarray), (tm_, torch.from_numpy)):
        parts = [metric.batch_eval(*(conv(a) for a in
                                     _metric_inputs(name, rs)))
                 for _ in range(2)]
        s = parts[0][0] + parts[1][0]
        c = parts[0][1] + parts[1][1]
        totals.append(float(np.asarray(metric.finalize(s, c))))
        rs = np.random.RandomState(3)
    np.testing.assert_allclose(totals[1], totals[0], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.get_metric("f1")


def test_accuracy_one_hot_and_binary_match_jax():
    rs = np.random.RandomState(4)
    probs = rs.rand(9, 4).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 9)]
    binary = (rs.rand(9, 1), rs.rand(9, 1))
    for yt, yp in ((onehot, probs), binary):
        ref = jmetrics.Accuracy().batch_eval(jnp.asarray(yt),
                                             jnp.asarray(yp))
        got = tmetrics.Accuracy().batch_eval(torch.from_numpy(yt),
                                             torch.from_numpy(yp))
        assert float(got[0]) == float(ref[0])
        assert float(got[1]) == float(ref[1])


@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_evaluate_matches_jax(policy):
    """Streaming ``evaluate`` (batches of 4 over 10 images: a padded
    tail) on the same weights: the loss within 1e-5 relative (f32) or
    1e-2 (bf16 rounds elsewhere), the accuracies equal."""
    metrics = ["accuracy", "top5_accuracy"]
    jm, tm = _pair(policy, JaxSGD(lr=0.1), SGD(lr=0.1), metrics)
    x, y = _data(10, seed=6)
    ref = jm.evaluate(x, y, batch_size=4)
    got = tm.evaluate(x, y, batch_size=4, device="cpu")
    assert set(got) == set(ref) == {"loss", "accuracy", "top5_accuracy"}
    np.testing.assert_allclose(got["loss"], ref["loss"],
                               rtol=1e-5 if policy == "float32" else 1e-2)
    if policy == "float32":
        assert got["accuracy"] == ref["accuracy"]
        assert got["top5_accuracy"] == ref["top5_accuracy"]
    one_batch = tm.evaluate(x, y, batch_size=10, device="cpu")
    np.testing.assert_allclose(one_batch["loss"], got["loss"], rtol=1e-5)
    with pytest.raises(ValueError, match="labels"):
        tm.evaluate(x, device="cpu")


def test_training_entry_points_raise_without_a_card(monkeypatch):
    """No GPU and no ``device=``: ``fit`` and ``evaluate`` raise instead
    of carrying on on the CPU."""
    _, tm = _pair("float32", JaxSGD(lr=0.1), SGD(lr=0.1), ["accuracy"])
    x, y = _data(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tm.fit(x, y, batch_size=4, verbose=0),
                 lambda: tm.evaluate(x, y, batch_size=4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert set(tm.evaluate(x, y, batch_size=4, device="cpu")) == \
        {"loss", "accuracy"}
