"""The port's learning-rate schedules and optimizers against the JAX
package's: every orca schedule's rate at counts 0-2000, each keras-1
optimizer over 5 updates against the JAX class's optax transform, the
guard's skip (``ok`` false) leaving every parameter and state leaf
bit-unchanged, and gradient clipping and Plateau through ``fit``.

Tolerances: schedules within 2 f32 ulp of the JAX schedule's value,
evaluated op by op (``jax.vmap`` without ``jit``: under ``jit`` XLA
turns a division by a constant into a multiplication by its reciprocal
and contracts multiply-adds, which moves ``Poly``'s rate at the clamp
edge by more than that); the warmup-cosine schedule within 2 ulp of its
peak (its cosine cancels near the end, where one ulp of ``cos``
is many of the small result). Optimizers: rtol 1e-6 (the same f32
elementwise arithmetic; rsqrt, powers and norms may round to the other
neighbour), plus atol 1e-6 for AdamW, whose update is the fused
kernel's expression (``m * bc1 / (sqrt(v * bc2) + eps)``) against
optax's ``mu / bc1 / (sqrt(nu / bc2) + eps)``. Through ``fit``: f32
losses rtol 1e-4, params atol 1e-4 (``test_torch_keras.py``'s bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.orca.learn.optimizers import schedule as JS
from zoo_tpu.pipeline.api.keras import optimizers as JO
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.orca.learn.optimizers import schedule as TS
from zoo_tpu_torch.pipeline.api.keras import optimizers as TO
from zoo_tpu_torch.pipeline.api.keras import Sequential as TSeq
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
from zoo_tpu_torch.pipeline.api.keras.layers import Dense as TDense

jax.config.update("jax_platforms", "cpu")

COUNTS = np.arange(0, 2001, dtype=np.int32)


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _schedules(m):
    return {
        "default": m.Default(),
        "poly": m.Poly(0.5, 1500),
        "poly_square": m.Poly(2.0, 1000),
        "exponential": m.Exponential(100, 0.9),
        "exponential_stair": m.Exponential(100, 0.9, stair_case=True),
        "step": m.Step(300, 0.5),
        "multistep": m.MultiStep([100, 700, 1500], 0.1),
        "warmup": m.Warmup(1e-4),
        "sequential": m.SequentialSchedule(5).add(m.Warmup(2e-4), 200)
        .add(m.Poly(1.0, 1000), 1000).add(m.Exponential(50, 0.95), 10),
        "plateau": m.Plateau(),
    }


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _port_rates(fn, counts):
    return np.array([float(fn(torch.tensor(int(c), dtype=torch.int32)))
                     for c in counts], np.float32)


@pytest.mark.parametrize("name", sorted(_schedules(JS)))
def test_schedule_matches_jax_within_two_ulp(name):
    base = 0.05
    want = np.asarray(jax.vmap(_schedules(JS)[name].get_scheduler(base))(
        jnp.asarray(COUNTS)), np.float32)
    got = _port_rates(_schedules(TS)[name].get_scheduler(base), COUNTS)
    assert got.shape == want.shape
    assert _ulps(got, want).max() <= 2, name


def test_warmup_cosine_matches_optax():
    """``AdamWeightDecay(total_steps=2000, warmup_ratio=0.05)``'s
    schedule: optax's ``warmup_cosine_decay_schedule(0, lr, 100,
    2000)``."""
    want = np.asarray(jax.vmap(optax.warmup_cosine_decay_schedule(
        0.0, 0.05, 100, 2000))(jnp.asarray(COUNTS)), np.float32)
    opt = TO.AdamWeightDecay(lr=0.05, total_steps=2000, warmup_ratio=0.05)
    assert isinstance(opt.schedule, TS.WarmupCosineDecay)
    got = _port_rates(opt.schedule.get_scheduler(0.05), COUNTS)
    assert np.abs(got - want).max() <= 2 * np.spacing(np.float32(0.05))


SHAPES = {"a": {"W": (5, 7), "b": (7,)}, "c": {"W": (3,)}}

OPT_CASES = [
    ("SGD", dict(lr=0.1, momentum=0.9)),
    ("SGD", dict(lr=0.1, momentum=0.9, decay=0.3)),
    ("SGD", dict(lr=0.1, nesterov=True, momentum=0.5)),
    ("SGD", dict(lr=0.1, learningrate_schedule="step")),
    ("Adam", dict(lr=0.01)),
    ("Adam", dict(lr=0.01, decay=0.1)),
    ("Adam", dict(lr=0.01, learningrate_schedule="poly")),
    ("RMSprop", dict(lr=0.01)),
    ("RMSprop", dict(lr=0.01, rho=0.8, decay=0.2)),
    ("Adagrad", dict(lr=0.1)),
    ("Adagrad", dict(lr=0.1, learningrate_schedule="exponential")),
    ("Adadelta", dict(lr=1.0)),
    ("Adadelta", dict(lr=0.5, rho=0.9, decay=0.1)),
    ("Adamax", dict(lr=0.02)),
    ("Adamax", dict(lr=0.02, learningrate_schedule="warmup")),
    ("LARS", dict(lr=0.5)),
    ("LARS", dict(lr=0.5, momentum=0.5, weight_decay=1e-2,
                  learningrate_schedule="multistep")),
    ("AdamWeightDecay", dict(lr=0.01, fused=False)),
    ("AdamWeightDecay", dict(lr=0.01, total_steps=10, warmup_ratio=0.3)),
]


def _sched(mod, name):
    return {"step": lambda: mod.Step(2, 0.5),
            "poly": lambda: mod.Poly(1.0, 6),
            "exponential": lambda: mod.Exponential(2, 0.8),
            "warmup": lambda: mod.Warmup(0.01),
            "multistep": lambda: mod.MultiStep([1, 3], 0.5)}[name]()


def _kwargs(kw, mod):
    out = dict(kw)
    if isinstance(out.get("learningrate_schedule"), str):
        out["learningrate_schedule"] = _sched(
            mod, out["learningrate_schedule"])
    return out


def _trees(seed):
    rs = np.random.RandomState(seed)

    def tree():
        return {k: {kk: rs.randn(*s).astype(np.float32)
                    for kk, s in v.items()} for k, v in SHAPES.items()}
    return tree(), [tree() for _ in range(5)]


def _torch(tree):
    return {k: {kk: torch.tensor(a) for kk, a in v.items()}
            for k, v in tree.items()}


@pytest.mark.parametrize("name,kw", OPT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPT_CASES)])
def test_optimizer_matches_optax_over_five_updates(name, kw):
    p0, gs = _trees(3)
    tx = getattr(JO, name)(**_kwargs(kw, JS)).make()
    jp = jax.tree.map(jnp.asarray, p0)
    st = tx.init(jp)
    opt = getattr(TO, name)(**_kwargs(kw, TS))
    tp = _torch(p0)
    ts = opt.init(tp)
    for g in gs:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.apply(_torch(g), ts, tp)
    count = ts["step"] if name == "AdamWeightDecay" else ts["count"]
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == 5
    atol = 1e-6 if name == "AdamWeightDecay" else 0.0
    for (k, kk) in ((k, kk) for k in SHAPES for kk in SHAPES[k]):
        moved = np.abs(tp[k][kk].numpy() - p0[k][kk]).max()
        assert moved > 1e-4, (k, kk)
        np.testing.assert_allclose(tp[k][kk].numpy(), np.asarray(jp[k][kk]),
                                   rtol=1e-6, atol=atol, err_msg=f"{k}/{kk}")


@pytest.mark.parametrize("name,kw", OPT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPT_CASES)])
def test_skipped_update_leaves_params_and_state_bit_unchanged(name, kw):
    """The guard's ``ok`` false: parameters and every state leaf, the
    device count included, keep their bits, though the gradient is NaN;
    ``ok`` true afterwards updates as usual."""
    p0, gs = _trees(4)
    opt = getattr(TO, name)(**_kwargs(kw, TS))
    tp = _torch(p0)
    state = opt.init(tp)
    tp, state = opt.apply(_torch(gs[0]), state, tp)
    before = [t.clone() for t in tree_leaves(tp) + tree_leaves(state)]
    nan = {k: {kk: torch.full_like(t, float("nan")) for kk, t in v.items()}
           for k, v in tp.items()}
    tp, state = opt.apply(nan, state, tp, ok=torch.tensor(False))
    after = tree_leaves(tp) + tree_leaves(state)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tp, state = opt.apply(_torch(gs[1]), state, tp, ok=torch.tensor(True))
    key = "step" if name == "AdamWeightDecay" else "count"
    assert int(state[key]) == 2


def test_fused_with_a_schedule_raises():
    with pytest.raises(ValueError, match="constant lr"):
        TO.AdamWeightDecay(fused=True, total_steps=100)
    with pytest.raises(ValueError, match="constant lr"):
        TO.AdamWeightDecay(fused=True,
                           learningrate_schedule=TS.Poly(1.0, 10))
    with pytest.raises(ValueError, match="constant lr"):
        TO.AdamWeightDecay(fused=True, learningrate_schedule=TS.Plateau())
    assert not TO.AdamWeightDecay(total_steps=10).fused


def _mlp_pair(opt_j, opt_t, seed=0):
    jm = JSeq()
    jm.add(JDense(16, input_shape=(8,), activation="relu"))
    jm.add(JDense(1))
    jm.compile(optimizer=opt_j, loss="mse")
    jm.build(jax.random.PRNGKey(seed), [(None, 8)])
    tm = TSeq()
    tm.add(TDense(16, input_shape=(8,), activation="relu"))
    tm.add(TDense(1))
    tm.compile(optimizer=opt_t, loss="mse")
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _regression(n=256, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    return x, (x @ rs.randn(8, 1) * 3.0).astype(np.float32)


def _assert_params_close(jm, tm):
    want = jax.tree_util.tree_leaves(jm.params)
    have = tree_leaves(tm.params)
    assert len(want) == len(have)
    for a, b in zip(have, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-4)


@pytest.mark.parametrize("clip", ["const", "l2"])
def test_gradient_clipping_through_fit_matches_jax(clip):
    jm, tm = _mlp_pair(JO.SGD(lr=0.05, momentum=0.9),
                       TO.SGD(lr=0.05, momentum=0.9))
    for m in (jm, tm):
        if clip == "const":
            m.set_constant_gradient_clipping(-0.05, 0.05)
        else:
            m.set_gradient_clipping_by_l2_norm(0.5)
    x, y = _regression()
    want = jm.fit(x, y, batch_size=32, nb_epoch=3, verbose=0)
    got = tm.fit(x, y, batch_size=32, nb_epoch=3, verbose=0, device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    _assert_params_close(jm, tm)
    # the clip bites: without it the same fit moves elsewhere
    free = _mlp_pair(JO.SGD(lr=0.05, momentum=0.9),
                     TO.SGD(lr=0.05, momentum=0.9))[1]
    free_loss = free.fit(x, y, batch_size=32, nb_epoch=3, verbose=0,
                         device="cpu")["loss"]
    assert abs(free_loss[-1] - got["loss"][-1]) > 1e-3
    tm.clear_gradient_clipping()
    assert tm._grad_clip is None


def test_plateau_through_fit_matches_jax():
    """Plateau on the training loss (patience 1, factor 0.5) with a rate
    high enough to stall: the rate written into the state's device
    ``lr`` follows the JAX ``inject_hyperparams`` rate epoch by
    epoch."""
    def plateau(m):
        return m.Plateau(monitor="Loss", factor=0.5, patience=1,
                         epsilon=1e9)
    jm, tm = _mlp_pair(JO.Adam(lr=0.05, learningrate_schedule=plateau(JS)),
                       TO.Adam(lr=0.05, learningrate_schedule=plateau(TS)))
    x, y = _regression()
    rates_j, rates_t, lj, lt = [], [], [], []
    for _ in range(4):
        lj += jm.fit(x, y, batch_size=32, nb_epoch=1, verbose=0)["loss"]
        lt += tm.fit(x, y, batch_size=32, nb_epoch=1, verbose=0,
                     device="cpu")["loss"]
        rates_j.append(float(np.asarray(
            jm._opt_state.hyperparams["learning_rate"])))
        rates_t.append(float(tm._opt_state["lr"]))
    assert rates_t == rates_j
    assert rates_t[-1] < 0.05
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    _assert_params_close(jm, tm)


def test_scheduled_optimizer_through_fit_matches_jax():
    jm, tm = _mlp_pair(
        JO.RMSprop(lr=0.01, learningrate_schedule=JS.Step(4, 0.5)),
        TO.RMSprop(lr=0.01, learningrate_schedule=TS.Step(4, 0.5)))
    x, y = _regression()
    want = jm.fit(x, y, batch_size=32, nb_epoch=2, verbose=0)
    got = tm.fit(x, y, batch_size=32, nb_epoch=2, verbose=0, device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    _assert_params_close(jm, tm)
    assert int(tm._opt_state["count"]) == 16
