"""The port's Keras training slice against the JAX package.

A JAX ``Sequential`` around ``Llama(tiny_llama_config())`` and the
port's counterpart start from the same weights (the JAX tree carried
over by ``keras_params_from_jax``) and ``fit`` the same numpy data, two
epochs, shuffled from seed 0, with ``AdamWeightDecay(lr=1e-2)``, fused
(the JAX side interprets its Pallas kernel, the port runs the kernel's
plain version on the CPU) or not (optax against the plain version).

Tolerances: f32 per-epoch losses within rtol 1e-4 and every parameter
within 1e-4 absolute after 8 steps (the two frameworks sum in another
order; at lr 1e-2 Adam's normalised step carries those ~1e-7 relative
gradient differences to ~1e-5 in the weights). Under ``mixed_bfloat16``
only the losses are compared, within rtol 2e-2: bf16 rounds at other
points in the two frameworks, and Adam turns a sign change of a small
bf16 gradient into a full lr-sized step, so the weights are no sharper
witness than the loss.
"""

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.common import knobs as jax_knobs
from zoo_tpu.models.llm.llama import Llama as JaxLlama
from zoo_tpu.models.llm.llama import tiny_llama_config as jax_tiny
from zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from zoo_tpu.pipeline.api.keras import objectives as jax_obj
from zoo_tpu.pipeline.api.keras.engine import data_utils as jax_du
from zoo_tpu.pipeline.api.keras.optimizers import \
    AdamWeightDecay as JaxAdamW

from zoo_tpu_torch.common import knobs as port_knobs
from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.llm import llama as tl
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras import objectives as obj
from zoo_tpu_torch.pipeline.api.keras.engine import data_utils as du
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    tree_leaves,
    tree_map,
)
from zoo_tpu_torch.pipeline.api.keras.optimizers import (
    AdamWeightDecay,
    get_optimizer,
)

jax.config.update("jax_platforms", "cpu")

LOSS = "sparse_categorical_crossentropy_from_logits"
T_LEN = 16


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an active orca mesh; one left by another
    test must not change the reference path."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _data(n=16, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (n, T_LEN)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _port_model(fused, policy="float32", remat=False):
    m = Sequential()
    m.add(tl.Llama(tl.tiny_llama_config(), attention_impl="dense",
                   remat=remat, input_shape=(T_LEN,)))
    return m.compile(optimizer=AdamWeightDecay(lr=1e-2, fused=fused),
                     loss=LOSS, dtype_policy=policy)


@pytest.mark.parametrize("fused,policy", [
    (True, "float32"), (False, "float32"), (True, "mixed_bfloat16")])
def test_fit_matches_jax(fused, policy):
    ids, labels = _data()
    jm = JaxSequential()
    jm.add(JaxLlama(jax_tiny(), attention_impl="dense",
                    input_shape=(T_LEN,)))
    jm.compile(optimizer=JaxAdamW(lr=1e-2, fused=fused), loss=LOSS,
               dtype_policy=policy)
    tree = jax.tree_util.tree_map(np.asarray, jm.build())
    ref = jm.fit(ids, labels, batch_size=4, nb_epoch=2, shuffle=True,
                 seed=0, verbose=0)

    pm = _port_model(fused, policy)
    pm.params = keras_params_from_jax(tree, "cpu")
    got = pm.fit(ids, labels, batch_size=4, nb_epoch=2, shuffle=True,
                 seed=0, verbose=0, device="cpu")
    assert set(pm.params) == set(jm.params) == {"000_llama"}
    assert pm._step == jm._step == 8
    if policy == "mixed_bfloat16":
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-2)
        return
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    have = _flat(pm.params)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-4, err_msg=k)
    if fused:
        # the fused state converts too, and holds the same moments
        state = keras_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jm._opt_state), "cpu")
        assert state["step"] == pm._opt_state["step"] == 8
        for part in ("m", "v"):
            mine, theirs = _flat(pm._opt_state[part]), _flat(state[part])
            for k in theirs:
                np.testing.assert_allclose(mine[k], theirs[k], atol=1e-4,
                                           err_msg=f"{part} {k}")


def test_fused_and_unfused_agree_through_fit_and_reuse_state():
    """The port's counterpart of the JAX package's fused-vs-optax fit
    test: two ``fit`` calls each, the second continuing the first's
    optimizer state (step counter included)."""
    ids, labels = _data(n=12, seed=3)
    start = tl.init_params(tl.tiny_llama_config(),
                           torch.Generator().manual_seed(1))
    losses, params = {}, {}
    for fused in (False, True):
        m = _port_model(fused)
        m.params = {"000_llama": tree_map(torch.clone, start)}
        h1 = m.fit(ids, labels, batch_size=4, nb_epoch=2, shuffle=False,
                   verbose=0, device="cpu")
        state = m._opt_state
        h2 = m.fit(ids, labels, batch_size=4, nb_epoch=2, shuffle=False,
                   verbose=0, device="cpu")
        # the second fit updated the first fit's moments in place
        assert m._opt_state["m"] is state["m"]
        assert m._opt_state["step"] == 12
        losses[fused] = h1["loss"] + h2["loss"]
        params[fused] = [t.detach() for t in tree_leaves(m.params)]
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)
    for a, b in zip(params[True], params[False]):
        assert torch.equal(a, b)
    assert losses[True][-1] < losses[True][0]


def _grads(model_fn, params, ids, labels):
    tree = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = tree_leaves(tree)
    loss = obj.sparse_categorical_crossentropy_from_logits(
        labels, model_fn(tree))
    return dict(zip(_flat(tree).keys(), torch.autograd.grad(loss, leaves)))


def test_gradients_reach_wq_wk_wv_through_the_flash_path(monkeypatch):
    """The flash kernel's output carries a gradient: q/k/v projections
    get the dense path's gradients (on the CPU the autograd function
    runs the plain forward and backward)."""
    from zoo_tpu_torch.ops.kernels.flash_attention import flash_attention
    cfg = tl.tiny_llama_config()
    params = tl.init_params(cfg, torch.Generator().manual_seed(2))
    ids, labels = (torch.from_numpy(a) for a in _data(n=2, seed=5))
    layer = tl.Llama(cfg, attention_impl="dense", input_shape=(T_LEN,))
    dense = _grads(lambda p: layer.call(p, ids), params, ids, labels)

    def through_flash(q, k, v, causal, impl):
        return flash_attention(q, k, v, causal=causal)
    monkeypatch.setattr(tl, "dot_product_attention", through_flash)
    flash = _grads(lambda p: layer.call(p, ids), params, ids, labels)
    for k in ("blocks/wq", "blocks/wk", "blocks/wv"):
        assert float(flash[k].abs().max()) > 0, k
    # 1e-5: the explicit recomputation and autograd of the dense path
    # sum the same f32 terms in another order
    for k in dense:
        np.testing.assert_allclose(flash[k].numpy(), dense[k].numpy(),
                                   atol=1e-5, err_msg=k)


def test_remat_modes_give_equal_gradients():
    cfg = tl.tiny_llama_config()
    params = tl.init_params(cfg, torch.Generator().manual_seed(4))
    ids, labels = (torch.from_numpy(a) for a in _data(n=2, seed=6))
    out = {}
    for remat in (False, True, "dots"):
        layer = tl.Llama(cfg, attention_impl="dense", remat=remat,
                         input_shape=(T_LEN,))
        out[remat] = _grads(lambda p: layer.call(p, ids, training=True),
                            params, ids, labels)
    for remat in (True, "dots"):
        for k, g in out[False].items():
            np.testing.assert_allclose(out[remat][k].numpy(), g.numpy(),
                                       atol=1e-7, err_msg=f"{remat} {k}")
    with pytest.raises(ValueError, match="remat"):
        tl.Llama(cfg, remat="full")


def test_keras_layer_equals_the_served_model():
    cfg = tl.tiny_llama_config()
    params = tl.init_params(cfg, torch.Generator().manual_seed(7))
    ids = torch.from_numpy(_data(n=2)[0])
    layer = tl.Llama(cfg, input_shape=(T_LEN,))
    assert layer.compute_output_shape((None, T_LEN)) == (None, T_LEN, 256)
    with pytest.raises(ValueError, match="Keras layer"):
        layer.params
    with torch.no_grad():
        assert torch.equal(layer.call(params, ids), tl.Llama(cfg, params)(ids))


def test_losses_match_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(3, 5, 11).astype(np.float32)
    labels = rs.randint(0, 11, (3, 5))
    labels[0, :2] = -100                           # ignore_index
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    for name in (LOSS, "sparse_categorical_crossentropy", "mse"):
        if name == "mse":
            args = (logits[..., 0], logits[..., 1])
        elif name == LOSS:
            args = (labels, logits)
        else:
            probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
            args = (np.maximum(labels, 0), probs)
        want = float(jax_obj.get_loss(name)(*args))
        got = float(obj.get_loss(name)(*(torch.from_numpy(np.asarray(a))
                                         for a in args)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    # bf16 logits stay bf16 into the loss; channel-first layout
    bf = obj.sparse_categorical_crossentropy_from_logits(
        t_labels, t_logits.to(torch.bfloat16))
    assert bf.dtype == torch.float32
    np.testing.assert_allclose(
        float(obj.sparse_categorical_crossentropy_from_logits(
            t_labels, t_logits.permute(0, 2, 1))),
        float(jax_obj.sparse_categorical_crossentropy_from_logits(
            labels, np.transpose(logits, (0, 2, 1)))), rtol=1e-6)
    assert obj.sparse_categorical_crossentropy_from_logits \
        ._handles_low_precision
    with pytest.raises(ValueError, match="unknown loss"):
        obj.get_loss("hinge")


@pytest.mark.parametrize("n,bs", [(10, 3), (16, 4)])
def test_batch_slices_match_jax(n, bs):
    a, b = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(2):                      # two epochs, one stream each
        want = list(jax_du.batch_slices(n, bs, True, a))
        got = list(du.batch_slices(n, bs, True, b))
        assert [w.tolist() for w in want] == [g.tolist() for g in got]
    xs, ys = du.to_xy_arrays({"x": np.zeros((4, 2)), "y": [0, 1, 0, 1]})
    assert du.num_samples(xs) == 4 and ys.shape == (4,)


def test_optimizer_and_compile_contract(monkeypatch):
    with pytest.raises(ValueError, match="constant lr"):
        AdamWeightDecay(fused=True, total_steps=100)
    scheduled = AdamWeightDecay(learningrate_schedule=lambda s: 1e-3)
    assert scheduled.schedule is not None and not scheduled.fused
    monkeypatch.setenv("ZOO_FUSED_OPTIM", "1")
    assert AdamWeightDecay().fused
    monkeypatch.setenv("ZOO_FUSED_OPTIM", "0")
    assert not AdamWeightDecay().fused
    assert isinstance(get_optimizer("adamw"), AdamWeightDecay)
    assert get_optimizer("sgd").name == "sgd"
    assert get_optimizer("rmsprop").name == "rmsprop"
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("nope")
    m = Sequential()
    m.add(tl.Llama(tl.tiny_llama_config(), input_shape=(T_LEN,)))
    m.compile("adamw", LOSS, metrics=["accuracy"])
    assert [x.name for x in m.metrics] == ["accuracy"]
    with pytest.raises(ValueError, match="unknown metric"):
        m.compile("adamw", LOSS, metrics=["f1"])
    with pytest.raises(ValueError, match="dtype_policy"):
        m.compile("adamw", LOSS, dtype_policy="float16")
    fresh = Sequential()
    fresh.add(tl.Llama(tl.tiny_llama_config(), input_shape=(T_LEN,)))
    with pytest.raises(RuntimeError, match="compile"):
        fresh.fit(*_data(n=4), batch_size=4, device="cpu")


def test_port_knobs_match_the_jax_registry():
    for name, knob in port_knobs.KNOBS.items():
        ref = jax_knobs.get(name)
        assert (knob.type, knob.default) == (ref.type, ref.default), name
    assert port_knobs.value("ZOO_FUSED_OPTIM", {}) is False
