"""The port's BERT slice against the JAX package: ``LayerNorm``,
``TransformerLayer``, ``BERT`` and their Keras ``fit``.

Both packages get the same numpy ids and the same weights (the JAX
layer's tree carried over by ``keras_params_from_jax``). The JAX side
runs its dense attention on the CPU (``auto`` picks flash on a TPU
only); the port's runs its plain versions.

Tolerances: f32 outputs and gradients within 1e-5 absolute (two blocks
of width 32, the same products summed in another order); the remat
modes within 1e-7 of each other (the same port arithmetic, recomputed);
bf16 ``LayerNorm`` within one bf16 ulp of its output (both round the
normalized tensor to bf16, then the affine rounds once more, where XLA
may keep the product in f32). ``fit`` as ``tests/test_torch_keras.py``
holds the Llama layer: f32 per-epoch losses within rtol 1e-4 and every
parameter within 1e-4 absolute after 8 AdamW steps at lr 1e-2; under
``mixed_bfloat16`` the losses within rtol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from zoo_tpu.pipeline.api.keras import layers as jlayers
from zoo_tpu.pipeline.api.keras.optimizers import \
    AdamWeightDecay as JaxAdamW

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    tree_leaves,
    tree_map,
)
from zoo_tpu_torch.pipeline.api.keras.layers import self_attention as tsa
from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

jax.config.update("jax_platforms", "cpu")

LOSS = "sparse_categorical_crossentropy_from_logits"
VOCAB, HIDDEN, N_BLOCK, N_HEAD, INTER, SEQ = 50, 32, 2, 4, 64, 16
SMALL = dict(hidden_size=HIDDEN, n_block=N_BLOCK, n_head=N_HEAD)


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


def _ids(b=3, t=12, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)).astype(
        np.int32)


def _layers(kind, **kw):
    """The JAX layer, the port's, and the JAX layer's weights on the
    port's side."""
    if kind == "bert":
        args = dict(vocab=VOCAB, seq_len=SEQ, intermediate_size=INTER,
                    max_position_len=SEQ, **SMALL, **kw)
        jl, tl = jlayers.BERT(**args), tlayers.BERT(**args)
    else:
        args = dict(vocab=VOCAB, seq_len=SEQ, intermediate_size=INTER,
                    hidden_drop=0.0, attn_drop=0.0, **SMALL, **kw)
        jl = jlayers.TransformerLayer(**args)
        tl = tlayers.TransformerLayer(**args)
    jp = jl.build(jax.random.PRNGKey(3), (None, SEQ))
    return jl, tl, jp, keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rs = np.random.RandomState(1)
    x = (rs.randn(4, 7, HIDDEN) * 3 + 1).astype(np.float32)
    g = rs.uniform(0.5, 1.5, HIDDEN).astype(np.float32)
    b = (rs.randn(HIDDEN) * 0.1).astype(np.float32)
    want = np.asarray(jlayers.LayerNorm().call(
        {"gamma": jnp.asarray(g), "beta": jnp.asarray(b)},
        jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    layer = tlayers.LayerNorm()
    params = layer.build(torch.Generator().manual_seed(0), (None, HIDDEN))
    assert torch.equal(params["gamma"], torch.ones(HIDDEN)) and \
        torch.equal(params["beta"], torch.zeros(HIDDEN))
    got = layer.call({"gamma": torch.from_numpy(g),
                      "beta": torch.from_numpy(b)},
                     torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_transformer_layer_matches_jax(bidirectional):
    jl, tl, jp, tp = _layers("transformer", bidirectional=bidirectional)
    ids = _ids()
    want = np.asarray(jl.call(jp, jnp.asarray(ids)))
    got = tl.call(tp, torch.from_numpy(ids))
    assert got.shape == (3, 12, HIDDEN)
    assert tl.compute_output_shape((None, 12)) == (None, 12, HIDDEN)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert tl.last_attention_impl == "dense"
    # causal: a later token never changes an earlier output
    other = ids.copy()
    other[:, -1] = (other[:, -1] + 1) % VOCAB
    moved = tl.call(tp, torch.from_numpy(other))
    assert torch.equal(moved[:, :-1], got[:, :-1]) != bidirectional


@pytest.mark.parametrize("inputs", ["ids", "ids_seg_mask"])
def test_bert_matches_jax(inputs):
    """Default dropout (0.1): an inference forward applies none in
    either package."""
    jl, tl, jp, tp = _layers("bert")
    ids = _ids(seed=2)
    rs = np.random.RandomState(5)
    if inputs == "ids":
        jx, tx = jnp.asarray(ids), torch.from_numpy(ids)
    else:
        seg = rs.randint(0, 2, ids.shape).astype(np.int32)
        mask = np.ones(ids.shape, np.int32)
        mask[0, 9:] = 0
        mask[2, 5:] = 0
        jx = [jnp.asarray(a) for a in (ids, seg, mask)]
        tx = [torch.from_numpy(a) for a in (ids, seg, mask)]
    want = jl.call(jp, jx)
    got = tl.call(tp, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        tl.pooled_output(tp, got).numpy(),
        np.asarray(jl.pooled_output(jp, want)), atol=1e-5)
    assert tl.compute_output_shape([(None, 12)] * 3) == (None, 12, HIDDEN)
    assert tl.last_attention_impl == "dense"


def _loss(call, params):
    out = call(params)
    w = torch.linspace(-1.0, 1.0, out.shape[-1])
    return (out * w).sum() / out.numel()


def test_remat_modes_give_equal_gradients_and_match_jax():
    jl, _, jp, tp = _layers("bert", hidden_p_drop=0.0, attn_p_drop=0.0)
    ids = _ids(seed=4)
    w = np.linspace(-1.0, 1.0, HIDDEN, dtype=np.float32)
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: (jl.call(p, jnp.asarray(ids), training=True) * w).sum()
        / (ids.size * HIDDEN))(jp)))
    out = {}
    for remat in (False, True, "dots"):
        tl = tlayers.BERT(vocab=VOCAB, seq_len=SEQ, intermediate_size=INTER,
                          max_position_len=SEQ, hidden_p_drop=0.0,
                          attn_p_drop=0.0, remat=remat, **SMALL)
        tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
        loss = _loss(lambda p: tl.call(p, torch.from_numpy(ids),
                                       training=True), tree)
        grads = torch.autograd.grad(loss, tree_leaves(tree),
                                    allow_unused=True,
                                    materialize_grads=True)
        out[remat] = dict(zip(_flat(tree), grads))
    assert set(out[False]) == set(jgrads)
    for k, g in out[False].items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], atol=1e-5,
                                   err_msg=k)
        for remat in (True, "dots"):
            np.testing.assert_allclose(out[remat][k].numpy(), g.numpy(),
                                       atol=1e-7, err_msg=f"{remat} {k}")
    assert float(out[False]["blocks/qkv_w"].abs().max()) > 0
    assert float(out[False]["pool_w"].abs().max()) == 0   # not reached


def test_bert_routes_through_the_flash_function(monkeypatch):
    """Unmasked, BERT hands the flash path non-causal (B, H, T, D)
    contiguous tensors; through the flash autograd function (its plain
    forward and backward on the CPU) the gradients are the dense path's.
    With a mask, ``auto`` takes the dense path and ``flash`` refuses."""
    from zoo_tpu_torch.ops.kernels.flash_attention import flash_attention
    _, tl, _, tp = _layers("bert", hidden_p_drop=0.0, attn_p_drop=0.0)
    ids = torch.from_numpy(_ids(seed=6))

    def grads():
        tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
        loss = _loss(lambda p: tl.call(p, ids, training=True), tree)
        return dict(zip(_flat(tree), torch.autograd.grad(
            loss, tree_leaves(tree), allow_unused=True,
            materialize_grads=True)))

    dense = grads()
    seen = []

    def through_flash(q, k, v, mask, causal, impl):
        assert mask is None and q.is_contiguous() and k.is_contiguous()
        seen.append(causal)
        return flash_attention(q, k, v, causal=causal)
    monkeypatch.setattr(tsa, "dot_product_attention", through_flash)
    flash = grads()
    assert seen == [False] * N_BLOCK
    for k in dense:
        np.testing.assert_allclose(flash[k].numpy(), dense[k].numpy(),
                                   atol=1e-6, err_msg=k)
    monkeypatch.undo()
    mask = torch.ones(ids.shape, dtype=torch.int32)
    flash_layer = tlayers.BERT(vocab=VOCAB, seq_len=SEQ,
                               intermediate_size=INTER, max_position_len=SEQ,
                               attention_impl="flash", attn_p_drop=0.0,
                               **SMALL)
    with pytest.raises(ValueError, match="mask"):
        flash_layer.call(tp, [ids, torch.zeros_like(ids), mask])


def _bert_model(cls_seq, bert_cls, lambda_cls, dense_cls, opt, policy):
    m = cls_seq()
    m.add(bert_cls(vocab=VOCAB, seq_len=SEQ, intermediate_size=INTER,
                   hidden_p_drop=0.0, attn_p_drop=0.0, remat="dots",
                   max_position_len=SEQ, input_shape=(SEQ,), **SMALL))
    m.add(lambda_cls(lambda h: h[:, 0], output_shape=(HIDDEN,)))
    m.add(dense_cls(2))
    m.compile(optimizer=opt, loss=LOSS, dtype_policy=policy)
    return m


@pytest.mark.parametrize("fused,policy", [
    (False, "float32"), (True, "float32"), (True, "mixed_bfloat16")])
def test_bert_fit_matches_jax(fused, policy):
    """``bench.py``'s ``bench_bert`` model at small widths: BERT,
    ``Lambda(h[:, 0])``, ``Dense(2)``, AdamW, from-logits loss."""
    rs = np.random.RandomState(7)
    ids = rs.randint(0, VOCAB, (16, SEQ)).astype(np.int32)
    y = rs.randint(0, 2, 16).astype(np.int32)
    jm = _bert_model(JaxSequential, jlayers.BERT, jlayers.Lambda,
                     jlayers.Dense, JaxAdamW(lr=1e-2, fused=fused), policy)
    tree = jax.tree_util.tree_map(np.asarray, jm.build())
    ref = jm.fit(ids, y, batch_size=4, nb_epoch=2, shuffle=True, seed=0,
                 verbose=0)
    tm = _bert_model(Sequential, tlayers.BERT, tlayers.Lambda,
                     tlayers.Dense, AdamWeightDecay(lr=1e-2, fused=fused),
                     policy)
    tm.params = keras_params_from_jax(tree, "cpu")
    got = tm.fit(ids, y, batch_size=4, nb_epoch=2, shuffle=True, seed=0,
                 verbose=0, device="cpu")
    assert set(tm.params) == set(jm.params) == {"000_bert", "001_lambda",
                                                 "002_dense"}
    assert tm._step == jm._step == 8
    if policy == "mixed_bfloat16":
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-2)
        return
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    have = _flat(tm.params)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-4, err_msg=k)
    # the leaves the loss does not reach (pooler, segment table) were
    # decayed by AdamW from zero gradients, as in JAX
    start = _flat(tree)
    assert not np.array_equal(have["000_bert/pool_w"],
                              start["000_bert/pool_w"])


def test_dropout_is_refused_in_training_only():
    """Dropout is no longer refused: BERT-tiny's training forward at
    ``hidden_p_drop = attn_p_drop = 0.1`` under each remat mode matches
    JAX's under the same key (outputs and gradients within 1e-5, the
    masks JAX's, the recompute drawing them again), and a ``fit`` of
    BERT or of a TransformerLayer with dropout runs. What stays refused
    is refused at construction: ``flash`` with attention dropout (the
    kernels take no mask), a bad remat mode, a width not divisible."""
    import jax.random as jrandom

    from zoo_tpu_torch.ops.random import PRNGKey
    jl, _, jp, tp = _layers("bert", hidden_p_drop=0.1, attn_p_drop=0.1)
    ids = _ids(b=4, t=SEQ, seed=8)
    w = np.linspace(-1.0, 1.0, HIDDEN, dtype=np.float32)
    jk = jrandom.PRNGKey(4)
    want = np.asarray(jl.call(jp, jnp.asarray(ids), training=True, rng=jk))
    jgrads = _flat(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: (jl.call(p, jnp.asarray(ids), training=True, rng=jk)
                   * w).sum() / (ids.size * HIDDEN))(jp)))
    for remat in (True, "dots"):
        tl = tlayers.BERT(vocab=VOCAB, seq_len=SEQ, intermediate_size=INTER,
                          max_position_len=SEQ, hidden_p_drop=0.1,
                          attn_p_drop=0.1, remat=remat, **SMALL)
        tl.name = jl.name
        tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
        out = tl.call(tree, torch.from_numpy(ids), training=True,
                      rng=PRNGKey(4))
        np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
        grads = torch.autograd.grad(_loss(lambda _: out, tree),
                                    tree_leaves(tree), allow_unused=True,
                                    materialize_grads=True)
        for k, g in zip(_flat(tree), grads):
            np.testing.assert_allclose(g.numpy(), jgrads[k], atol=1e-5,
                                       err_msg=f"{remat} {k}")
    for layer in (tlayers.BERT(vocab=VOCAB, seq_len=SEQ, **SMALL),
                  tlayers.TransformerLayer(vocab=VOCAB, seq_len=SEQ,
                                           attn_drop=0.0, **SMALL)):
        m = Sequential().add(layer)
        m.compile("adamw", "mse")
        hist = m.fit(ids, np.zeros((4, SEQ, HIDDEN), np.float32),
                     batch_size=4, nb_epoch=1, verbose=0, device="cpu")
        assert np.isfinite(hist["loss"]).all()
        assert m.predict(ids, device="cpu").shape == (4, SEQ, HIDDEN)
    with pytest.raises(ValueError, match="attention dropout"):
        tlayers.BERT(vocab=VOCAB, attention_impl="flash", **SMALL)
    with pytest.raises(ValueError, match="remat"):
        tlayers.TransformerLayer(vocab=VOCAB, seq_len=SEQ, remat="full")
    with pytest.raises(ValueError, match="divide"):
        tlayers.TransformerLayer(vocab=VOCAB, seq_len=SEQ, hidden_size=30,
                                 n_head=4)


def test_keras_params_from_jax_carries_the_bert_tree():
    jm = _bert_model(JaxSequential, jlayers.BERT, jlayers.Lambda,
                     jlayers.Dense, JaxAdamW(), "float32")
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.build()))
    tm = _bert_model(Sequential, tlayers.BERT, tlayers.Lambda,
                     tlayers.Dense, AdamWeightDecay(), "float32")
    have = _flat(keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu"))
    mine = _flat(tm.build(device="cpu"))   # the port's own build
    assert set(have) == set(want) == set(mine)
    for k in want:
        assert have[k].shape == want[k].shape == mine[k].shape, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert have["000_bert/blocks/qkv_w"].shape == (N_BLOCK, HIDDEN,
                                                    3 * HIDDEN)
    # the port's draws: N(0, 0.02) matrices, unit gains, zero biases
    assert abs(float(mine["000_bert/tok"].std()) - 0.02) < 2e-3
    assert (mine["000_bert/blocks/ln1_g"] == 1).all()
    assert (mine["000_bert/blocks/fc1_b"] == 0).all()
