"""The port's image-inference slice against the JAX package: the Keras
layers ResNet uses, the functional ``Model``, ``ResNet`` itself, and
``InferenceModel``/``quantize_model``.

Both sides start from the same weights: the JAX model builds its
params, its BatchNorm stats are redrawn from a seed (so BN is not the
identity), and ``keras_params_from_jax`` carries the tree over. The
JAX forward takes its ``auto`` conv path on the CPU (``lax.conv``); the
port's takes the reference conv there, the kernels' plain version.

Tolerances on the softmax outputs of a tiny ResNet (bottleneck, blocks
(1, 1), 32x32x3, 10 classes): f32 float and int8 within 1e-6 (the same
f32 math; XLA and PyTorch sum the convs in another order, which moves
an output by ~2e-8 here); under ``mixed_bfloat16`` within 4e-3 (bf16
rounds at other points in the two frameworks: about one bf16 ulp,
2**-8, of outputs below 1). Layers: f32 within 1e-6 or bit-equal where
both compute the same elementwise ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models.image import resnet as jresnet
from zoo_tpu.pipeline.api.keras import layers as jlayers
from zoo_tpu.pipeline.api.keras.engine import base as jbase
from zoo_tpu.pipeline.inference import inference_model as jinf

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.image import resnet as tresnet
from zoo_tpu_torch.pipeline.api.keras import Input, Model
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras.engine import base as tbase
from zoo_tpu_torch.pipeline.inference import inference_model as tinf

jax.config.update("jax_platforms", "cpu")

TOL = {"float32": 1e-6, "mixed_bfloat16": 4e-3}


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """A JAX predict would shard over an orca mesh left by another test
    on the same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _redraw_bn(tree, rs):
    """BatchNorm gamma/beta/stats drawn from ``rs``, other leaves kept."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw_bn(v, rs)
        elif k in ("mean", "beta"):
            out[k] = jnp.asarray((rs.randn(*v.shape) * 0.1)
                                 .astype(np.float32))
        elif k in ("var", "gamma"):
            out[k] = jnp.asarray(rs.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        else:
            out[k] = v
    return out


def _pair(policy="float32", bottleneck=True, blocks=(1, 1)):
    """A JAX tiny ResNet and the port's, on the same weights."""
    jm = jresnet.ResNet(10, blocks, bottleneck=bottleneck,
                        input_shape=(32, 32, 3))
    jm.compile("adam", "sparse_categorical_crossentropy",
               dtype_policy=policy)
    jm.build(jax.random.PRNGKey(0))
    jm.params = _redraw_bn(jm.params, np.random.RandomState(1))
    tm = tresnet.ResNet(10, blocks, bottleneck=bottleneck,
                        input_shape=(32, 32, 3))
    tm.compile("adamw", "sparse_categorical_crossentropy",
               dtype_policy=policy)
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _images(n=6, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3) \
        .astype(np.float32)


@pytest.mark.parametrize("bottleneck", [True, False])
def test_params_keys_and_shapes_match_jax(bottleneck):
    jm, tm = _pair(bottleneck=bottleneck)
    jf = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    tf = _flat(tm.params)
    assert set(jf) == set(tf)
    assert all(jf[k].shape == tf[k].shape for k in jf)
    # the port's own build gives the same keys and shapes
    fresh = tresnet.ResNet(10, (1, 1), bottleneck=bottleneck,
                           input_shape=(32, 32, 3))
    built = _flat(fresh.build(torch.Generator().manual_seed(0),
                              device="cpu"))
    assert {k: v.shape for k, v in built.items()} == \
        {k: v.shape for k, v in jf.items()}


def test_resnet50_layer_keys_match_jax():
    jm = jresnet.resnet50(1000, (224, 224, 3))
    tm = tresnet.resnet50(1000, (224, 224, 3))
    assert list(jm._param_keys().values()) == \
        list(tm._param_keys().values())
    convs = [layer for layer in tm.layers
             if isinstance(layer, tlayers.Convolution2D)]
    inside = [c for c in convs if c.kernel == (1, 1) or c.subsample ==
              (1, 1)]
    assert (len(convs), len(inside)) == (52, 49)


@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_tiny_resnet_predict_matches_jax(policy):
    jm, tm = _pair(policy)
    x = _images()
    ref = jm.predict(x, batch_size=4)
    got = tm.predict(x, batch_size=4, device="cpu")
    assert got.dtype == np.float32 and got.shape == (6, 10)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[policy])
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-2)


@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_tiny_resnet_int8_matches_jax(policy):
    jm, tm = _pair(policy)
    x = _images()
    jinf.quantize_model(jm, mode="force")
    tinf.quantize_model(tm, mode="force")
    jf = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    tf = _flat(tm.params)
    assert set(jf) == set(tf)
    for k in jf:
        assert tf[k].dtype == jf[k].dtype, k
        if k.endswith("W_q") or k.endswith("W_scale"):
            np.testing.assert_array_equal(tf[k], jf[k])
    ref = jm.predict(x, batch_size=4)
    got = tm.predict(x, batch_size=4, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[policy])


def test_keras_params_from_jax_carries_stats_and_int8_leaves():
    jm, _ = _pair()
    jinf.quantize_model(jm, mode="force")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    got = keras_params_from_jax(tree, "cpu")
    bn = next(k for k in tree if k.endswith("batchnormalization"))
    assert set(got[bn]["stats"]) == {"mean", "var"}
    dense = next(k for k in tree if k.endswith("dense"))
    assert got[dense]["W_q"].dtype == torch.int8
    assert got[dense]["W_scale"].dtype == torch.float32
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, _flat(tree)[k])


def test_carried_int8_conv_weights_get_the_kmajor_copy():
    """The JAX package's int8 conv leaves, carried over, come with the
    K-major copy the port's int8 conv kernel reads, kept beside the tree
    (whose keys stay the JAX package's)."""
    from zoo_tpu_torch.ops.kernels.conv import int8_weights_kmajor, kmajor_of
    jm, _ = _pair()
    jinf.quantize_model(jm, mode="force")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    got = keras_params_from_jax(tree, "cpu")
    convs = [k for k in tree if k.endswith("convolution2d")]
    assert convs
    for k in convs:
        w_q = got[k]["W_q"]
        assert torch.equal(kmajor_of(w_q), int8_weights_kmajor(w_q))
        hwio = torch.from_numpy(np.array(tree[k]["W_q"]))
        assert torch.equal(kmajor_of(w_q), hwio.permute(3, 0, 1, 2)
                           .reshape(w_q.shape[3], -1))
    assert set(_flat(got)) == set(_flat(tree))


def test_quantize_model_auto_keeps_the_faster_path(monkeypatch):
    monkeypatch.setattr(tinf, "_AUTO_VERDICT_CACHE", {})
    rates = iter([100.0, 50.0])          # float, then int8: int8 loses
    monkeypatch.setattr(tinf, "_time_forward",
                        lambda model, xs, reps=3: next(rates))
    _, tm = _pair()
    before = _flat(tm.params)
    tinf.quantize_model(tm, mode="auto")
    assert tm._quant_path == "bf16-fallback"
    assert tm._quant_speedup == 0.5 and not tm._quantized
    after = _flat(tm.params)
    assert set(after) == set(before)
    assert all(np.array_equal(after[k], before[k]) for k in before)
    # the same architecture replays the cached verdict without timing
    monkeypatch.setattr(tinf, "_time_forward", lambda *a, **k: 1 / 0)
    _, tm2 = _pair()
    tinf.quantize_model(tm2, mode="auto")
    assert tm2._quant_path == "bf16-fallback"
    assert not any(k.endswith("W_q") for k in _flat(tm2.params))

    monkeypatch.setattr(tinf, "_AUTO_VERDICT_CACHE", {})
    rates = iter([50.0, 100.0])          # int8 wins
    monkeypatch.setattr(tinf, "_time_forward",
                        lambda model, xs, reps=3: next(rates))
    _, tm3 = _pair()
    tinf.quantize_model(tm3, mode="auto")
    assert tm3._quant_path == "int8" and tm3._quant_speedup == 2.0
    assert any(k.endswith("W_q") for k in _flat(tm3.params))
    _, tm4 = _pair()                      # cached int8 verdict applies
    monkeypatch.setattr(tinf, "_time_forward", lambda *a, **k: 1 / 0)
    tinf.quantize_model(tm4, mode="auto")
    assert tm4._quant_path == "int8" and tm4._quantized


def test_quantize_model_modes(monkeypatch):
    _, tm = _pair()
    tinf.quantize_model(tm, mode="off")
    assert tm._quant_path == "bf16" and not tm._quantized
    with pytest.raises(ValueError, match="unknown int8 mode"):
        tinf.quantize_model(tm, mode="sometimes")
    monkeypatch.setenv("ZOO_INT8_MODE", "off")
    tinf.quantize_model(tm)
    assert tm._quant_path == "bf16"
    tinf.quantize_model(tm, mode="force")   # an argument beats the env
    assert tm._quant_path == "int8" and tm._quantized
    with pytest.raises(RuntimeError, match="inference-only"):
        tm.fit(_images(4), np.zeros(4, np.int32), batch_size=2,
               device="cpu")
    unbuilt = tresnet.ResNet(10, (1, 1), bottleneck=True,
                             input_shape=(32, 32, 3))
    with pytest.raises(ValueError, match="built"):
        tinf.quantize_model(unbuilt, mode="force")


def test_quantize_model_unset_mode_forces(monkeypatch):
    # the registry's default, `auto`, is the file loaders'; unset, the
    # knob leaves quantize_model to force, as in the JAX package
    from zoo_tpu_torch.common import knobs
    assert knobs.get("ZOO_INT8_MODE").default == "auto"
    monkeypatch.delenv("ZOO_INT8_MODE", raising=False)
    monkeypatch.setattr(tinf, "_time_forward", lambda *a, **k: 1 / 0)
    _, tm = _pair()
    tinf.quantize_model(tm)
    assert tm._quant_path == "int8" and tm._quantized


def test_time_forward_runs_the_forward():
    _, tm = _pair()
    rate = tinf._time_forward(tm, [np.zeros((2, 32, 32, 3), np.float32)],
                              reps=1)
    assert rate > 0


def test_inference_model_load_keras_and_predict():
    jm, tm = _pair()
    x = _images(7)
    im = tinf.InferenceModel(supported_concurrent_num=2)
    with pytest.raises(RuntimeError, match="no model"):
        im.predict(x)
    assert im.load_keras(tm, batch_size=4, device="cpu") is im
    assert im.model is tm
    got = im.predict(x)                  # 4 + a ragged tail of 3
    np.testing.assert_allclose(got, jm.predict(x, batch_size=4), rtol=0,
                               atol=TOL["float32"])
    one_by_one = np.concatenate([im.predict(x[i:i + 1], batch_size=1)
                                 for i in range(7)])
    np.testing.assert_allclose(got, one_by_one, rtol=0, atol=1e-6)


def test_stem_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    w = rs.randn(7, 7, 3, 8).astype(np.float32)
    js = jresnet.SpaceToDepthStem(8)
    ts = tresnet.SpaceToDepthStem(8)
    ref = js.call({"W": jnp.asarray(w)}, jnp.asarray(x))
    got = ts.call({"W": torch.from_numpy(w)}, torch.from_numpy(x))
    assert ts.compute_output_shape((None, 16, 16, 3)) == (None, 8, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # and it is the plain 7x7/s2 SAME conv
    plain = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,border,ordering", [
    (112, "same", "tf"), (9, "same", "tf"), (9, "valid", "tf"),
    (8, "same", "th")])
def test_max_pooling_matches_jax(dtype, h, border, ordering):
    x = np.random.RandomState(3).randn(2, h, h, 4).astype(np.float32)
    if ordering == "th":
        x = x.transpose(0, 3, 1, 2).copy()
    jl = jlayers.MaxPooling2D((3, 3), strides=(2, 2), border_mode=border,
                              dim_ordering=ordering)
    tl = tlayers.MaxPooling2D((3, 3), strides=(2, 2), border_mode=border,
                              dim_ordering=ordering)
    ref = jl.call({}, jnp.asarray(x, getattr(jnp, dtype)))
    got = tl.call({}, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tuple(got.shape) == ref.shape
    assert tl.compute_output_shape((None,) + x.shape[1:]) == \
        jl.compute_output_shape((None,) + x.shape[1:])
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_global_average_pooling_matches_jax(ordering):
    x = np.random.RandomState(4).randn(2, 5, 5, 6).astype(np.float32)
    ref = jlayers.GlobalAveragePooling2D(dim_ordering=ordering).call(
        {}, jnp.asarray(x))
    got = tlayers.GlobalAveragePooling2D(dim_ordering=ordering).call(
        {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_normalization_inference_matches_jax(dtype):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 4, 6).astype(np.float32)
    p = {"gamma": rs.uniform(0.5, 1.5, 6).astype(np.float32),
         "beta": rs.randn(6).astype(np.float32),
         "stats": {"mean": rs.randn(6).astype(np.float32),
                   "var": rs.uniform(0.5, 1.5, 6).astype(np.float32)}}
    ref = jlayers.BatchNormalization().call(
        jax.tree_util.tree_map(jnp.asarray, p),
        jnp.asarray(x, getattr(jnp, dtype)))
    tp = keras_params_from_jax(p, "cpu")
    got = tlayers.BatchNormalization().call(
        tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=tol)
    # training normalizes by the batch moments, not the running stats
    train = tlayers.BatchNormalization().call(tp, torch.from_numpy(x),
                                              training=True)
    np.testing.assert_allclose(train.mean((0, 1, 2)).numpy(),
                               p["beta"], rtol=0, atol=1e-5)
    assert float((train - got.float()).abs().max()) > 0.1


@pytest.mark.parametrize("mode", ["sum", "mul", "ave", "max", "min",
                                  "concat", "dot", "cos"])
def test_merge_matches_jax(mode):
    rs = np.random.RandomState(6)
    xs = [rs.randn(3, 5).astype(np.float32) for _ in range(2)]
    jl, tl = jlayers.Merge(mode=mode), tlayers.Merge(mode=mode)
    ref = jl.call({}, [jnp.asarray(a) for a in xs])
    got = tl.call({}, [torch.from_numpy(a) for a in xs])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    shapes = [(None, 5), (None, 5)]
    assert tl.compute_output_shape(shapes) == jl.compute_output_shape(shapes)


@pytest.mark.parametrize("name", ["relu", "relu6", "tanh", "sigmoid",
                                  "softmax", "log_softmax", "softplus",
                                  "elu", "selu", "gelu", "silu", "exp",
                                  "linear"])
def test_activations_match_jax(name):
    x = np.random.RandomState(7).randn(4, 9).astype(np.float32)
    ref = jbase.get_activation_fn(name)(jnp.asarray(x))
    got = tbase.get_activation_fn(name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_softmax_in_bf16_matches_jax():
    x = np.random.RandomState(8).randn(4, 1000).astype(np.float32) * 3
    ref = jbase.get_activation_fn("softmax")(jnp.asarray(x, jnp.bfloat16))
    got = tbase.get_activation_fn("softmax")(
        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("ordering", ["tf", "th"])
def test_conv2d_layer_with_bias_matches_jax(ordering):
    rs = np.random.RandomState(9)
    x = rs.randn(2, 6, 6, 3).astype(np.float32)
    if ordering == "th":
        x = x.transpose(0, 3, 1, 2).copy()
    p = {"W": rs.randn(3, 3, 3, 5).astype(np.float32),
         "b": rs.randn(5).astype(np.float32)}
    kw = dict(activation="relu", border_mode="same", dim_ordering=ordering)
    jl = jlayers.Convolution2D(5, 3, 3, **kw)
    tl = tlayers.Conv2D(5, 3, 3, **kw)
    ref = jl.call(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = tl.call(keras_params_from_jax(p, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert tl.compute_output_shape((None,) + x.shape[1:]) == \
        jl.compute_output_shape((None,) + x.shape[1:])


def test_initializers_keep_their_bounds():
    g = torch.Generator().manual_seed(0)
    w = tbase.get_initializer("glorot_uniform")(g, (3, 3, 16, 32))
    limit = np.sqrt(6.0 / (9 * 16 + 9 * 32))
    assert w.dtype == torch.float32 and float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit
    assert torch.equal(tbase.get_initializer("one")(g, (4,)),
                       torch.ones(4))
    # orthogonal (the recurrent layers' U) is ported; a name neither
    # package knows raises
    q = tbase.get_initializer("orthogonal")(g, (8, 8))
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(8), atol=1e-5)
    with pytest.raises(ValueError, match="unknown initializer"):
        tbase.get_initializer("no_such_initializer")


def test_functional_model_builds_a_shared_layer_once():
    x_in = Input((4,))
    shared = tlayers.Dense(4, activation="relu")
    a = shared(x_in)
    b = shared(a)
    out = tlayers.merge([a, b], mode="sum")
    m = Model(x_in, tlayers.Dense(2)(out))
    assert [type(layer).__name__ for layer in m.layers] == \
        ["Dense", "Merge", "Dense"]
    params = m.build(torch.Generator().manual_seed(0), device="cpu")
    assert list(params) == ["000_dense", "001_merge", "002_dense"]
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    p = params["000_dense"]
    h = torch.relu(torch.from_numpy(x) @ p["W"] + p["b"])
    h2 = torch.relu(h @ p["W"] + p["b"])
    want = (h + h2) @ params["002_dense"]["W"] + params["002_dense"]["b"]
    np.testing.assert_allclose(m.predict(x, device="cpu"), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="not connected"):
        Model([x_in, Input((4,))], out)
