"""The port's VGG-16/19, ``Flatten`` and ``Dropout`` against the JAX
package's.

Both sides start from the same weights: the JAX ``vgg16`` builds its
params and ``keras_params_from_jax`` carries the tree over (the keys
match: the same graph, layer for layer).

* Float, f32, at 160 x 160 x 3 (fc6 takes 5 x 5 x 512 = 12,800
  features): within 1e-6 of the JAX forward (softmax outputs; XLA and
  PyTorch sum the convs in another order, ~3e-7 here).
* Int8 after ``quantize_model(mode="force")`` on both sides, at the same
  input, so fc6 (K = 12,800 > 8192) takes the two-pass route on both:
  the int8 leaves are equal, one ``quantized_matmul`` runs a forward
  (fc6) and two fused ones (fc7, fc8), and the output is within 1e-6 of
  the JAX forward run op by op (``jax.disable_jit``; the JAX Pallas
  kernels interpreted). Under ``jit`` XLA may rewrite an activation's
  ``x / scale`` as ``x * (1 / scale)`` or reorder a conv's sum, which
  moves a value by an ulp; past one of the 15 int8 roundings that can
  move a quantized activation by a whole step (the outputs then differ
  by ~2e-3), so the eager forward is the one compared.
* ``mixed_bfloat16``, float, at 64 x 64: within 4e-3 (about one bf16
  ulp of outputs below 1; the two frameworks round at other points),
  as ``tests/test_torch_resnet.py`` holds ResNet.
* ``Dropout`` is the identity at inference, a training forward with
  ``p > 0`` is refused naming ROADMAP A.11b; ``Flatten`` flattens NHWC
  as JAX does; ``vgg19`` builds the JAX graph (the rest of the family:
  ``tests/test_torch_image_zoo.py``).
"""

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models.image import imageclassification as jvgg
from zoo_tpu.pipeline.api.keras import layers as jlayers
from zoo_tpu.pipeline.inference import inference_model as jinf

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models import image as timage
from zoo_tpu_torch.ops.kernels import quant as Q
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.inference import inference_model as tinf

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

SIZE = (160, 160, 3)          # fc6: 5 x 5 x 512 = 12,800 > 8192


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


@pytest.fixture(autouse=True)
def _two_threads():
    """The port's CPU convs on two threads: the suite's other workers
    keep their cores (timing-bound tests run beside this file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _pair(build, size, policy="float32", classes=10, tree=None):
    """A JAX model and the port's on the same weights: ``tree`` (numpy,
    the JAX keys), else the JAX model's own draw."""
    jm = getattr(jvgg, build)(classes, size)
    jm.compile("adam", "sparse_categorical_crossentropy",
               dtype_policy=policy)
    if tree is None:
        jm.build(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jm.params)
    else:
        jm.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    tm = getattr(timage, build)(classes, size)
    tm.compile("adam", "sparse_categorical_crossentropy",
               dtype_policy=policy)
    tm.params = keras_params_from_jax(tree, "cpu")
    return jm, tm


def _images(n, size, seed=0):
    return (np.random.RandomState(seed).rand(n, *size) * 255.0).astype(
        np.float32)


@pytest.fixture(scope="module")
def vgg16_tree():
    """VGG-16's weights at ``SIZE``, drawn once by the JAX model (the
    draw takes seconds); each test builds its own pair on them."""
    jax_context._runtime_context = None
    jm, _ = _pair("vgg16", SIZE)
    return jax.tree_util.tree_map(np.asarray, jm.params)


@pytest.mark.timeout(300)
def test_vgg16_float_matches_jax(vgg16_tree):
    jm, tm = _pair("vgg16", SIZE, tree=vgg16_tree)
    assert set(_flat(tm.params)) == set(_flat(jax.tree_util.tree_map(
        np.asarray, jm.params)))
    assert tm.params["019_dense"]["W"].shape == (12800, 4096)
    x = _images(2, SIZE)
    ref = np.asarray(jm.predict(x, batch_size=2))
    got = tm.predict(x, batch_size=2, device="cpu")
    assert got.shape == (2, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.timeout(600)    # ~70 s alone: the JAX Pallas GEMMs interpreted
def test_vgg16_int8_two_pass_fc6_matches_jax(vgg16_tree, monkeypatch):
    jm, tm = _pair("vgg16", SIZE, tree=vgg16_tree)
    jinf.quantize_model(jm, mode="force")
    tinf.quantize_model(tm, mode="force")
    jf = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    tf = _flat(tm.params)
    assert set(jf) == set(tf)
    for k in jf:
        assert tf[k].dtype == jf[k].dtype, k
        if k.endswith("W_q") or k.endswith("W_scale"):
            np.testing.assert_array_equal(tf[k], jf[k])
    calls = {"qmm": [], "fqmm": 0}
    qmm, fqmm = Q.quantized_matmul, Q.fused_quantized_matmul_plain

    def count_qmm(x_q, w_q, *a, **k):
        calls["qmm"].append(tuple(w_q.shape))
        return qmm(x_q, w_q, *a, **k)

    def count_fqmm(*a, **k):
        calls["fqmm"] += 1
        return fqmm(*a, **k)

    monkeypatch.setattr(Q, "quantized_matmul", count_qmm)
    monkeypatch.setattr(Q, "fused_quantized_matmul_plain", count_fqmm)
    x = _images(2, SIZE, seed=1)
    got = tm.predict(x, batch_size=2, device="cpu")
    assert calls == {"qmm": [(12800, 4096)], "fqmm": 2}
    with jax.disable_jit():
        ref = np.asarray(jm.predict(x, batch_size=2))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got.argmax(1) == ref.argmax(1)).all()


def test_vgg16_bf16_matches_jax():
    jm, tm = _pair("vgg16", (64, 64, 3), policy="mixed_bfloat16")
    x = _images(3, (64, 64, 3), seed=2)
    ref = np.asarray(jm.predict(x, batch_size=3))
    got = tm.predict(x, batch_size=3, device="cpu")
    assert got.dtype == np.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got, ref, rtol=0, atol=4e-3)


def test_vgg19_builds_the_jax_graph():
    jm = jvgg.vgg19(5, (32, 32, 3))
    jm.build(jax.random.PRNGKey(0))
    tm = timage.vgg19(5, (32, 32, 3))
    tm.build(device="cpu")
    jshapes = {k: v.shape for k, v in _flat(jax.tree_util.tree_map(
        np.asarray, jm.params)).items()}
    assert {k: v.shape for k, v in _flat(tm.params).items()} == jshapes
    assert sum(1 for l in tm.layers
               if isinstance(l, tlayers.Convolution2D)) == 16
    assert tm.name == "vgg-19" and timage.vgg16(3).name == "vgg-16"


def test_dropout_is_the_identity_at_inference_and_refused_in_training():
    """VGG's ``Dropout(0.5)``: the identity at inference in both
    packages; in training no longer refused but JAX's, bit for bit, under
    the same key and layer name (output and vjp)."""
    import jax.numpy as jnp

    from zoo_tpu_torch.ops.random import PRNGKey
    x = torch.randn(4, 6)
    for p in (0.0, 0.5):
        assert torch.equal(tlayers.Dropout(p).call({}, x), x)
    assert torch.equal(tlayers.Dropout(0.0).call({}, x, training=True), x)
    # the JAX layer is the identity at inference too
    np.testing.assert_array_equal(
        np.asarray(jlayers.Dropout(0.5).call({}, x.numpy())), x.numpy())
    jl, tl = jlayers.Dropout(0.5, name="fc6_drop"), \
        tlayers.Dropout(0.5, name="fc6_drop")
    jk = jax.random.PRNGKey(12)
    want, vjp = jax.vjp(lambda a: jl.call({}, a, training=True, rng=jk),
                        jnp.asarray(x.numpy()))
    g = torch.randn(4, 6)
    tx = x.clone().requires_grad_()
    got = tl.call({}, tx, training=True, rng=PRNGKey(12))
    got.backward(g)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    assert np.array_equal(tx.grad.numpy(),
                          np.asarray(vjp(jnp.asarray(g.numpy()))[0]))
    with pytest.raises(ValueError, match="rng"):
        tlayers.Dropout(0.5).call({}, x, training=True)


def test_flatten_matches_jax():
    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    got = tlayers.Flatten().call({}, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jlayers.Flatten().call({}, x)))
    assert tlayers.Flatten().compute_output_shape((None, 3, 4, 5)) == \
        jlayers.Flatten().compute_output_shape((None, 3, 4, 5))
