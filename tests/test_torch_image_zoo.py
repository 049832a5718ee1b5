"""The port's image-classification zoo against the JAX package's:
Inception-v1, MobileNet v1 (``alpha`` 0.75) and v2, SqueezeNet and
DenseNet-121 at 32 x 32 x 3 with 7 classes (``ImageClassifier`` and the
preprocessing: ``tests/test_torch_image_classifier.py``).

Both sides run on the same weights: the JAX model draws its params,
BatchNorm's gamma and beta are redrawn from a numpy seed, its running
statistics are set to those of a batch of 32 other images (one
training-mode forward of the port at momentum 0: else the seed-built
MobileNets' activations die out and every image gets the same output),
and ``keras_params_from_jax`` carries the tree over (the keys match: the
same graph, layer for layer). The JAX forwards take most of this file's time, so a
module-scoped fixture computes each family's once.

Tolerance: softmax outputs within 1e-5 of the JAX forward, f32 (XLA
and PyTorch sum the convs in another order), on outputs that differ
between images by far more than that.
"""

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models.image import imageclassification as jzoo

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models import image as timage
from zoo_tpu_torch.models.image import imageclassification as tzoo
from zoo_tpu_torch.ops import random as R
from zoo_tpu_torch.pipeline.api.keras.layers import BatchNormalization

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

SIZE, CLASSES, N = (32, 32, 3), 7, 3
TOL = 1e-5
FAMILIES = {
    "inception_v1": {},
    "mobilenet_v1": {"alpha": 0.75},
    "mobilenet_v2": {},
    "squeezenet": {},
    "densenet121": {},
}
# the input scale at which a family's softmax outputs spread: the two
# without BatchNorm take pixel-scale inputs (their logits scale with
# them), the rest the unit scale their deploy chains give
SCALE = {"inception_v1": 100.0, "squeezenet": 2000.0}


def redraw_batchnorm(tree, seed):
    """Each BatchNorm's gamma, var ~ U(0.5, 1.5) and beta, mean ~ 0.1 N,
    from ``seed`` (numpy, so both packages read the same values)."""
    rs = np.random.RandomState(seed)
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict) and "stats" in val:
            d = val["gamma"].shape[0]
            val["gamma"] = (rs.rand(d) + 0.5).astype(np.float32)
            val["beta"] = (0.1 * rs.randn(d)).astype(np.float32)
            val["stats"] = {"mean": (0.1 * rs.randn(d)).astype(np.float32),
                            "var": (rs.rand(d) + 0.5).astype(np.float32)}
    return tree


def refresh_batchnorm(model, x):
    """Every BatchNorm's running statistics set to those of its input in
    a training-mode forward of ``x`` (momentum 0 for that pass): in
    inference the model then normalizes ``x`` as training mode does."""
    bns = [l for l in model.layers if isinstance(l, BatchNormalization)]
    saved = [l.momentum for l in bns]
    collect = {}
    try:
        for layer in bns:
            layer.momentum = 0.0
        with torch.no_grad():
            model._forward(model.params, [torch.from_numpy(x)],
                           training=True, collect=collect,
                           rng=R.PRNGKey(0))
    finally:
        for layer, m in zip(bns, saved):
            layer.momentum = m
    for key, val in collect.items():
        model.params[key]["stats"] = val["stats"]


def _images(family, n, seed=0):
    return (SCALE.get(family, 1.0) * np.random.RandomState(seed).randn(
        n, *SIZE)).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


@pytest.fixture(scope="module")
def jax_runs():
    """Each family's JAX params (numpy, BN redrawn) and its forward on
    ``_images(N)``: computed once for the file."""
    jax_context._runtime_context = None
    out = {}
    for family, kw in FAMILIES.items():
        x = _images(family, N)
        jm = getattr(jzoo, family)(CLASSES, input_shape=SIZE, **kw)
        jm.build(jax.random.PRNGKey(0))
        tree = redraw_batchnorm(
            jax.tree_util.tree_map(np.asarray, jm.params), 1)
        tm = _port(family, tree)
        refresh_batchnorm(tm, _images(family, 32, seed=1))
        tree = jax.tree_util.tree_map(
            lambda t: t.numpy(), tm.params)
        jm.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
        out[family] = (tree, np.asarray(jm.predict(x, batch_size=N)))
    return out


def _port(family, tree):
    kw = FAMILIES[family]
    tm = getattr(timage, family)(CLASSES, input_shape=SIZE, **kw)
    tm.params = keras_params_from_jax(tree, "cpu")
    return tm


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
        else:
            out.add((prefix + k, tuple(v.shape)))
    return out


@pytest.mark.timeout(300)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_equals_jax(jax_runs, family):
    tree, want = jax_runs[family]
    tm = _port(family, tree)
    built = getattr(timage, family)(
        CLASSES, input_shape=SIZE, **FAMILIES[family]).build(device="cpu")
    assert _keys(built) == _keys(tree)          # the same graph's tree
    got = tm.predict(_images(family, N), batch_size=N, device="cpu")
    assert got.shape == (N, CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the comparison is not vacuous: the images' outputs differ
    assert np.abs(want - want.mean(0)).max() > 100 * TOL


def test_the_catalogue_names_equal_jax():
    """The catalogue, its configs and its functions' names."""
    assert sorted(tzoo._ZOO) == sorted(jzoo._ZOO)
    assert tzoo._CONFIGS == jzoo._CONFIGS
    for name in tzoo._ZOO:
        assert tzoo._ZOO[name].__name__ == jzoo._ZOO[name].__name__
    with pytest.raises(ValueError, match="unknown image-classification"):
        tzoo.create_image_classifier("alexnet")


def test_model_names_pick_their_configs():
    for name in tzoo._ZOO:
        m = tzoo.create_image_classifier(name, 5)
        assert m.name == name == jzoo.create_image_classifier(name, 5).name
