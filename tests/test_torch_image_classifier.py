"""The port's ``ImageClassifier`` and deploy preprocessing against the
JAX package's: the per-family chains (resize 256, centre crop 224,
channel normalization) on mixed-size uint8 BGR images give equal
tensors (the port's uint8 resize is cv2's, bit for bit);
``predict_image_set`` with SqueezeNet at 224 x 224 (the cheapest family
at that size), 7 classes, on the JAX classifier's weights gives the
same top-k labels, and probabilities within 1e-5 (f32 convs summed in
another order); ``LabelOutput`` is equal; a saved and loaded classifier
predicts the same bits; the detectors are exported beside them.
"""

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.feature.image import ImageSet as JImageSet
from zoo_tpu.models.image import imageclassification as jzoo

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.feature.image import ImageSet
from zoo_tpu_torch.models import image as timage
from zoo_tpu_torch.models.image import imageclassification as tzoo

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

CLASSES, TOL = 7, 1e-5


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _bgr_images(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, s + (3,)).astype(np.uint8)
            for s in ((240, 320), (300, 300), (256, 341), (224, 230))]


@pytest.mark.parametrize("name", sorted(jzoo._CONFIGS))
def test_preprocess_chain_equals_jax(name):
    imgs = _bgr_images()
    want = JImageSet.from_arrays([i.copy() for i in imgs]).transform(
        jzoo.image_classification_preprocess(name))
    got = ImageSet.from_arrays([i.copy() for i in imgs]).transform(
        tzoo.image_classification_preprocess(name))
    for a, b in zip(got.features, want.features):
        assert a["tensor"].shape == (224, 224, 3)
        assert np.array_equal(a["tensor"], b["tensor"])


def test_label_output_equals_jax():
    p = np.random.RandomState(4).rand(10).astype(np.float32)
    labels = {1: "cat", 3: "dog"}
    want = jzoo.LabelOutput(labels, top_k=4)({"predict": p.copy()})
    got = tzoo.LabelOutput(labels, top_k=4)({"predict": p.copy()})
    assert got["classes"] == want["classes"]
    assert got["probs"] == want["probs"]


@pytest.fixture(scope="module")
def squeezenet_224():
    """SqueezeNet at 224 x 224, 7 classes: the JAX classifier, its
    params (numpy) and ``predict_image_set``'s features on four mixed
    sizes of uint8 BGR images."""
    jax_context._runtime_context = None
    jc = jzoo.ImageClassifier.create("squeezenet", CLASSES,
                                     label_map={0: "zero", 5: "five"})
    jc.model.build(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jc.model.params)
    imgs = _bgr_images(1)
    jset = jc.predict_image_set(
        JImageSet.from_arrays([i.copy() for i in imgs]), top_k=3)
    return tree, imgs, jset


@pytest.mark.timeout(300)
def test_predict_image_set_equals_jax(squeezenet_224):
    tree, imgs, jset = squeezenet_224
    tc = tzoo.ImageClassifier.create("squeezenet", CLASSES,
                                     label_map={0: "zero", 5: "five"})
    tc.model.params = keras_params_from_jax(tree, "cpu")
    originals = [i.copy() for i in imgs]
    tset = tc.predict_image_set(ImageSet.from_arrays(imgs), top_k=3,
                                device="cpu")
    for f, g, orig in zip(tset.features, jset.features, originals):
        assert np.array_equal(f["image"], orig)     # images untouched
        assert f["classes"] == g["classes"]
        np.testing.assert_allclose(f["probs"], g["probs"], atol=TOL, rtol=0)
        np.testing.assert_allclose(f["predict"], np.asarray(g["predict"]),
                                   atol=TOL, rtol=0)


@pytest.mark.timeout(300)
def test_save_and_load_round_trip(squeezenet_224, tmp_path):
    tree, imgs, _ = squeezenet_224
    tc = tzoo.ImageClassifier.create("squeezenet", CLASSES)
    tc.model.params = keras_params_from_jax(tree, "cpu")
    x = tc.preprocess(ImageSet.from_arrays(imgs[:2]))
    want = tc.model.predict(x, batch_size=2, device="cpu")
    path = str(tmp_path / "squeezenet.model")
    tc.save_model(path)
    back = tzoo.ImageClassifier.load_model(path, device="cpu")
    assert back.model_name == "squeezenet"
    got = back.model.predict(x, batch_size=2, device="cpu")
    assert np.array_equal(got, want)


def test_mobilenet_round_trip_keeps_depthwise(tmp_path):
    """A model file holds the depthwise layers (a new layer class) and
    loads to the same outputs."""
    tm = timage.mobilenet_v1(CLASSES, alpha=0.25, input_shape=(32, 32, 3))
    tm.build(torch.Generator().manual_seed(0), device="cpu")
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    want = tm.predict(x, batch_size=2, device="cpu")
    path = str(tmp_path / "mobilenet.model")
    tm.save(path)
    back = timage.mobilenet_v1(CLASSES).load(path, device="cpu")
    assert np.array_equal(back.predict(x, batch_size=2, device="cpu"), want)


def test_detectors_name_roadmap_a12():
    """The detectors of ROADMAP A.12 are ported: the names are the
    objectdetection module's, exported as the JAX package exports
    them (their parity is ``tests/test_torch_objectdetection.py``)."""
    from zoo_tpu_torch.models.image import objectdetection as tdet
    for name in ("SSD", "ObjectDetector", "nms", "multibox_loss"):
        assert getattr(timage, name) is getattr(tdet, name)
    assert timage.SSD(3, input_size=32).anchors.shape[1] == 4
    assert set(timage.__all__) == set(
        __import__("zoo_tpu.models.image", fromlist=["x"]).__all__)
