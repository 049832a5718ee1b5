"""SSD detection of the port (``zoo_tpu_torch.models.image.
objectdetection``) against the JAX module on the same numpy inputs and
the same weights (the JAX model's params carried over with
``zoo_tpu_torch.convert.ssd_from_jax``): anchors and targets bit-equal;
decoding, IoU, NMS (exact score ties included: ``lax.top_k`` puts the
lower index first) and the multibox loss (equal-loss negatives
included: the mining ranks by stable sorts) within f32 rounding; the
forward, three ``fit_detection`` epochs, ``predict_detections`` and the
``ObjectDetector`` pipeline (the port's own uint8 resize against cv2's,
and a saved model file) on small inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models.image import objectdetection as J

from zoo_tpu_torch.convert import ssd_from_jax
from zoo_tpu_torch.models.image import objectdetection as T

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX module places on an orca mesh left by another test."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def make_shapes(n, size=64, seed=0):
    """``examples/object_detection_ssd.py``'s synthetic shapes: bright
    squares (class 1) and blue bars (class 2) on dim noise, one object
    an image with its normalized box."""
    rs = np.random.RandomState(seed)
    imgs = rs.rand(n, size, size, 3).astype(np.float32) * 0.2
    boxes, labels = [], []
    for i in range(n):
        cls = 1 + rs.randint(2)
        if cls == 1:
            w = h = rs.randint(16, 28)
        else:
            w, h = rs.randint(24, 36), rs.randint(8, 14)
        x1 = rs.randint(0, size - w)
        y1 = rs.randint(0, size - h)
        color = (np.array([0.9, 0.8, 0.2]) if cls == 1
                 else np.array([0.2, 0.3, 0.9]))
        imgs[i, y1:y1 + h, x1:x1 + w] = color + 0.05 * rs.randn(h, w, 3)
        boxes.append(np.array([[x1 / size, y1 / size, (x1 + w) / size,
                                (y1 + h) / size]], np.float32))
        labels.append(np.array([cls], np.int32))
    return imgs, boxes, labels


def _pair(n_classes=3, input_size=64, channels=(16, 32)):
    jm = J.SSD(n_classes, input_size=input_size, feature_channels=channels)
    jm.build()
    return jm, ssd_from_jax(jm, device="cpu")


@pytest.mark.parametrize("input_size,channels", [(64, (16, 32)),
                                                 (300, (32, 64, 128)),
                                                 (75, (8, 8, 8, 8))])
def test_anchors_equal(input_size, channels):
    jm = J.SSD(21, input_size=input_size, feature_channels=channels)
    tm = T.SSD(21, input_size=input_size, feature_channels=channels)
    assert tm.feature_sizes == jm.feature_sizes
    assert tm.scales == jm.scales
    assert np.array_equal(tm.anchors, jm.anchors)
    if input_size == 300:
        assert tm.feature_sizes == [38, 19, 10]
        assert tm.anchors.shape == (5715, 4)


def test_encode_targets_equal():
    anchors = J.SSD(3, input_size=64).anchors
    rs = np.random.RandomState(0)
    for g in (0, 1, 3, 6):
        xy = rs.rand(g, 2) * 0.6
        gt = np.concatenate([xy, xy + 0.05 + rs.rand(g, 2) * 0.3], 1)
        labels = rs.randint(1, 3, g).astype(np.int32)
        for thr in (0.3, 0.5):
            c1, b1 = T.encode_targets(anchors, gt.astype(np.float32),
                                      labels, thr)
            c2, b2 = J.encode_targets(anchors, gt.astype(np.float32),
                                      labels, thr)
            assert np.array_equal(c1, c2) and np.array_equal(b1, b2)


def test_decode_and_iou_match_jax():
    rs = np.random.RandomState(1)
    anchors = J.SSD(3, input_size=64).anchors
    deltas = rs.randn(2, anchors.shape[0], 4).astype(np.float32)
    got = T.decode_boxes(_t(anchors), _t(deltas)).numpy()
    want = np.stack([np.asarray(J.decode_boxes(jnp.asarray(anchors),
                                               jnp.asarray(d)))
                     for d in deltas])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    a, b = got[0, :40], got[1, :30]
    np.testing.assert_allclose(
        T.iou_matrix(_t(a), _t(b)).numpy(),
        np.asarray(J.iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        T.decode_boxes(_t([[0.5, 0.5, 0.2, 0.2]]), torch.zeros(1, 4)),
        [[0.4, 0.4, 0.6, 0.6]], atol=1e-6)


@pytest.mark.parametrize("case", ["random", "ties", "overlaps"])
@pytest.mark.parametrize("top_k", [3, 10, 50])
def test_nms_matches_jax(case, top_k):
    rs = np.random.RandomState(2)
    n = 30
    xy = rs.rand(n, 2) * 0.7
    boxes = np.concatenate([xy, xy + 0.1 + rs.rand(n, 2) * 0.2],
                           1).astype(np.float32)
    scores = rs.rand(n).astype(np.float32)
    if case == "ties":
        # exact equal scores: the lower index ranks first
        scores = np.round(scores * 4).astype(np.float32) / 4
    if case == "overlaps":
        boxes[1::2] = boxes[0::2] + 0.01
        scores[1::2] = scores[0::2]
    tb, ts, ti = T.nms(_t(boxes), _t(scores), top_k, 0.45)
    jb, js, ji = J.nms(jnp.asarray(boxes), jnp.asarray(scores), top_k,
                       0.45)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    # batched over images: each row is its own image's NMS
    tb2, ts2, ti2 = T.nms(_t(np.stack([boxes, boxes[::-1].copy()])),
                          _t(np.stack([scores, scores[::-1].copy()])),
                          top_k, 0.45)
    assert np.array_equal(ti2[0].numpy(), ti.numpy())
    _, js1, ji1 = J.nms(jnp.asarray(boxes[::-1].copy()),
                        jnp.asarray(scores[::-1].copy()), top_k, 0.45)
    assert np.array_equal(ti2[1].numpy(), np.asarray(ji1))
    assert np.array_equal(ts2[1].numpy(), np.asarray(js1))


@pytest.mark.parametrize("flat", [False, True])
def test_multibox_loss_matches_jax(flat):
    """``flat``: a constant background, so every negative anchor has
    exactly the same cross entropy and the mining picks the lowest
    anchor indices (stable ranks); a different pick changes nothing in
    the sum here, so the chosen set is checked too."""
    rs = np.random.RandomState(3)
    B, A, C = 3, 120, 4
    logits = rs.randn(B, A, C).astype(np.float32)
    if flat:
        logits[:] = np.array([2.0, 0.5, -0.5, 0.1], np.float32)
    deltas = rs.randn(B, A, 4).astype(np.float32)
    cls_t = np.zeros((B, A), np.int32)
    for b in range(B):
        cls_t[b, rs.choice(A, 3 + b, replace=False)] = rs.randint(1, C,
                                                                  3 + b)
    box_t = rs.randn(B, A, 4).astype(np.float32)
    got = T.multibox_loss(_t(logits), _t(deltas), _t(cls_t), _t(box_t))
    want = J.multibox_loss(jnp.asarray(logits), jnp.asarray(deltas),
                           jnp.asarray(cls_t), jnp.asarray(box_t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if flat:
        # the stable double argsort: negatives are the lowest indices
        ce = np.full((A,), 1.0, np.float32)
        neg_ce = torch.where(_t(cls_t[0] > 0), torch.tensor(-np.inf),
                             _t(ce))
        rank = torch.argsort(torch.argsort(-neg_ce, stable=True),
                             stable=True).numpy()
        jrank = np.asarray(jnp.argsort(jnp.argsort(-jnp.asarray(
            neg_ce.numpy()))))
        assert np.array_equal(rank, jrank)


def test_forward_from_converted_params():
    jm, tm = _pair(n_classes=4, input_size=64)
    assert set(tm.params) == set(jm.params)
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    jc, jb = jm._forward(jm.params, [jnp.asarray(x)], training=False,
                         rng=None, collect=None)
    with torch.no_grad():
        tc, tb = tm._forward(tm.params, [_t(x)], training=False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)


def test_fit_detection_three_epochs_matches_jax():
    jm, tm = _pair(n_classes=3, input_size=64)
    imgs, boxes, labels = make_shapes(24, size=64, seed=0)
    want = jm.fit_detection(imgs, boxes, labels, epochs=3, batch_size=8,
                            lr=1e-3, seed=0)
    got = tm.fit_detection(imgs, boxes, labels, epochs=3, batch_size=8,
                           lr=1e-3, seed=0, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    jleaves = jax.tree_util.tree_leaves(jm.params)
    tleaves = [t.detach().numpy() for t in T.tree_leaves(tm.params)]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_predict_detections_matches_jax():
    jm, tm = _pair(n_classes=3, input_size=64)
    imgs, boxes, labels = make_shapes(16, size=64, seed=1)
    jm.fit_detection(imgs, boxes, labels, epochs=2, batch_size=8)
    tm.params = ssd_from_jax(jm, device="cpu").params
    for thr, k in ((0.0, 10), (0.3, 50)):
        want = jm.predict_detections(imgs[:6], score_threshold=thr,
                                     top_k=k)
        got = tm.predict_detections(imgs[:6], score_threshold=thr,
                                    top_k=k, device="cpu")
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.shape[1] == 6
            assert np.array_equal(g[:, 0], w[:, 0])
            np.testing.assert_allclose(g[:, 1:], w[:, 1:], atol=1e-5)
            assert ((g[:, 0] >= 1) & (g[:, 0] < 3)).all()


def test_object_detector_save_load_and_image_set(tmp_path):
    pytest.importorskip("cv2")
    from zoo_tpu.feature.image import ImageSet as JImageSet
    from zoo_tpu_torch.feature.image import ImageSet

    jm, tm = _pair(n_classes=3, input_size=64)
    path = str(tmp_path / "ssd.model")
    tm.save(path)
    det = T.ObjectDetector.load_model(path, label_map={1: "cat"},
                                      device="cpu")
    assert det.label_map == {1: "cat"} and isinstance(det.model, T.SSD)
    rs = np.random.RandomState(5)
    imgs = [rs.randint(0, 255, (80, 100, 3)).astype(np.uint8)
            for _ in range(3)]
    got = det.predict_image_set(ImageSet.from_arrays(
        [i.copy() for i in imgs]), score_threshold=0.0, device="cpu")
    want = J.ObjectDetector(jm).predict_image_set(JImageSet.from_arrays(
        [i.copy() for i in imgs]), score_threshold=0.0)
    for g, w in zip(got.get_predict(), want.get_predict()):
        assert np.array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], atol=1e-5)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = T.SSD(3, input_size=32, feature_channels=(8,))
    x = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.predict_detections(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.fit_detection(x, [np.zeros((0, 4))], [np.zeros(0)], epochs=1)
    assert tm.predict_detections(x, device="cpu")[0].shape[1] == 6
