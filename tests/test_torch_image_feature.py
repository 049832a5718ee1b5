"""The port's ``feature/common.py``, ``feature/image.py`` and
``feature/image3d`` against the JAX package's (which calls OpenCV here):
the same seeded numpy images through both.

Exactness: cv2's uint8 ``INTER_LINEAR`` resize, ``COLOR_BGR2HSV`` and
every transform that does not convert HSV back are bit-equal (the
random ones drawing from a ``seed`` what the JAX module draws from
Python's ``random`` after ``random.seed(seed)``); float resizes within
2e-5 relative (cv2 sums its taps in another order); ``COLOR_HSV2BGR``
(and so ``ImageHue``, ``ImageSaturation``, ``ImageColorJitter``) within 1
on uint8, at least 98 % of elements equal (measured 98.6 %: OpenCV's
SIMD path rounds its f32 products differently). Decoding needs cv2: the
port imports it only there, and without it raises naming the package.
"""

import random
import sys

import numpy as np
import pytest

import zoo_tpu.feature.common as jcommon
import zoo_tpu.feature.image as jimage
import zoo_tpu.feature.image3d as j3d

import zoo_tpu_torch.feature.common as tcommon
import zoo_tpu_torch.feature.image as timage
import zoo_tpu_torch.feature.image3d as t3d

cv2 = pytest.importorskip("cv2")

HSV_EQUAL_SHARE = 0.98


def _bgr(h, w, seed=0, c=3):
    shape = (h, w, c) if c else (h, w)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


RESIZES = [((240, 320), (256, 256)), ((300, 300), (256, 256)),
           ((256, 341), (256, 256)), ((37, 53), (20, 90)),
           ((64, 64), (32, 32)), ((50, 40), (17, 13)), ((7, 9), (64, 3)),
           ((224, 224), (224, 224)), ((1, 5), (4, 4))]


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("channels", [3, 1, 0])
def test_uint8_resize_is_cv2s(src, dst, channels):
    img = _bgr(*src, seed=sum(src), c=channels)
    if channels == 1:
        img = img[..., :1]
    want = cv2.resize(img, dst[::-1])
    got = timage.resize_linear(img, dst[1], dst[0])
    if channels == 1:
        want = want[..., None]          # cv2 drops a one-channel axis
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("src,dst", RESIZES[:6])
def test_float_resize_within_cv2s_rounding(src, dst):
    img = np.random.RandomState(1).rand(*src, 3).astype(np.float32) * 255
    want = cv2.resize(img, dst[::-1])
    got = timage.resize_linear(img, dst[1], dst[0])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_bgr_to_hsv_is_cv2s():
    img = _bgr(300, 400, seed=3)
    img[:5, :5] = 7                          # grey: s = 0, h = 0
    assert np.array_equal(timage.bgr_to_hsv(img),
                          cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


def _within_one(got, want, steps=1):
    """Within 1 a conversion back from HSV (``steps`` of them chained),
    at least ``HSV_EQUAL_SHARE ** steps`` of the elements equal."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= steps
    assert (d == 0).mean() >= HSV_EQUAL_SHARE ** steps, (d == 0).mean()


def test_hsv_to_bgr_within_one_of_cv2():
    rs = np.random.RandomState(4)
    hsv = np.stack([rs.randint(0, 180, (300, 300)),
                    rs.randint(0, 256, (300, 300)),
                    rs.randint(0, 256, (300, 300))], -1).astype(np.uint8)
    _within_one(timage.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def _run(jt, tt, img, seed=None):
    """One transformer of each package on a copy of ``img``; the JAX one
    after ``random.seed(seed)``."""
    if seed is not None:
        random.seed(seed)
    want = jt(jimage.ImageFeature(image=img.copy()))
    got = tt(timage.ImageFeature(image=img.copy()))
    return got, want


DETERMINISTIC = [
    ("ImageResize", (100, 130)), ("ImageAspectScale", (64, 200, 8)),
    ("ImageAspectScale", (300,)), ("ImageChannelOrder", ()),
    ("ImageChannelNormalize", (104.0, 117.0, 123.0, 58.0, 57.0, 57.5)),
    ("PerImageNormalize", ()), ("ImageCenterCrop", (50, 70)),
    ("ImageCenterCrop", (500, 10)),
    ("ImageFixedCrop", (0.1, 0.2, 0.7, 0.9)),
    ("ImageFixedCrop", (3, 5, 40, 60, False)),
    ("ImageFiller", (0.2, 0.1, 0.5, 0.6, 17)), ("ImageHFlip", ()),
]


@pytest.mark.parametrize("name,args", DETERMINISTIC)
def test_deterministic_transforms_equal_jax(name, args):
    img = _bgr(90, 120, seed=5)
    got, want = _run(getattr(jimage, name)(*args),
                     getattr(timage, name)(*args), img)
    assert got["image"].dtype == want["image"].dtype
    assert np.array_equal(got["image"], want["image"])


def test_pixel_normalize_and_tensor_and_sample_equal_jax():
    img = _bgr(6, 5, seed=6)
    means = np.random.RandomState(7).rand(6, 5, 3).astype(np.float32)
    got, want = _run(jimage.ImagePixelNormalize(means),
                     timage.ImagePixelNormalize(means), img)
    assert np.array_equal(got["image"], want["image"])
    for kw in ({}, {"format": "NHWC"}, {"to_rgb": True}):
        got, want = _run(jimage.ImageMatToTensor(**kw),
                         timage.ImageMatToTensor(**kw), img)
        assert np.array_equal(got["tensor"], want["tensor"])
    f = {"tensor": img, "label": 3}
    assert timage.ImageSetToSample()(dict(f))["sample"][1] == 3
    assert jimage.ImageSetToSample()(dict(f))["sample"][1] == 3
    assert timage.ImageSetToSample(target_keys=None)(dict(f))["sample"][1] \
        is None


RANDOM = [
    ("ImageRandomCrop", (40, 30), {}),
    ("ImageExpand", (), {}),
    ("ImageMirror", (), {}),
    ("ImageBrightness", (-32.0, 32.0), {}),
    ("ImageRandomAspectScale", ([40, 60, 80], 100), {}),
]


@pytest.mark.parametrize("name,args,kw", RANDOM)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_transforms_draw_jaxs_values(name, args, kw, seed):
    """Three images through one transformer: the seed's whole sequence
    of draws is the JAX module's after ``random.seed``."""
    jt = getattr(jimage, name)(*args, **kw)
    tt = getattr(timage, name)(*args, seed=seed, **kw)
    random.seed(seed)
    wants = [jt(jimage.ImageFeature(image=_bgr(60, 80, seed=i)))
             for i in range(3)]
    gots = [tt(timage.ImageFeature(image=_bgr(60, 80, seed=i)))
            for i in range(3)]
    for got, want in zip(gots, wants):
        assert np.array_equal(got["image"], want["image"])


@pytest.mark.parametrize("seed", [0, 5])
def test_random_preprocessing_draws_jaxs_values(seed):
    jt = jimage.ImageRandomPreprocessing(jimage.ImageHFlip(), 0.5)
    tt = timage.ImageRandomPreprocessing(timage.ImageHFlip(), 0.5, seed=seed)
    random.seed(seed)
    wants = [jt(jimage.ImageFeature(image=_bgr(8, 9, seed=i)))["image"]
             for i in range(6)]
    gots = [tt(timage.ImageFeature(image=_bgr(8, 9, seed=i)))["image"]
            for i in range(6)]
    assert all(np.array_equal(a, b) for a, b in zip(gots, wants))


@pytest.mark.parametrize("name,args,steps", [
    ("ImageHue", (-18.0, 18.0), 1), ("ImageSaturation", (0.5, 1.5), 1),
    ("ImageColorJitter", (1.0, 32.0, 1.0, 0.5, 1.5, 1.0, 18.0), 2)])
@pytest.mark.parametrize("seed", [0, 9])
def test_colour_transforms_within_one(name, args, steps, seed):
    """One HSV round trip a transform; the jitter chains two (saturation
    and hue, with every probability 1)."""
    img = _bgr(64, 96, seed=8)
    got, want = _run(getattr(jimage, name)(*args),
                     getattr(timage, name)(*args, seed=seed), img, seed)
    _within_one(np.asarray(got["image"]), np.asarray(want["image"]), steps)


def test_image_set_equals_jax(tmp_path):
    imgs = [_bgr(20 + i, 30, seed=i) for i in range(5)]
    labels = [0, 1, 0, 2, 1]
    js = jimage.ImageSet.from_arrays([i.copy() for i in imgs], labels)
    ts = timage.ImageSet.from_arrays([i.copy() for i in imgs], labels)
    chain = [jimage.ImageResize(16, 16), jimage.ImageMatToTensor(),
             jimage.ImageSetToSample()]
    tchain = [timage.ImageResize(16, 16), timage.ImageMatToTensor(),
              timage.ImageSetToSample()]
    js.transform(jcommon.ChainedPreprocessing(chain))
    ts.transform(tcommon.ChainedPreprocessing(tchain))
    jx, jy = js.to_arrays()
    tx, ty = ts.to_arrays()
    assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    assert ts.get_label() == js.get_label() and len(ts) == 5
    np.random.seed(3)
    jsplit = js.random_split([0.6, 0.4])
    tsplit = ts.random_split([0.6, 0.4], seed=3)
    for a, b in zip(tsplit, jsplit):
        assert [np.array_equal(x["tensor"], y["tensor"])
                for x, y in zip(a.features, b.features)] == [True] * len(b)
    for n in (None, 2, 3):
        jparts, tparts = js.to_xshards(n).collect(), \
            ts.to_xshards(n).collect()
        assert [len(p) for p in tparts] == [len(p) for p in jparts]
        assert all(np.array_equal(a["tensor"], b["tensor"])
                   for tp, jp in zip(tparts, jparts)
                   for a, b in zip(tp, jp))


def test_decoding_equals_jax_with_cv2(tmp_path):
    for label in ("cat", "dog"):
        (tmp_path / label).mkdir()
        for i in range(2):
            cv2.imwrite(str(tmp_path / label / f"{i}.png"),
                        _bgr(12 + i, 10, seed=i))
    for kw in ({"with_label": True}, {"with_label": True,
                                      "resize_height": 7,
                                      "resize_width": 9}):
        js = jimage.ImageSet.read(str(tmp_path), **kw)
        ts = timage.ImageSet.read(str(tmp_path), **kw)
        assert ts.label_map == js.label_map == {"cat": 0, "dog": 1}
        assert ts.get_label() == js.get_label()
        for a, b in zip(ts.get_image(), js.get_image()):
            assert np.array_equal(a, b)
    data = cv2.imencode(".png", _bgr(9, 11))[1].tobytes()
    got = timage.ImageBytesToMat()({"bytes": data})
    want = jimage.ImageBytesToMat()({"bytes": data})
    assert np.array_equal(got["image"], want["image"])


def test_decoding_without_cv2_names_the_package(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        timage.ImageBytesToMat()({"bytes": b"\x89PNG"})
    with pytest.raises(ImportError, match="cv2"):
        timage.ImageSet.read(str(tmp_path))
    # resize and colour need no cv2
    assert timage.ImageResize(4, 4).map_image(_bgr(8, 8)).shape == (4, 4, 3)


def test_preprocessing_algebra_equals_jax(tmp_path):
    def both(mod):
        return mod.Lambda(lambda v: v * 2) > mod.SeqToTensor((2, 3))
    x = np.arange(6)
    assert np.array_equal(both(tcommon)(x), both(jcommon)(x))
    assert len((both(tcommon) > tcommon.ToTuple()).transformers) == 3
    for name, args, x in [
            ("ScalarToTensor", (), 3), ("SeqToTensor", (), [1, 2]),
            ("ArrayToTensor", ((2, 2),), [1, 2, 3, 4]),
            ("ToTuple", (), 5), ("TensorToSample", (), np.ones(2))]:
        got = getattr(tcommon, name)(*args)(x)
        want = getattr(jcommon, name)(*args)(x)
        assert type(got) is type(want)
        if isinstance(want, tuple):
            assert len(got) == len(want)
        else:
            assert np.array_equal(got, want) and got.dtype == want.dtype
    parts = tcommon.SeqToMultipleTensors([(2,), (2, 2)])(range(6))
    assert [p.tolist() for p in parts] == [
        p.tolist() for p in jcommon.SeqToMultipleTensors([(2,), (2, 2)])(
            range(6))]
    pair = tcommon.FeatureLabelPreprocessing(tcommon.ScalarToTensor(),
                                             tcommon.ToTuple())((1, 2))
    assert pair[1] == (2,) and pair[0].dtype == np.float32
    samples = [(np.full(2, i), i) for i in range(5)]
    for drop in (False, True):
        got = tcommon.SampleToMiniBatch(2, drop).apply(samples)
        want = jcommon.SampleToMiniBatch(2, drop).apply(samples)
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    path = tmp_path / "rel.csv"
    path.write_text("q1,a1,1\nq1,a2,0\nbad\n")
    assert tcommon.Relations.read(str(path)) == [
        tcommon.Relation("q1", "a1", 1), tcommon.Relation("q1", "a2", 0)]
    assert [(r.id1, r.id2, r.label) for r in jcommon.Relations.read(
        str(path))] == [("q1", "a1", 1), ("q1", "a2", 0)]
    assert list(tcommon.FeatureSet([1, 2]).cache()) == [1, 2]
    # ported with the tiered cache and the parquet readers: both equal
    # the JAX package's on the same inputs
    batches = [np.full(2, float(i)) for i in range(3)]
    for tier in ("DRAM", "PMEM"):
        got = list(tcommon.FeatureSet.ndarrays(batches, tier))
        want = list(jcommon.FeatureSet.ndarrays(batches, tier))
        assert len(got) == len(want) == 3
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    ppath = str(tmp_path / "rel.parquet")
    pq.write_table(pa.table({"id1": ["q1", "q2"], "id2": ["a1", "a2"],
                             "label": [1, 0]}), ppath)
    assert [(r.id1, r.id2, r.label) for r in
            tcommon.Relations.read_parquet(ppath)] == \
        [(r.id1, r.id2, r.label) for r in
         jcommon.Relations.read_parquet(ppath)] == \
        [("q1", "a1", 1), ("q2", "a2", 0)]


def test_image3d_equals_jax():
    vol = np.random.RandomState(2).rand(9, 10, 11).astype(np.float32)
    cases = [("Crop3D", ((1, 2, 3), (4, 5, 6))),
             ("CenterCrop3D", ((5, 4, 3),)),
             ("Rotate3D", ((0.3, -0.2, 0.5),)),
             ("AffineTransform3D", (np.eye(3) * 1.1, (0.5, -1.0, 2.0))),
             ("AffineTransform3D", (np.diag([1.0, 0.9, 1.2]),))]
    for name, args in cases:
        got = getattr(t3d, name)(*args).map_image(vol)
        want = getattr(j3d, name)(*args).map_image(vol)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for seed in (0, 4):
        random.seed(seed)
        jt = j3d.RandomCrop3D((3, 4, 5))
        wants = [jt.map_image(vol) for _ in range(3)]
        tt = t3d.RandomCrop3D((3, 4, 5), seed=seed)
        assert all(np.array_equal(tt.map_image(vol), w) for w in wants)
    from zoo_tpu_torch.feature.image3d import transformation
    assert transformation.Rotate3D is t3d.Rotate3D
