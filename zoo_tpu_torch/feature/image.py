"""Image pipeline of the port (counterpart of ``zoo_tpu/feature/image.py``):
``ImageFeature``, ``ImageSet`` and the ``Image*`` transformers over HWC
numpy arrays (BGR, OpenCV's order, as in the JAX module).

The JAX module calls OpenCV for resizing, colour conversion and
decoding. The machine with the card has neither ``cv2`` nor ``PIL``, so
this module computes the first two itself and imports ``cv2`` only
inside the decoding functions:

- :func:`resize_linear` is ``cv2.resize(img, (w, h))`` (``INTER_LINEAR``):
  sample ``(d + 0.5) * src / dst - 0.5`` per axis, the column taps
  clamped at the edges (weight 0 past them), the row taps clipped to
  the image; for uint8 OpenCV's fixed point (11-bit weights, the
  horizontal sums in int32, the vertical pass ``((b0 * (S0 >> 4)) >>
  16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``), equal to cv2 on every
  size tried; other dtypes in floating point (cv2's SIMD order differs:
  within a few f32 ulp);
- :func:`bgr_to_hsv` is ``COLOR_BGR2HSV`` for uint8 (OpenCV's 12-bit
  division tables, H in [0, 180)), equal to cv2; :func:`hsv_to_bgr` is
  ``COLOR_HSV2BGR`` in f32, within 1 of cv2 (98.6 % equal);
- ``ImageBytesToMat`` and ``ImageSet.read`` decode with ``cv2``, imported
  when they run; without it they raise, naming the package.

Random transformers take ``seed`` (an int, or a ``random.Random`` to
share): one seed draws what the JAX module draws from Python's
``random`` after ``random.seed(seed)``. ``ImageSet.to_xshards`` splits
the features into XShards of feature lists, as the JAX module does.
"""

from __future__ import annotations

import glob as _glob
import os
import random
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from zoo_tpu_torch.feature.common import Preprocessing

Seed = Union[int, random.Random, None]


def _rng(seed: Seed) -> random.Random:
    return seed if isinstance(seed, random.Random) else random.Random(seed)


def _cv2(what: str):
    """``cv2``, imported here; a clear error where it is absent."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} decodes images with OpenCV: install the cv2 package "
            "(opencv-python); zoo_tpu_torch resizes and converts colours "
            "without it, but does not decode") from e
    return cv2


# ------------------------------------------------------------- resize

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _taps(src: int, dst: int, clamp: bool):
    """First tap, second tap and the f32 fraction of each output along
    one axis, cv2's ``INTER_LINEAR`` coordinates: ``clamp`` (columns)
    zeroes the fraction past either edge; rows keep it and clip their
    taps to the image."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        out = (s < 0) | (s >= src - 1)
        f[out] = 0.0
        s = np.clip(s, 0, src - 1)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _fixed(f: np.ndarray):
    """The fraction's 11-bit fixed-point weights (round half to even, as
    ``saturate_cast<short>``)."""
    one = np.float32(1.0)
    a0 = np.rint((one - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    a1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return a0, a1


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` of an HW or HWC array
    (module docstring)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    x0, x1, fx = _taps(w, width, clamp=True)
    y0, y1, fy = _taps(h, height, clamp=False)
    tail = (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        a0, a1 = _fixed(fx)
        b0, b1 = _fixed(fy)
        src = img.astype(np.int64)
        hz = src[:, x0] * a0[(slice(None),) + tail] + \
            src[:, x1] * a1[(slice(None),) + tail]
        b0, b1 = (b[(slice(None), None) + tail] for b in (b0, b1))
        out = (((b0 * (hz[y0] >> 4)) >> 16) +
               ((b1 * (hz[y1] >> 4)) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    ft = img.dtype.type if img.dtype in (np.float32, np.float64) \
        else np.float64
    src = img.astype(ft)
    ax1, ay1 = fx.astype(ft), fy.astype(ft)
    ax0, ay0 = ft(1) - ax1, ft(1) - ay1
    col = (slice(None),) + tail
    hz = src[:, x0] * ax0[col] + src[:, x1] * ax1[col]
    row = (slice(None), None) + tail
    out = hz[y0] * ay0[row] + hz[y1] * ay1[row]
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


# ---------------------------------------------------------- colour

_HSV_SHIFT = 12
_i = np.arange(256, dtype=np.float64)
_SDIV = np.where(_i > 0, np.rint((255 << _HSV_SHIFT) / np.maximum(_i, 1)),
                 0).astype(np.int64)
_HDIV = np.where(_i > 0, np.rint((180 << _HSV_SHIFT) /
                                 (6.0 * np.maximum(_i, 1))),
                 0).astype(np.int64)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                     [0, 1, 3], [2, 1, 0]])


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` of a uint8 BGR image: H in
    [0, 180), S and V in [0, 255], OpenCV's integer arithmetic."""
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    hue = np.where(v == r, g - b,
                   np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hue = (hue * _HDIV[diff] + half) >> _HSV_SHIFT
    hue = hue + np.where(hue < 0, 180, 0)
    return np.stack([np.clip(hue, 0, 255), s, v], -1).astype(np.uint8)


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` of a uint8 HSV image (H in
    [0, 180)): OpenCV's sector formula in f32, truncated to uint8."""
    f32 = np.float32
    one = f32(1.0)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255)
    sector = np.floor(h)
    h = (h - sector).astype(f32)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], -1)
    idx = _SECTORS[sector.astype(np.int64) % 6]
    bgr = np.take_along_axis(tab, idx, -1) * f32(255)
    return np.clip(np.trunc(bgr), 0, 255).astype(np.uint8)


class ImageFeature(dict):
    """Mutable record flowing through the pipeline: keys ``image`` (HWC
    ndarray), ``label``, ``uri``, and what transformers attach
    (``tensor``, ``sample``, ``predict``, ...)."""

    def __init__(self, image=None, label=None, uri: Optional[str] = None):
        super().__init__()
        if image is not None:
            self["image"] = image
        if label is not None:
            self["label"] = label
        if uri is not None:
            self["uri"] = uri


class ImagePreprocessing(Preprocessing):
    """Base: transforms an ``ImageFeature`` in place via
    :meth:`map_image`."""

    def map_image(self, img: np.ndarray) -> np.ndarray:
        return img

    def __call__(self, feature: ImageFeature) -> ImageFeature:
        feature["image"] = self.map_image(feature["image"])
        return feature


# ---------------------------------------------------------- transformers

class ImageBytesToMat(ImagePreprocessing):
    """Decode encoded bytes (jpg/png) to an HWC BGR mat with cv2
    (imported here; raises without it)."""

    def __call__(self, feature: ImageFeature) -> ImageFeature:
        cv2 = _cv2("ImageBytesToMat")
        buf = np.frombuffer(feature["bytes"], dtype=np.uint8)
        feature["image"] = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        return feature


class ImageResize(ImagePreprocessing):
    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def map_image(self, img):
        return resize_linear(img, self.w, self.h)


class ImageAspectScale(ImagePreprocessing):
    """Scale the short side to ``min_size``, the long side capped at
    ``max_size``."""

    def __init__(self, min_size: int, max_size: int = 1000,
                 scale_multiple_of: int = 1):
        self.min_size, self.max_size = min_size, max_size
        self.mult = scale_multiple_of

    def map_image(self, img):
        return self._scale(img, self.min_size)

    def _scale(self, img, min_size):
        h, w = img.shape[:2]
        short, long_ = min(h, w), max(h, w)
        scale = min(min_size / short, self.max_size / long_)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if self.mult > 1:
            nh = (nh // self.mult) * self.mult
            nw = (nw // self.mult) * self.mult
        return resize_linear(img, max(nw, 1), max(nh, 1))


class ImageRandomAspectScale(ImageAspectScale):
    """``min_size`` drawn from ``scales`` per image."""

    def __init__(self, scales: Sequence[int], max_size: int = 1000,
                 seed: Seed = None):
        super().__init__(min_size=scales[0], max_size=max_size)
        self.scales = list(scales)
        self.rng = _rng(seed)

    def map_image(self, img):
        return self._scale(img, self.rng.choice(self.scales))


class ImageBrightness(ImagePreprocessing):
    """Add a uniform delta in [delta_low, delta_high]."""

    def __init__(self, delta_low: float, delta_high: float,
                 seed: Seed = None):
        self.low, self.high = delta_low, delta_high
        self.rng = _rng(seed)

    def map_image(self, img):
        delta = self.rng.uniform(self.low, self.high)
        return np.clip(img.astype(np.float32) + delta, 0, 255)


class ImageHue(ImagePreprocessing):
    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 seed: Seed = None):
        self.low, self.high = delta_low, delta_high
        self.rng = _rng(seed)

    def map_image(self, img):
        hsv = bgr_to_hsv(img.astype(np.uint8)).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] +
                       self.rng.uniform(self.low, self.high) / 2.0) % 180
        return hsv_to_bgr(hsv.astype(np.uint8))


class ImageSaturation(ImagePreprocessing):
    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Seed = None):
        self.low, self.high = delta_low, delta_high
        self.rng = _rng(seed)

    def map_image(self, img):
        hsv = bgr_to_hsv(img.astype(np.uint8)).astype(np.float32)
        hsv[..., 1] = np.clip(
            hsv[..., 1] * self.rng.uniform(self.low, self.high), 0, 255)
        return hsv_to_bgr(hsv.astype(np.uint8))


class ImageChannelOrder(ImagePreprocessing):
    """BGR <-> RGB."""

    def map_image(self, img):
        return img[..., ::-1].copy()


class ImageColorJitter(ImagePreprocessing):
    """Random brightness, saturation and hue in random order; the three
    share the jitter's generator, so one seed draws the JAX module's
    sequence."""

    def __init__(self, brightness_prob=0.5, brightness_delta=32.0,
                 saturation_prob=0.5, saturation_lower=0.5,
                 saturation_upper=1.5, hue_prob=0.5, hue_delta=18.0,
                 seed: Seed = None):
        self.rng = _rng(seed)
        self.ops = [
            (brightness_prob, ImageBrightness(
                -brightness_delta, brightness_delta, seed=self.rng)),
            (saturation_prob, ImageSaturation(
                saturation_lower, saturation_upper, seed=self.rng)),
            (hue_prob, ImageHue(-hue_delta, hue_delta, seed=self.rng)),
        ]

    def map_image(self, img):
        ops = list(self.ops)
        self.rng.shuffle(ops)
        for prob, op in ops:
            if self.rng.random() < prob:
                img = op.map_image(img.astype(np.uint8))
        return img


class ImageChannelNormalize(ImagePreprocessing):
    """``(x - mean) / std`` per channel, BGR order, in f32."""

    def __init__(self, mean_b: float, mean_g: float, mean_r: float,
                 std_b: float = 1.0, std_g: float = 1.0, std_r: float = 1.0):
        self.mean = np.array([mean_b, mean_g, mean_r], np.float32)
        self.std = np.array([std_b, std_g, std_r], np.float32)

    def map_image(self, img):
        return (img.astype(np.float32) - self.mean) / self.std


class PerImageNormalize(ImagePreprocessing):
    """``(x - min) / (max - min)`` per image."""

    def map_image(self, img):
        img = img.astype(np.float32)
        lo, hi = img.min(), img.max()
        return (img - lo) / max(hi - lo, 1e-8)


class ImagePixelNormalize(ImagePreprocessing):
    """Subtract a per-pixel mean array."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def map_image(self, img):
        return img.astype(np.float32) - self.means.reshape(img.shape)


class ImageCenterCrop(ImagePreprocessing):
    def __init__(self, crop_width: int, crop_height: int):
        self.w, self.h = crop_width, crop_height

    def map_image(self, img):
        h, w = img.shape[:2]
        y0 = max((h - self.h) // 2, 0)
        x0 = max((w - self.w) // 2, 0)
        return img[y0:y0 + self.h, x0:x0 + self.w]


class ImageRandomCrop(ImagePreprocessing):
    def __init__(self, crop_width: int, crop_height: int, seed: Seed = None):
        self.w, self.h = crop_width, crop_height
        self.rng = _rng(seed)

    def map_image(self, img):
        h, w = img.shape[:2]
        y0 = self.rng.randint(0, max(h - self.h, 0))
        x0 = self.rng.randint(0, max(w - self.w, 0))
        return img[y0:y0 + self.h, x0:x0 + self.w]


class ImageFixedCrop(ImagePreprocessing):
    """Crop by an explicit box; normalized coordinates when
    ``normalized``."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def map_image(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = int(x1 * w), int(x2 * w)
            y1, y2 = int(y1 * h), int(y2 * h)
        return img[int(y1):int(y2), int(x1):int(x2)]


class ImageExpand(ImagePreprocessing):
    """Place the image on a random larger canvas filled with the means
    (SSD-style augmentation)."""

    def __init__(self, means_b: float = 123, means_g: float = 117,
                 means_r: float = 104, max_expand_ratio: float = 4.0,
                 seed: Seed = None):
        self.mean = np.array([means_b, means_g, means_r], np.float32)
        self.max_ratio = max_expand_ratio
        self.rng = _rng(seed)

    def map_image(self, img):
        ratio = self.rng.uniform(1.0, self.max_ratio)
        h, w = img.shape[:2]
        nh, nw = int(h * ratio), int(w * ratio)
        out = np.empty((nh, nw, img.shape[2]), np.float32)
        out[:] = self.mean
        y0 = self.rng.randint(0, nh - h)
        x0 = self.rng.randint(0, nw - w)
        out[y0:y0 + h, x0:x0 + w] = img
        return out


class ImageFiller(ImagePreprocessing):
    """Fill a normalized box with a constant."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 value: int = 255):
        self.box, self.value = (x1, y1, x2, y2), value

    def map_image(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        img = img.copy()
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        return img


class ImageHFlip(ImagePreprocessing):
    def map_image(self, img):
        return img[:, ::-1].copy()


class ImageMirror(ImagePreprocessing):
    """Horizontal flip with probability 0.5."""

    def __init__(self, seed: Seed = None):
        self.rng = _rng(seed)

    def map_image(self, img):
        return img[:, ::-1].copy() if self.rng.random() < 0.5 else img


class ImageRandomPreprocessing(ImagePreprocessing):
    """Apply ``preprocessing`` with probability ``prob``."""

    def __init__(self, preprocessing: ImagePreprocessing, prob: float,
                 seed: Seed = None):
        self.inner = preprocessing
        self.prob = prob
        self.rng = _rng(seed)

    def __call__(self, feature):
        return self.inner(feature) if self.rng.random() < self.prob \
            else feature


class ImageMatToTensor(ImagePreprocessing):
    """HWC -> CHW (``format="NCHW"``) or HWC f32 under key ``tensor``;
    ``to_rgb`` flips the channel order."""

    def __init__(self, to_rgb: bool = False, format: str = "NCHW"):
        self.to_rgb = to_rgb
        self.format = format

    def __call__(self, feature):
        img = feature["image"].astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        if self.format == "NCHW":
            img = np.transpose(img, (2, 0, 1))
        feature["tensor"] = np.ascontiguousarray(img)
        return feature


class ImageSetToSample(ImagePreprocessing):
    """Terminal step: ``sample`` = (tensor, label)."""

    def __init__(self, input_keys: Sequence[str] = ("tensor",),
                 target_keys: Optional[Sequence[str]] = ("label",)):
        self.input_keys = list(input_keys)
        self.target_keys = list(target_keys) if target_keys else None

    def __call__(self, feature):
        xs = [feature[k] for k in self.input_keys]
        ys = None
        if self.target_keys and self.target_keys[0] in feature:
            ys = feature[self.target_keys[0]]
        feature["sample"] = (xs[0] if len(xs) == 1 else tuple(xs), ys)
        return feature


# -------------------------------------------------------------- ImageSet

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class ImageSet:
    """A list of ``ImageFeature``s: ``read`` from a file, directory or
    glob (decoding with cv2), ``transform`` through a Preprocessing,
    ``to_arrays`` for training."""

    def __init__(self, features: List[ImageFeature]):
        self.features = features

    @classmethod
    def read(cls, path: str, with_label: bool = False,
             resize_height: int = -1, resize_width: int = -1) -> "ImageSet":
        """Flat files, or ``path/<label>/*.jpg`` with ``with_label`` (the
        label map from the sorted directory names)."""
        cv2 = _cv2("ImageSet.read")
        files: List[Tuple[str, Optional[int]]] = []
        label_map = {}
        if os.path.isdir(path) and with_label:
            classes = sorted(d for d in os.listdir(path)
                             if os.path.isdir(os.path.join(path, d)))
            label_map = {c: i for i, c in enumerate(classes)}
            for c in classes:
                for f in sorted(os.listdir(os.path.join(path, c))):
                    if f.lower().endswith(_IMG_EXTS):
                        files.append((os.path.join(path, c, f),
                                      label_map[c]))
        elif os.path.isdir(path):
            for f in sorted(os.listdir(path)):
                if f.lower().endswith(_IMG_EXTS):
                    files.append((os.path.join(path, f), None))
        else:
            for f in sorted(_glob.glob(path)) or [path]:
                files.append((f, None))
        feats = []
        for f, lbl in files:
            img = cv2.imread(f, cv2.IMREAD_COLOR)
            if img is None:
                continue
            if resize_height > 0 and resize_width > 0:
                img = resize_linear(img, resize_width, resize_height)
            feats.append(ImageFeature(image=img, label=lbl, uri=f))
        out = cls(feats)
        out.label_map = label_map
        return out

    @classmethod
    def from_arrays(cls, images: Sequence[np.ndarray],
                    labels: Optional[Sequence] = None) -> "ImageSet":
        feats = [ImageFeature(image=img,
                              label=None if labels is None else labels[i])
                 for i, img in enumerate(images)]
        return cls(feats)

    def transform(self, transformer: Preprocessing) -> "ImageSet":
        self.features = [transformer(f) for f in self.features]
        return self

    def get_image(self, key: str = "image") -> List[np.ndarray]:
        return [f[key] for f in self.features]

    def get_label(self) -> List:
        return [f.get("label") for f in self.features]

    def get_predict(self, key: str = "predict") -> List:
        return [f.get(key) for f in self.features]

    def to_arrays(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Stack the ``sample`` entries into (x, y) batch arrays."""
        xs = np.stack([f["sample"][0] for f in self.features])
        ys = None
        if self.features and self.features[0]["sample"][1] is not None:
            ys = np.asarray([f["sample"][1] for f in self.features])
        return xs, ys

    def random_split(self, weights: Sequence[float],
                     seed: Optional[int] = None) -> List["ImageSet"]:
        """Split by ``weights``; the permutation is
        ``np.random.RandomState(seed)``'s (the JAX module draws it from
        numpy's global generator)."""
        idx = np.random.RandomState(seed).permutation(len(self.features))
        w = np.asarray(weights, np.float64)
        bounds = np.cumsum(w / w.sum() * len(idx)).astype(int)
        out, lo = [], 0
        for hi in bounds:
            out.append(ImageSet([self.features[i] for i in idx[lo:hi]]))
            lo = hi
        return out

    def to_xshards(self, num_shards: Optional[int] = None):
        """The features as a ``LocalXShards`` of ``num_shards`` (default
        ``default_cores()``) contiguous lists of feature dicts."""
        from zoo_tpu_torch.common.context import default_cores
        from zoo_tpu_torch.orca.data.shard import LocalXShards
        n = num_shards or default_cores()
        chunks = np.array_split(np.arange(len(self.features)), max(n, 1))
        return LocalXShards([[self.features[i] for i in c] for c in chunks])

    def __len__(self):
        return len(self.features)
