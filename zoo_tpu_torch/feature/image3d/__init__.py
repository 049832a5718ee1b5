"""3-D (volumetric) image transforms of the port (counterpart of
``zoo_tpu/feature/image3d``): crops on numpy, and rotations and affine
maps through ``scipy.ndimage`` (as in the JAX package; scipy is on the
machine with the card), over (D, H, W) arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from zoo_tpu_torch.feature.image import ImagePreprocessing, Seed, _rng


class Crop3D(ImagePreprocessing):
    """Crop a (depth, height, width) patch at ``start``."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(start)
        self.patch = tuple(patch_size)

    def map_image(self, img):
        z, y, x = self.start
        d, h, w = self.patch
        return img[z:z + d, y:y + h, x:x + w]


class RandomCrop3D(ImagePreprocessing):
    """A (depth, height, width) patch at a random corner (``seed`` as
    the 2-D random transformers take it)."""

    def __init__(self, patch_size: Sequence[int], seed: Seed = None):
        self.patch = tuple(patch_size)
        self.rng = _rng(seed)

    def map_image(self, img):
        d, h, w = self.patch
        z = self.rng.randint(0, max(img.shape[0] - d, 0))
        y = self.rng.randint(0, max(img.shape[1] - h, 0))
        x = self.rng.randint(0, max(img.shape[2] - w, 0))
        return img[z:z + d, y:y + h, x:x + w]


class CenterCrop3D(ImagePreprocessing):
    def __init__(self, patch_size: Sequence[int]):
        self.patch = tuple(patch_size)

    def map_image(self, img):
        d, h, w = self.patch
        z = max((img.shape[0] - d) // 2, 0)
        y = max((img.shape[1] - h) // 2, 0)
        x = max((img.shape[2] - w) // 2, 0)
        return img[z:z + d, y:y + h, x:x + w]


class Rotate3D(ImagePreprocessing):
    """Rotate by Euler angles (radians) about the three axes, linear
    interpolation, edges repeated."""

    def __init__(self, rotation_angles: Sequence[float]):
        self.angles = tuple(rotation_angles)

    def map_image(self, img):
        from scipy.ndimage import rotate
        out = img.astype(np.float32)
        for angle, axes in zip(self.angles, [(1, 2), (0, 2), (0, 1)]):
            if angle:
                out = rotate(out, np.degrees(angle), axes=axes,
                             reshape=False, order=1, mode="nearest")
        return out


class AffineTransform3D(ImagePreprocessing):
    """Apply a 3x3 affine matrix and a translation about the volume's
    centre, linear interpolation, edges repeated."""

    def __init__(self, matrix: np.ndarray,
                 translation: Optional[Sequence[float]] = None):
        self.matrix = np.asarray(matrix, np.float64).reshape(3, 3)
        self.translation = (np.zeros(3) if translation is None
                            else np.asarray(translation, np.float64))

    def map_image(self, img):
        from scipy.ndimage import affine_transform
        center = (np.asarray(img.shape, np.float64) - 1) / 2.0
        offset = center - self.matrix @ center + self.translation
        return affine_transform(img.astype(np.float32), self.matrix,
                                offset=offset, order=1, mode="nearest")
