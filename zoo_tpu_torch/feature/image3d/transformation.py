"""The reference's import path ``feature.image3d.transformation``: the
3-D transforms live in the package root."""

from zoo_tpu_torch.feature.image3d import (  # noqa: F401
    AffineTransform3D,
    CenterCrop3D,
    Crop3D,
    RandomCrop3D,
    Rotate3D,
)
