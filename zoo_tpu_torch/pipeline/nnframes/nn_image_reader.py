"""DataFrame image loading for NNFrames pipelines (counterpart of
``zoo_tpu/pipeline/nnframes/nn_image_reader.py``).

``NNImageReader.readImages`` reads an image directory into a pandas
DataFrame: an ``image`` column of decoded HWC BGR uint8 arrays
(``cv2.imread`` semantics, decoded through
:mod:`zoo_tpu_torch.feature.image`, which imports cv2 when it decodes and
raises naming it where it is absent), ``origin`` (the path) and, for a
``path/<class>/*`` layout, an integer ``label``. ``RowToImageFeature``
turns a cell back into an ``ImageFeature``: the first link of an
``NNEstimator`` ``sample_preprocessing`` chain. pandas is imported when
``readImages`` runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from zoo_tpu_torch.feature.image import (
    ImageFeature,
    ImagePreprocessing,
    ImageSet,
)


class NNImageReader:
    """reference: ``nn_image_reader.py:25`` (Spark-free equivalent)."""

    @staticmethod
    def readImages(path: str, sc=None, minPartitions: int = 1,
                   resizeH: int = -1, resizeW: int = -1,
                   image_codec: int = -1,
                   with_label: Optional[bool] = None):
        """Read a directory/glob of images into a pandas DataFrame with
        columns ``image`` (HWC BGR uint8 ndarray), ``origin`` (file
        path) and — for a ``path/<class>/*`` layout — ``label``.

        ``sc``/``minPartitions``/``image_codec`` are accepted for the
        reference's signature and ignored (no Spark in this process;
        pass the DataFrame to ``NNEstimator.fit`` directly).
        ``with_label=None`` auto-detects the class-subdirectory layout.
        """
        import os

        from zoo_tpu_torch.pipeline.nnframes.nn_classifier import _pandas
        pd = _pandas()

        if with_label is None:
            # class-dir layout only if some non-hidden subdir actually
            # holds images — a stray '.ipynb_checkpoints'/'__MACOSX'
            # must not flip a flat directory into (empty) labeled mode
            from zoo_tpu_torch.feature.image import _IMG_EXTS

            def _has_images(d):
                return os.path.isdir(d) and any(
                    f.lower().endswith(_IMG_EXTS)
                    for f in os.listdir(d))

            with_label = os.path.isdir(path) and any(
                not d.startswith((".", "__"))
                and _has_images(os.path.join(path, d))
                for d in os.listdir(path))
        iset = ImageSet.read(path, with_label=with_label,
                             resize_height=resizeH, resize_width=resizeW)
        if not iset.features:
            raise FileNotFoundError(f"no readable images under {path!r}")
        data = {"image": [f["image"] for f in iset.features],
                "origin": [f.get("uri") for f in iset.features]}
        if with_label:
            data["label"] = np.asarray(
                [f.get("label", -1) for f in iset.features], np.int32)
        df = pd.DataFrame(data)
        df.attrs["label_map"] = getattr(iset, "label_map", {})
        return df


class RowToImageFeature(ImagePreprocessing):
    """First link of an image ``sample_preprocessing`` chain: turns a
    DataFrame cell (ndarray, or an ImageFeature already) into a fresh
    ``ImageFeature`` so downstream transformers can mutate freely
    (reference: ``RowToImageFeature`` over the Spark image struct)."""

    def __call__(self, cell):
        if isinstance(cell, ImageFeature):
            return ImageFeature(image=np.asarray(cell["image"]).copy(),
                                label=cell.get("label"),
                                uri=cell.get("uri"))
        return ImageFeature(image=np.asarray(cell).copy())
