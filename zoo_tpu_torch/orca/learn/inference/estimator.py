"""The inference-only Estimator (counterpart of
``zoo_tpu/orca/learn/inference/estimator.py``; the reference's OpenVINO
estimator: predict over XShards and arrays, ``fit`` refuses).

It holds an :class:`~zoo_tpu_torch.pipeline.inference.InferenceModel` on
the card; ``from_model(quantize=True)`` is the int8 route (the int8
conv and GEMM kernels), ``from_caffe`` a Caffe net. ``from_tf`` and
``from_onnx`` need TensorFlow or ONNX and wait for ROADMAP A.16;
``from_openvino`` refuses, naming the migrations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from zoo_tpu_torch.pipeline.inference.inference_model import InferenceModel


class InferenceEstimator:
    def __init__(self, model: InferenceModel,
                 batch_size: Optional[int] = None):
        self.model = model
        self.batch_size = batch_size

    def fit(self, *args, **kwargs):
        """The reference's ``OpenvinoEstimator.fit`` raises: inference
        only."""
        raise NotImplementedError(
            "inference estimators cannot fit; load a trainable model "
            "through Estimator.from_keras / from_torch instead")

    def predict(self, data, batch_size: Optional[int] = None,
                feature_cols=None):
        """Predictions for numpy arrays, a ``{"x": ...}`` dict, XShards
        or a DataFrame-like table with ``feature_cols``. XShards in give
        XShards of ``{"prediction": ...}`` dicts, one a shard."""
        from zoo_tpu_torch.orca.data.shard import LocalXShards
        from zoo_tpu_torch.pipeline.api.keras.engine import data_utils

        bs = batch_size or self.batch_size or 256

        def _to_np(out):
            # multi-output models return a tuple of per-head arrays
            if isinstance(out, (list, tuple)):
                return [np.asarray(o) for o in out]
            return np.asarray(out)

        if isinstance(data, LocalXShards):
            def _predict_shard(shard):
                if isinstance(shard, np.ndarray):  # bare-array partitions
                    xs = [shard]
                else:
                    xs, _ = data_utils.to_xy_arrays(
                        LocalXShards([shard]), None, feature_cols, None)
                out = self.model.predict(
                    xs if len(xs) > 1 else xs[0], batch_size=bs)
                return {"prediction": _to_np(out)}
            return data.transform_shard(_predict_shard)
        xs, _ = data_utils.to_xy_arrays(data, None, feature_cols, None)
        return _to_np(self.model.predict(
            xs if len(xs) > 1 else xs[0], batch_size=bs))

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError(
            "inference estimators expose predict() only (reference "
            "OpenVINO estimator behavior)")

    def get_model(self):
        return self.model


class Estimator:
    """The loaders (the reference's ``Estimator.from_openvino`` and its
    siblings). ``device``: where the model runs (default: the current
    CUDA device)."""

    @staticmethod
    def from_model(path: str, batch_size: Optional[int] = None,
                   quantize: bool = False, concurrent_num: int = 4,
                   device=None) -> InferenceEstimator:
        """A model file of the port; ``quantize=True`` is the int8 route
        (in the ``ZOO_INT8_MODE`` mode, as ``InferenceModel.load``)."""
        im = InferenceModel(supported_concurrent_num=concurrent_num)
        im.load(path, batch_size=batch_size, quantize=quantize,
                device=device)
        return InferenceEstimator(im, batch_size)

    @staticmethod
    def from_tf(path: str, batch_size: Optional[int] = None,
                concurrent_num: int = 4) -> InferenceEstimator:
        raise NotImplementedError(
            "Estimator.from_tf needs the TF graph bridge, which waits for "
            "ROADMAP A.16 in the port")

    @staticmethod
    def from_onnx(path, batch_size: Optional[int] = None,
                  concurrent_num: int = 4) -> InferenceEstimator:
        raise NotImplementedError(
            "Estimator.from_onnx needs the ONNX loader, which waits for "
            "ROADMAP A.16 in the port")

    @staticmethod
    def from_caffe(def_path, model_path,
                   batch_size: Optional[int] = None,
                   concurrent_num: int = 4,
                   device=None) -> InferenceEstimator:
        im = InferenceModel(supported_concurrent_num=concurrent_num)
        im.load_caffe(def_path, model_path, batch_size=batch_size,
                      device=device)
        return InferenceEstimator(im, batch_size)

    @staticmethod
    def from_openvino(*, model_path, batch_size: int = 0):
        """Reference code's entry: an OpenVINO IR cannot run on the
        card; the error names the migrations."""
        raise NotImplementedError(
            "OpenVINO IR is a CPU-specific format; on the card export the "
            "original model instead and use Estimator.from_tf / "
            "from_onnx / from_model(..., quantize=True) for the "
            "optimized-int8 path")
