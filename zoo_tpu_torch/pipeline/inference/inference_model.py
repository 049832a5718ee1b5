"""``InferenceModel`` and ``quantize_model`` (counterpart of
``zoo_tpu/pipeline/inference/inference_model.py``).

``InferenceModel`` holds a Keras model of the port and bounds the
predict calls in flight with a semaphore. ``quantize_model`` rewrites
every ``Dense`` and ``Convolution2D`` weight to int8 per output channel
(``W`` -> ``W_q``, ``W_scale``), after which the forward runs the int8
kernels of :mod:`zoo_tpu_torch.ops.kernels.quant`. In ``auto`` mode it
keeps int8 only where it measures faster than the float forward.

The chosen path is recorded on the model (``_quant_path``,
``_quant_speedup``) and published as the ``zoo_quant_path_info`` gauge.
``InferenceModel.load`` reads the
port's own model file (``KerasNet.save``); the other file loaders
(``load_tf``, ``load_onnx``, ``load_caffe``, ``load_encrypted``) raise,
naming the ROADMAP item that brings each.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from zoo_tpu_torch.common import knobs
from zoo_tpu_torch.common.device import resolve_device

logger = logging.getLogger(__name__)


def _publish_quant_path(path: str, speedup: Optional[float]) -> None:
    """Record every quantize_model decision in the scrape: prior
    verdicts flip to 0 (info-gauge style) so exactly one series is 1."""
    from zoo_tpu_torch.obs.metrics import gauge

    fam = gauge(
        "zoo_quant_path_info",
        "int8 quantization path chosen by quantize_model (1 = current "
        "verdict) with the measured int8/float speedup as a label "
        "(\"-\" when the mode skipped the microbench)",
        labels=("path", "speedup"))
    for child in fam.children():
        child.set(0.0)
    fam.labels(path=path,
               speedup="-" if speedup is None else f"{speedup:.3f}"
               ).set(1.0)


class InferenceModel:
    def __init__(self, supported_concurrent_num: int = 1):
        self._sem = threading.Semaphore(supported_concurrent_num)
        self.supported_concurrent_num = supported_concurrent_num
        self._model = None
        self._batch_size: Optional[int] = None
        self._device: Optional[torch.device] = None

    def load_keras(self, model, batch_size: Optional[int] = None,
                   example_input: Optional[Sequence[np.ndarray]] = None,
                   device=None):
        """Hold a Keras model of the port, run on the current CUDA device
        unless ``device`` names another. With ``batch_size`` and built
        params, one warm-up predict at that batch size builds the
        kernels before the first request."""
        self._device = resolve_device(device)
        self._model = model
        self._batch_size = batch_size
        if batch_size and model.params is not None:
            shapes = model._built_shapes or model._input_shapes()
            if example_input is None and shapes:
                example_input = [np.zeros((batch_size,) + tuple(s[1:]),
                                          np.float32) for s in shapes]
            if example_input is not None:
                model.predict(example_input if len(example_input) > 1
                              else example_input[0], batch_size=batch_size,
                              device=self._device)
        return self

    def load(self, path: str, batch_size: Optional[int] = None,
             quantize: bool = False, device=None):
        """Load a whole model written by ``KerasNet.save`` onto the
        current CUDA device (or ``device``). ``quantize=True`` is the
        int8 path, in the mode ``ZOO_INT8_MODE`` gives (default
        ``auto``: int8 is kept only where it measures faster), as the
        JAX package's loader quantizes. A model saved quantized loads
        with its int8 weights, the int8 convs' K-major copies rebuilt.
        A JAX package ``.zoo`` file is refused before anything in it is
        read (``load_weights`` takes that package's weight file)."""
        from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
            KerasNet,
        )
        model = KerasNet.load(path, device=device)
        if quantize:
            model = quantize_model(model,
                                   mode=knobs.value("ZOO_INT8_MODE"))
        return self.load_keras(model, batch_size=batch_size, device=device)

    def load_tf(self, *args, **kwargs):
        raise NotImplementedError(
            "InferenceModel.load_tf needs the TF graph bridge, which "
            "waits for ROADMAP A.16 in the port")

    def load_onnx(self, *args, **kwargs):
        raise NotImplementedError(
            "InferenceModel.load_onnx needs the ONNX loader, which waits "
            "for ROADMAP A.16 in the port")

    def load_caffe(self, *args, **kwargs):
        raise NotImplementedError(
            "InferenceModel.load_caffe waits for ROADMAP A.12 (the rest "
            "of the image-inference slice) in the port")

    def load_encrypted(self, *args, **kwargs):
        raise NotImplementedError(
            "InferenceModel.load_encrypted (and save_encrypted) wait for "
            "ROADMAP A.12 in the port")

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Outputs of the held model for numpy ``x``, at most
        ``supported_concurrent_num`` calls in flight."""
        if self._model is None:
            raise RuntimeError("no model loaded")
        bs = batch_size or self._batch_size or 256
        with self._sem:
            return self._model.predict(x, batch_size=bs,
                                       device=self._device)

    @property
    def model(self):
        return self._model


# auto mode keeps int8 only when it beats the float forward by this
# factor
INT8_MIN_SPEEDUP = 1.05


def _copy_tree(tree):
    """Shallow-copy every nested dict of a params tree (tensors shared):
    enough to undo the in-place W -> W_q/W_scale rewrite."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


#: (architecture fingerprint, sample shapes, min_speedup) -> (path,
#: speedup): an auto verdict is a property of the architecture and the
#: device, not of the weight values, so re-quantizing the same topology
#: replays it instead of measuring again.
_AUTO_VERDICT_CACHE: dict = {}


def _model_fingerprint(model) -> tuple:
    """Architecture identity for the auto-verdict cache: layer types in
    order and every param leaf's path, shape and dtype (values
    excluded), leaves in sorted-key order."""
    def leaves(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}[{k!r}]")
        else:
            yield path, tuple(tree.shape), str(tree.dtype)

    layers = tuple(type(l).__name__ for l in getattr(model, "layers", ()))
    return layers, tuple(leaves(model.params, ""))


def _time_forward(model, xs, reps: int = 3) -> float:
    """Samples/s of the forward on the params' device, after one
    warm-up call, synchronised on a CUDA device. Module-level so tests
    can stub it."""
    step = model._build_pred_step()
    dev = model._params_device()
    batch = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in xs]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step(*batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(*batch)
    sync()
    return xs[0].shape[0] * reps / max(time.perf_counter() - t0, 1e-9)


def _apply_int8(model):
    from zoo_tpu_torch.ops.kernels.conv import (
        attach_kmajor,
        pallas_conv_supported,
    )
    from zoo_tpu_torch.ops.kernels.quant import (
        quantize_conv_weights,
        quantize_int8,
    )
    from zoo_tpu_torch.pipeline.api.keras.layers.convolutional import (
        Convolution2D,
    )
    from zoo_tpu_torch.pipeline.api.keras.layers.core import Dense

    dense_keys = {model._key_of(l) for l in model.layers
                  if isinstance(l, Dense)}
    # conv key -> whether the int8 kernel takes the layer (its envelope)
    conv_keys = {model._key_of(l): pallas_conv_supported(l.kernel,
                                                         l.subsample)
                 for l in model.layers if isinstance(l, Convolution2D)}

    def walk(tree):
        for key, val in list(tree.items()):
            if isinstance(val, dict):
                if key in dense_keys and "W" in val:
                    val["W_q"], val["W_scale"] = quantize_int8(
                        val.pop("W").detach(), axis=0)
                elif key in conv_keys and "W" in val:
                    val["W_q"], val["W_scale"] = quantize_conv_weights(
                        val.pop("W").detach())
                    if conv_keys[key]:
                        # the kernel's K-major weights, made once here
                        attach_kmajor(val["W_q"])
                else:
                    walk(val)

    with torch.no_grad():
        walk(model.params)
    model._quantized = True  # inference-only: fit() refuses


def quantize_model(model, mode: Optional[str] = None,
                   min_speedup: float = INT8_MIN_SPEEDUP,
                   sample_batch: int = 8):
    """Post-training int8 quantization of every ``Dense`` and
    ``Convolution2D`` weight (per output channel, symmetric), in place.

    ``mode`` (an explicit argument wins; else ``ZOO_INT8_MODE`` from the
    environment; else ``"force"``, the JAX package's rule):

    * ``"force"`` — always quantize;
    * ``"off"`` — leave the model as it is;
    * ``"auto"`` — quantize, time the int8 forward against the float
      one at ``sample_batch`` rows on the params' device, and keep int8
      only if it wins by ``min_speedup``; otherwise restore the float
      weights. Verdicts are cached per architecture.

    Records ``model._quant_path`` (``"int8"`` / ``"bf16-fallback"`` /
    ``"bf16"``) and, where auto measured it, ``model._quant_speedup``.
    """
    if not mode:
        mode = knobs.value("ZOO_INT8_MODE") \
            if os.environ.get("ZOO_INT8_MODE") else "force"
    if mode not in ("auto", "force", "off"):
        raise ValueError(f"unknown int8 mode {mode!r} "
                         "(expected auto|force|off)")
    if mode == "off":
        model._quant_path = "bf16"
        _publish_quant_path("bf16", None)
        return model
    if model.params is None:
        raise ValueError("model must be built before quantization")
    shapes = model._built_shapes or model._input_shapes()
    if mode == "force" or not shapes or any(
            d is None for s in shapes for d in s[1:]):
        # nothing to measure with: auto behaves like force
        _apply_int8(model)
        model._quant_path = "int8"
        _publish_quant_path("int8", None)
        return model

    xs = [np.zeros((sample_batch,) + tuple(s[1:]), np.float32)
          for s in shapes]
    key = (_model_fingerprint(model), tuple(x.shape for x in xs),
           float(min_speedup))
    cached = _AUTO_VERDICT_CACHE.get(key)
    if cached is not None:
        path, speedup = cached
        model._quant_speedup = speedup
        model._quant_path = path
        if path == "int8":
            _apply_int8(model)
        _publish_quant_path(path, speedup)
        return model
    float_rate = _time_forward(model, xs)
    saved = _copy_tree(model.params)
    _apply_int8(model)
    int8_rate = _time_forward(model, xs)
    speedup = int8_rate / max(float_rate, 1e-9)
    model._quant_speedup = speedup
    if speedup >= min_speedup:
        model._quant_path = "int8"
        _AUTO_VERDICT_CACHE[key] = ("int8", speedup)
        _publish_quant_path("int8", speedup)
        return model
    model.params = saved
    model._quantized = False
    model._quant_path = "bf16-fallback"
    _AUTO_VERDICT_CACHE[key] = ("bf16-fallback", speedup)
    _publish_quant_path("bf16-fallback", speedup)
    logger.info("int8 quantization measured %.3fx the float forward "
                "(< %.2fx): keeping the float path", speedup, min_speedup)
    return model
