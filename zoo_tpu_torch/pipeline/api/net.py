"""``Net``: the loaders of models from other formats (counterpart of
``zoo_tpu/pipeline/api/net.py``). Each returns a model of the port that
predicts and fine-tunes on the card like a natively built one.
``load_tf``, ``load_onnx`` and ``load_keras`` need TensorFlow or ONNX
and wait for ROADMAP A.16.
"""

from __future__ import annotations

from typing import Optional, Sequence


class Net:
    @staticmethod
    def load(path: str, device=None):
        """A whole-model file of the port (``model.save``), its params on
        ``device`` (default: the runtime context's, else the current CUDA
        device)."""
        from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
            KerasNet,
        )
        return KerasNet.load(path, device=device)

    load_bigdl = load

    @staticmethod
    def load_caffe(def_path: Optional[str], model_path: str, device=None):
        """A Caffe model (prototxt and caffemodel) as a Keras model of
        the port (:func:`zoo_tpu_torch.models.caffe_loader.load_caffe`)."""
        from zoo_tpu_torch.models.caffe_loader import load_caffe
        return load_caffe(def_path, model_path, device=device)

    @staticmethod
    def load_torch(module_or_path, example_inputs: Sequence):
        """A torch ``nn.Module`` (or a ``torch.save`` file of one) traced
        into a trainable model (:mod:`zoo_tpu_torch.bridges.fx_bridge`).
        A file is read with ``weights_only=False``: trust it as far as
        its source."""
        from zoo_tpu_torch.bridges.fx_bridge import torch_to_graph_net
        if isinstance(module_or_path, str):
            import torch
            module_or_path = torch.load(module_or_path, weights_only=False,
                                        map_location="cpu")
        return torch_to_graph_net(module_or_path, example_inputs)

    @staticmethod
    def load_tf(path: str, signature: str = "serving_default"):
        raise NotImplementedError(
            "Net.load_tf needs TensorFlow, which waits for ROADMAP A.16 "
            "in the port")

    @staticmethod
    def load_onnx(path_or_bytes):
        raise NotImplementedError(
            "Net.load_onnx needs the ONNX importer, which waits for "
            "ROADMAP A.16 in the port")

    @staticmethod
    def load_keras(model):
        raise NotImplementedError(
            "Net.load_keras converts a tf.keras model, which waits for "
            "ROADMAP A.16 in the port")
