"""Orca PyTorch Estimator: a torch module trained by the port's Keras
engine (counterpart of ``zoo_tpu/orca/learn/pytorch/estimator.py``).

The module is traced once, at the first ``fit``/``predict``/``evaluate``
(2 rows of each input), through :mod:`zoo_tpu_torch.bridges.fx_bridge`;
the trace runs on a CPU copy, and the weights then live on the
estimator's device (``device=``, else the runtime context's, else the
current CUDA device). The torch optimizer and loss become the port's by
the JAX package's tables: an ``AdamW`` becomes ``AdamWeightDecay``
(whose ``fused=None`` reads ``ZOO_FUSED_OPTIM``), an ``SGD`` the port's
``SGD`` (the fused SGD kernel on the card). The JAX table tests
``Adam`` before ``AdamW``, and on a torch where ``AdamW`` subclasses
``Adam`` a torch AdamW loses its weight decay there; the port tests
``AdamW`` first (ROADMAP C). The table's other choices are kept:
``AdamWeightDecay`` keeps its own epsilon (1e-6), and ``Adam``'s
``weight_decay``/``amsgrad`` are dropped.

``get_model()`` writes the trained weights back into the user's module
by FQN, on the module's own device.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from zoo_tpu_torch.orca.learn.keras.estimator import KerasEstimator


def _convert_loss(loss):
    if loss is None or isinstance(loss, str):
        return loss
    if _is_torch_loss(loss):
        return _torch_loss_name(loss)
    if callable(loss):
        return loss
    raise ValueError(f"unsupported loss: {loss!r}")


def _is_torch_loss(obj) -> bool:
    return isinstance(obj, torch.nn.modules.loss._Loss)


def _torch_loss_name(loss) -> str:
    tnn = torch.nn
    table = {
        tnn.MSELoss: "mse",
        tnn.L1Loss: "mae",
        tnn.CrossEntropyLoss: "sparse_categorical_crossentropy_from_logits",
        tnn.BCELoss: "binary_crossentropy",
        tnn.BCEWithLogitsLoss: "binary_crossentropy_from_logits",
        tnn.NLLLoss: "nll",
    }
    for cls, name in table.items():
        if isinstance(loss, cls):
            return name
    raise ValueError(f"unsupported torch loss: {type(loss).__name__}")


def _convert_optimizer(optimizer):
    """A ``torch.optim`` instance as the port's optimizer with the same
    hyperparameters (the JAX package's table, ``AdamW`` tested before
    ``Adam``)."""
    from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt

    if optimizer is None:
        return "adam"
    if isinstance(optimizer, (str, zopt.Optimizer)):
        return optimizer
    topt = torch.optim
    if isinstance(optimizer, topt.Optimizer):
        g = optimizer.param_groups[0]
        if isinstance(optimizer, topt.AdamW):
            b1, b2 = g.get("betas", (0.9, 0.999))
            return zopt.AdamWeightDecay(
                lr=g["lr"], beta_1=b1, beta_2=b2,
                weight_decay=g.get("weight_decay", 0.01))
        if isinstance(optimizer, topt.Adam):
            b1, b2 = g.get("betas", (0.9, 0.999))
            return zopt.Adam(lr=g["lr"], beta_1=b1, beta_2=b2,
                             epsilon=g.get("eps", 1e-8))
        if isinstance(optimizer, topt.SGD):
            return zopt.SGD(lr=g["lr"], momentum=g.get("momentum", 0.0),
                            nesterov=g.get("nesterov", False))
        if isinstance(optimizer, topt.RMSprop):
            return zopt.RMSprop(lr=g["lr"], rho=g.get("alpha", 0.99),
                                epsilon=g.get("eps", 1e-8))
        if isinstance(optimizer, topt.Adagrad):
            return zopt.Adagrad(lr=g["lr"])
    raise ValueError(f"unsupported optimizer: {optimizer!r}")


class Estimator:
    @staticmethod
    def from_torch(*, model=None, optimizer=None, loss=None,
                   model_creator: Optional[Callable] = None,
                   optimizer_creator: Optional[Callable] = None,
                   loss_creator: Optional[Callable] = None,
                   config: Optional[dict] = None,
                   metrics=None, model_dir: Optional[str] = None,
                   backend: Optional[str] = None,
                   dtype_policy: str = "float32",
                   guard=None, device=None) -> "PyTorchEstimator":
        """Instances, or the reference's creator functions called with
        ``config``. ``backend`` is accepted and ignored, as in the JAX
        package; ``device``: where the model trains and predicts."""
        cfg = dict(config or {})
        if model is None and model_creator is not None:
            model = model_creator(cfg)
        if model is None:
            raise ValueError("pass model= or model_creator=")
        if optimizer is None and optimizer_creator is not None:
            optimizer = optimizer_creator(model, cfg)
        if loss is None and loss_creator is not None:
            loss = loss_creator(cfg) if not _is_torch_loss(loss_creator) \
                else loss_creator
        return PyTorchEstimator(model, optimizer, loss, metrics=metrics,
                                model_dir=model_dir,
                                dtype_policy=dtype_policy, guard=guard,
                                device=device)


class PyTorchEstimator(KerasEstimator):
    """The Keras estimator's surface; the conversion waits for the first
    data, which gives the trace its input shapes."""

    def __init__(self, torch_model, optimizer, loss, metrics=None,
                 model_dir: Optional[str] = None,
                 dtype_policy: str = "float32", guard=None, device=None):
        self.torch_model = torch_model
        self._optimizer_arg = _convert_optimizer(optimizer)
        self._loss_arg = _convert_loss(loss)
        self._metrics_arg = metrics or []
        self._model_dir_arg = model_dir
        self._dtype_policy = dtype_policy
        self._converted = False
        super().__init__(model=None, model_dir=None, guard=guard,
                         device=device)
        self.model_dir = model_dir

    def _ensure_converted(self, xs):
        if self._converted:
            return
        from zoo_tpu_torch.bridges.fx_bridge import torch_to_graph_net
        from zoo_tpu_torch.orca.learn.ckpt import CheckpointManager

        # trace with a tiny example batch (2 rows of each input); the
        # weights then live on the estimator's device
        examples = [np.asarray(a[:2]) for a in xs]
        self.model = torch_to_graph_net(self.torch_model, examples)
        self.model._place_params(self.model.params, self._device())
        self.model.compile(optimizer=self._optimizer_arg,
                           loss=self._loss_arg or "mse",
                           metrics=self._metrics_arg,
                           dtype_policy=self._dtype_policy)
        if self._model_dir_arg:
            self._ckpt = CheckpointManager(
                os.path.join(self._model_dir_arg, "ckpts"))
            self.model.set_tensorboard(self._model_dir_arg, "summaries")
        # the manager and the converted model exist only now: rewire the
        # guard's checkpoint callbacks and attach it to the new KerasNet
        self._bind_guard()
        self._converted = True

    def _normalize(self, data, feature_cols, label_cols):
        from zoo_tpu_torch.pipeline.api.keras.engine import data_utils
        return data_utils.to_xy_arrays(data, None, feature_cols,
                                       label_cols)

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols=None, label_cols=None, validation_data=None,
            checkpoint_trigger=None, shuffle: bool = True):
        xs, ys = self._normalize(data, feature_cols, label_cols)
        self._ensure_converted(xs)
        return super().fit({"x": xs if len(xs) > 1 else xs[0], "y": ys},
                           epochs=epochs, batch_size=batch_size,
                           validation_data=validation_data,
                           checkpoint_trigger=checkpoint_trigger,
                           shuffle=shuffle)

    def predict(self, data, batch_size: int = 256, feature_cols=None):
        xs, _ = self._normalize(data, feature_cols, None)
        self._ensure_converted(xs)
        return super().predict(xs if len(xs) > 1 else xs[0],
                               batch_size=batch_size)

    def evaluate(self, data, batch_size: int = 32, feature_cols=None,
                 label_cols=None):
        xs, ys = self._normalize(data, feature_cols, label_cols)
        self._ensure_converted(xs)
        return super().evaluate({"x": xs if len(xs) > 1 else xs[0],
                                 "y": ys}, batch_size=batch_size)

    def get_model(self):
        """The torch module with the current (trained) weights written
        back, as the reference returns the trained torch model."""
        if self._converted and self.model is not None \
                and self.model.params is not None:
            self._export_weights_to_torch()
        return self.torch_model

    def _export_weights_to_torch(self):
        """Trained weights back by torch FQN: the bridge keeps torch's
        own layouts, so this is a copy into each parameter, on its own
        device and in its own dtype."""
        w = self.model.params["torch_graph"]["w"]
        named = dict(self.torch_model.named_parameters())
        with torch.no_grad():
            for fqn, val in w.items():
                if fqn in named:
                    t = named[fqn]
                    t.copy_(val.detach().to(t.device, t.dtype))
