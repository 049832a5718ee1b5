"""``Sequential`` with ``compile``/``fit`` on one device (counterpart of
the single-device part of ``zoo_tpu/pipeline/api/keras/engine/
topology.py``).

The JAX package jits one train step (forward, backward, optimizer
update) and feeds it superbatches; here the same step runs eagerly on
one CUDA device (or, when asked, the CPU): the trainable f32 leaves
are cast to the compute dtype inside autograd, the loss is
differentiated with ``torch.autograd.grad``, and the optimizer updates
the leaves in place. Per-step losses are summed on the device and read
once per epoch. Batches follow the JAX package's order
(:func:`~.data_utils.batch_slices` with ``RandomState(seed)``).

Not ported yet: ``evaluate``/``predict``, metrics, the functional
``Model``, validation data, meshes and plans, the training guard,
checkpoints and summaries.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from zoo_tpu_torch.common.device import resolve_device
from zoo_tpu_torch.pipeline.api.keras.engine import data_utils
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    tree_leaves,
    tree_map,
)
from zoo_tpu_torch.pipeline.api.keras.objectives import get_loss
from zoo_tpu_torch.pipeline.api.keras.optimizers import get_optimizer


class KerasNet:
    """Training engine shared by the Keras models."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__.lower()
        self.params: Optional[Dict] = None
        self.optimizer = None
        self.loss_fn: Optional[Callable] = None
        self.dtype_policy = "float32"
        self._opt_state = None
        self._step = 0

    # -- param keys --------------------------------------------------------
    def _param_keys(self) -> Dict[int, str]:
        """Params keys by layer position and type (``000_llama``), as the
        JAX package keys them, so its trees load by name."""
        return {id(layer): f"{i:03d}_{type(layer).__name__.lower()}"
                for i, layer in enumerate(self.layers)}

    def _key_of(self, layer) -> str:
        return self._param_keys()[id(layer)]

    # -- to be provided by subclasses ------------------------------------
    @property
    def layers(self) -> List[Layer]:
        raise NotImplementedError

    def _init_params(self, generator, input_shapes) -> Dict:
        raise NotImplementedError

    def _forward(self, params, inputs: List, *, training: bool):
        raise NotImplementedError

    def _input_shapes(self) -> Optional[List[Tuple]]:
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def compile(self, optimizer, loss, metrics=None,
                dtype_policy: str = "float32"):
        """``dtype_policy``: ``"float32"`` or ``"mixed_bfloat16"`` —
        parameters and optimizer state stay f32, the forward and
        backward run in bf16 with f32 islands in the norms, softmax and
        loss reductions; gradients arrive in f32."""
        if metrics:
            raise NotImplementedError("metrics are not ported to "
                                      "zoo_tpu_torch yet")
        if dtype_policy not in ("float32", "mixed_bfloat16"):
            raise ValueError(f"unknown dtype_policy: {dtype_policy}")
        self.dtype_policy = dtype_policy
        self.optimizer = get_optimizer(optimizer)
        self.loss_fn = get_loss(loss)
        self._opt_state = None  # a new optimizer cannot reuse old state
        return self

    def build(self, generator: Optional[torch.Generator] = None,
              input_shapes=None, device=None) -> Dict:
        """Materialize params (idempotent), drawn from ``generator``
        (default: seed 0 on ``device``)."""
        if self.params is not None:
            return self.params
        shapes = input_shapes or self._input_shapes()
        if shapes is None:
            raise ValueError(
                f"{self.name}: cannot infer input shape; pass input_shape to "
                "the first layer or call build(input_shapes=...)")
        if generator is None:
            generator = torch.Generator(
                device=resolve_device(device)).manual_seed(0)
        self.params = self._init_params(generator,
                                        [tuple(s) for s in shapes])
        return self.params

    def _cast_compute(self, tree):
        """f32 tensors to bf16 under ``mixed_bfloat16``; inside autograd,
        so gradients flow back to the f32 leaves in f32."""
        if self.dtype_policy != "mixed_bfloat16":
            return tree

        def cast(t):
            return t.to(torch.bfloat16) if t.dtype == torch.float32 else t
        if isinstance(tree, list):
            return [cast(t) for t in tree]
        return tree_map(cast, tree)

    def _train_step(self, opt_state, xs: List[torch.Tensor],
                    ys: torch.Tensor):
        """Forward, backward and the optimizer's in-place update; returns
        ``(opt_state, loss)`` with the loss a detached f32 scalar."""
        params = self.params
        leaves = tree_leaves(params)
        with torch.enable_grad():
            preds = self._forward(self._cast_compute(params),
                                  self._cast_compute(xs), training=True)
            if not getattr(self.loss_fn, "_handles_low_precision", False) \
                    and preds.dtype == torch.bfloat16:
                preds = preds.float()
            loss = self.loss_fn(ys, preds)
        grads = iter(torch.autograd.grad(loss, leaves))
        grad_tree = tree_map(lambda _: next(grads), params)
        _, opt_state = self.optimizer.apply(grad_tree, opt_state, params)
        return opt_state, loss.detach()

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            shuffle: bool = True, seed: int = 0, verbose: int = 1,
            device=None) -> Dict[str, List[float]]:
        """Train on numpy ``x``/``y``; returns ``{"loss": [per-epoch
        mean]}``. Runs on the current CUDA device unless ``device`` names
        another (``device="cpu"`` runs every plain version). The ragged
        tail of each epoch's permutation is dropped; a second ``fit``
        continues from the optimizer state the first one left."""
        if self.loss_fn is None:
            raise RuntimeError("call compile() before fit()")
        xs, ys = data_utils.to_xy_arrays(x, y)
        if ys is None:
            raise ValueError("fit requires labels")
        n = data_utils.num_samples(xs)
        if n < batch_size:
            raise ValueError(f"dataset ({n}) smaller than the batch "
                             f"({batch_size})")
        dev = resolve_device(device)
        self.build(torch.Generator(device=dev).manual_seed(int(seed)),
                   [(None,) + a.shape[1:] for a in xs])
        # the trainable leaves: f32 tensors on the device that autograd
        # differentiates the loss against
        self.params = tree_map(
            lambda t: t if t.device == dev and t.requires_grad
            and t.is_leaf else t.detach().to(dev).requires_grad_(True),
            self.params)
        opt_state = self._opt_state
        if opt_state is None:
            opt_state = self.optimizer.init(self.params)
        nprng = np.random.RandomState(seed)
        history: Dict[str, List[float]] = {"loss": []}
        for epoch in range(nb_epoch):
            loss_sum, n_steps = None, 0
            for idx in data_utils.batch_slices(n, batch_size, shuffle,
                                               nprng):
                batch = [torch.from_numpy(np.ascontiguousarray(a[idx]))
                         .to(dev) for a in xs + [ys]]
                opt_state, loss = self._train_step(opt_state, batch[:-1],
                                                   batch[-1])
                loss_sum = loss if loss_sum is None else loss_sum + loss
                self._step += 1
                n_steps += 1
            epoch_loss = float(loss_sum) / max(n_steps, 1)
            history["loss"].append(epoch_loss)
            if verbose:
                print(f"Epoch {epoch + 1}/{nb_epoch} - loss: "
                      f"{epoch_loss:.4f}")
        self._opt_state = opt_state
        return history


class Sequential(KerasNet):
    """Linear stack of layers."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name=name)
        self._layers: List[Layer] = []

    @property
    def layers(self) -> List[Layer]:
        return self._layers

    def add(self, layer: Layer) -> "Sequential":
        self._layers.append(layer)
        self.params = None  # invalidate
        return self

    def _input_shapes(self):
        if self._layers and self._layers[0].batch_input_shape is not None:
            return [self._layers[0].batch_input_shape]
        return None

    def _init_params(self, generator, input_shapes) -> Dict:
        shape = tuple(input_shapes[0])
        params: Dict = {}
        for layer in self._layers:
            params[self._key_of(layer)] = layer.build(generator, shape)
            shape = layer.compute_output_shape(shape)
        return params

    def _forward(self, params, inputs: List, *, training):
        h = inputs[0] if len(inputs) == 1 else inputs
        for layer in self._layers:
            h = layer.call(params.get(self._key_of(layer), {}), h,
                           training=training)
        return h
