"""``Sequential`` and the functional ``Model`` with ``compile``/``fit``/
``predict`` on one device (counterpart of the single-device part of
``zoo_tpu/pipeline/api/keras/engine/topology.py``).

The JAX package jits one train step (forward, backward, optimizer
update) and feeds it superbatches; here the same step runs eagerly on
one CUDA device (or, when asked, the CPU). The params split as the JAX
step splits them (:func:`_split_state`): the trainable f32 leaves are
cast to the compute dtype inside autograd, the loss is differentiated
against them alone with ``torch.autograd.grad``, and the optimizer
updates them in place; the BatchNorm running stats stay f32 out of the
gradient, and each BatchNorm's ``updated_stats`` from its training
input replace them after the update. Per-step losses are summed on the
device and read once per epoch. Batches follow the JAX package's order
(:func:`~.data_utils.batch_slices` with ``RandomState(seed)``).

``predict`` runs the forward under ``torch.no_grad()`` batch by batch
in order, the ragged tail padded with copies of its first row and
sliced off after, and brings the outputs to the host once at the end;
under ``mixed_bfloat16`` every f32 leaf but the BatchNorm running stats
is cast to bf16 (:func:`_split_state`) and bf16 outputs come back f32.
``evaluate`` streams the same forward batch by batch and sums the loss
and each compiled metric's ``(sum, count)`` on the device, read once at
the end (the JAX package's ``_evaluate_arrays``).

Persistence: ``save_weights``/``load_weights`` use the JAX package's
weight file (a plain pickle of ``{"params": numpy tree, "step"}`` under
the same layer keys), so either package reads the other's. ``save``/
``load`` write the port's own whole-model file (:data:`MODEL_MAGIC`,
then a standard-library pickle of the model with its params as numpy);
``load`` checks the header before it unpickles and resolves only the
parts of a model (undotted names of the port's layers, models,
initializers, optimizers, metrics and losses, numpy's array parts and
torch's dtypes), so it refuses a JAX ``.zoo`` file without importing
either JAX package, and a file that names any other function or class.
Even so, a model file is code to trust as far as its source: a
registry's directory is the deployment's, as the JAX package's
cloudpickle files are.

Not ported yet: validation data, meshes and plans, the training guard,
checkpoints and summaries.
"""

from __future__ import annotations

import io
import pickle
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from zoo_tpu_torch.common.device import resolve_device
from zoo_tpu_torch.pipeline.api.keras.engine import data_utils
from zoo_tpu_torch.pipeline.api.keras.engine import base as _base
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    KTensor,
    Layer,
    tree_leaves,
    tree_map,
)
from zoo_tpu_torch.pipeline.api.keras.metrics import Metric, get_metric
from zoo_tpu_torch.pipeline.api.keras.objectives import get_loss
from zoo_tpu_torch.pipeline.api.keras.optimizers import get_optimizer


def _split_state(params: Dict) -> Tuple[Dict, Dict]:
    """Separate the non-trainable running stats (BatchNorm's
    ``stats``) from the other params, so the compute cast leaves them
    f32."""
    trainable, state = {}, {}
    for lname, p in params.items():
        if isinstance(p, dict) and "stats" in p:
            state[lname] = {"stats": p["stats"]}
            trainable[lname] = {k: v for k, v in p.items() if k != "stats"}
        else:
            trainable[lname] = p
    return trainable, state


def _merge_state(trainable: Dict, state: Dict) -> Dict:
    out = dict(trainable)
    for lname, st in state.items():
        merged = dict(out.get(lname, {}))
        merged.update(st)
        out[lname] = merged
    return out


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy batch on ``dev``, 64-bit narrowed to 32 as ``jnp.asarray``
    narrows it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.int()
    return t.to(dev)


def _outputs_f32(preds):
    if isinstance(preds, tuple):
        return tuple(_outputs_f32(p) for p in preds)
    return preds.float() if preds.dtype == torch.bfloat16 else preds


def _call(layer, key: str, params: Dict, h, training: bool,
          collect: Optional[Dict]):
    """``layer.call`` on ``h``; in training, with ``collect`` given, a
    layer with running stats also leaves its ``updated_stats`` from
    ``h`` in ``collect[key]`` (one computation of the batch moments)."""
    p = params.get(key, {})
    if training and collect is not None and \
            hasattr(layer, "call_and_update"):
        out, stats = layer.call_and_update(p, h)
        collect[key] = {"stats": stats}
        return out
    return layer.call(p, h, training=training)


#: the first bytes of a whole-model file of the port; ``KerasNet.load``
#: reads nothing past them unless they match
MODEL_MAGIC = b"ZOO_TPU_TORCH MODEL v1\n"

# what a model file may name outside the port: the hook dicts of an
# nn.Module and a numpy array's parts (numpy's core module under both
# of its names, 1.x and 2.x)
_SAFE_GLOBALS = {("collections", "OrderedDict"), ("numpy", "ndarray"),
                 ("numpy", "dtype")} | {
    (f"numpy.{core}.multiarray", fn) for core in ("core", "_core")
    for fn in ("_reconstruct", "scalar")}
_ROOTS = ("zoo_tpu_torch", "numpy", "torch")


def _nameable(module: str, name: str) -> bool:
    """Whether ``load`` looks ``module.name`` up at all: never a dotted
    name, which pickle would follow attribute by attribute out of the
    module, and never a module outside the port, numpy and torch."""
    return "." not in name and (
        (module, name) in _SAFE_GLOBALS or module.split(".")[0] in _ROOTS)


def _allowed(module: str, name: str, obj) -> bool:
    """Whether a model file may name ``obj`` as ``module.name``: the
    globals above, numpy's scalar types, torch's dtypes, and the parts
    of a model that the port defines in ``module`` (its layers, models,
    initializers, optimizers, metrics and losses:
    :func:`~.base.model_file_part`). Nothing else, so loading a file
    calls no function that a model does not need to be rebuilt."""
    if not _nameable(module, name):
        return False
    if (module, name) in _SAFE_GLOBALS:
        return True
    root = module.split(".")[0]
    if root == "numpy":
        return isinstance(obj, type) and issubclass(obj, np.generic)
    if root == "torch":
        return isinstance(obj, torch.dtype)
    return getattr(obj, "__module__", None) == module and \
        _base.is_model_file_part(obj)


class _ModelPickler(pickle.Pickler):
    """Standard pickle with two substitutions: an activation of the
    keras registry is stored by its name (several are lambdas or torch
    builtins), and a tensor held outside the params tree as a CPU numpy
    array. A class or function that ``load`` would not resolve is
    refused here, at save."""

    def reducer_override(self, obj):
        if isinstance(obj, (type, types.FunctionType,
                            types.BuiltinFunctionType)):
            module = getattr(obj, "__module__", None) or ""
            if not _allowed(module, obj.__qualname__, obj):
                raise pickle.PicklingError(
                    f"{module}.{obj.__qualname__} is not a part of a "
                    "model that a model file may name (see "
                    "model_file_part)")
        return NotImplemented

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            return ("tensor", obj.detach().cpu().numpy())
        if callable(obj) and not isinstance(obj, type):
            for name, fn in _base._ACTIVATIONS.items():
                if fn is obj:
                    return ("activation", name)
        return None


class _ModelUnpickler(pickle.Unpickler):
    def __init__(self, f, device: torch.device):
        super().__init__(f)
        self._device = device

    def find_class(self, module, name):
        if _nameable(module, name):
            obj = super().find_class(module, name)
            if _allowed(module, name, obj):
                return obj
        raise pickle.UnpicklingError(
            f"a model file of the port may not name {module}.{name}")

    def persistent_load(self, pid):
        kind, value = pid
        if kind == "tensor":
            return torch.from_numpy(np.array(value, copy=True)).to(
                self._device)
        if kind == "activation":
            return _base._ACTIVATIONS[value]
        raise pickle.UnpicklingError(f"unknown persistent id {kind!r}")


def _numpy_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _leaf_shapes(tree, prefix=()) -> Dict[Tuple, Tuple]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(np.shape(tree))}


@_base.model_file_part
class KerasNet:
    """Engine shared by the Keras models."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__.lower()
        self.params: Optional[Dict] = None
        self.optimizer = None
        self.loss_fn: Optional[Callable] = None
        self.metrics: List[Metric] = []
        self.dtype_policy = "float32"
        self._opt_state = None
        self._step = 0
        self._keys: Optional[Dict[int, str]] = None
        self._built_shapes: Optional[List[Tuple]] = None
        self._quantized = False

    # -- param keys --------------------------------------------------------
    def _param_keys(self) -> Dict[int, str]:
        """Params keys by layer position and type (``000_llama``), as the
        JAX package keys them, so its trees load by name. Built once per
        layer list (the JAX package rebuilds the map on every lookup)."""
        if self._keys is None:
            self._keys = {id(layer): f"{i:03d}_{type(layer).__name__.lower()}"
                          for i, layer in enumerate(self.layers)}
        return self._keys

    def _key_of(self, layer) -> str:
        return self._param_keys()[id(layer)]

    # -- to be provided by subclasses ------------------------------------
    @property
    def layers(self) -> List[Layer]:
        raise NotImplementedError

    def _init_params(self, generator, input_shapes) -> Dict:
        raise NotImplementedError

    def _forward(self, params, inputs: List, *, training: bool,
                 collect: Optional[Dict] = None):
        """The model's outputs. In training, with ``collect`` given,
        each BatchNorm's ``updated_stats`` from its input lands in
        ``collect[key] = {"stats": ...}``."""
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
        if dtype_policy not in ("float32", "mixed_bfloat16"):
            raise ValueError(f"unknown dtype_policy: {dtype_policy}")
        self.dtype_policy = dtype_policy
        self.optimizer = get_optimizer(optimizer)
        self.loss_fn = get_loss(loss)
        self.metrics = [get_metric(m) for m in (metrics or [])]
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
        self._built_shapes = [tuple(s) for s in shapes]
        self.params = self._init_params(generator, self._built_shapes)
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
        """Forward, backward against the trainable leaves, the
        optimizer's in-place update, then the running stats replaced by
        their updates; returns ``(opt_state, loss)`` with the loss a
        detached f32 scalar."""
        trainable, state = _split_state(self.params)
        collect: Dict = {}
        with torch.enable_grad():
            # cast trainables only: the running stats keep f32
            # resolution, or momentum-0.99 increments vanish below a
            # bf16 ulp
            preds = self._forward(
                _merge_state(self._cast_compute(trainable), state),
                self._cast_compute(xs), training=True, collect=collect)
            if not getattr(self.loss_fn, "_handles_low_precision", False) \
                    and preds.dtype == torch.bfloat16:
                preds = preds.float()
            loss = self.loss_fn(ys, preds)
        # a leaf the loss does not reach (BERT's pooler, the segment
        # table without segment ids) gets zeros, as jax.grad gives it
        grads = iter(torch.autograd.grad(loss, tree_leaves(trainable),
                                         allow_unused=True,
                                         materialize_grads=True))
        grad_tree = tree_map(lambda _: next(grads), trainable)
        _, opt_state = self.optimizer.apply(grad_tree, opt_state, trainable)
        self.params = _merge_state(trainable, collect or state)
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
        if self._quantized:
            raise RuntimeError("a quantized model is inference-only")
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
        # differentiates the loss against; the running stats: plain
        # tensors on the device
        trainable, state = _split_state(self.params)
        trainable = tree_map(
            lambda t: t if t.device == dev and t.requires_grad
            and t.is_leaf else t.detach().to(dev).requires_grad_(True),
            trainable)
        self.params = _merge_state(trainable, tree_map(
            lambda t: t.detach().to(dev), state))
        opt_state = self._opt_state
        if opt_state is None:
            opt_state = self.optimizer.init(trainable)
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

    # -- inference ---------------------------------------------------------
    def _params_device(self) -> torch.device:
        return tree_leaves(self.params)[0].device

    def _build_pred_step(self, device=None) -> Callable:
        """The forward on ``device`` (default: where the params live) as
        ``step(*numpy_or_tensor_batches) -> outputs``: params moved and
        cast once, here, for every call of the step; inputs cast to the
        compute dtype; bf16 outputs returned f32."""
        dev = self._params_device() if device is None else \
            torch.device(device)
        with torch.no_grad():
            trainable, state = _split_state(tree_map(
                lambda t: t.detach().to(dev), self.params))
            params = _merge_state(self._cast_compute(trainable), state)

        def step(*xs):
            batch = [x if isinstance(x, torch.Tensor) else _to_device(x, dev)
                     for x in xs]
            with torch.no_grad():
                return _outputs_f32(self._forward(
                    params, self._cast_compute(batch), training=False))
        return step

    def predict(self, x, batch_size: int = 256, device=None) -> np.ndarray:
        """Outputs for numpy ``x`` (one array or a list), in order.
        Runs on the current CUDA device unless ``device`` names another
        (``device="cpu"`` runs every plain version); builds the params
        there from seed 0 if the model has none."""
        xs, _ = data_utils.to_xy_arrays(x, None)
        dev = resolve_device(device)
        if self.params is None:
            self.build(torch.Generator(device=dev).manual_seed(0),
                       [(None,) + a.shape[1:] for a in xs])
        return self._predict_arrays(xs, batch_size, dev)

    def evaluate(self, x, y=None, batch_size: int = 32,
                 device=None) -> Dict[str, float]:
        """The loss and each compiled metric over numpy ``x``/``y``,
        streamed batch by batch in order (the ragged tail padded, then
        its padding sliced off); one read from the device at the end.
        Runs on the current CUDA device unless ``device`` names another
        (``device="cpu"`` runs every plain version)."""
        xs, ys = data_utils.to_xy_arrays(x, y)
        if ys is None:
            raise ValueError("evaluate requires labels")
        if len(getattr(self, "outputs", [None])) > 1:
            raise NotImplementedError("evaluate of a multi-output model is "
                                      "not ported to zoo_tpu_torch yet")
        dev = resolve_device(device)
        if self.params is None:
            self.build(torch.Generator(device=dev).manual_seed(0),
                       [(None,) + a.shape[1:] for a in xs])
        return self._evaluate_arrays(xs, ys, batch_size, dev)

    def _evaluate_arrays(self, xs: List[np.ndarray], ys: np.ndarray,
                         batch_size: int, dev: torch.device
                         ) -> Dict[str, float]:
        step = self._build_pred_step(dev)
        n = data_utils.num_samples(xs)
        bs = max(1, min(batch_size, n))
        loss_sum, seen = None, 0
        totals: Dict[str, Optional[Tuple]] = {m.name: None
                                              for m in self.metrics}
        for idx in data_utils.batch_slices(n, bs, False,
                                           drop_remainder=False):
            padded, real = data_utils.pad_batch([a[idx] for a in xs], bs)
            preds = step(*padded)[:real]
            yt = _to_device(ys[idx], dev)
            if self.loss_fn is not None:
                contrib = self.loss_fn(yt, preds) * real
                loss_sum = contrib if loss_sum is None \
                    else loss_sum + contrib
            for m in self.metrics:
                s, c = m.batch_eval(yt, preds)
                prev = totals[m.name]
                totals[m.name] = (s, c) if prev is None \
                    else (prev[0] + s, prev[1] + c)
            seen += real
        out = {}
        if loss_sum is not None:
            out["loss"] = float(loss_sum) / max(seen, 1)
        for m in self.metrics:
            out[m.name] = float(m.finalize(*totals[m.name]))
        return out

    def _predict_arrays(self, xs: List[np.ndarray], batch_size: int,
                        dev: torch.device):
        step = self._build_pred_step(dev)
        n = data_utils.num_samples(xs)
        bs = max(1, min(batch_size, n))
        outs = []
        for start in range(0, n, bs):
            padded, real = data_utils.pad_batch(
                [a[start:start + bs] for a in xs], bs)
            preds = step(*padded)
            # stays on the device: one transfer at the end
            outs.append(tuple(p[:real] for p in preds)
                        if isinstance(preds, tuple) else preds[:real])
        if outs and isinstance(outs[0], tuple):
            return tuple(torch.cat([o[i] for o in outs]).cpu().numpy()
                         for i in range(len(outs[0])))
        return torch.cat(outs).cpu().numpy()


    # -- persistence -------------------------------------------------------
    def to_bytes(self) -> bytes:
        """The whole model (architecture and weights) as the port's
        model file: :data:`MODEL_MAGIC`, then a standard-library pickle
        of the model with its params as CPU numpy. What only a live
        model holds is left out, as the JAX package's ``to_bytes``
        leaves out its jit caches: the optimizer state and the
        layer-id key cache. A layer holding an object pickle cannot
        store (a ``Lambda`` around a ``lambda``) raises, naming it."""
        live = {k: getattr(self, k) for k in ("params", "_opt_state",
                                              "_keys")}
        try:
            self._opt_state = None
            self._keys = None
            if live["params"] is not None:
                self.params = _numpy_tree(live["params"])
            buf = io.BytesIO()
            buf.write(MODEL_MAGIC)
            try:
                _ModelPickler(buf, protocol=4).dump(self)
            except (pickle.PicklingError, AttributeError, TypeError) as e:
                raise ValueError(
                    f"{self.name} cannot be saved: "
                    f"{self._unpicklable_layer()} holds an object a model "
                    f"file cannot store ({e}); give it a module-level "
                    "function instead of a lambda or closure") from e
            return buf.getvalue()
        finally:
            for k, v in live.items():
                setattr(self, k, v)

    def _unpicklable_layer(self) -> str:
        for layer in self.layers:
            try:
                _ModelPickler(io.BytesIO(), protocol=4).dump(layer)
            except (pickle.PicklingError, AttributeError, TypeError):
                return f"layer {layer.name!r} ({type(layer).__name__})"
        return "the model"

    def save(self, path: str) -> str:
        data = self.to_bytes()
        with open(path, "wb") as f:
            f.write(data)
        return path

    @staticmethod
    def load(path: str, device=None) -> "KerasNet":
        """A model written by :meth:`save`, its params on the current
        CUDA device unless ``device`` names another. The header is
        checked before anything is unpickled: a JAX ``.zoo`` file (a
        cloudpickle of the JAX package's model) or any other file is
        refused. Int8 conv weights get their kernel's K-major copies
        again (:func:`~zoo_tpu_torch.convert.keras_params_from_jax`)."""
        dev = resolve_device(device)
        with open(path, "rb") as f:
            return KerasNet._read(f, dev, path)

    @staticmethod
    def from_bytes(data: bytes, device=None,
                   source: str = "the buffer") -> "KerasNet":
        """:meth:`load` of a model file held in memory (``to_bytes``'s
        output, or a decrypted one), read by the same checks and the
        same allowlist; ``source`` names it in a refusal."""
        dev = resolve_device(device)
        return KerasNet._read(io.BytesIO(data), dev, source)

    @staticmethod
    def _read(f, dev: torch.device, source: str) -> "KerasNet":
        from zoo_tpu_torch.convert import keras_params_from_jax
        head = f.read(len(MODEL_MAGIC))
        if head != MODEL_MAGIC:
            raise ValueError(
                f"{source} is not a model file of zoo_tpu_torch (no "
                f"{MODEL_MAGIC!r} header). A JAX package .zoo file "
                "is a cloudpickle of that package's model and is not "
                "read here: build the same model in the port and "
                "read the JAX package's save_weights file with "
                "load_weights")
        model = _ModelUnpickler(f, dev).load()
        if not isinstance(model, KerasNet):
            raise ValueError(f"{source} holds a {type(model).__name__}, "
                             "not a model")
        if model.params is not None:
            model.params = keras_params_from_jax(model.params, dev)
        return model

    def save_weights(self, path: str):
        """The JAX package's weight file: a pickle of ``{"params":
        numpy tree, "step"}``, layer keys as both packages make them."""
        with open(path, "wb") as f:
            pickle.dump({"params": _numpy_tree(self.params),
                         "step": int(self._step)}, f)

    def load_weights(self, path: str, device=None):
        """Restore a ``save_weights`` file of either package onto the
        params' device (else the current CUDA device, or ``device``).
        Params are keyed by layer position and type, so a file restores
        only into a structurally identical model: a mismatch is a hard
        error, as in the JAX package, never a silent mis-restore."""
        from zoo_tpu_torch.convert import keras_params_from_jax
        with open(path, "rb") as f:
            blob = _ModelUnpickler(f, torch.device("cpu")).load()
        loaded = blob["params"]
        if self.params is None:
            try:   # the model's own structure, to validate against
                self.build(device=device)
            except ValueError:
                pass   # input shape unknowable here: accept unvalidated
        if self.params is not None:
            have, got = _leaf_shapes(self.params), _leaf_shapes(loaded)
            if have != got:
                missing = sorted(map(str, set(have) - set(got)))
                extra = sorted(map(str, set(got) - set(have)))
                changed = sorted(str(k) for k in have
                                 if k in got and have[k] != got[k])
                raise ValueError(
                    "checkpoint does not match this model's structure "
                    "(params are keyed by layer position+type, so layers "
                    "must match one-for-one). "
                    f"missing={missing[:5]} unexpected={extra[:5]} "
                    f"shape-changed={changed[:5]}")
            dev = self._params_device()
        else:
            dev = resolve_device(device)
        self.params = keras_params_from_jax(loaded, dev)
        self._step = int(blob.get("step", 0))
        return self


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
        self._keys = None
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

    def _forward(self, params, inputs: List, *, training, collect=None):
        h = inputs[0] if len(inputs) == 1 else inputs
        for layer in self._layers:
            h = _call(layer, self._key_of(layer), params, h, training,
                      collect)
        return h


def Input(shape: Tuple, name: Optional[str] = None) -> KTensor:
    """Symbolic input of a functional ``Model`` (``shape`` excludes the
    batch dim)."""
    return KTensor((None,) + tuple(shape))


class Model(KerasNet):
    """Functional graph model: the layers between ``input`` and
    ``output`` KTensors, run in topological order; a layer used at
    several nodes is built once and shares its params."""

    def __init__(self, input: Union[KTensor, Sequence[KTensor]],
                 output: Union[KTensor, Sequence[KTensor]],
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.inputs = list(input) if isinstance(input, (list, tuple)) \
            else [input]
        self.outputs = list(output) if isinstance(output, (list, tuple)) \
            else [output]
        self.output = self.outputs[0]
        self._topo = self._toposort()
        seen, self._layer_list = set(), []
        for node in self._topo:
            if node.layer is not None and id(node.layer) not in seen:
                seen.add(id(node.layer))
                self._layer_list.append(node.layer)

    def _toposort(self) -> List[KTensor]:
        """Depth-first from each output, parents in inbound order: the
        JAX package's order, which fixes the params keys."""
        seen, order = set(), []

        def visit(node: KTensor):
            if id(node) in seen:
                return
            seen.add(id(node))
            for parent in node.inbound:
                visit(parent)
            order.append(node)

        for out in self.outputs:
            visit(out)
        for t in self.inputs:
            if id(t) not in seen:
                raise ValueError("an input tensor is not connected to output")
        return order

    @property
    def layers(self) -> List[Layer]:
        return self._layer_list

    def _input_shapes(self):
        return [t.shape for t in self.inputs]

    def _init_params(self, generator, input_shapes) -> Dict:
        params: Dict = {}
        shapes = {id(t): tuple(s) for t, s in zip(self.inputs, input_shapes)}
        for node in self._topo:
            if node.layer is None:
                continue
            in_shapes = [shapes[id(p)] for p in node.inbound]
            arg = in_shapes if len(in_shapes) > 1 else in_shapes[0]
            key = self._key_of(node.layer)
            if key not in params:  # shared layers build once
                params[key] = node.layer.build(generator, arg)
            shapes[id(node)] = node.layer.compute_output_shape(arg)
        return params

    def _forward(self, params, inputs: List, *, training, collect=None):
        values = {id(t): v for t, v in zip(self.inputs, inputs)}
        for node in self._topo:
            if node.layer is None:
                if id(node) not in values:
                    raise ValueError("missing input value")
                continue
            args = [values[id(p)] for p in node.inbound]
            arg = args if len(args) > 1 else args[0]
            values[id(node)] = _call(node.layer, self._key_of(node.layer),
                                     params, arg, training, collect)
        if len(self.outputs) == 1:
            return values[id(self.output)]
        return tuple(values[id(o)] for o in self.outputs)
