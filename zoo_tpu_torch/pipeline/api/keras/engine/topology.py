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

Training (``fit``) feeds host superbatches: ``group`` batches (at most
16, at most 64 MB, then the largest divisor of the batch count: the JAX
package's rule) are sliced on the host, copied to the device once and
stepped through batch by batch. With a training guard attached
(:meth:`set_guard`, which the Orca estimator does by default) each step
folds the health check into itself, as the JAX step does: ``ok =
isfinite(loss) & isfinite(sum g^2)`` on the device, and where it is
false the params, the whole optimizer state (its device count included)
and the BatchNorm stats pass through bit-unchanged, the loss counts 0
and stays out of the mean. The host reads the guard's ``{bad, streak}``
counters only at superbatch boundaries (one small copy into pinned
memory and an event wait, where the JAX loop's ``device_get`` is), and
escalates to rollback or preemption there; the ``fit.batch`` fault seam
fires once a superbatch on the host slice. Gradient clipping (constant
or global L2 norm; the norm and the guard's sum of squares are one
reduction), validation data, TensorBoard summaries and the metric-driven
Plateau schedule are the JAX ``fit``'s.

Not ported yet: meshes and plans, the profiler (``set_profile``,
ROADMAP A.15).
"""

from __future__ import annotations

import io
import pickle
import time
import types
import warnings
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
from zoo_tpu_torch.pipeline.api.keras.optimizers import (
    get_optimizer,
    state_to_device,
)
from zoo_tpu_torch.tensorboard import TrainSummary
from zoo_tpu_torch.util.resilience import fault_point


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


def _cast_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


@_base.model_file_part
class MultiLoss:
    """The loss of a multi-output model: one loss per output, summed
    with weights (``compile(loss=[...], loss_weights=[...])``), as the
    JAX package combines them. A class, so a model file can hold it."""

    def __init__(self, fns: Sequence[Callable], weights: Sequence[float]):
        self.fns, self.weights = list(fns), [float(w) for w in weights]

    def __call__(self, ys, preds):
        ys = ys if isinstance(ys, (list, tuple)) else [ys]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        if not (len(self.fns) == len(ys) == len(preds)):
            raise ValueError(
                f"{len(self.fns)} losses, {len(ys)} label sets, "
                f"{len(preds)} outputs — counts must match")
        return sum(w * f(y, p) for w, f, y, p in
                   zip(self.weights, self.fns, ys, preds))


class _BoundaryReader:
    """Reads a few device scalars to the host at a guard boundary: on a
    CUDA device one copy into a pinned buffer and a wait on an event
    recorded after it (the superbatch's steps finish first: the read is
    a host-device sync once a superbatch, where the JAX loop's
    ``device_get`` is, and no stream synchronisation); on the CPU a
    plain read. ``reads`` counts them."""

    def __init__(self, dev: torch.device):
        self.dev, self.reads = dev, 0
        self._buf = None

    def read(self, *scalars) -> List[float]:
        vals = torch.stack([torch.zeros((), dtype=torch.float64,
                                        device=self.dev) if t is None
                            else t.detach().to(torch.float64)
                            for t in scalars])
        self.reads += 1
        if self.dev.type != "cuda":
            return vals.tolist()
        if self._buf is None or self._buf.numel() != vals.numel():
            self._buf = torch.empty(vals.numel(), dtype=torch.float64,
                                    pin_memory=True)
        self._buf.copy_(vals, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return self._buf.tolist()


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
        self._grad_clip: Optional[Tuple] = None
        self._guard = None   # orca.learn.guard.TrainingGuard
        self.train_summary = TrainSummary()
        self.validation_summary = TrainSummary()

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
    def compile(self, optimizer, loss, metrics=None, loss_weights=None,
                dtype_policy: str = "float32"):
        """``loss``: one loss, or for a multi-output model a list of one
        loss per output, combined as their sum weighted by
        ``loss_weights`` (default 1 each), as the JAX package combines
        them. ``dtype_policy``: ``"float32"`` or ``"mixed_bfloat16"`` —
        parameters and optimizer state stay f32, the forward and
        backward run in bf16 with f32 islands in the norms, softmax and
        loss reductions; gradients arrive in f32."""
        if dtype_policy not in ("float32", "mixed_bfloat16"):
            raise ValueError(f"unknown dtype_policy: {dtype_policy}")
        n_out = len(getattr(self, "outputs", [None]))
        if n_out > 1 and not isinstance(loss, (list, tuple)):
            raise ValueError(
                f"model has {n_out} outputs; compile(loss=[...]) needs one "
                "loss per output")
        if isinstance(loss, (list, tuple)) and len(loss) != n_out:
            raise ValueError(f"{len(loss)} losses for {n_out} outputs")
        if loss_weights is not None and not isinstance(loss,
                                                       (list, tuple)):
            raise ValueError("loss_weights needs a list of losses")
        self.dtype_policy = dtype_policy
        self.optimizer = get_optimizer(optimizer)
        if isinstance(loss, (list, tuple)):
            fns = [get_loss(x) for x in loss]
            ws = ([float(w) for w in loss_weights]
                  if loss_weights is not None else [1.0] * len(fns))
            if len(ws) != len(fns):
                raise ValueError(f"{len(ws)} loss_weights for "
                                 f"{len(fns)} losses")
            self.loss_fn = MultiLoss(fns, ws)
        else:
            self.loss_fn = get_loss(loss)
        self.metrics = [get_metric(m) for m in (metrics or [])]
        self._opt_state = None  # a new optimizer cannot reuse old state
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        """Clip every gradient element into [min_value, max_value]."""
        self._grad_clip = ("const", float(min_value), float(max_value))
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        """Scale gradients so their global L2 norm is at most
        ``clip_norm``."""
        self._grad_clip = ("l2", float(clip_norm))
        return self

    def clear_gradient_clipping(self):
        self._grad_clip = None
        return self

    def set_guard(self, guard):
        """Attach a :class:`zoo_tpu_torch.orca.learn.guard.TrainingGuard`:
        every step of the next ``fit`` carries the health fold and the
        device counters."""
        self._guard = guard
        return self

    def clear_guard(self):
        self._guard = None
        return self

    def _active_guard(self):
        g = getattr(self, "_guard", None)
        return g if g is not None and g.active else None

    def set_tensorboard(self, log_dir: str, app_name: str):
        """Train and validation summaries into event files under
        ``log_dir/app_name/{train,val}``."""
        self.train_summary = TrainSummary(log_dir, app_name + "/train")
        self.validation_summary = TrainSummary(log_dir, app_name + "/val")

    def set_profile(self, trace_dir=None, trace_epochs: int = 1):
        raise NotImplementedError(
            "set_profile: the step profiler (common/profiling.py) is not "
            "ported to zoo_tpu_torch yet (ROADMAP A.15)")

    def get_train_summary(self, tag: str = "Loss"):
        return self._summary("train_summary").read_scalar(tag)

    def get_validation_summary(self, tag: str):
        return self._summary("validation_summary").read_scalar(tag)

    def _summary(self, attr: str):
        if getattr(self, attr, None) is None:   # a model loaded from a file
            setattr(self, attr, TrainSummary())
        return getattr(self, attr)

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

    def _adapt_inputs(self, xs: List[np.ndarray]) -> List[np.ndarray]:
        """A single-input model fed k 1-D feature columns gets them
        stacked into one (batch, k) array, as the JAX package does."""
        shapes = self._input_shapes() or self._built_shapes
        if shapes and len(shapes) == 1 and len(xs) > 1 \
                and all(a.ndim == 1 for a in xs):
            return [np.stack(xs, axis=1)]
        return xs

    def _labels(self, ys) -> List[np.ndarray]:
        """The label arrays, one per output."""
        n_out = len(getattr(self, "outputs", [None]))
        if isinstance(ys, (list, tuple)):
            if n_out <= 1:
                # one output: a list of label rows is ONE label array
                return [np.stack([np.asarray(a) for a in ys])
                        if len(ys) > 1 else np.asarray(ys[0])]
            if len(ys) != n_out:
                raise ValueError(f"model has {n_out} outputs but got "
                                 f"{len(ys)} label arrays")
            return [np.asarray(a) for a in ys]
        return [ys]

    def _cast_compute(self, tree):
        """f32 tensors to bf16 under ``mixed_bfloat16``; inside autograd,
        so gradients flow back to the f32 leaves in f32."""
        if self.dtype_policy != "mixed_bfloat16":
            return tree
        cast = _cast_bf16
        if isinstance(tree, list):
            return [cast(t) for t in tree]
        return tree_map(cast, tree)

    def _clip(self, grads: List[torch.Tensor]):
        """Gradient clipping before the update (outside the optimizer,
        so toggling it never invalidates optimizer state). Returns the
        clipped gradients and, under L2 clipping, their sum of squares
        (the one reduction the guard reads too)."""
        clip = getattr(self, "_grad_clip", None)
        if clip is None:
            return grads, None
        if clip[0] == "const":
            _, lo, hi = clip
            return [torch.clamp(g, lo, hi) for g in grads], None
        from zoo_tpu_torch.orca.learn.guard import TrainingGuard
        sq = TrainingGuard.grad_sq_sum(grads)
        scale = torch.clamp(clip[1] / (torch.sqrt(sq) + 1e-12), max=1.0)
        return [g * scale for g in grads], sq * scale * scale

    def _train_step(self, opt_state, xs: List[torch.Tensor], ys,
                    guard=None, gstate=None):
        """Forward, backward against the trainable leaves, clipping, the
        optimizer's in-place update, then the running stats replaced by
        their updates; returns ``(opt_state, loss, gstate)`` with the
        loss a detached f32 scalar. With a ``guard`` the step is folded
        on its device predicate (nothing changes where it is false, and
        the loss is 0 there) and ``gstate`` advances."""
        trainable, state = _split_state(self.params)
        collect: Dict = {}
        with torch.enable_grad():
            # cast trainables only: the running stats keep f32
            # resolution, or momentum-0.99 increments vanish below a
            # bf16 ulp
            preds = self._forward(
                _merge_state(self._cast_compute(trainable), state),
                self._cast_compute(xs), training=True, collect=collect)
            if not getattr(self.loss_fn, "_handles_low_precision", False):
                preds = _outputs_f32(preds)
            loss = self.loss_fn(ys, preds)
        # a leaf the loss does not reach (BERT's pooler, the segment
        # table without segment ids) gets zeros, as jax.grad gives it
        grads = list(torch.autograd.grad(loss, tree_leaves(trainable),
                                         allow_unused=True,
                                         materialize_grads=True))
        grads, sq = self._clip(grads)
        loss = loss.detach()
        ok = None
        if guard is not None:
            if sq is None:
                sq = guard.grad_sq_sum(grads)
            ok = guard.grad_norm_ok(loss, sq_sum=sq)
        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), trainable)
        _, opt_state = self.optimizer.apply(grad_tree, opt_state, trainable,
                                            ok)
        new_stats = collect or state
        if ok is not None:
            if collect:
                new_stats = guard.health_fold(ok, collect, state)
            loss = torch.where(ok, loss, torch.zeros_like(loss))
            gstate = guard.gstate_update(gstate, ok)
        self.params = _merge_state(trainable, new_stats)
        return opt_state, loss, gstate

    def _place_params(self, params, dev: torch.device) -> None:
        """``params`` (tensors anywhere, or numpy) as this model's
        params on ``dev``: the trainable leaves as f32 leaf tensors that
        autograd differentiates against, the running stats plain."""
        def tensor(a):
            if isinstance(a, torch.Tensor):
                return a
            return torch.from_numpy(np.array(a, copy=True))
        trainable, state = _split_state(tree_map(tensor, params))
        trainable = tree_map(
            lambda t: t if t.device == dev and t.requires_grad
            and t.is_leaf else t.detach().to(dev).requires_grad_(True),
            trainable)
        self.params = _merge_state(trainable, tree_map(
            lambda t: t.detach().to(dev), state))

    @staticmethod
    def _superbatch_group(arrs: List[np.ndarray], batch_size: int,
                          n_batches: int) -> int:
        """Batches per host superbatch, the JAX ``fit``'s rule: as many
        as fit 64 MB, at most 16, then the largest divisor of the batch
        count not above that (when one above 1 exists)."""
        sample_bytes = sum(a[:1].nbytes for a in arrs)
        group = max(1, min(16, (64 << 20) // max(sample_bytes * batch_size,
                                                 1)))
        scan = min(group, n_batches)
        while scan > 1 and n_batches % scan:
            scan -= 1
        return scan if scan > 1 else group

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, shuffle: bool = True, feature_cols=None,
            label_cols=None, seed: int = 0, verbose: int = 1,
            device=None) -> Dict[str, List[float]]:
        """Train on ``x``/``y`` (numpy, a dict of them, or a DataFrame
        with ``feature_cols``/``label_cols``); returns ``{"loss":
        [per-epoch mean], "val_<name>": [...] with validation_data}``.
        Runs on the current CUDA device unless ``device`` names another
        (``device="cpu"`` runs every plain version). The ragged tail of
        each epoch's permutation is dropped; a second ``fit`` continues
        from the optimizer state the first one left. With a guard
        attached, a boundary's verdict may roll back to the last
        verified checkpoint (:class:`~zoo_tpu_torch.orca.learn.guard.
        EpochRolledBack` when that wipes a whole epoch) or checkpoint
        and raise ``Preempted``."""
        if self.loss_fn is None:
            raise RuntimeError("call compile() before fit()")
        if self._quantized:
            raise RuntimeError("a quantized model is inference-only")
        xs, ys = data_utils.to_xy_arrays(x, y, feature_cols, label_cols)
        xs = self._adapt_inputs(xs)
        if ys is None:
            raise ValueError("fit requires labels")
        ys_list = self._labels(ys)
        n = data_utils.num_samples(xs)
        if n < batch_size:
            raise ValueError(f"dataset ({n}) smaller than the batch "
                             f"({batch_size})")
        dev = resolve_device(device)
        self.build(torch.Generator(device=dev).manual_seed(int(seed)),
                   [(None,) + a.shape[1:] for a in xs])
        self._place_params(self.params, dev)
        opt_state = self._opt_state
        if opt_state is None:
            opt_state = self.optimizer.init(_split_state(self.params)[0])
        guard = self._active_guard()
        gstate = None
        if guard is not None:
            guard.begin_fit()
            gstate = guard.device_init(dev)
        val_arrays = None
        if validation_data is not None:
            vx = validation_data[0] if isinstance(validation_data, tuple) \
                else validation_data
            vy = validation_data[1] if isinstance(validation_data, tuple) \
                and len(validation_data) > 1 else None
            val_arrays = data_utils.to_xy_arrays(vx, vy, feature_cols,
                                                 label_cols)
            val_arrays = (self._adapt_inputs(val_arrays[0]), val_arrays[1])
        arrs = xs + ys_list
        n_x = len(xs)
        n_batches = max(n // batch_size, 1)
        group = self._superbatch_group(arrs, batch_size, n_batches)
        reader = _BoundaryReader(dev)
        nprng = np.random.RandomState(seed)
        history: Dict[str, List[float]] = {"loss": []}
        # boundary bookkeeping: per-epoch cumulative baselines so each
        # superbatch boundary sees window deltas (reset at epoch start)
        gb = {"loss": 0.0, "steps": 0, "bad": 0, "bad0": 0, "idx": None,
              "n": 0}
        run = {"opt": opt_state, "g": gstate, "loss_sum": None, "steps": 0}

        def boundary(epoch, final=False):
            """Superbatch-boundary guard check: read the device counters
            (the only host read the guard adds), escalate to rollback /
            preempt when the controller says so."""
            gb["n"] += 1
            if not (final or guard.preempt_requested
                    or gb["n"] % guard.config.check_every == 0):
                return
            g = run["g"]
            bad, streak, cur = reader.read(
                g["bad"], g["streak"], run["loss_sum"])
            bad, streak = int(bad), int(streak)
            cur = 0.0 if run["loss_sum"] is None else cur
            act = guard.on_boundary(
                bad_total=bad, streak=streak,
                window_loss=cur - gb["loss"],
                window_steps=run["steps"] - gb["steps"],
                global_step=self._step, epoch=epoch,
                batch_hint=gb["idx"])
            gb["loss"], gb["steps"], gb["bad"] = cur, run["steps"], bad
            if act == "rollback":
                state, aux, lr_scale = guard.rollback()
                self._place_params(state["params"], dev)
                inner = state_to_device(aux, dev) if aux is not None else \
                    self.optimizer.init(_split_state(self.params)[0])
                if lr_scale != 1.0 and isinstance(inner, dict) \
                        and "lr" in inner:
                    inner["lr"].mul_(lr_scale)
                run["opt"], run["g"] = inner, guard.device_init(dev)
                gb["bad"] = gb["bad0"] = 0
                if not final:
                    # the diverged pre-rollback losses must not leak
                    # into this epoch's reported loss/throughput: the
                    # epoch restarts its accumulators at the restore
                    # point (a rollback AT epoch end keeps them)
                    run["loss_sum"], run["steps"] = None, 0
                    gb["loss"], gb["steps"] = 0.0, 0
            elif act == "preempt":
                # commit the CURRENT state to the model so the owner's
                # save callback snapshots exactly this step, then save
                # and exit resume-don't-retry
                self._opt_state = run["opt"]
                guard.preempt_checkpoint(step=self._step)

        for epoch in range(nb_epoch):
            t0 = time.perf_counter()
            run["loss_sum"], run["steps"] = None, 0
            gb["loss"], gb["steps"] = 0.0, 0
            gb["bad0"] = gb["bad"]
            for idx in data_utils.batch_slices(n, batch_size, shuffle, nprng,
                                               group=group):
                sliced = [a[idx] for a in arrs]
                if guard is not None:
                    # chaos seam: armed tests corrupt the host superbatch
                    # in place (poison-batch injection); the idx hint
                    # feeds quarantine records
                    gb["idx"] = (int(idx[0]), int(idx[-1]))
                    fault_point("fit.batch", arrays=sliced, idx=idx)
                staged = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in sliced]
                for j in range(len(idx) // batch_size):
                    sub = [t[j * batch_size:(j + 1) * batch_size]
                           for t in staged]
                    ys_b = sub[n_x:]
                    run["opt"], loss, run["g"] = self._train_step(
                        run["opt"], sub[:n_x],
                        ys_b[0] if len(ys_b) == 1 else ys_b, guard,
                        run["g"])
                    run["loss_sum"] = loss if run["loss_sum"] is None \
                        else run["loss_sum"] + loss
                    self._step += 1
                    run["steps"] += 1
                if guard is not None:
                    boundary(epoch)
            if guard is not None:
                boundary(epoch, final=True)
                # skipped steps contributed 0 to the sanitized loss sum;
                # keep them out of the mean too
                denom = max(run["steps"] - max(0, gb["bad"] - gb["bad0"]), 1)
            else:
                denom = max(run["steps"], 1)
            if guard is not None and run["loss_sum"] is None:
                # a mid-epoch rollback wiped every step of this epoch:
                # there is no honest loss to report; the estimator's
                # retry perimeter restores the verified checkpoint and
                # retrains the lost epoch
                from zoo_tpu_torch.orca.learn.guard import EpochRolledBack
                raise EpochRolledBack(
                    f"{self.name}: guard rollback wiped every step of "
                    f"epoch {epoch + 1}; retrain it from the restored "
                    "checkpoint")
            epoch_loss = float(run["loss_sum"]) / denom
            history["loss"].append(epoch_loss)
            self._summary("train_summary").add_scalar("Loss", epoch_loss,
                                                      self._step)
            self._summary("train_summary").add_scalar(
                "Throughput",
                run["steps"] * batch_size / max(time.perf_counter() - t0,
                                                1e-9), self._step)
            if val_arrays is not None:
                val = self._evaluate_arrays(val_arrays[0], val_arrays[1],
                                            batch_size, dev)
                for k, v in val.items():
                    history.setdefault("val_" + k, []).append(v)
                    self._summary("validation_summary").add_scalar(
                        k, v, self._step)
            self._plateau_step(run["opt"], epoch_loss, history)
            if verbose:
                extra = {k: v[-1] for k, v in history.items() if k != "loss"}
                print(f"Epoch {epoch + 1}/{nb_epoch} - loss: "
                      f"{epoch_loss:.4f}" +
                      "".join(f" - {k}: {v:.4f}" for k, v in extra.items()))
        self._opt_state = run["opt"]
        self.boundary_reads = reader.reads
        return history

    def _plateau_step(self, opt_state, epoch_loss: float, history) -> None:
        """Run the optimizer's Plateau controller on this epoch's
        monitored value and write the new rate into the state's device
        ``"lr"`` (a fill: no host copy)."""
        plateau = getattr(self.optimizer, "plateau", None)
        if plateau is None:
            return
        mon = plateau.monitor
        if mon.lower() == "loss":
            watched = epoch_loss
        else:
            series = history.get(mon) or history.get("val_" + mon)
            watched = series[-1] if series else None
        if watched is None:
            warnings.warn(
                f"Plateau monitors '{mon}' but no such series was "
                "produced this epoch (pass validation_data / the "
                "metric); skipping lr adjustment")
            return
        opt_state["lr"].fill_(plateau.update(watched))

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

    def predict(self, x, batch_size: int = 256, feature_cols=None,
                device=None) -> np.ndarray:
        """Outputs for ``x`` (one array, a list, or a DataFrame with
        ``feature_cols``), in order. Runs on the current CUDA device
        unless ``device`` names another (``device="cpu"`` runs every
        plain version); builds the params there from seed 0 if the model
        has none."""
        xs, _ = data_utils.to_xy_arrays(x, None, feature_cols, None)
        xs = self._adapt_inputs(xs)
        dev = resolve_device(device)
        if self.params is None:
            self.build(torch.Generator(device=dev).manual_seed(0),
                       [(None,) + a.shape[1:] for a in xs])
        return self._predict_arrays(xs, batch_size, dev)

    def evaluate(self, x, y=None, batch_size: int = 32, feature_cols=None,
                 label_cols=None, device=None) -> Dict[str, float]:
        """The loss and each compiled metric over ``x``/``y``, streamed
        batch by batch in order (the ragged tail padded, then its
        padding sliced off); one read from the device at the end. A
        multi-output model gets its combined loss over all the rows, as
        in the JAX package (per-head metrics are not aggregated). Runs
        on the current CUDA device unless ``device`` names another
        (``device="cpu"`` runs every plain version)."""
        xs, ys = data_utils.to_xy_arrays(x, y, feature_cols, label_cols)
        xs = self._adapt_inputs(xs)
        if ys is None:
            raise ValueError("evaluate requires labels")
        dev = resolve_device(device)
        if self.params is None:
            self.build(torch.Generator(device=dev).manual_seed(0),
                       [(None,) + a.shape[1:] for a in xs])
        return self._evaluate_arrays(xs, ys, batch_size, dev)

    def _evaluate_arrays(self, xs: List[np.ndarray], ys,
                         batch_size: int, dev: torch.device
                         ) -> Dict[str, float]:
        if len(getattr(self, "outputs", [None])) > 1:
            preds = self._predict_arrays(xs, batch_size, dev)
            if self.loss_fn is None:
                return {}
            yt = [_to_device(np.asarray(a), dev) for a in ys] \
                if isinstance(ys, (list, tuple)) else \
                _to_device(np.asarray(ys), dev)
            with torch.no_grad():
                return {"loss": float(self.loss_fn(
                    yt, tuple(_to_device(p, dev) for p in preds)))}
        if isinstance(ys, (list, tuple)):
            ys = self._labels(ys)[0]
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
        leaves out its jit caches: the optimizer state, the layer-id
        key cache, the attached guard and the summaries. A layer holding an object pickle cannot
        store (a ``Lambda`` around a ``lambda``) raises, naming it."""
        live = {k: getattr(self, k, None) for k in (
            "params", "_opt_state", "_keys", "_guard", "train_summary",
            "validation_summary")}
        try:
            self._opt_state = None
            self._keys = None
            self._guard = None   # holds locks and events: owners re-attach
            self.train_summary = self.validation_summary = None
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
