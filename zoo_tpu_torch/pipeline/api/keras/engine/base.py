"""Layer protocol of the Keras-style API (counterpart of
``zoo_tpu/pipeline/api/keras/engine/base.py``).

A layer is an ``nn.Module`` that follows the JAX package's keras-1
protocol, with its parameters held by the model, not by the layer:

- ``build(generator, input_shape) -> params``: a tree (dicts) of f32
  tensors drawn from the ``torch.Generator``, on its device;
- ``call(params, inputs, *, training, rng=None) -> outputs``: ``rng``
  is the training step's key (a (2,) int64 tensor of JAX's threefry
  words, on the params' device) in training, None otherwise; a layer
  that draws from it derives its own key by :func:`layer_rng`;
- ``compute_output_shape(input_shape)``.

``input_shape`` excludes the batch dimension; reported shapes carry
``None`` for it. Calling a layer on a :class:`KTensor` (or a list of
them) adds a node to a functional graph (``Input``/``Model`` in
``topology``); calling it on tensors is ``nn.Module``'s call.
"""

from __future__ import annotations

import collections
import math
import types
import zlib
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

_NAME_COUNTERS: Dict[str, int] = collections.defaultdict(int)


#: the classes (with their subclasses) and module-level functions of
#: the port that a model file may name (:func:`model_file_part`)
_MODEL_FILE_PARTS: set = set()


def model_file_part(obj):
    """Let a model file of the port name ``obj``, a class (and so its
    subclasses) or a module-level function; ``KerasNet.load`` resolves
    nothing else of the port, and ``save`` refuses anything else."""
    _MODEL_FILE_PARTS.add(obj)
    return obj


def is_model_file_part(obj) -> bool:
    if isinstance(obj, type):
        return any(isinstance(c, type) and issubclass(obj, c)
                   for c in _MODEL_FILE_PARTS)
    return isinstance(obj, types.FunctionType) and obj in _MODEL_FILE_PARTS


def _auto_name(cls_name: str) -> str:
    _NAME_COUNTERS[cls_name] += 1
    return f"{cls_name.lower()}_{_NAME_COUNTERS[cls_name]}"


def tree_leaves(tree) -> list:
    """Tensors of a dict tree in sorted-key order, the order in which
    ``jax.tree_util`` flattens the same dicts."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more dict trees of the same
    structure, called in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Initializers (keras-1 names): fn(generator, shape) -> f32 tensor on the
# generator's device. Values differ from jax.random's for the same seed;
# parity tests carry the JAX package's weights over instead.
# ---------------------------------------------------------------------------

def _fans(shape) -> Tuple[float, float]:
    """Fan-in and fan-out as ``jax.nn.initializers`` count them: the
    last two axes are (in, out), the rest the receptive field."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in = shape[-2] * receptive if len(shape) > 1 else shape[0]
    return fan_in, shape[-1] * receptive


@model_file_part
class _Uniform:
    """U(-limit, limit) with the limit a function of the fans: keras-1's
    ``glorot_uniform`` (6 / (in + out)), ``he_uniform`` (6 / in) and
    ``lecun_uniform`` (3 / in), under the square root. A class, not a
    closure, so a layer holding it pickles into a model file."""

    def __init__(self, kind: str):
        self.kind = kind

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        fi, fo = _fans(tuple(shape))
        limit = math.sqrt({"glorot": 6.0 / (fi + fo), "he": 6.0 / fi,
                           "lecun": 3.0 / fi}[self.kind])
        out = torch.empty(tuple(shape), dtype=torch.float32,
                          device=generator.device)
        return out.uniform_(-limit, limit, generator=generator)


@model_file_part
class _TruncNormal:
    """N(0, s**2) truncated to two standard deviations, ``s`` set so the
    draw's variance is ``scale / fan_in``: ``jax.nn.initializers.
    he_normal`` at scale 2, whose ``truncated_normal`` variance scaling
    divides the stddev by 0.87962566103423978 (the truncated
    distribution's stddev)."""

    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        fi, _ = _fans(tuple(shape))
        std = math.sqrt(self.scale / fi) / .87962566103423978
        out = torch.empty(tuple(shape), dtype=torch.float32,
                          device=generator.device)
        return torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std,
                                           2 * std, generator=generator)


@model_file_part
class _Const:
    def __init__(self, value: float):
        self.value = value

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        return torch.full(tuple(shape), self.value, dtype=torch.float32,
                          device=generator.device)


@model_file_part
class uniform:
    """U[0, scale), as ``jax.nn.initializers.uniform(scale)``."""

    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        out = torch.empty(tuple(shape), dtype=torch.float32,
                          device=generator.device)
        return out.uniform_(0.0, self.scale, generator=generator)


@model_file_part
class normal:
    """N(0, stddev**2), as ``jax.nn.initializers.normal(stddev)``."""

    def __init__(self, stddev: float):
        self.stddev = stddev

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        out = torch.empty(tuple(shape), dtype=torch.float32,
                          device=generator.device)
        return out.normal_(0.0, self.stddev, generator=generator)


@model_file_part
class orthogonal:
    """A (semi-)orthogonal matrix over the last axis, as
    ``jax.nn.initializers.orthogonal()``: the Q of a QR of a normal
    matrix, its columns' signs fixed by R's diagonal."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        shape = tuple(shape)
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        wide = n_rows < n_cols
        a = torch.empty((n_cols, n_rows) if wide else (n_rows, n_cols),
                        dtype=torch.float32, device=generator.device)
        a.normal_(generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if wide:
            q = q.T
        return (self.scale * q).reshape(shape).contiguous()


_INITIALIZERS = {
    "glorot_uniform": _Uniform("glorot"),
    "he_uniform": _Uniform("he"),
    "lecun_uniform": _Uniform("lecun"),
    "he_normal": _TruncNormal(2.0),
    "uniform": uniform(0.05),
    "normal": normal(0.05),
    "zero": _Const(0.0),
    "zeros": _Const(0.0),
    "one": _Const(1.0),
    "ones": _Const(1.0),
    "orthogonal": orthogonal(),
}


def get_initializer(name: Union[str, Callable, None]) -> Callable:
    """Initializer by keras-1 name (default ``glorot_uniform``), or the
    callable itself."""
    if callable(name):
        return name
    name = (name or "glorot_uniform").lower()
    if name not in _INITIALIZERS:
        raise ValueError(f"unknown initializer: {name} (the port has "
                         f"{', '.join(sorted(_INITIALIZERS))})")
    return _INITIALIZERS[name]


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` as it computes: in the input dtype, max
    subtracted, exp, divided by the sum."""
    u = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


def _hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_sigmoid``: ``relu6(x + 3) / 6`` (not keras-1's
    ``0.2 x + 0.5``), the division as XLA compiles it: a multiply by
    the f32 reciprocal of 6."""
    return torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": _hard_sigmoid,
    "softmax": _softmax,
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": torch.nn.functional.softplus,
    "elu": torch.nn.functional.elu,
    "selu": torch.nn.functional.selu,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "silu": torch.nn.functional.silu,
    "swish": torch.nn.functional.silu,
    "exp": torch.exp,
    "linear": lambda x: x,
}


def get_activation_fn(name: Union[str, Callable, None]
                      ) -> Optional[Callable]:
    """Activation by keras name (``gelu`` is the tanh form, the default
    of ``jax.nn.gelu``), the callable itself, or None."""
    if name is None or callable(name):
        return name
    name = name.lower()
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation: {name}")
    return _ACTIVATIONS[name]


def layer_rng(rng: Optional[torch.Tensor], layer_name: str
              ) -> Optional[torch.Tensor]:
    """The layer's own key: ``fold_in(rng, crc32(name))``, the JAX
    package's derivation (a stable digest, so both packages derive the
    same key for a layer of the same name); None for None. On the card
    the fold is one launch of the key kernel, so the key never visits
    the host."""
    if rng is None:
        return None
    from zoo_tpu_torch.ops.kernels import dropout as D
    return D.fold_in(rng, zlib.crc32(layer_name.encode()))


def normalize_shape(shape) -> Tuple:
    """``(None, ...)`` or ``(...)`` as a ``(None, ...)`` shape."""
    shape = tuple(shape)
    if not shape or shape[0] is not None:
        return (None,) + shape
    return shape


@model_file_part
class KTensor:
    """Symbolic tensor node of the functional graph: its shape (with a
    None batch dim), the layer that made it and that layer's inputs."""

    def __init__(self, shape: Tuple, layer: Optional["Layer"] = None,
                 inbound: Sequence["KTensor"] = ()):
        self.shape = tuple(shape)
        self.layer = layer
        self.inbound = list(inbound)

    def __repr__(self):
        lname = self.layer.name if self.layer else "input"
        return f"KTensor(shape={self.shape}, from={lname})"


@model_file_part
class Layer(nn.Module):
    """Base layer. Subclasses implement ``build``/``call``/
    ``compute_output_shape`` as functions of the params they are given."""

    def __init__(self, input_shape: Optional[Tuple] = None,
                 name: Optional[str] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        # keras-1: input_shape excludes the batch dim
        self.batch_input_shape = (None,) + tuple(input_shape) \
            if input_shape is not None else None

    def build(self, generator: torch.Generator, input_shape) -> Dict:
        """Create params for ``input_shape`` (with a leading None batch
        dim). Default: a parameterless layer."""
        return {}

    def call(self, params, inputs, *, training: bool = False, rng=None):
        raise NotImplementedError

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)

    def __call__(self, *args, **kwargs):
        """On a :class:`KTensor` or a list of them: a new graph node with
        the output shape; otherwise ``nn.Module``'s call."""
        x = args[0] if len(args) == 1 and not kwargs else None
        nodes = list(x) if isinstance(x, (list, tuple)) else [x]
        if nodes and all(isinstance(t, KTensor) for t in nodes):
            in_shape = ([t.shape for t in nodes] if len(nodes) > 1
                        else nodes[0].shape)
            return KTensor(self.compute_output_shape(in_shape), layer=self,
                           inbound=nodes)
        return super().__call__(*args, **kwargs)
