"""Layer protocol of the Keras-style API (counterpart of
``zoo_tpu/pipeline/api/keras/engine/base.py``).

A layer is an ``nn.Module`` that follows the JAX package's keras-1
protocol, with its parameters held by the model, not by the layer:

- ``build(generator, input_shape) -> params``: a tree (dicts) of f32
  tensors drawn from the ``torch.Generator``, on its device;
- ``call(params, inputs, *, training) -> outputs``;
- ``compute_output_shape(input_shape)``.

``input_shape`` excludes the batch dimension; reported shapes carry
``None`` for it. The functional API (``KTensor``, ``Input``, ``Model``)
is not ported yet.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch
from torch import nn

_NAME_COUNTERS: Dict[str, int] = collections.defaultdict(int)


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

    def call(self, params, inputs, *, training: bool = False):
        raise NotImplementedError

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)
