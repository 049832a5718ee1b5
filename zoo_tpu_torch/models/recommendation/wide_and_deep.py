"""Wide & Deep recommender (counterpart of
``zoo_tpu/models/recommendation/wide_and_deep.py``).

Input layout (one int/float matrix, columns in order):
``[wide_base..., wide_cross..., indicator..., embed..., continuous...]``.
The wide tower is a per-column embedding of width ``class_num`` (the
one-hot linear layer), summed; the deep tower concatenates the
indicator columns' one-hot rows (an identity-initialised embedding),
the embedding columns and the continuous columns, then an MLP. Their
logits add, then a softmax.

The column selectors and the identity initializer are module-level
callables (:class:`ColumnOf`, :class:`ColumnRange`, :class:`eye`), not
the JAX package's closures, so the model saves to the port's model
file; the layers (``Lambda``, ``Embedding``) and their params keys are
the JAX model's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from zoo_tpu_torch.models.recommendation.recommender import Recommender
from zoo_tpu_torch.pipeline.api.keras.engine.base import model_file_part
from zoo_tpu_torch.pipeline.api.keras.engine.topology import Input, Model
from zoo_tpu_torch.pipeline.api.keras.layers import (
    Activation,
    Dense,
    Embedding,
    Lambda,
    merge,
)


@model_file_part
@dataclasses.dataclass
class ColumnFeatureInfo:
    """The column groups and their sizes (reference: ``ColumnFeatureInfo``
    in ``pyzoo/zoo/models/recommendation/wide_and_deep.py``)."""

    wide_base_cols: List[str] = dataclasses.field(default_factory=list)
    wide_base_dims: List[int] = dataclasses.field(default_factory=list)
    wide_cross_cols: List[str] = dataclasses.field(default_factory=list)
    wide_cross_dims: List[int] = dataclasses.field(default_factory=list)
    indicator_cols: List[str] = dataclasses.field(default_factory=list)
    indicator_dims: List[int] = dataclasses.field(default_factory=list)
    embed_cols: List[str] = dataclasses.field(default_factory=list)
    embed_in_dims: List[int] = dataclasses.field(default_factory=list)
    embed_out_dims: List[int] = dataclasses.field(default_factory=list)
    continuous_cols: List[str] = dataclasses.field(default_factory=list)

    @property
    def feature_cols(self) -> List[str]:
        return (self.wide_base_cols + self.wide_cross_cols +
                self.indicator_cols + self.embed_cols +
                self.continuous_cols)


@model_file_part
class ColumnOf:
    """``v[:, j]``: one column of the input matrix."""

    def __init__(self, j: int):
        self.j = int(j)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v[:, self.j]


@model_file_part
class ColumnRange:
    """``v[:, start:stop]`` in f32 (the continuous columns)."""

    def __init__(self, start: int, stop: int):
        self.start, self.stop = int(start), int(stop)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v[:, self.start:self.stop].float()


@model_file_part
class eye:
    """The identity initializer: ``jnp.eye(shape[0], shape[1])``."""

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        return torch.eye(shape[0], shape[1], dtype=torch.float32,
                         device=generator.device)


class WideAndDeep(Model, Recommender):
    def __init__(self, class_num: int, column_info: ColumnFeatureInfo,
                 model_type: str = "wide_n_deep",
                 hidden_layers: Sequence[int] = (40, 20, 10)):
        if model_type not in ("wide_n_deep", "wide", "deep"):
            raise ValueError("model_type must be wide_n_deep | wide | deep")
        self.column_info = column_info
        self.model_type = model_type
        ci = column_info

        n_wide = len(ci.wide_base_cols) + len(ci.wide_cross_cols)
        n_ind = len(ci.indicator_cols)
        n_embed = len(ci.embed_cols)
        n_cont = len(ci.continuous_cols)
        total = n_wide + n_ind + n_embed + n_cont
        x = Input(shape=(total,), name="wnd_input")

        towers = []
        offset = 0
        if model_type in ("wide", "wide_n_deep") and n_wide:
            # wide: the one-hot linear layer as a per-column embedding
            # of width class_num, summed
            wide_parts = []
            for i, dim in enumerate(list(ci.wide_base_dims) +
                                    list(ci.wide_cross_dims)):
                col = Lambda(ColumnOf(offset + i), output_shape=(None,))(x)
                wide_parts.append(Embedding(dim + 1, class_num,
                                            init="zero")(col))
            towers.append(wide_parts[0] if len(wide_parts) == 1
                          else merge(wide_parts, mode="sum"))
        offset += n_wide

        if model_type in ("deep", "wide_n_deep"):
            deep_parts = []
            for i, dim in enumerate(ci.indicator_dims):
                col = Lambda(ColumnOf(offset + i), output_shape=(None,))(x)
                # an indicator column's one-hot row: an identity table
                deep_parts.append(Embedding(dim + 1, dim + 1,
                                            init=eye())(col))
            off2 = offset + n_ind
            for i, (din, dout) in enumerate(zip(ci.embed_in_dims,
                                                ci.embed_out_dims)):
                col = Lambda(ColumnOf(off2 + i), output_shape=(None,))(x)
                deep_parts.append(Embedding(din + 1, dout)(col))
            off3 = off2 + n_embed
            if n_cont:
                deep_parts.append(Lambda(ColumnRange(off3, off3 + n_cont),
                                         output_shape=(n_cont,))(x))
            h = deep_parts[0] if len(deep_parts) == 1 else merge(
                deep_parts, mode="concat")
            for units in hidden_layers:
                h = Dense(units, activation="relu")(h)
            towers.append(Dense(class_num)(h))

        out = towers[0] if len(towers) == 1 else merge(towers, mode="sum")
        out = Activation("softmax")(out)
        Model.__init__(self, input=x, output=out, name="wide_and_deep")
