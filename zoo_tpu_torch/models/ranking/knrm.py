"""KNRM, kernel-pooling neural ranking (counterpart of
``zoo_tpu/models/ranking/knrm.py``): query and document token ids, one
shared embedding, the cosine interaction matrix, RBF kernel pooling,
then a linear layer and a sigmoid.

The id slices are module-level callables (:class:`IdSlice`) and the
interaction a module-level layer, not the JAX package's closures and
local class, so the model saves to the port's model file; the layers'
types, and so their params keys, are the JAX model's.
"""

from __future__ import annotations

from typing import Optional

import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    model_file_part,
)
from zoo_tpu_torch.pipeline.api.keras.engine.topology import Input, Model
from zoo_tpu_torch.pipeline.api.keras.layers import (
    Dense,
    Embedding,
    Lambda,
    Merge,
)


@model_file_part
class IdSlice:
    """``v[:, start:stop]``: the query's or the document's ids."""

    def __init__(self, start: int, stop: Optional[int]):
        self.start, self.stop = start, stop

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v[:, self.start:self.stop]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-8)


class _Interaction(Merge):
    """Cosine similarity of every query token with every document token:
    (B, Tq, E), (B, Td, E) -> (B, Tq, Td)."""

    def __init__(self, text1_length: int, text2_length: int, **kwargs):
        super().__init__(mode="dot", **kwargs)
        self.text1_length = text1_length
        self.text2_length = text2_length

    def call(self, params, inputs, *, training=False, rng=None):
        qe, de = inputs
        return torch.bmm(_unit(qe), _unit(de).transpose(1, 2))

    def compute_output_shape(self, input_shape):
        return (input_shape[0][0], self.text1_length, self.text2_length)


class _KernelPooling(Layer):
    """RBF kernel pooling over the interaction matrix: ``kernel_num``
    kernels with mu from 1 down to -1, sigma ``sigma`` (``exact_sigma``
    for the exact-match kernel at mu = 1); each kernel summed over the
    document, ``log1p``, summed over the query."""

    def __init__(self, kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, **kwargs):
        super().__init__(**kwargs)
        self.kernel_num = kernel_num
        self.sigma = sigma
        self.exact_sigma = exact_sigma

    def call(self, params, inputs, *, training=False, rng=None):
        mus, sigmas = [], []
        for i in range(self.kernel_num):
            mus.append(1.0 - 2.0 * i / max(self.kernel_num - 1, 1))
            sigmas.append(self.exact_sigma if i == 0 else self.sigma)
        mu = torch.tensor(mus, dtype=torch.float32, device=inputs.device)
        sg = torch.tensor(sigmas, dtype=torch.float32, device=inputs.device)
        k = torch.exp(-((inputs[..., None] - mu) ** 2) / (2 * sg ** 2))
        return torch.log1p(k.sum(dim=2)).sum(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.kernel_num)


class KNRM(Model):
    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: int = 5000, embed_size: int = 50,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001):
        self.text1_length = text1_length
        self.text2_length = text2_length
        pair = Input(shape=(text1_length + text2_length,), name="qd_pair")
        q_ids = Lambda(IdSlice(0, text1_length),
                       output_shape=(text1_length,))(pair)
        d_ids = Lambda(IdSlice(text1_length, None),
                       output_shape=(text2_length,))(pair)
        embed = Embedding(vocab_size, embed_size)  # shared weights
        q = embed(q_ids)
        d = embed(d_ids)
        sim = _Interaction(text1_length, text2_length)([q, d])
        pooled = _KernelPooling(kernel_num, sigma, exact_sigma)(sim)
        out = Dense(1, activation="sigmoid")(pooled)
        Model.__init__(self, input=pair, output=out, name="knrm")
