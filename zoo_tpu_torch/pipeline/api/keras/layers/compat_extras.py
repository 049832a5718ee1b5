"""Reference layer names with no mechanism of their own (counterpart of
``zoo_tpu/pipeline/api/keras/layers/compat_extras.py``): ``SparseDense``
and ``SparseEmbedding`` are ``Dense`` and ``Embedding`` over dense
minibatches (the reference's extra arguments accepted), ``Mul``
multiplies by one learned scalar. ``KerasLayerWrapper`` converts a
tf.keras layer through the keras bridge, which the port does not have
yet: it raises, naming ROADMAP A.16.
"""

from __future__ import annotations

import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import Layer
from zoo_tpu_torch.pipeline.api.keras.layers.core import Dense, Embedding


class SparseDense(Dense):
    """``Dense`` over the densified input; ``backward_start`` and
    ``backward_length`` (partial backprop on the JVM) are accepted and
    not used."""

    def __init__(self, output_dim, backward_start=-1, backward_length=-1,
                 **kwargs):
        super().__init__(output_dim, **kwargs)


class SparseEmbedding(Embedding):
    """``Embedding`` of dense int ids."""


class Mul(Layer):
    """Multiply the input by one learned scalar ``w`` (1 at the
    start)."""

    def build(self, generator, input_shape):
        return {"w": torch.ones((1,), device=generator.device)}

    def call(self, params, x, *, training=False, rng=None):
        return x * params["w"].to(x.dtype)

    def compute_output_shape(self, input_shape):
        return input_shape


class KerasLayerWrapper:
    """Wrap one tf.keras layer as a zoo layer (needs TensorFlow and the
    keras bridge): not ported, raises naming ROADMAP A.16."""

    def __new__(cls, keras_layer=None, input_shape=None, **kwargs):
        raise NotImplementedError(
            "KerasLayerWrapper is not ported to zoo_tpu_torch yet: it "
            "converts a tf.keras layer through bridges/keras_bridge.py "
            "(ROADMAP A.16)")
