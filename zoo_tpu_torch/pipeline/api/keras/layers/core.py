"""Core keras-1 layers (counterpart of
``zoo_tpu/pipeline/api/keras/layers/core.py``): ``InputLayer``,
``Dense`` (with its int8 path), ``Activation``, ``Dropout``,
``Flatten``, ``Reshape``, ``Permute``, ``RepeatVector``, ``Lambda``,
``Embedding``, ``BatchNormalization``, ``GaussianNoise`` and
``Merge``/``merge``. Keras-1 argument names are kept. Parameters are
held by the model, as ``engine.base`` describes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    KTensor,
    Layer,
    get_activation_fn,
    get_initializer,
    layer_rng,
    normalize_shape,
)


class InputLayer(Layer):
    """Placeholder layer: the identity."""

    def __init__(self, input_shape=None, **kwargs):
        super().__init__(input_shape=input_shape, **kwargs)

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs


class Dense(Layer):
    """Fully connected layer, ``W`` (in, out) and ``b``. After
    ``quantize_model`` it holds ``W_q``/``W_scale`` instead of ``W`` and
    runs :func:`~zoo_tpu_torch.ops.kernels.quant.quantized_dense`."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, bias: bool = True,
                 W_regularizer=None, b_regularizer=None,
                 input_dim: Optional[int] = None, **kwargs):
        if input_dim is not None and kwargs.get("input_shape") is None:
            kwargs["input_shape"] = (input_dim,)
        super().__init__(**kwargs)
        self.output_dim = int(output_dim)
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.bias = bias
        # kept, not applied: the JAX package's Dense holds them the same way
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer

    def build(self, generator, input_shape):
        params = {"W": self.init(generator,
                                 (input_shape[-1], self.output_dim))}
        if self.bias:
            params["b"] = get_initializer("zero")(generator,
                                                  (self.output_dim,))
        return params

    def call(self, params, inputs, *, training=False, rng=None):
        if "W_q" in params:  # int8 weights (the quantize_model path)
            from zoo_tpu_torch.ops.kernels.quant import quantized_dense
            y = quantized_dense(inputs, params["W_q"], params["W_scale"])
        else:
            y = torch.matmul(inputs, params["W"])
        if self.bias:
            y = y + params["b"]
        return self.activation(y) if self.activation else y

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(Layer):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self.activation = get_activation_fn(activation)

    def call(self, params, inputs, *, training=False, rng=None):
        return self.activation(inputs)


def spatial_dropout(layer: Layer, inputs, rng, mask_shape=None):
    """``layer``'s inverted dropout of rate ``layer.p`` in training: the
    mask JAX draws from ``layer_rng(rng, layer.name)`` over
    ``mask_shape`` (default ``inputs``'s), through the dropout kernel."""
    if rng is None:
        raise ValueError(f"{layer.name}: dropout needs an rng in training")
    from zoo_tpu_torch.ops.kernels import dropout as D
    return D.dropout(inputs, layer_rng(rng, layer.name), layer.p,
                     mask_shape)


class Dropout(Layer):
    """Inverted dropout (JAX ``core.py`` ``Dropout``): the identity at
    inference; in training ``where(mask, x / (1 - p), 0)`` with JAX's
    ``bernoulli(layer_rng(rng, name), 1 - p, x.shape)`` mask, bit for
    bit (:func:`zoo_tpu_torch.ops.kernels.dropout.dropout`)."""

    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)

    def call(self, params, inputs, *, training=False, rng=None):
        if not training or self.p <= 0.0:
            return inputs
        return spatial_dropout(self, inputs, rng)


class Flatten(Layer):
    """All axes but the batch axis into one, in row-major (NHWC) order,
    as the JAX layer's ``reshape``."""

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs.reshape(inputs.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))


class Reshape(Layer):
    """Reshape the non-batch axes (one -1 wildcard allowed)."""

    def __init__(self, target_shape: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.target_shape = tuple(target_shape)

    def _resolve(self, input_shape):
        out = list(self.target_shape)
        if -1 in out:
            known = int(np.prod([d for d in out if d != -1]))
            out[out.index(-1)] = int(np.prod(input_shape[1:])) // known
        return tuple(out)

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs.reshape((inputs.shape[0],) + self._resolve(
            (None,) + tuple(inputs.shape[1:])))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self._resolve(input_shape)


class Permute(Layer):
    """Permute the non-batch axes; ``dims`` are 1-based (keras-1)."""

    def __init__(self, dims: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.dims = tuple(dims)

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(input_shape[d] for d in self.dims)


class RepeatVector(Layer):
    """(B, D) -> (B, n, D)."""

    def __init__(self, n: int, **kwargs):
        super().__init__(**kwargs)
        self.n = int(n)

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs[:, None, :].repeat(1, self.n, 1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.n, input_shape[1])


class GaussianNoise(Layer):
    """Additive N(0, sigma**2) noise in training: ``x + sigma *
    normal(layer_rng(rng, name), x.shape)``, the draw
    :func:`zoo_tpu_torch.ops.random.normal` (within 3 ulp of
    ``jax.random.normal``); the identity otherwise."""

    def __init__(self, sigma: float, **kwargs):
        super().__init__(**kwargs)
        self.sigma = float(sigma)

    def call(self, params, inputs, *, training=False, rng=None):
        if not training or self.sigma <= 0:
            return inputs
        if rng is None:
            raise ValueError(f"{self.name}: GaussianNoise needs an rng in "
                             "training")
        from zoo_tpu_torch.ops import random as R
        noise = R.normal(layer_rng(rng, self.name), inputs.shape)
        return inputs + self.sigma * noise


class Lambda(Layer):
    """An arbitrary function of the inputs, applied as is. Without
    ``output_shape`` the shape is inferred by calling the function on
    f32 tensors of batch 1 on the ``meta`` device (the JAX package's
    ``jax.eval_shape``)."""

    def __init__(self, function, output_shape=None, **kwargs):
        super().__init__(**kwargs)
        self.function = function
        self._output_shape = output_shape

    def call(self, params, inputs, *, training=False, rng=None):
        return self.function(inputs)

    def compute_output_shape(self, input_shape):
        if self._output_shape is not None:
            return normalize_shape(self._output_shape)
        single = not isinstance(input_shape, list)
        shapes = [input_shape] if single else input_shape
        args = [torch.empty((1,) + tuple(s[1:]), dtype=torch.float32,
                            device="meta") for s in shapes]
        out = self.function(*args)
        return (None,) + tuple(out.shape[1:])


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` in JAX's default ``fill`` mode:
    an id in [-n, n) picks its row (a negative one from the end), any
    other gives a row of NaN and no gradient, where a plain gather would
    fault on the device. The gather is ``F.embedding``, whose backward
    sums the rows of repeated ids in a fixed order on the card too."""
    n = table.shape[0]
    ids = ids.long()
    inside = (ids >= -n) & (ids < n)
    rows = F.embedding(ids.remainder(n), table)     # in [0, n)
    return torch.where(inside[..., None], rows, float("nan"))


class Embedding(Layer):
    """Trainable lookup table ``E`` (``input_dim``, ``output_dim``):
    int ids ``(batch, ...)`` gain a trailing ``output_dim`` axis. Ids
    stay integers under ``mixed_bfloat16`` (the compute cast touches f32
    tensors only); out-of-table ids as :func:`take_rows` says."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 input_length: Optional[int] = None, **kwargs):
        if input_length is not None and kwargs.get("input_shape") is None:
            kwargs["input_shape"] = (input_length,)
        super().__init__(**kwargs)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.init = get_initializer(init)

    def build(self, generator, input_shape):
        return {"E": self.init(generator, (self.input_dim, self.output_dim))}

    def call(self, params, inputs, *, training=False, rng=None):
        return take_rows(params["E"], inputs)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class BatchNormalization(Layer):
    """Batch norm over the trailing feature axis, running stats in
    ``params["stats"]`` (kept f32 under ``mixed_bfloat16``), as the JAX
    package's layer.

    The moments are an f32 island: batch moments in training, the
    running stats otherwise. The normalisation is then a precomputed
    (C,) scale and shift, computed in f32 and applied in the input's
    dtype. In training the gradient flows through the batch moments;
    :meth:`updated_stats` gives the running stats after one batch
    (momentum 0.99 on the detached moments), which the engine merges
    back after the optimizer's update."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 beta_init="zero", gamma_init="one", **kwargs):
        super().__init__(**kwargs)
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.beta_init = get_initializer(beta_init)
        self.gamma_init = get_initializer(gamma_init)

    def build(self, generator, input_shape):
        d = input_shape[-1]
        return {"gamma": self.gamma_init(generator, (d,)),
                "beta": self.beta_init(generator, (d,)),
                "stats": {"mean": get_initializer("zero")(generator, (d,)),
                          "var": get_initializer("one")(generator, (d,))}}

    @staticmethod
    def _moments(inputs):
        """Biased batch mean and variance over every axis but the last,
        in f32."""
        return torch.var_mean(inputs.float(), dim=tuple(
            range(inputs.ndim - 1)), correction=0)[::-1]

    def _normalize(self, params, inputs, mean, var):
        inv = torch.rsqrt(var + self.epsilon) * params["gamma"].float()
        shift = params["beta"].float() - mean * inv
        return inputs * inv.to(inputs.dtype) + shift.to(inputs.dtype)

    def _running(self, params, mean, var):
        m, st = self.momentum, params["stats"]
        return {"mean": m * st["mean"] + (1 - m) * mean.detach(),
                "var": m * st["var"] + (1 - m) * var.detach()}

    def call(self, params, inputs, *, training=False, rng=None):
        if training:
            mean, var = self._moments(inputs)
        else:
            mean, var = params["stats"]["mean"], params["stats"]["var"]
        return self._normalize(params, inputs, mean, var)

    def updated_stats(self, params, inputs):
        """The running stats after the batch ``inputs``."""
        return self._running(params, *self._moments(inputs))

    def call_and_update(self, params, inputs):
        """``(call(training=True), updated_stats)`` from one computation
        of the batch moments."""
        mean, var = self._moments(inputs)
        return (self._normalize(params, inputs, mean, var),
                self._running(params, mean, var))


class Merge(Layer):
    """Merge a list of inputs: modes concat / sum / mul / ave / max /
    min / dot / cos, as the JAX package's ``Merge``."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1, **kwargs):
        super().__init__(**kwargs)
        self.mode = mode
        self.concat_axis = concat_axis

    def call(self, params, inputs, *, training=False, rng=None):
        xs = list(inputs)
        if self.mode == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        if self.mode in ("sum", "ave"):
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out / len(xs) if self.mode == "ave" else out
        if self.mode in ("mul", "max", "min"):
            op = {"mul": torch.mul, "max": torch.maximum,
                  "min": torch.minimum}[self.mode]
            out = xs[0]
            for x in xs[1:]:
                out = op(out, x)
            return out
        if self.mode == "dot":
            return torch.sum(xs[0] * xs[1], dim=-1, keepdim=True)
        if self.mode == "cos":
            a, b = xs[0], xs[1]
            num = torch.sum(a * b, dim=-1, keepdim=True)
            den = (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
                   * torch.linalg.vector_norm(b, dim=-1, keepdim=True))
            return num / torch.clamp(den, min=1e-8)
        raise ValueError(f"unknown merge mode: {self.mode}")

    def compute_output_shape(self, input_shape):
        shapes = input_shape
        if self.mode == "concat":
            out = list(shapes[0])
            dims = [s[self.concat_axis] for s in shapes]
            out[self.concat_axis] = None if None in dims else sum(dims)
            return tuple(out)
        if self.mode in ("dot", "cos"):
            return (shapes[0][0], 1)
        return tuple(shapes[0])


def merge(inputs: Sequence[KTensor], mode: str = "sum",
          concat_axis: int = -1, name: Optional[str] = None) -> KTensor:
    """Functional-API merge helper."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(
        list(inputs))
