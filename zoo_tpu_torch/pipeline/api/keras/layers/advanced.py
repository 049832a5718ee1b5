"""Advanced activations and the dense variants of keras-1 (counterpart of
``zoo_tpu/pipeline/api/keras/layers/advanced.py``): ``LeakyReLU``,
``ELU``, ``ThresholdedReLU``, ``PReLU``, ``SReLU``, ``Highway`` and
``MaxoutDense``, with the JAX layers' params keys and shapes, so a
JAX-built tree carries over unchanged. Plain torch ops: the JAX package
computes them outside Pallas.
"""

from __future__ import annotations

import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_activation_fn,
    get_initializer,
)


class LeakyReLU(Layer):
    def __init__(self, alpha: float = 0.3, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def call(self, params, inputs, *, training=False, rng=None):
        return torch.where(inputs >= 0, inputs, self.alpha * inputs)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def call(self, params, inputs, *, training=False, rng=None):
        return torch.where(inputs >= 0, inputs,
                           self.alpha * (torch.exp(inputs) - 1.0))


class ThresholdedReLU(Layer):
    def __init__(self, theta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.theta = float(theta)

    def call(self, params, inputs, *, training=False, rng=None):
        return torch.where(inputs > self.theta, inputs,
                           torch.zeros((), dtype=inputs.dtype,
                                       device=inputs.device))


class PReLU(Layer):
    """Per-feature trainable leak ``alpha``, 0.25 at the start."""

    def build(self, generator, input_shape):
        return {"alpha": torch.full(tuple(input_shape[1:]), 0.25,
                                    dtype=torch.float32,
                                    device=generator.device)}

    def call(self, params, inputs, *, training=False, rng=None):
        return torch.where(inputs >= 0, inputs, params["alpha"] * inputs)


class SReLU(Layer):
    """S-shaped ReLU with the per-feature params ``t_left``, ``a_left``,
    ``t_right`` (U[0, 1) at the start) and ``a_right``."""

    def build(self, generator, input_shape):
        shape = tuple(input_shape[1:])
        zero, one = get_initializer("zero"), get_initializer("one")
        t_right = torch.empty(shape, dtype=torch.float32,
                              device=generator.device)
        return {"t_left": zero(generator, shape),
                "a_left": zero(generator, shape),
                "t_right": t_right.uniform_(0.0, 1.0, generator=generator),
                "a_right": one(generator, shape)}

    def call(self, params, inputs, *, training=False, rng=None):
        tl, al = params["t_left"], params["a_left"]
        tr, ar = params["t_right"], params["a_right"]
        y = torch.where(inputs <= tl, tl + al * (inputs - tl), inputs)
        return torch.where(inputs >= tr, tr + ar * (inputs - tr), y)


class Highway(Layer):
    """``y = T(x) * H(x) + (1 - T(x)) * x``; the carry bias starts at -2
    (pass-through)."""

    def __init__(self, activation=None, bias: bool = True,
                 init="glorot_uniform", **kwargs):
        super().__init__(**kwargs)
        self.activation = get_activation_fn(activation) or (lambda x: x)
        self.bias = bias
        self.init = get_initializer(init)

    def build(self, generator, input_shape):
        d = input_shape[-1]
        p = {"W": self.init(generator, (d, d)),
             "W_carry": self.init(generator, (d, d))}
        if self.bias:
            p["b"] = get_initializer("zero")(generator, (d,))
            p["b_carry"] = torch.full((d,), -2.0, dtype=torch.float32,
                                      device=generator.device)
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        h = inputs @ params["W"]
        t = inputs @ params["W_carry"]
        if self.bias:
            h = h + params["b"]
            t = t + params["b_carry"]
        h = self.activation(h)
        t = torch.sigmoid(t)
        return t * h + (1 - t) * inputs


class MaxoutDense(Layer):
    """The max over ``nb_feature`` linear maps, ``W`` (nb_feature, in,
    out)."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 init="glorot_uniform", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.init = get_initializer(init)
        self.bias = bias

    def build(self, generator, input_shape):
        d = input_shape[-1]
        p = {"W": self.init(generator,
                            (self.nb_feature, d, self.output_dim))}
        if self.bias:
            p["b"] = get_initializer("zero")(
                generator, (self.nb_feature, self.output_dim))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        y = torch.einsum("bd,kdo->bko", inputs, params["W"])
        if self.bias:
            y = y + params["b"]
        return torch.amax(y, dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.output_dim)
