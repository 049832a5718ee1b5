"""Recurrent layers, keras-1 style (counterpart of
``zoo_tpu/pipeline/api/keras/layers/recurrent.py``): ``SimpleRNN``,
``LSTM`` (gates i, f, c, o), ``GRU`` (gates z, r, h), the
``Bidirectional`` wrapper and ``TimeDistributed``.

Weights as the JAX package lays them out: ``W`` (in, g * units), ``U``
(units, g * units) and ``b`` (g * units), g the gate count. The input
projection of every timestep is one GEMM, ``x @ W + b`` over (B * T,
in), hoisted out of the recurrence as the JAX layer hoists it out of its
``lax.scan``; the recurrence is then a Python loop over time, each step
one ``h @ U`` product and the gates' elementwise ops. The JAX package
computes the recurrence outside Pallas, so these are plain torch ops
and ``torch.matmul`` (in full f32: the port leaves TF32 off). The carry
starts as f32 zeros, as JAX's does, so under ``mixed_bfloat16`` the
recurrence runs in f32 (bf16 ``U`` promoted in each product), as in the
JAX package.

Launches: each timestep is a dozen or so small ops forward (the
product, the add, the gates' activations, the cell and output updates)
and about twice that backward. A training step of ``TextClassifier``'s
one-layer LSTM or GRU at T = 500, B = 128 made 25,119 and 27,117 device
launches, the card busy 7 % of the step (an H100 80GB HBM3 at 700 W):
the host's launch rate, not the card, bounds it.
"""

from __future__ import annotations

import copy

import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_activation_fn,
    get_initializer,
)


def _mm(h: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``h @ u`` in the promoted dtype of the two (``jnp.matmul``'s
    promotion; torch's matmul takes one dtype)."""
    dt = torch.promote_types(h.dtype, u.dtype)
    return h.to(dt) @ u.to(dt)


class _Recurrent(Layer):
    gate_mult = 1

    def __init__(self, output_dim: int, init="glorot_uniform",
                 inner_init="orthogonal", activation="tanh",
                 inner_activation="hard_sigmoid",
                 return_sequences: bool = False, go_backwards: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self.output_dim = int(output_dim)
        self.init = get_initializer(init)
        self.inner_init = get_initializer(inner_init)
        self.activation = get_activation_fn(activation)
        self.inner_activation = get_activation_fn(inner_activation)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def build(self, generator, input_shape):
        g, d = self.gate_mult, self.output_dim
        return {"W": self.init(generator, (input_shape[-1], g * d)),
                "U": self.inner_init(generator, (d, g * d)),
                "b": get_initializer("zero")(generator, (g * d,))}

    def _init_carry(self, batch: int, device):
        raise NotImplementedError

    def _step(self, params, carry, zx):
        """One timestep on the precomputed input projection ``zx``:
        ``(carry, h)``."""
        raise NotImplementedError

    def call(self, params, inputs, *, training=False, rng=None):
        # (B, T, D): the input projection of every step in one GEMM
        zx = torch.matmul(inputs, params["W"]) + params["b"]
        steps = torch.unbind(zx, dim=1)
        if self.go_backwards:
            steps = steps[::-1]
        carry = self._init_carry(inputs.shape[0], inputs.device)
        hs = []
        for z in steps:
            carry, h = self._step(params, carry, z)
            hs.append(h)
        if not self.return_sequences:
            return hs[-1]
        if self.go_backwards:
            hs = hs[::-1]
        return torch.stack(hs, dim=1)

    def compute_output_shape(self, input_shape):
        n, t, _ = input_shape
        if self.return_sequences:
            return (n, t, self.output_dim)
        return (n, self.output_dim)


class SimpleRNN(_Recurrent):
    gate_mult = 1

    def _init_carry(self, batch, device):
        return torch.zeros((batch, self.output_dim), device=device)

    def _step(self, params, h, zx):
        h = self.activation(zx + _mm(h, params["U"]))
        return h, h


class LSTM(_Recurrent):
    """keras-1 gate order i, f, c, o; carry ``(h, c)``."""

    gate_mult = 4

    def _init_carry(self, batch, device):
        zeros = torch.zeros((batch, self.output_dim), device=device)
        return zeros, zeros

    def _step(self, params, carry, zx):
        h, c = carry
        z = zx + _mm(h, params["U"])
        zi, zf, zc, zo = torch.chunk(z, 4, dim=-1)
        inner = self.inner_activation
        c = inner(zf) * c + inner(zi) * self.activation(zc)
        h = inner(zo) * self.activation(c)
        return (h, c), h


class GRU(_Recurrent):
    """keras-1 gate order z, r, h: ``z`` and ``r`` from one product with
    ``U[:, :2d]``, the candidate from ``(r * h) @ U[:, 2d:]``."""

    gate_mult = 3

    def _init_carry(self, batch, device):
        return torch.zeros((batch, self.output_dim), device=device)

    def _step(self, params, h, zx):
        d, u = self.output_dim, params["U"]
        zr = self.inner_activation(zx[:, :2 * d] + _mm(h, u[:, :2 * d]))
        z, r = zr[:, :d], zr[:, d:]
        hh = self.activation(zx[:, 2 * d:] + _mm(r * h, u[:, 2 * d:]))
        h = z * h + (1 - z) * hh
        return h, h


class Bidirectional(Layer):
    """A recurrent layer run forward and backward (a copy with
    ``go_backwards`` flipped), params ``{"fw", "bw"}``, the outputs
    merged by ``merge_mode``: concat, sum, mul or ave."""

    def __init__(self, layer: _Recurrent, merge_mode: str = "concat",
                 **kwargs):
        super().__init__(**kwargs)
        if not isinstance(layer, _Recurrent):
            raise ValueError("Bidirectional wraps a recurrent layer")
        if merge_mode not in ("concat", "sum", "mul", "ave"):
            raise ValueError(f"unknown merge_mode: {merge_mode}")
        self.forward_layer = layer
        self.backward_layer = copy.copy(layer)
        self.backward_layer.go_backwards = not layer.go_backwards
        self.merge_mode = merge_mode

    def build(self, generator, input_shape):
        return {"fw": self.forward_layer.build(generator, input_shape),
                "bw": self.backward_layer.build(generator, input_shape)}

    def call(self, params, inputs, *, training=False, rng=None):
        a = self.forward_layer.call(params["fw"], inputs, training=training,
                                    rng=rng)
        b = self.backward_layer.call(params["bw"], inputs,
                                     training=training, rng=rng)
        if self.merge_mode == "concat":
            return torch.cat([a, b], dim=-1)
        if self.merge_mode == "sum":
            return a + b
        if self.merge_mode == "mul":
            return a * b
        return (a + b) / 2

    def compute_output_shape(self, input_shape):
        s = self.forward_layer.compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(s[:-1]) + (s[-1] * 2,)
        return tuple(s)


class TimeDistributed(Layer):
    """An inner layer applied to every timestep: time folded into the
    batch, one call, unfolded."""

    def __init__(self, layer: Layer, **kwargs):
        super().__init__(**kwargs)
        self.inner = layer

    def build(self, generator, input_shape):
        return self.inner.build(generator, (input_shape[0],)
                                + tuple(input_shape[2:]))

    def call(self, params, inputs, *, training=False, rng=None):
        b, t = inputs.shape[0], inputs.shape[1]
        y = self.inner.call(params, inputs.reshape((b * t,)
                                                   + inputs.shape[2:]),
                            training=training, rng=rng)
        return y.reshape((b, t) + tuple(y.shape[1:]))

    def compute_output_shape(self, input_shape):
        inner = self.inner.compute_output_shape(
            (input_shape[0],) + tuple(input_shape[2:]))
        return (input_shape[0], input_shape[1]) + tuple(inner[1:])
