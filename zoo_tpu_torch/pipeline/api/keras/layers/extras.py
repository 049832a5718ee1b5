"""Element-wise and utility layers of keras-1's layer zoo (counterpart of
``zoo_tpu/pipeline/api/keras/layers/extras.py``): the torch-style maps
(``AddConstant`` to ``Max``), ``Masking``, the noise layers
(``GaussianDropout``, ``GaussianSampler``), the two local response
normalizations and ``ResizeBilinear``.

Plain torch ops, as the JAX package computes them outside Pallas. The
draws are JAX's: ``RReLU``'s slopes are ``jax.random.uniform``'s bits
(:func:`zoo_tpu_torch.ops.random.uniform`, bit for bit);
``GaussianDropout`` and ``GaussianSampler`` draw
:func:`zoo_tpu_torch.ops.random.normal` (within 3 ulp of
``jax.random.normal``). ``ResizeBilinear`` is ``jax.image.resize``'s
bilinear: a triangle kernel widened by 1 / scale when it downsamples
(antialiased), its weights those of JAX's ``compute_weight_mat``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from zoo_tpu_torch.ops import random as R
from zoo_tpu_torch.pipeline.api.keras.engine.base import Layer, layer_rng


class _Elementwise(Layer):
    """Shape-preserving parameterless map."""

    def _fn(self, x):
        raise NotImplementedError

    def call(self, params, inputs, *, training=False, rng=None):
        return self._fn(inputs)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


class Identity(_Elementwise):
    def _fn(self, x):
        return x


class Exp(_Elementwise):
    def _fn(self, x):
        return torch.exp(x)


class Log(_Elementwise):
    def _fn(self, x):
        return torch.log(x)


class Sqrt(_Elementwise):
    def _fn(self, x):
        return torch.sqrt(x)


class Square(_Elementwise):
    def _fn(self, x):
        return torch.square(x)


class Negative(_Elementwise):
    def _fn(self, x):
        return -x


class AddConstant(_Elementwise):
    def __init__(self, constant_scalar: float, **kwargs):
        super().__init__(**kwargs)
        self.c = float(constant_scalar)

    def _fn(self, x):
        return x + self.c


class MulConstant(_Elementwise):
    def __init__(self, constant_scalar: float, **kwargs):
        super().__init__(**kwargs)
        self.c = float(constant_scalar)

    def _fn(self, x):
        return x * self.c


class Power(_Elementwise):
    """``(shift + scale * x) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.power, self.scale, self.shift = power, scale, shift

    def _fn(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class HardTanh(_Elementwise):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.lo, self.hi = min_value, max_value

    def _fn(self, x):
        return torch.clamp(x, self.lo, self.hi)


class HardShrink(_Elementwise):
    def __init__(self, value: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.v = value

    def _fn(self, x):
        return torch.where(torch.abs(x) > self.v, x, _zero(x))


class SoftShrink(_Elementwise):
    def __init__(self, value: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.v = value

    def _fn(self, x):
        return torch.sign(x) * torch.clamp_min(torch.abs(x) - self.v, 0.0)


class Threshold(_Elementwise):
    """``x`` where ``x > th``, else ``v``."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.th, self.v = th, v

    def _fn(self, x):
        return torch.where(x > self.th, x, torch.full(
            (), self.v, dtype=x.dtype, device=x.device))


class BinaryThreshold(_Elementwise):
    def __init__(self, value: float = 1e-6, **kwargs):
        super().__init__(**kwargs)
        self.v = value

    def _fn(self, x):
        return (x > self.v).float()


class RReLU(Layer):
    """Randomized leaky ReLU: in training (with a key) each slope is
    ``jax.random.uniform(layer_rng(rng, name), x.shape, lower, upper)``,
    bit for bit; otherwise the midpoint."""

    def __init__(self, lower: float = 1 / 8, upper: float = 1 / 3, **kwargs):
        super().__init__(**kwargs)
        self.lower, self.upper = lower, upper

    def call(self, params, inputs, *, training=False, rng=None):
        if training and rng is not None:
            slope = R.uniform(layer_rng(rng, self.name), inputs.shape,
                              self.lower, self.upper)
        else:
            slope = (self.lower + self.upper) / 2.0
        return torch.where(inputs >= 0, inputs, inputs * slope)


class CAdd(Layer):
    """Learnable per-element bias ``b`` of shape ``size``."""

    def __init__(self, size: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)

    def build(self, generator, input_shape):
        return {"b": torch.zeros(self.size, device=generator.device)}

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs + params["b"]


class CMul(Layer):
    """Learnable per-element scale ``g`` of shape ``size``."""

    def __init__(self, size: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)

    def build(self, generator, input_shape):
        return {"g": torch.ones(self.size, device=generator.device)}

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs * params["g"]


class Scale(Layer):
    """``CMul`` then ``CAdd``: ``x * g + b``."""

    def __init__(self, size: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)

    def build(self, generator, input_shape):
        return {"g": torch.ones(self.size, device=generator.device),
                "b": torch.zeros(self.size, device=generator.device)}

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs * params["g"] + params["b"]


class Narrow(Layer):
    """``length`` elements from ``offset`` along ``dim`` (the batch axis
    is 0; ``length=-1`` takes the rest)."""

    def __init__(self, dim: int, offset: int, length: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.dim, self.offset, self.length = dim, offset, length

    def call(self, params, inputs, *, training=False, rng=None):
        length = self.length if self.length != -1 \
            else inputs.shape[self.dim] - self.offset
        return inputs.narrow(self.dim, self.offset, length)

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        if self.length != -1:
            out[self.dim] = self.length
        elif out[self.dim] is not None:
            out[self.dim] = out[self.dim] - self.offset
        return tuple(out)


class _DropDim(Layer):
    """A layer whose output loses axis ``dim``."""

    def __init__(self, dim: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        del out[self.dim]
        return tuple(out)


class Select(_DropDim):
    """Index ``index`` along ``dim``."""

    def __init__(self, dim: int, index: int, **kwargs):
        super().__init__(dim, **kwargs)
        self.index = index

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs.select(self.dim, self.index)


class Squeeze(_DropDim):
    def call(self, params, inputs, *, training=False, rng=None):
        if inputs.shape[self.dim] != 1:
            raise ValueError(f"{self.name}: axis {self.dim} of "
                             f"{tuple(inputs.shape)} is not 1")
        return inputs.squeeze(self.dim)


class ExpandDim(Layer):
    def __init__(self, dim: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs.unsqueeze(self.dim)

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        out.insert(self.dim if self.dim >= 0 else len(out) + 1 + self.dim,
                   1)
        return tuple(out)


class Max(_DropDim):
    """The max over ``dim``."""

    def call(self, params, inputs, *, training=False, rng=None):
        return torch.amax(inputs, dim=self.dim)


class GetShape(Layer):
    """The input's shape as an int32 vector."""

    def call(self, params, inputs, *, training=False, rng=None):
        return torch.tensor(tuple(inputs.shape), dtype=torch.int32,
                            device=inputs.device)

    def compute_output_shape(self, input_shape):
        return (len(input_shape),)


class Masking(Layer):
    """Zero every timestep whose features all equal ``mask_value``."""

    def __init__(self, mask_value: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.mask_value = mask_value

    def call(self, params, inputs, *, training=False, rng=None):
        keep = torch.any(inputs != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, inputs, _zero(inputs))


class GaussianDropout(Layer):
    """Multiplicative 1-mean gaussian noise of stddev ``sqrt(p / (1 -
    p))`` in training."""

    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)

    def call(self, params, inputs, *, training=False, rng=None):
        if not training or rng is None or self.p <= 0:
            return inputs
        std = math.sqrt(self.p / (1.0 - self.p))
        noise = R.normal(layer_rng(rng, self.name), inputs.shape)
        return inputs * (1.0 + std * noise)


class GaussianSampler(Layer):
    """``mean + exp(log_var / 2) * N(0, 1)`` of ``[mean, log_var]`` when
    given a key (the VAE reparameterization), ``mean`` otherwise."""

    def call(self, params, inputs, *, training=False, rng=None):
        mean, log_var = inputs
        if rng is None:
            return mean
        noise = R.normal(layer_rng(rng, self.name), mean.shape)
        return mean + torch.exp(log_var * 0.5) * noise

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[0])


class LRN2D(Layer):
    """Local response normalization across ``n`` channels: the squares
    padded by ``n // 2`` on the channel axis and summed over ``n``
    shifted slices, in the JAX layer's order."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0, beta: float = 0.75,
                 n: int = 5, dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, int(n)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        x = inputs
        caxis = 1 if self.dim_ordering == "th" else 3
        half = self.n // 2
        pads = [0, 0] * (x.ndim - 1 - caxis) + [half, half]
        padded = F.pad(torch.square(x), pads)
        acc = 0
        for i in range(self.n):
            acc = acc + padded.narrow(caxis, i, x.shape[caxis])
        return x / torch.pow(self.k + self.alpha / self.n * acc, self.beta)


class WithinChannelLRN2D(Layer):
    """LRN over a ``size`` x ``size`` window within each channel of a
    (B, C, H, W) input, the window's squares zero-padded by ``size //
    2``."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, **kwargs):
        super().__init__(**kwargs)
        self.size, self.alpha, self.beta = int(size), alpha, beta

    def call(self, params, inputs, *, training=False, rng=None):
        half, k = self.size // 2, self.size
        sq = F.pad(torch.square(inputs), (half, half, half, half))
        summed = sq.unfold(2, k, 1).unfold(3, k, 1).sum((-2, -1))
        denom = torch.pow(1.0 + self.alpha / (self.size ** 2) * summed,
                          self.beta)
        return inputs / denom


def resize_weights(in_size: int, out_size: int, device=None
                   ) -> torch.Tensor:
    """(in_size, out_size) f32 weights of ``jax.image.resize``'s bilinear
    along one axis (``compute_weight_mat`` with the triangle kernel,
    antialiased, no translation): output ``j`` samples at ``(j + 0.5) /
    scale - 0.5``; a downsample widens the kernel by ``1 / scale``; each
    column is normalized to sum 1, and a sample outside the input gets
    none."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        in_size, dtype=f32, device=device)[:, None]) / kernel_scale
    w = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros((), dtype=f32, device=device))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w,
                       torch.zeros((), dtype=f32, device=device))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """``jax.image.resize(x, (B, out_h, out_w, C), "bilinear")`` of an
    NHWC ``x``: an axis whose size stays is left alone, as JAX leaves
    it; each resized axis is one product with :func:`resize_weights`."""
    b, h, w, c = x.shape
    y = x
    if out_h != h:
        wh = resize_weights(h, out_h, x.device).to(x.dtype)
        y = torch.einsum("bhwc,ho->bowc", y, wh)
    if out_w != w:
        ww = resize_weights(w, out_w, x.device).to(x.dtype)
        y = torch.einsum("bhwc,wo->bhoc", y, ww)
    return y


class ResizeBilinear(Layer):
    """Bilinear resize of the spatial axes, as ``jax.image.resize``
    computes it (:func:`resize_bilinear`); ``align_corners`` is accepted
    and, as in the JAX layer, not used."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, dim_ordering: str = "th",
                 **kwargs):
        super().__init__(**kwargs)
        self.oh, self.ow = int(output_height), int(output_width)
        self.align_corners = align_corners
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        x = inputs
        if self.dim_ordering == "th":
            x = x.permute(0, 2, 3, 1)
        y = resize_bilinear(x, self.oh, self.ow)
        if self.dim_ordering == "th":
            y = y.permute(0, 3, 1, 2)
        return y.contiguous()

    def compute_output_shape(self, input_shape):
        if self.dim_ordering == "th":
            return (input_shape[0], input_shape[1], self.oh, self.ow)
        return (input_shape[0], self.oh, self.ow, input_shape[3])
