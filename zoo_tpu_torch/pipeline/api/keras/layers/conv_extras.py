"""The rest of keras-1's conv layer zoo (counterpart of
``zoo_tpu/pipeline/api/keras/layers/conv_extras.py``): the 3-D conv,
pools, padding, cropping, upsampling and spatial dropout; the atrous,
transposed, depthwise, separable, shared and locally connected convs;
``ConvLSTM2D`` and ``WordEmbedding``. Same constructor arguments,
params keys and layouts as the JAX layers (DHWIO / HWIO weights, convs
channel-last inside, ``dim_ordering="th"`` permuted at the boundary).

The JAX package runs every one of these through
``lax.conv_general_dilated`` (or its patches), outside any Pallas
kernel, so the port runs them through its reference conv: the 2-D ones
through :func:`zoo_tpu_torch.ops.kernels.conv.conv2d_plain` (f32 sums,
TF32 off, XLA's SAME pads, ``groups`` for the depthwise convs:
``DepthwiseConvolution2D``'s output channel ``c * depth_multiplier +
m`` reads input channel ``c``, as ``feature_group_count`` orders it),
the 3-D one through ``F.conv3d`` under the same settings
(:func:`_conv3d`). Only ``ShareConvolution2D``, a ``Convolution2D``,
goes through the one conv dispatch point (the kernel where its shape
is inside the envelope), as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from zoo_tpu_torch.ops.kernels.conv import (
    _no_tf32,
    _spatial_pads,
    conv2d_plain,
)
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    get_activation_fn,
    get_initializer,
)
from zoo_tpu_torch.pipeline.api.keras.layers.convolutional import (
    Convolution2D,
)
from zoo_tpu_torch.pipeline.api.keras.layers.core import (
    spatial_dropout,
    take_rows,
)


def _tup(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _out_dim(size, k, s, mode):
    if size is None:
        return None
    if mode == "same":
        return -(-size // s)
    return (size - k) // s + 1


def _zeros(generator, shape):
    return get_initializer("zero")(generator, shape)


def _xla_pads(sizes, kernel, strides, mode):
    """XLA's (lo, hi) pads of each spatial axis (the odd pad at the
    end)."""
    return [_spatial_pads(n, 1, k, 1, (s, 1), mode)[0]
            for n, k, s in zip(sizes, kernel, strides)]


class _F32(torch.autograd.Function):
    """``fn(*tensors)`` with TF32 off in the forward and in the backward
    (the gradients by autograd of ``fn`` taken again, under cuDNN's
    deterministic algorithms), as :func:`conv2d_plain` keeps its
    gradients."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(*tensors)
        with _no_tf32():
            return fn(*tensors)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[1:]
        ts = [t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad(), _no_tf32(deterministic=True):
            y = ctx.fn(*ts)
            grads = iter(torch.autograd.grad(
                y, [t for t in ts if t.requires_grad], g))
        return (None,) + tuple(next(grads) if n else None for n in needs)


def _conv3d_fn(strides, pads):
    def fn(x, w):
        (a, b), (c, d), (e, f) = pads
        xn = F.pad(x.permute(0, 4, 1, 2, 3), (e, f, c, d, a, b))
        y = F.conv3d(xn, w.permute(4, 3, 0, 1, 2), stride=strides)
        return y.permute(0, 2, 3, 4, 1).contiguous()
    return fn


def _conv3d(x: torch.Tensor, w: torch.Tensor, strides, mode: str
            ) -> torch.Tensor:
    """NDHWC ``x`` conv DHWIO ``w``: f32 sums, TF32 off, XLA's pads."""
    pads = _xla_pads(x.shape[1:4], w.shape[:3], strides, mode)
    return _F32.apply(_conv3d_fn(tuple(strides), pads), x, w)


def _to_channels_last(x, ordering):
    return x.permute(0, 2, 3, 1) if ordering == "th" else x


def _from_channels_last(y, ordering):
    return y.permute(0, 3, 1, 2).contiguous() if ordering == "th" else y


class _Conv(Layer):
    """Bias, activation and ``dim_ordering`` around a channel-last conv."""

    def _finish(self, params, y):
        if self.bias:
            y = y + params["b"]
        return self.activation(y) if self.activation else y


class Convolution3D(_Conv):
    """3-D conv, ``W`` DHWIO; th layout (B, C, D, H, W)."""

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, init="glorot_uniform", activation=None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int, int] = (1, 1, 1),
                 dim_ordering: str = "th", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.kernel = (int(kernel_dim1), int(kernel_dim2), int(kernel_dim3))
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = _tup(subsample, 3)
        self.dim_ordering = dim_ordering
        self.bias = bias

    def build(self, generator, input_shape):
        cin = input_shape[1] if self.dim_ordering == "th" else input_shape[4]
        p = {"W": self.init(generator, self.kernel + (cin, self.nb_filter))}
        if self.bias:
            p["b"] = _zeros(generator, (self.nb_filter,))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        x = inputs
        if self.dim_ordering == "th":
            x = x.permute(0, 2, 3, 4, 1)
        y = self._finish(params, _conv3d(x, params["W"], self.subsample,
                                         self.border_mode))
        if self.dim_ordering == "th":
            y = y.permute(0, 4, 1, 2, 3).contiguous()
        return y

    def compute_output_shape(self, input_shape):
        if self.dim_ordering == "th":
            b, c, d, h, w = input_shape
        else:
            b, d, h, w, c = input_shape
        od, oh, ow = (_out_dim(n, k, s, self.border_mode) for n, k, s in
                      zip((d, h, w), self.kernel, self.subsample))
        if self.dim_ordering == "th":
            return (b, self.nb_filter, od, oh, ow)
        return (b, od, oh, ow, self.nb_filter)


def _conv2d_out_shape(layer, input_shape, channels, kernel):
    if layer.dim_ordering == "th":
        b, c, h, w = input_shape
    else:
        b, h, w, c = input_shape
    oh = _out_dim(h, kernel[0], layer.subsample[0], layer.border_mode)
    ow = _out_dim(w, kernel[1], layer.subsample[1], layer.border_mode)
    if layer.dim_ordering == "th":
        return (b, channels, oh, ow)
    return (b, oh, ow, channels)


class AtrousConvolution2D(_Conv):
    """Dilated 2-D conv (``atrous_rate``, XLA's ``rhs_dilation``)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 init="glorot_uniform", activation=None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 atrous_rate: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.kernel = (int(nb_row), int(nb_col))
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = _tup(subsample, 2)
        self.rate = _tup(atrous_rate, 2)
        self.dim_ordering = dim_ordering
        self.bias = bias

    def build(self, generator, input_shape):
        cin = input_shape[1] if self.dim_ordering == "th" else input_shape[3]
        p = {"W": self.init(generator, self.kernel + (cin, self.nb_filter))}
        if self.bias:
            p["b"] = _zeros(generator, (self.nb_filter,))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        x = _to_channels_last(inputs, self.dim_ordering)
        y = conv2d_plain(x, params["W"], self.subsample,
                         self.border_mode.upper(), dilation=self.rate)
        return _from_channels_last(self._finish(params, y),
                                   self.dim_ordering)

    def compute_output_shape(self, input_shape):
        ek = tuple(self.rate[i] * (self.kernel[i] - 1) + 1 for i in (0, 1))
        return _conv2d_out_shape(self, input_shape, self.nb_filter, ek)


class AtrousConvolution1D(_Conv):
    """Dilated 1-D conv over (B, T, C), ``W`` (k, C, nb_filter)."""

    def __init__(self, nb_filter: int, filter_length: int,
                 init="glorot_uniform", activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 atrous_rate: int = 1, bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.k = int(filter_length)
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.stride = int(subsample_length)
        self.rate = int(atrous_rate)
        self.bias = bias

    def build(self, generator, input_shape):
        p = {"W": self.init(generator,
                            (self.k, input_shape[-1], self.nb_filter))}
        if self.bias:
            p["b"] = _zeros(generator, (self.nb_filter,))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        y = conv2d_plain(inputs[:, None], params["W"][None],
                         (1, self.stride), self.border_mode.upper(),
                         dilation=(1, self.rate))[:, 0]
        return self._finish(params, y)

    def compute_output_shape(self, input_shape):
        b, t, c = input_shape
        ek = self.rate * (self.k - 1) + 1
        return (b, _out_dim(t, ek, self.stride, self.border_mode),
                self.nb_filter)


class Deconvolution2D(_Conv):
    """Transposed 2-D conv, ``W`` HWOI, VALID only: as the JAX layer
    computes it, the input dilated by ``subsample`` (zeros between its
    pixels), padded by ``k - 1`` each side and convolved with the
    spatially flipped kernel."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 init="glorot_uniform", activation=None,
                 subsample: Tuple[int, int] = (1, 1),
                 border_mode: str = "valid",
                 dim_ordering: str = "th", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        if border_mode != "valid":
            raise ValueError("Deconvolution2D supports border_mode='valid' "
                             "only (the reference's constraint too)")
        self.nb_filter = int(nb_filter)
        self.kernel = (int(nb_row), int(nb_col))
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.subsample = _tup(subsample, 2)
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering
        self.bias = bias

    def build(self, generator, input_shape):
        cin = input_shape[1] if self.dim_ordering == "th" else input_shape[3]
        p = {"W": self.init(generator, self.kernel + (self.nb_filter, cin))}
        if self.bias:
            p["b"] = _zeros(generator, (self.nb_filter,))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        x = _to_channels_last(inputs, self.dim_ordering)
        b, h, w, c = x.shape
        (kh, kw), (sh, sw) = self.kernel, self.subsample
        if (sh, sw) != (1, 1):
            xd = x.new_zeros((b, (h - 1) * sh + 1, (w - 1) * sw + 1, c))
            xd[:, ::sh, ::sw] = x
            x = xd
        wt = torch.flip(params["W"], (0, 1)).permute(0, 1, 3, 2)
        y = conv2d_plain(x, wt, (1, 1), ((kh - 1, kh - 1), (kw - 1, kw - 1)))
        return _from_channels_last(self._finish(params, y),
                                   self.dim_ordering)

    def compute_output_shape(self, input_shape):
        if self.dim_ordering == "th":
            b, c, h, w = input_shape
        else:
            b, h, w, c = input_shape
        oh = None if h is None else (h - 1) * self.subsample[0] + \
            self.kernel[0]
        ow = None if w is None else (w - 1) * self.subsample[1] + \
            self.kernel[1]
        if self.dim_ordering == "th":
            return (b, self.nb_filter, oh, ow)
        return (b, oh, ow, self.nb_filter)


class SeparableConvolution2D(_Conv):
    """Depthwise conv (``depth_W`` HWIO, I = 1, O = C * multiplier) then
    a 1x1 pointwise conv (``point_W``)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 init="glorot_uniform", activation=None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 depth_multiplier: int = 1,
                 dim_ordering: str = "th", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.kernel = (int(nb_row), int(nb_col))
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = _tup(subsample, 2)
        self.mult = int(depth_multiplier)
        self.dim_ordering = dim_ordering
        self.bias = bias

    def build(self, generator, input_shape):
        cin = input_shape[1] if self.dim_ordering == "th" else input_shape[3]
        p = {"depth_W": self.init(generator,
                                  self.kernel + (1, cin * self.mult)),
             "point_W": self.init(generator,
                                  (1, 1, cin * self.mult, self.nb_filter))}
        if self.bias:
            p["b"] = _zeros(generator, (self.nb_filter,))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        x = _to_channels_last(inputs, self.dim_ordering)
        y = conv2d_plain(x, params["depth_W"], self.subsample,
                         self.border_mode.upper(), groups=x.shape[-1])
        y = conv2d_plain(y, params["point_W"], (1, 1), "VALID")
        return _from_channels_last(self._finish(params, y),
                                   self.dim_ordering)

    def compute_output_shape(self, input_shape):
        return _conv2d_out_shape(self, input_shape, self.nb_filter,
                                 self.kernel)


class ShareConvolution2D(Convolution2D):
    """A ``Convolution2D`` (a conv already shares its weights
    spatially)."""


class LocallyConnected1D(_Conv):
    """Unshared conv over time: ``W`` (OT, k * C, nb_filter), each
    output step's window flattened step-major, as the JAX layer's
    ``dynamic_slice`` windows reshape."""

    def __init__(self, nb_filter: int, filter_length: int,
                 activation=None, subsample_length: int = 1,
                 border_mode: str = "valid", bias: bool = True,
                 init="glorot_uniform", **kwargs):
        super().__init__(**kwargs)
        if border_mode != "valid":
            raise ValueError("LocallyConnected1D supports border_mode="
                             "'valid' only (like the reference)")
        self.nb_filter = int(nb_filter)
        self.k = int(filter_length)
        self.stride = int(subsample_length)
        self.activation = get_activation_fn(activation)
        self.bias = bias
        self.init = get_initializer(init)

    def build(self, generator, input_shape):
        t, c = input_shape[1], input_shape[2]
        ot = (t - self.k) // self.stride + 1
        p = {"W": self.init(generator, (ot, self.k * c, self.nb_filter))}
        if self.bias:
            p["b"] = _zeros(generator, (ot, self.nb_filter))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        b = inputs.shape[0]
        ot = params["W"].shape[0]
        patches = inputs.unfold(1, self.k, self.stride)[:, :ot]
        patches = patches.transpose(2, 3).reshape(b, ot, -1)
        y = torch.einsum("bok,okf->bof", patches, params["W"])
        return self._finish(params, y)

    def compute_output_shape(self, input_shape):
        b, t, c = input_shape
        ot = None if t is None else (t - self.k) // self.stride + 1
        return (b, ot, self.nb_filter)


class LocallyConnected2D(_Conv):
    """Unshared 2-D conv: ``W`` (OH * OW, C * kh * kw, nb_filter), each
    patch's features channel-major, as ``conv_general_dilated_patches``
    orders them (and ``F.unfold``)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample: Tuple[int, int] = (1, 1),
                 border_mode: str = "valid", dim_ordering: str = "th",
                 bias: bool = True, init="glorot_uniform", **kwargs):
        super().__init__(**kwargs)
        if border_mode != "valid":
            raise ValueError("LocallyConnected2D supports border_mode="
                             "'valid' only (like the reference)")
        self.nb_filter = int(nb_filter)
        self.kernel = (int(nb_row), int(nb_col))
        self.subsample = _tup(subsample, 2)
        self.activation = get_activation_fn(activation)
        self.dim_ordering = dim_ordering
        self.bias = bias
        self.init = get_initializer(init)

    def _hw(self, input_shape):
        return (input_shape[2], input_shape[3]) \
            if self.dim_ordering == "th" else (input_shape[1],
                                               input_shape[2])

    def build(self, generator, input_shape):
        h, w = self._hw(input_shape)
        c = input_shape[1] if self.dim_ordering == "th" else input_shape[3]
        oh = (h - self.kernel[0]) // self.subsample[0] + 1
        ow = (w - self.kernel[1]) // self.subsample[1] + 1
        p = {"W": self.init(generator, (oh * ow, self.kernel[0]
                                        * self.kernel[1] * c,
                                        self.nb_filter))}
        if self.bias:
            p["b"] = _zeros(generator, (oh * ow, self.nb_filter))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        x = inputs if self.dim_ordering == "th" else \
            inputs.permute(0, 3, 1, 2)                      # NCHW
        b, _, h, w = x.shape
        (kh, kw), (sh, sw) = self.kernel, self.subsample
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        patches = F.unfold(x, (kh, kw), stride=(sh, sw)).transpose(1, 2)
        y = torch.einsum("bpk,pkf->bpf", patches, params["W"])
        if self.bias:
            y = y + params["b"]
        y = y.reshape(b, oh, ow, self.nb_filter)
        if self.activation:
            y = self.activation(y)
        return _from_channels_last(y, self.dim_ordering)

    def compute_output_shape(self, input_shape):
        h, w = self._hw(input_shape)
        oh = None if h is None else (h - self.kernel[0]) // \
            self.subsample[0] + 1
        ow = None if w is None else (w - self.kernel[1]) // \
            self.subsample[1] + 1
        if self.dim_ordering == "th":
            return (input_shape[0], self.nb_filter, oh, ow)
        return (input_shape[0], oh, ow, self.nb_filter)


class ConvLSTM2D(Layer):
    """Convolutional LSTM over a (B, T, C, H, W) sequence (th layout,
    square kernel, SAME, stride 1): ``W`` (k, k, C, 4F), ``U`` (k, k, F,
    4F), ``b`` (4F), gates i, f, c, o. A Python loop over time, as the
    port's recurrent layers loop (the JAX layer's ``lax.scan``)."""

    def __init__(self, nb_filter: int, nb_kernel: int,
                 activation="tanh", inner_activation="hard_sigmoid",
                 dim_ordering: str = "th", border_mode: str = "same",
                 subsample: Tuple[int, int] = (1, 1),
                 return_sequences: bool = False,
                 init="glorot_uniform", **kwargs):
        super().__init__(**kwargs)
        if dim_ordering != "th":
            raise ValueError("ConvLSTM2D supports dim_ordering='th' (the "
                             "reference only ships th)")
        if border_mode != "same" or _tup(subsample, 2) != (1, 1):
            raise ValueError("ConvLSTM2D supports border_mode='same', "
                             "subsample=(1,1) (reference constraint)")
        self.nb_filter = int(nb_filter)
        self.k = int(nb_kernel)
        self.activation = get_activation_fn(activation)
        self.inner_activation = get_activation_fn(inner_activation)
        self.return_sequences = return_sequences
        self.init = get_initializer(init)

    def build(self, generator, input_shape):
        c, f = input_shape[2], self.nb_filter
        return {"W": self.init(generator, (self.k, self.k, c, 4 * f)),
                "U": self.init(generator, (self.k, self.k, f, 4 * f)),
                "b": _zeros(generator, (4 * f,))}

    def call(self, params, inputs, *, training=False, rng=None):
        x = inputs.permute(1, 0, 3, 4, 2)                 # (T, B, H, W, C)
        b, h, w = x.shape[1], x.shape[2], x.shape[3]
        hp = inputs.new_zeros((b, h, w, self.nb_filter))
        cp = torch.zeros_like(hp)
        act, inner = self.activation, self.inner_activation
        hs = []
        for t in range(x.shape[0]):
            z = conv2d_plain(x[t], params["W"]) + \
                conv2d_plain(hp, params["U"]) + params["b"]
            zi, zf, zc, zo = torch.chunk(z, 4, dim=-1)
            cp = inner(zf) * cp + inner(zi) * act(zc)
            hp = inner(zo) * act(cp)
            hs.append(hp)
        if self.return_sequences:
            return torch.stack(hs, 1).permute(0, 1, 4, 2, 3).contiguous()
        return hp.permute(0, 3, 1, 2).contiguous()

    def compute_output_shape(self, input_shape):
        b, t, c, h, w = input_shape
        if self.return_sequences:
            return (b, t, self.nb_filter, h, w)
        return (b, self.nb_filter, h, w)


class WordEmbedding(Layer):
    """Frozen pretrained word embedding: the table rides in the
    ``stats`` subtree (``{"stats": {"table": ...}}``), so no step takes
    its gradient. Ids outside the table read NaN rows, as ``jnp.take``'s
    fill mode (:func:`take_rows`)."""

    def __init__(self, embedding_matrix: np.ndarray, **kwargs):
        super().__init__(**kwargs)
        self.matrix = np.asarray(embedding_matrix, np.float32)

    @classmethod
    def from_glove(cls, path: str, word_index: dict, **kwargs):
        from zoo_tpu_torch.feature.text import load_glove_matrix
        return cls(load_glove_matrix(path, word_index), **kwargs)

    def build(self, generator, input_shape):
        return {"stats": {"table": torch.as_tensor(
            self.matrix, device=generator.device).clone()}}

    def call(self, params, inputs, *, training=False, rng=None):
        return take_rows(params["stats"]["table"], inputs)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.matrix.shape[1],)


# ------------------------------------------------- 3-D pool/pad/resize

def _axes3(ordering):
    return (2, 3, 4) if ordering == "th" else (1, 2, 3)


class _Pool3D(Layer):
    """th layout (B, C, D, H, W); pools run channel-first inside."""

    def __init__(self, pool_size=(2, 2, 2), strides=None,
                 border_mode: str = "valid", dim_ordering: str = "th",
                 **kwargs):
        super().__init__(**kwargs)
        self.pool = _tup(pool_size, 3)
        self.strides = _tup(strides, 3) if strides is not None else self.pool
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering

    def _reduce(self, x, pads):
        raise NotImplementedError

    def call(self, params, inputs, *, training=False, rng=None):
        x = inputs if self.dim_ordering == "th" else \
            inputs.permute(0, 4, 1, 2, 3)
        pads = _xla_pads(x.shape[2:], self.pool, self.strides,
                         self.border_mode)
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        y = self._reduce(x, flat)
        return y if self.dim_ordering == "th" else \
            y.permute(0, 2, 3, 4, 1).contiguous()

    def compute_output_shape(self, input_shape):
        if self.dim_ordering == "th":
            b, c, d, h, w = input_shape
        else:
            b, d, h, w, c = input_shape
        od, oh, ow = (_out_dim(n, k, s, self.border_mode) for n, k, s in
                      zip((d, h, w), self.pool, self.strides))
        if self.dim_ordering == "th":
            return (b, c, od, oh, ow)
        return (b, od, oh, ow, c)


class MaxPooling3D(_Pool3D):
    def _reduce(self, x, pads):
        if any(pads):
            x = F.pad(x, pads, value=float("-inf"))
        return F.max_pool3d(x, self.pool, self.strides)


class AveragePooling3D(_Pool3D):
    """Window sums over zero padding divided by the window's size (the
    JAX layer divides by ``prod(pool_size)``, padding included)."""

    def _reduce(self, x, pads):
        if any(pads):
            x = F.pad(x, pads)
        s = x.unfold(2, self.pool[0], self.strides[0]) \
            .unfold(3, self.pool[1], self.strides[1]) \
            .unfold(4, self.pool[2], self.strides[2]).sum((-3, -2, -1))
        return s / float(np.prod(self.pool))


class GlobalAveragePooling3D(Layer):
    def __init__(self, dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        return torch.mean(inputs, dim=_axes3(self.dim_ordering))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],
                input_shape[1 if self.dim_ordering == "th" else 4])


class GlobalMaxPooling3D(GlobalAveragePooling3D):
    def call(self, params, inputs, *, training=False, rng=None):
        return torch.amax(inputs, dim=_axes3(self.dim_ordering))


class UpSampling3D(Layer):
    def __init__(self, size=(2, 2, 2), dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.size = _tup(size, 3)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        y = inputs
        for ax, r in zip(_axes3(self.dim_ordering), self.size):
            y = y.repeat_interleave(r, dim=ax)
        return y

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        for ax, r in zip(_axes3(self.dim_ordering), self.size):
            if out[ax] is not None:
                out[ax] *= r
        return tuple(out)


class ZeroPadding3D(Layer):
    def __init__(self, padding=(1, 1, 1), dim_ordering: str = "th",
                 **kwargs):
        super().__init__(**kwargs)
        self.padding = _tup(padding, 3)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        d, h, w = self.padding
        pads = (w, w, h, h, d, d) if self.dim_ordering == "th" else \
            (0, 0, w, w, h, h, d, d)
        return F.pad(inputs, pads)

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        for ax, v in zip(_axes3(self.dim_ordering), self.padding):
            if out[ax] is not None:
                out[ax] += 2 * v
        return tuple(out)


class Cropping3D(Layer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)),
                 dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(_tup(c, 2) for c in cropping)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        y = inputs
        for ax, (lo, hi) in zip(_axes3(self.dim_ordering), self.cropping):
            y = y.narrow(ax, lo, y.shape[ax] - lo - hi)
        return y

    def compute_output_shape(self, input_shape):
        out = list(input_shape)
        for ax, (lo, hi) in zip(_axes3(self.dim_ordering), self.cropping):
            if out[ax] is not None:
                out[ax] -= lo + hi
        return tuple(out)


class SpatialDropout3D(Layer):
    """Drop whole channels of a volume: JAX's mask of shape (B, C, 1, 1,
    1) (``th``) or (B, 1, 1, 1, C) (``tf``), through the dropout
    kernel."""

    def __init__(self, p: float = 0.5, dim_ordering: str = "th", **kwargs):
        super().__init__(**kwargs)
        self.p = float(p)
        self.dim_ordering = dim_ordering

    def call(self, params, inputs, *, training=False, rng=None):
        if not training or rng is None or self.p <= 0:
            return inputs
        b = inputs.shape[0]
        shape = (b, inputs.shape[1], 1, 1, 1) if self.dim_ordering == "th" \
            else (b, 1, 1, 1, inputs.shape[4])
        return spatial_dropout(self, inputs, rng, shape)


class DepthwiseConvolution2D(_Conv):
    """Per-channel spatial conv, ``W`` HWIO with I = 1 and O = C *
    ``depth_multiplier`` (output ``c * depth_multiplier + m`` from input
    ``c``), through the reference conv with ``groups = C``: the depthwise
    half of ``SeparableConvolution2D``, which the MobileNets take."""

    def __init__(self, nb_row: int, nb_col: int, init="glorot_uniform",
                 activation=None, border_mode: str = "valid",
                 subsample=(1, 1), depth_multiplier: int = 1,
                 dim_ordering: str = "th", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.kernel = (int(nb_row), int(nb_col))
        self.init = get_initializer(init)
        self.activation = get_activation_fn(activation)
        self.border_mode = border_mode
        self.subsample = _tup(subsample, 2)
        self.mult = int(depth_multiplier)
        self.dim_ordering = dim_ordering
        self.bias = bias

    def build(self, generator, input_shape):
        cin = input_shape[1] if self.dim_ordering == "th" else input_shape[3]
        p = {"W": self.init(generator, self.kernel + (1, cin * self.mult))}
        if self.bias:
            p["b"] = _zeros(generator, (cin * self.mult,))
        return p

    def call(self, params, inputs, *, training=False, rng=None):
        x = _to_channels_last(inputs, self.dim_ordering)
        y = conv2d_plain(x, params["W"], self.subsample,
                         self.border_mode.upper(), groups=x.shape[-1])
        return _from_channels_last(self._finish(params, y),
                                   self.dim_ordering)

    def compute_output_shape(self, input_shape):
        c = input_shape[1] if self.dim_ordering == "th" else input_shape[3]
        return _conv2d_out_shape(self, input_shape, c * self.mult,
                                 self.kernel)
