"""Caffe model loader: deploy prototxt and ``.caffemodel`` ingestion
(counterpart of ``zoo_tpu/models/caffe_loader.py``).

The binary ``NetParameter`` is decoded straight from the protobuf wire
format with the port's own helpers (:mod:`zoo_tpu_torch.tensorboard.
proto`; field numbers per the public ``caffe.proto``), V2 ``layer`` and
legacy V1 ``layers`` alike; the deploy prototxt is parsed with a small
text-format reader that skips TRAIN-phase layers. The net is
interpreted as a :class:`CaffeNet`, a ``KerasNet`` whose params are the
layer blobs, so a loaded model predicts and fine-tunes like any other
model of the port.

Caffe is NCHW end to end and so is the interpreter. The arithmetic is
the JAX module's, not a ``torch.nn.functional`` shortcut whose semantics
differ: the convolutions are the reference conv (``conv2d_plain``: f32
sums, TF32 off) with explicit pads, groups and dilation, and the
deconvolution a fractionally-strided conv (zeros inserted between input
pixels, the kernel flipped and regrouped); MAX and AVE pooling keep
Caffe's ceil-mode extra row and column, and AVE divides by the window
clipped to the padded extent (padded zeros count, the ceil-mode
overflow does not); LRN scales ``alpha`` by the window size.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from zoo_tpu_torch.ops.kernels.conv import conv2d_plain
from zoo_tpu_torch.pipeline.api.keras.engine.base import model_file_part
from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
    KerasNet,
    _placed,
)
from zoo_tpu_torch.tensorboard import proto as wire

# ------------------------------------------------- caffe.proto field ids
# NetParameter
_NET_NAME, _NET_LAYERS_V1, _NET_INPUT, _NET_INPUT_DIM = 1, 2, 3, 4
_NET_INPUT_SHAPE, _NET_LAYER = 8, 100
# BlobShape / BlobProto
_SHAPE_DIM = 1
_BLOB_NUM, _BLOB_CH, _BLOB_H, _BLOB_W = 1, 2, 3, 4
_BLOB_DATA, _BLOB_SHAPE, _BLOB_DDATA = 5, 7, 9
# LayerParameter (the "new" format)
_L_NAME, _L_TYPE, _L_BOTTOM, _L_TOP, _L_BLOBS = 1, 2, 3, 4, 7
_L_PARAMS = {  # sub-message field id -> attr-group name
    104: "concat", 106: "convolution", 108: "dropout", 110: "eltwise",
    117: "inner_product", 118: "lrn", 121: "pooling", 122: "power",
    123: "relu", 125: "softmax", 131: "prelu", 133: "reshape",
    135: "flatten", 139: "batch_norm", 140: "elu", 142: "scale",
    143: "input",
}
# V1LayerParameter (legacy binaries still carry weights in this form)
_V1_BOTTOM, _V1_TOP, _V1_NAME, _V1_TYPE, _V1_BLOBS = 2, 3, 4, 5, 6
_V1_PARAMS = {9: "concat", 10: "convolution", 12: "dropout", 24: "eltwise",
              17: "inner_product", 18: "lrn", 19: "pooling", 21: "power",
              30: "relu", 39: "softmax", 38: "sigmoid", 37: "tanh"}
_V1_TYPE_NAMES = {
    3: "Concat", 4: "Convolution", 5: "Data", 6: "Dropout", 8: "Flatten",
    14: "InnerProduct", 15: "LRN", 17: "Pooling", 18: "ReLU", 19: "Sigmoid",
    20: "Softmax", 21: "SoftmaxWithLoss", 22: "Split", 23: "TanH",
    25: "Eltwise", 26: "Power", 39: "Deconvolution", 1: "Accuracy",
}


def _floats(vals: List) -> np.ndarray:
    """Repeated float field: packed bytes or scattered fixed32 values."""
    parts: List[np.ndarray] = []
    for v in vals:
        if isinstance(v, bytes):
            parts.append(np.frombuffer(v, "<f4"))
        else:
            parts.append(np.asarray([v], np.float32))
    return np.concatenate(parts).astype(np.float32) if parts else \
        np.zeros((0,), np.float32)


def _ints(vals: List) -> List[int]:
    out: List[int] = []
    for v in vals:
        if isinstance(v, bytes):
            pos = 0
            while pos < len(v):
                x, pos = wire.decode_varint(v, pos)
                out.append(x)
        else:
            out.append(int(v))
    return out


def _parse_blob(buf: bytes) -> np.ndarray:
    f = wire.parse_fields(buf)
    if _BLOB_SHAPE in f:
        dims = _ints(wire.parse_fields(f[_BLOB_SHAPE][0]).get(_SHAPE_DIM, []))
    else:  # legacy num/channels/height/width
        dims = [int(f.get(k, [1])[0])
                for k in (_BLOB_NUM, _BLOB_CH, _BLOB_H, _BLOB_W)]
        while len(dims) > 1 and dims[0] == 1:
            dims = dims[1:]
    if _BLOB_DDATA in f:
        data = np.asarray([float(v) for v in f[_BLOB_DDATA]], np.float32)
    else:
        data = _floats(f.get(_BLOB_DATA, []))
    return data.reshape(dims) if dims else data


# Per-group scalar field numbers (caffe.proto).
_ATTR_FIELDS: Dict[str, Dict[int, str]] = {
    "convolution": {1: "num_output", 2: "bias_term", 3: "pad",
                    4: "kernel_size", 5: "group", 6: "stride", 9: "pad_h",
                    10: "pad_w", 11: "kernel_h", 12: "kernel_w",
                    13: "stride_h", 14: "stride_w", 18: "dilation"},
    "pooling": {1: "pool", 2: "kernel_size", 3: "stride", 4: "pad",
                5: "kernel_h", 6: "kernel_w", 7: "stride_h", 8: "stride_w",
                9: "pad_h", 10: "pad_w", 12: "global_pooling"},
    "inner_product": {1: "num_output", 2: "bias_term", 5: "axis",
                      6: "transpose"},
    "lrn": {1: "local_size", 2: "alpha", 3: "beta", 4: "norm_region",
            5: "k"},
    "batch_norm": {1: "use_global_stats", 2: "moving_average_fraction",
                   3: "eps"},
    "scale": {1: "axis", 2: "num_axes", 4: "bias_term"},
    "concat": {1: "concat_dim", 2: "axis"},
    "eltwise": {1: "operation", 2: "coeff"},
    "dropout": {1: "dropout_ratio"},
    "relu": {1: "negative_slope"},
    "softmax": {2: "axis"},
    "flatten": {1: "axis", 2: "end_axis"},
    "reshape": {1: "shape", 2: "axis", 3: "num_axes"},
    "power": {1: "power", 2: "scale", 3: "shift"},
    "elu": {1: "alpha"},
    "prelu": {2: "channel_shared"},
    "input": {1: "shape"},
}
_REPEATED = {"pad", "kernel_size", "stride", "dilation", "coeff", "shape"}
_FLOAT_ATTRS = {"alpha", "beta", "k", "eps", "moving_average_fraction",
                "dropout_ratio", "negative_slope", "coeff", "power",
                "scale", "shift"}


def _parse_attr_group(group: str, buf: bytes) -> Dict[str, Any]:
    names = _ATTR_FIELDS.get(group, {})
    out: Dict[str, Any] = {}
    for field, wtype, val in wire.iter_fields(buf):
        name = names.get(field)
        if name is None:
            continue
        if name == "shape" and isinstance(val, bytes):
            out.setdefault("shape", []).append(
                _ints(wire.parse_fields(val).get(_SHAPE_DIM, [])))
            continue
        if name in _FLOAT_ATTRS and name not in _REPEATED:
            out[name] = float(val)
        elif name in _REPEATED:
            if isinstance(val, bytes):  # packed ints
                out.setdefault(name, []).extend(_ints([val]))
            else:
                out.setdefault(name, []).append(
                    float(val) if name in _FLOAT_ATTRS else int(val))
        else:
            out[name] = int(val) if not isinstance(val, bytes) else val
    return out


@model_file_part
class CaffeLayer:
    __slots__ = ("name", "type", "bottoms", "tops", "blobs", "attrs")

    def __init__(self, name, type_, bottoms, tops, blobs, attrs):
        self.name, self.type = name, type_
        self.bottoms, self.tops = bottoms, tops
        self.blobs: List[np.ndarray] = blobs
        self.attrs: Dict[str, Any] = attrs


def _parse_layer(buf: bytes, v1: bool) -> CaffeLayer:
    f = wire.parse_fields(buf)
    if v1:
        name = f.get(_V1_NAME, [b""])[0].decode()
        type_ = _V1_TYPE_NAMES.get(int(f.get(_V1_TYPE, [0])[0]), "Unknown")
        bottoms = [b.decode() for b in f.get(_V1_BOTTOM, [])]
        tops = [b.decode() for b in f.get(_V1_TOP, [])]
        blobs = [_parse_blob(b) for b in f.get(_V1_BLOBS, [])]
        params = _V1_PARAMS
    else:
        name = f.get(_L_NAME, [b""])[0].decode()
        type_ = f.get(_L_TYPE, [b""])[0].decode()
        bottoms = [b.decode() for b in f.get(_L_BOTTOM, [])]
        tops = [b.decode() for b in f.get(_L_TOP, [])]
        blobs = [_parse_blob(b) for b in f.get(_L_BLOBS, [])]
        params = _L_PARAMS
    attrs: Dict[str, Any] = {}
    for field, group in params.items():
        if field in f:
            attrs.update(_parse_attr_group(group, f[field][0]))
    return CaffeLayer(name, type_, bottoms, tops, blobs, attrs)


class CaffeNetParameter:
    """Parsed NetParameter (binary wire format)."""

    def __init__(self, data: bytes):
        f = wire.parse_fields(data)
        self.name = f.get(_NET_NAME, [b""])[0].decode()
        self.layers = ([_parse_layer(b, False) for b in f.get(_NET_LAYER, [])]
                       or [_parse_layer(b, True)
                           for b in f.get(_NET_LAYERS_V1, [])])
        self.inputs = [b.decode() for b in f.get(_NET_INPUT, [])]
        self.input_shapes: List[Tuple[int, ...]] = []
        for b in f.get(_NET_INPUT_SHAPE, []):
            self.input_shapes.append(tuple(
                _ints(wire.parse_fields(b).get(_SHAPE_DIM, []))))
        dims = _ints(f.get(_NET_INPUT_DIM, []))
        if dims and not self.input_shapes:
            self.input_shapes = [tuple(dims[i:i + 4])
                                 for i in range(0, len(dims), 4)]


# ----------------------------------------------- prototxt (text format)

_TOKEN = re.compile(r"""
    (?P<brace>[{}])            |
    (?P<name>[A-Za-z_][\w.]*)\s*:?\s* |
    (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*') |
    (?P<number>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)
""", re.VERBOSE)


def _tokenize_prototxt(text: str):
    text = re.sub(r"#[^\n]*", "", text)
    pos = 0
    while pos < len(text):
        if text[pos].isspace() or text[pos] == ",":
            pos += 1
            continue
        m = _TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"prototxt parse error at offset {pos}: "
                             f"{text[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup == "brace":
            yield ("brace", m.group("brace"))
        elif m.lastgroup == "name":
            yield ("name", m.group("name"))
        elif m.lastgroup == "string":
            yield ("value", m.group("string")[1:-1])
        else:
            n = m.group("number")
            yield ("value", float(n) if ("." in n or "e" in n.lower())
                   else int(n))


def parse_prototxt(text: str) -> Dict[str, List]:
    """Protobuf text format as nested {field: [values...]} dicts (every
    field a list: protobuf fields may repeat)."""
    tokens = list(_tokenize_prototxt(text))
    pos = 0

    def message():
        nonlocal pos
        out: Dict[str, List] = {}
        while pos < len(tokens):
            kind, val = tokens[pos]
            if kind == "brace" and val == "}":
                pos += 1
                return out
            if kind != "name":
                raise ValueError(f"prototxt: expected a field name, got "
                                 f"{val!r}")
            field = val
            pos += 1
            kind, val = tokens[pos]
            if kind == "brace" and val == "{":
                pos += 1
                out.setdefault(field, []).append(message())
            else:
                pos += 1
                if val in ("true", "false"):
                    val = val == "true"
                out.setdefault(field, []).append(val)
        return out

    return message()


_BOOL = {"true": True, "false": False, True: True, False: False,
         0: False, 1: True}

# V1 text-format layer-type enum names -> new-format type strings.
_V1_ENUM_NAMES = {
    "CONVOLUTION": "Convolution", "DECONVOLUTION": "Deconvolution",
    "POOLING": "Pooling", "INNER_PRODUCT": "InnerProduct", "RELU": "ReLU",
    "SOFTMAX": "Softmax", "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "CONCAT": "Concat", "DROPOUT": "Dropout", "ELTWISE": "Eltwise",
    "DATA": "Data", "FLATTEN": "Flatten", "SIGMOID": "Sigmoid",
    "TANH": "TanH", "SPLIT": "Split", "SLICE": "Slice", "POWER": "Power",
    "ACCURACY": "Accuracy", "ABSVAL": "AbsVal", "EXP": "Exp",
    "HDF5_DATA": "HDF5Data", "IMAGE_DATA": "ImageData",
    "MEMORY_DATA": "MemoryData", "DUMMY_DATA": "DummyData",
}


def _prototxt_layers(net: Dict[str, List]) -> List[CaffeLayer]:
    layers = []
    for ld in net.get("layer", net.get("layers", [])):
        name = ld.get("name", [""])[0]
        type_ = str(ld.get("type", [""])[0])
        # V1 prototxts carry SCREAMING_CASE enum names; only known enum
        # names map, so new-format all-caps types (ELU, BNLL, LRN) pass
        type_ = _V1_ENUM_NAMES.get(type_, type_)
        attrs: Dict[str, Any] = {}
        for group in _ATTR_FIELDS:
            sub = ld.get(group + "_param")
            if sub:
                for k, v in sub[0].items():
                    if k == "shape":
                        attrs["shape"] = [
                            [int(d) for d in s.get("dim", [])] for s in v]
                    elif k in _REPEATED:
                        attrs[k] = [x for x in v]
                    else:
                        attrs[k] = v[0]
        # pooling `pool: MAX` comes through as the enum name string
        if "pool" in attrs and isinstance(attrs["pool"], str):
            attrs["pool"] = {"MAX": 0, "AVE": 1, "STOCHASTIC": 2}[
                attrs["pool"]]
        if "operation" in attrs and isinstance(attrs["operation"], str):
            attrs["operation"] = {"PROD": 0, "SUM": 1, "MAX": 2}[
                attrs["operation"]]
        phase = [i.get("phase", [None])[0] for i in ld.get("include", [])]
        if phase and "TRAIN" in phase:
            continue  # the deploy graph only
        layers.append(CaffeLayer(
            name, type_, list(ld.get("bottom", [])), list(ld.get("top", [])),
            [], attrs))
    return layers


# ------------------------------------------------------------ the layers

_SKIP = {"Data", "DummyData", "ImageData", "HDF5Data", "MemoryData",
         "Accuracy", "Silence", "ArgMax", "SoftmaxWithLoss"}


def _pair(attrs, base, default=0):
    h = attrs.get(base + "_h")
    w = attrs.get(base + "_w")
    if h is not None or w is not None:
        return int(h or default), int(w or default)
    v = attrs.get(base, default)
    if isinstance(v, (list, tuple)):
        v = list(v) or [default]
        return (int(v[0]), int(v[-1]))
    return int(v), int(v)


def _conv_nchw(x, w_oihw, strides, pads, dilation, groups):
    """The reference conv on NCHW ``x`` and OIHW weights with explicit
    ``((top, bottom), (left, right))`` pads; NCHW out."""
    y = conv2d_plain(x.permute(0, 2, 3, 1), w_oihw.permute(2, 3, 1, 0),
                     strides, pads, dilation, groups)
    return y.permute(0, 3, 1, 2)


def _conv(layer: CaffeLayer, w, b, x, transpose=False):
    kh, kw = _pair(layer.attrs, "kernel_size")
    sh, sw = _pair(layer.attrs, "stride", 1)
    ph, pw = _pair(layer.attrs, "pad", 0)
    dil = layer.attrs.get("dilation", [1])
    d = int(dil[0]) if isinstance(dil, (list, tuple)) else int(dil)
    groups = int(layer.attrs.get("group", 1))
    w = w.reshape((-1,) + tuple(w.shape[-3:]))
    if transpose:
        # Caffe's Deconvolution weight is (in, out/g, kh, kw), applied as
        # a fractionally-strided conv: the input dilated by the stride
        # (zeros between pixels), the kernel flipped spatially and
        # regrouped to OIHW = (out, in/g, kh, kw), pads k_eff - 1 - p, so
        # out = (i - 1) * s + k_eff - 2p
        n, cin, h, wd = x.shape
        wt = w.reshape(groups, cin // groups, -1, kh, kw)
        wt = wt.permute(0, 2, 1, 3, 4).reshape(
            (-1, cin // groups, kh, kw)).flip((2, 3))
        xd = x.new_zeros((n, cin, (h - 1) * sh + 1, (wd - 1) * sw + 1))
        xd[:, :, ::sh, ::sw] = x
        keh, kew = d * (kh - 1) + 1, d * (kw - 1) + 1
        out = _conv_nchw(xd, wt, (1, 1),
                         ((keh - 1 - ph,) * 2, (kew - 1 - pw,) * 2),
                         (d, d), groups)
    else:
        out = _conv_nchw(x, w, (sh, sw), ((ph, ph), (pw, pw)), (d, d),
                         groups)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def _window_sum(x, kh, kw, sh, sw):
    """Sums over (kh, kw) windows at (sh, sw) strides of NCHW ``x`` (no
    padding)."""
    return F.avg_pool2d(x, (kh, kw), (sh, sw), divisor_override=1)


def _pool(layer: CaffeLayer, x):
    if _BOOL.get(layer.attrs.get("global_pooling", False), False):
        kh, kw = x.shape[2], x.shape[3]
        sh = sw = 1
        ph = pw = 0
    else:
        kh, kw = _pair(layer.attrs, "kernel_size")
        sh, sw = _pair(layer.attrs, "stride", 1)
        ph, pw = _pair(layer.attrs, "pad", 0)
    mode = int(layer.attrs.get("pool", 0))

    # Caffe sizes its output in ceil mode: the right and bottom edges
    # are padded so the last partial window is kept
    def ceil_extra(size, k, s, p):
        out = int(np.ceil((size + 2 * p - k) / s)) + 1
        if (out - 1) * s >= size + p:
            out -= 1
        return max(0, (out - 1) * s + k - size - p)
    eh = ceil_extra(x.shape[2], kh, sh, ph)
    ew = ceil_extra(x.shape[3], kw, sw, pw)
    pads = (pw, pw + ew, ph, ph + eh)
    if mode == 0:
        return F.max_pool2d(F.pad(x, pads, value=-float("inf")), (kh, kw),
                            (sh, sw))
    # AVE divides by the window clipped to the *padded* extent: padded
    # zeros count, only the ceil-mode overflow past height + pad does not
    s = _window_sum(F.pad(x, pads), kh, kw, sh, sw)
    ones = F.pad(torch.ones_like(x[:1, :1]), (pw, pw, ph, ph), value=1.0)
    ones = F.pad(ones, (0, ew, 0, eh))
    return s / _window_sum(ones, kh, kw, sh, sw)


def _lrn(layer: CaffeLayer, x):
    size = int(layer.attrs.get("local_size", 5))
    alpha = float(layer.attrs.get("alpha", 1.0))
    beta = float(layer.attrs.get("beta", 0.75))
    k = float(layer.attrs.get("k", 1.0))
    sq = x * x
    half = size // 2
    n, c, h, w = x.shape
    if int(layer.attrs.get("norm_region", 0)) == 1:  # WITHIN_CHANNEL
        acc = _window_sum(F.pad(sq, (half, half, half, half)), size, size,
                          1, 1)
        return x / torch.pow(k + alpha / (size * size) * acc, beta)
    acc = _window_sum(F.pad(sq, (0, 0, 0, 0, half, half)).reshape(
        n, 1, c + 2 * half, h * w), size, 1, 1, 1).reshape(n, c, h, w)
    return x / torch.pow(k + alpha / size * acc, beta)


def _eltwise(layer: CaffeLayer, *xs):
    op = int(layer.attrs.get("operation", 1))
    if op == 0:
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out
    if op == 2:
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out
    coeff = layer.attrs.get("coeff") or [1.0] * len(xs)
    return sum(float(c) * x for c, x in zip(coeff, xs))


def _bias_term(layer: CaffeLayer) -> bool:
    return _BOOL.get(layer.attrs.get("bias_term", True), True)


class CaffeNet(KerasNet):
    """A Caffe net as a trainable ``KerasNet``: the layer blobs are the
    params (``{"caffe": {"w": {"<layer>/b<i>": tensor}}}``), on the CPU
    until the net is placed (:func:`load_caffe` places it)."""

    def __init__(self, layers: List[CaffeLayer], inputs: List[str],
                 input_shapes: List[Tuple[int, ...]],
                 name: Optional[str] = None):
        super().__init__(name=name or "caffe")
        self.caffe_layers = [l for l in layers if l.type not in _SKIP]
        self.inputs = list(inputs)
        self._built_shapes = [
            (None,) + tuple(s[1:]) if s else (None,)
            for s in (input_shapes or [()] * len(self.inputs))]
        w = {}
        for l in self.caffe_layers:
            for i, blob in enumerate(l.blobs):
                w[f"{l.name}/b{i}"] = torch.from_numpy(
                    np.array(blob, np.float32, copy=True))
        self.params = {"caffe": {"w": w}}

    @property
    def layers(self):
        return []

    def _input_shapes(self):
        return self._built_shapes

    def _init_params(self, generator, input_shapes):
        return self.params

    def _forward(self, params, inputs, *, training, collect=None, rng=None):
        w = params["caffe"]["w"]
        env: Dict[str, Any] = {}
        for name, val in zip(self.inputs, inputs):
            env[name] = val
        out_names: List[str] = []
        for l in self.caffe_layers:
            if l.type == "Input":
                continue
            blobs = [w.get(f"{l.name}/b{i}") for i in range(8)]
            blobs = [b for b in blobs if b is not None]
            missing = [b for b in l.bottoms if b not in env]
            if missing:
                raise KeyError(
                    f"Caffe layer {l.name!r} ({l.type}) references "
                    f"undefined bottom blob(s) {missing}; defined: "
                    f"{sorted(env)}")
            xs = [env[b] for b in l.bottoms]
            y = self._apply(l, blobs, xs, training)
            tops = l.tops or [l.name]
            if isinstance(y, tuple):
                for t, v in zip(tops, y):
                    env[t] = v
                    out_names.append(t)
            else:
                env[tops[0]] = y
                out_names.append(tops[0])
            for b in l.bottoms:
                if b in out_names:
                    out_names.remove(b)
        outs = [env[n] for n in dict.fromkeys(out_names)]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _apply(self, l: CaffeLayer, blobs, xs, training):
        t = l.type
        x = xs[0] if xs else None
        chan = (1, -1) + (1,) * (x.dim() - 2) if x is not None else None
        if t == "Convolution":
            bias = blobs[1] if len(blobs) > 1 and _bias_term(l) else None
            return _conv(l, blobs[0], bias, x)
        if t == "Deconvolution":
            bias = blobs[1] if len(blobs) > 1 else None
            return _conv(l, blobs[0], bias, x, transpose=True)
        if t == "InnerProduct":
            axis = int(l.attrs.get("axis", 1))
            mat = blobs[0].reshape(blobs[0].shape[0], -1)  # (out, in)
            flat = x.reshape(tuple(x.shape[:axis]) + (-1,))
            y = torch.matmul(flat, mat.T)
            if len(blobs) > 1 and _bias_term(l):
                y = y + blobs[1].reshape(-1)
            return y
        if t == "ReLU":
            slope = float(l.attrs.get("negative_slope", 0.0))
            return F.leaky_relu(x, slope) if slope else torch.relu(x)
        if t == "PReLU":
            return torch.where(x >= 0, x, blobs[0].reshape(chan) * x)
        if t == "ELU":
            return F.elu(x, float(l.attrs.get("alpha", 1.0)))
        if t == "Sigmoid":
            return torch.sigmoid(x)
        if t == "TanH":
            return torch.tanh(x)
        if t == "BNLL":
            return torch.logaddexp(x, torch.zeros_like(x))
        if t == "Power":
            p = float(l.attrs.get("power", 1.0))
            s = float(l.attrs.get("scale", 1.0))
            sh = float(l.attrs.get("shift", 0.0))
            y = s * x + sh
            return y if p == 1.0 else torch.pow(y, p)
        if t == "AbsVal":
            return torch.abs(x)
        if t == "Exp":
            return torch.exp(x)
        if t == "Log":
            return torch.log(x)
        if t == "Pooling":
            return _pool(l, x)
        if t == "LRN":
            return _lrn(l, x)
        if t == "BatchNorm":
            mean, var = blobs[0].reshape(-1), blobs[1].reshape(-1)
            scale = float(blobs[2].reshape(-1)[0]) if len(blobs) > 2 \
                else 1.0
            if scale != 0:
                mean, var = mean / scale, var / scale
            eps = float(l.attrs.get("eps", 1e-5))
            return (x - mean.reshape(chan)) * torch.rsqrt(
                var.reshape(chan) + eps)
        if t == "Scale":
            y = x * blobs[0].reshape(chan)
            if len(blobs) > 1:  # a bias blob exists iff bias_term was set
                y = y + blobs[1].reshape(chan)
            return y
        if t == "Bias":
            return x + blobs[0].reshape(chan)
        if t == "Concat":
            axis = int(l.attrs.get("axis", l.attrs.get("concat_dim", 1)))
            return torch.cat(xs, dim=axis)
        if t == "Eltwise":
            return _eltwise(l, *xs)
        if t == "Dropout":
            return x  # the deploy-time identity
        if t == "Softmax":
            return torch.softmax(x, dim=int(l.attrs.get("axis", 1)))
        if t == "Flatten":
            axis = int(l.attrs.get("axis", 1))
            return x.reshape(tuple(x.shape[:axis]) + (-1,))
        if t == "Reshape":
            shape = l.attrs.get("shape", [[-1]])
            dims = list(shape[0] if isinstance(shape[0], (list, tuple))
                        else shape)
            out = [x.shape[i] if d == 0 else int(d)
                   for i, d in enumerate(dims)]
            return x.reshape(out)
        if t == "Split":
            return tuple(x for _ in (l.tops or [l.name]))
        if t == "Slice":
            n = len(l.tops)
            axis = int(l.attrs.get("axis", 1))
            return tuple(torch.chunk(x, n, dim=axis))
        raise NotImplementedError(
            f"Caffe layer type {t!r} (layer {l.name!r}) has no mapping in "
            "zoo_tpu_torch.models.caffe_loader")


def load_caffe(def_path: Optional[str], model_path: str,
               device=None) -> CaffeNet:
    """Load a Caffe model: ``model_path`` the binary ``.caffemodel``,
    ``def_path`` the deploy prototxt (None: the topology the binary
    carries). Weights are matched to the prototxt's layers by name. The
    params are placed on ``device`` (default: the runtime context's,
    else the current CUDA device; raises without one)."""
    dev = _placed(device)
    with open(model_path, "rb") as f:
        binary = CaffeNetParameter(f.read())
    weights = {l.name: l.blobs for l in binary.layers}
    if def_path is None:
        layers, inputs, shapes = (binary.layers, binary.inputs,
                                  binary.input_shapes)
        if not inputs:
            inp = [l for l in binary.layers if l.type == "Input"]
            inputs = [t for l in inp for t in l.tops]
            shapes = [tuple(s) for l in inp
                      for s in l.attrs.get("shape", [])]
    else:
        with open(def_path) as f:
            net = parse_prototxt(f.read())
        layers = _prototxt_layers(net)
        for l in layers:  # weights matched by layer name
            l.blobs = weights.get(l.name, [])
        inputs = [str(v) for v in net.get("input", [])]
        shapes = [tuple(int(d) for d in s.get("dim", []))
                  for s in net.get("input_shape", [])]
        dims = [int(v) for v in net.get("input_dim", [])]
        if dims and not shapes:
            shapes = [tuple(dims[i:i + 4]) for i in range(0, len(dims), 4)]
        if not inputs:
            inp = [l for l in layers if l.type == "Input"]
            inputs = [t for l in inp for t in l.tops]
            shapes = [tuple(s) for l in inp
                      for s in l.attrs.get("shape", [])]
    model = CaffeNet(layers, inputs, shapes, name=binary.name or "caffe")
    model._place_params(model.params, dev)
    return model
