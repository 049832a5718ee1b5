"""Implicit-GEMM convolutions and the one conv dispatch point
(counterpart of ``zoo_tpu/ops/pallas/conv.py``).

Layouts are the JAX package's: NHWC activations, HWIO weights. The
kernels are ``zoo_tpu_torch/csrc/conv2d.cu``, ``conv2d_tc.cuh``,
``conv2d_f32_tc.cuh`` and ``conv2d_int8_tc.cuh`` (their headers say
what bounds them): a float one (f32 or bf16 in, f32 accumulation,
output in the input type; bf16 on the tensor cores with the tiles
:func:`conv_plan` picks, f32 on the tensor cores as 3xTF32 with the
tiles :func:`conv_f32_plan` picks) and an int8
one on the int8 tensor cores (int32 accumulation, dequantized to f32 in
the epilogue, tiles from :func:`conv_int8_plan`). The int8 kernel reads
the weights as a K-major (O, KH*KW*C) copy: :func:`attach_kmajor` makes
it once per weight and keeps it beside the weight. All cover
the JAX kernels' envelope, a 1x1 conv at any stride and a 3x3 conv at
stride 1, SAME or VALID; the halo reads as zero inside the kernel, so
no padded copy is made.

:func:`resolve_conv_impl` is the single selection rule, used by the
Keras conv layer and the int8 conv path: ``auto`` picks the kernel on a
CUDA device for shapes inside the envelope and the reference conv
everywhere else; ``ZOO_CONV_IMPL`` overrides it (``pallas`` keeps the
JAX package's name for "the hand-written kernel"). The reference conv
is also the kernels' plain version: ``torch.nn.functional.conv2d`` with
XLA's SAME pads applied explicitly, in f32 for the float conv and in
float64 (exact on integer values) for the int8 one.

The float kernel is differentiable: :class:`_ConvKernel` launches it in
the forward, and its backward is the gradient of the reference conv in
the input dtype (``F.conv2d``'s own input and weight gradients, on the
saved inputs), as XLA transposes the JAX package's convs; the JAX
package has no backward conv kernel. The int8 conv is inference-only.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from zoo_tpu_torch.common import knobs
from zoo_tpu_torch.ops.kernels import _launch as L
from zoo_tpu_torch.ops.kernels import on_cuda

__all__ = ["conv2d", "conv2d_int8", "resolve_conv_impl",
           "pallas_conv_supported", "conv_plan", "conv_f32_plan",
           "conv_int8_plan",
           "int8_weights_kmajor", "attach_kmajor", "kmajor_of"]

# kernel launches since the last reset (see ops.kernels.launch_counts)
LAUNCHES = 0
INT8_LAUNCHES = 0
_fns = None

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _entries():
    global _fns
    if _fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("conv2d")
        fl, q = lib.zt_conv2d, lib.zt_conv2d_int8
        fl.argtypes = [L.P] * 3 + [L.I] * 18 + [L.P]
        q.argtypes = [L.P] * 5 + [L.I] * 19 + [L.P]
        fl.restype = q.restype = L.I
        _fns = (lib, fl, q)
    return _fns


# the bf16 tensor-core kernel (csrc/conv2d_tc.cuh): output rows of a
# block (two warpgroups of 64), channels per reduction step
_TC_BM, _TC_BK = 128, 64


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Launch plan of the float conv kernels (bf16 and f32): a ``bm`` x
    ``bn`` output tile per block of ``threads``, a ring of ``stages``
    slots filled by copies of ``vec`` channels of ``item`` bytes each,
    ``smem`` bytes of dynamic shared memory, ``m_tiles`` x ``n_tiles``
    blocks."""
    bm: int
    bn: int
    stages: int
    vec: int
    smem: int
    threads: int
    m_tiles: int
    n_tiles: int
    item: int = 2

    @property
    def copy_bytes(self) -> int:
        return self.item * self.vec

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_plan(rows: int, c: int, o: int, align: int = 16) -> ConvPlan:
    """The bf16 kernel's plan for ``rows`` = N*OH*OW output pixels, ``c``
    input and ``o`` output channels, pointers aligned to ``align`` bytes.

    - Copy width: the widest of 8, 4, 2, 1 channels that divides ``c``
      and ``o`` and whose bytes divide ``align`` (16-byte copies for
      every ResNet-50 shape).
    - Tile: 128 rows (a warpgroup per 64) by 64 columns where ``o <= 64``
      (one tile covers O, so the activation is read once), with 4 ring
      stages; else by 128 columns, with 3 stages. Either way a block
      takes 101,376 bytes of shared memory and at most 128 registers a
      thread (16-byte copies), so two blocks share an SM: ResNet-50's
      7x7 convs (6,272 rows x 512 channels, 196 tiles) are resident at
      once on 132 SMs, one wave.
    """
    if min(rows, c, o) <= 0:
        raise ValueError(f"empty conv: rows={rows} c={c} o={o}")
    vec = next(v for v in (8, 4, 2, 1)
               if c % v == 0 and o % v == 0 and align % (2 * v) == 0)
    bm, (bn, stages) = _TC_BM, ((64, 4) if o <= 64 else (128, 3))
    stage = (bm + bn) * _TC_BK * 2
    smem = 1024 + max(stages * stage, bm * (bn + 8) * 2) + 16 * bm
    return ConvPlan(bm, bn, stages, vec, smem, 2 * bm, _cdiv(rows, bm),
                    _cdiv(o, bn))


# the f32 3xTF32 kernel (csrc/conv2d_f32_tc.cuh): channels a reduction
# step (one 128-byte activation row), pixels a warpgroup takes
_F32_BK, _F32_WG_PIXELS = 32, 128


def conv_f32_plan(rows: int, c: int, o: int, align: int = 16) -> ConvPlan:
    """The f32 (3xTF32, ``wgmma``) kernel's plan for ``rows`` = N*OH*OW
    output pixels, ``c`` input and ``o`` output channels, pointers
    aligned to ``align`` bytes. ``bm`` counts pixels and ``bn`` output
    channels, as for the bf16 kernel, though the kernel takes the product
    transposed (output channels on wgmma's M side).

    - Copy width: 4 floats (16 bytes) where ``c`` and ``o`` are
      multiples of 4 and the pointers 16-byte aligned, else 1 (4-byte
      copies).
    - Tile: two warpgroups of 64 output channels x 128 pixels: 128 x 128
      where ``o > 64``, else 64 channels x 256 pixels (one O tile covers
      O, so the activation is read once).
    - Shared memory: ring slots (4 at 128 x 128, 3 at 256 x 64) of an
      activation tile and its TF32 lo part (128-byte rows) and a weight
      tile (32 rows of ``bn + 8`` floats), 16 bytes of row origins a
      pixel, and 1024 bytes of slack to align the ring: 203,776 bytes at
      128 x 128, 229,376 at 256 x 64; one block an SM either way.
    """
    if min(rows, c, o) <= 0:
        raise ValueError(f"empty conv: rows={rows} c={c} o={o}")
    vec = 4 if c % 4 == 0 and o % 4 == 0 and align % 16 == 0 else 1
    bn = 64 if o <= 64 else 128
    bm = _F32_WG_PIXELS * (2 if bn == 64 else 1)
    stages = 4 if bn == 128 else 3
    stage = 2 * bm * _F32_BK * 4 + _F32_BK * (bn + 8) * 4
    smem = 1024 + stages * stage + 16 * bm
    return ConvPlan(bm, bn, stages, vec, smem, 256, _cdiv(rows, bm),
                    _cdiv(o, bn), item=4)


# the int8 tensor-core kernel (csrc/conv2d_int8_tc.cuh): output rows of
# a block (two warpgroups of 64); ring stages by channels (bytes) a step
_I8_BM = 128
_I8_STAGES = {64: 6, 128: 3}


@dataclasses.dataclass(frozen=True)
class ConvInt8Plan:
    """Launch plan of the int8 conv kernel: a ``bm`` x ``bn`` output tile
    per block of ``threads``, ``bk`` channels a reduction step, a ring of
    ``stages`` slots filled by copies of ``vec`` bytes, outputs stored
    ``out_vec`` f32 at a time, ``smem`` bytes of dynamic shared memory,
    ``m_tiles`` x ``n_tiles`` blocks."""
    bm: int
    bn: int
    bk: int
    stages: int
    vec: int
    out_vec: int
    smem: int
    threads: int
    m_tiles: int
    n_tiles: int

    @property
    def copy_bytes(self) -> int:
        return self.vec

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles


def conv_int8_plan(rows: int, c: int, o: int, align: int = 16,
                   out_align: int = 16) -> ConvInt8Plan:
    """The int8 kernel's plan for ``rows`` = N*OH*OW output pixels, ``c``
    input and ``o`` output channels, the activation and K-major weight
    pointers aligned to ``align`` bytes, the output and weight-scale
    pointers to ``out_align``.

    - Copy width: the widest of 16, 8, 4, 2, 1 bytes (channels) that
      divides ``c`` and ``align`` (16-byte copies for every ResNet-50
      shape). The K-major weight rows run over the channels too, so
      ``o`` does not narrow the copies; it narrows the stores: 16 bytes
      (4 f32) where ``o % 4 == 0``, else 4.
    - Step: 128 channels in 128-byte swizzled rows where ``c % 128 ==
      0`` (with 16-byte copies), 3 ring stages; else 64 channels in
      64-byte rows, 6 stages.
    - Tile: 128 rows (a warpgroup per 64) by 64 columns where ``o <=
      64``, else by 128. Shared memory: the ring or the int32 epilogue
      tile, whichever is larger, 16 bytes of row origins a row and 1024
      bytes of slack to align the ring: 101,376 bytes at 128 columns,
      so two blocks share an SM.
    """
    if min(rows, c, o) <= 0:
        raise ValueError(f"empty conv: rows={rows} c={c} o={o}")
    vec = next(v for v in (16, 8, 4, 2, 1) if c % v == 0 and align % v == 0)
    bk = 128 if c % 128 == 0 and vec == 16 else 64
    bn = 64 if o <= 64 else 128
    out_vec = 4 if o % 4 == 0 and out_align % 16 == 0 else 1
    bm, stages = _I8_BM, _I8_STAGES[bk]
    ring = stages * (bm + bn) * bk
    smem = 1024 + max(ring, bm * (bn + 8) * 4) + 16 * bm
    return ConvInt8Plan(bm, bn, bk, stages, vec, out_vec, smem, 2 * bm,
                        _cdiv(rows, bm), _cdiv(o, bn))


def int8_weights_kmajor(w_q: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's weight operand: HWIO ``w_q`` (kh, kw, c, o) as an
    (o, kh*kw*c) K-major copy, row ``o`` holding tap-major channels."""
    return w_q.permute(3, 0, 1, 2).reshape(w_q.shape[3], -1).contiguous()


# K-major copies made once per weight: (device, storage pointer, offset,
# shape, stride) of the int8 HWIO tensor -> (a weak reference to the
# tensor the copy was made from, its version, the copy). A lookup hits
# for that tensor and every view of the same storage (``detach()``,
# ``.to()`` its own device), as long as the tensor lives and was not
# written in place since.
_KMAJOR: dict = {}


def _kmajor_key(w_q: torch.Tensor):
    return (str(w_q.device), w_q.untyped_storage().data_ptr(),
            w_q.storage_offset(), tuple(w_q.shape), tuple(w_q.stride()))


def kmajor_of(w_q: torch.Tensor) -> Optional[torch.Tensor]:
    """The K-major copy made for ``w_q`` (or a view of its storage) by
    :func:`attach_kmajor`, or None."""
    hit = _KMAJOR.get(_kmajor_key(w_q))
    if hit is None:
        return None
    ref, version, copy = hit
    source = ref()
    if source is None or source._version != version or \
            w_q._version != version:
        return None
    return copy


def attach_kmajor(w_q: torch.Tensor) -> torch.Tensor:
    """``w_q``'s K-major copy (:func:`int8_weights_kmajor`), made once and
    kept beside the weight while it lives: ``quantize_model`` and
    ``keras_params_from_jax`` attach it to every int8 conv weight, and the
    layer's forward finds it again instead of transposing per call."""
    copy = kmajor_of(w_q)
    if copy is not None:
        return copy
    key = _kmajor_key(w_q)
    copy = int8_weights_kmajor(w_q.detach())
    _KMAJOR[key] = (weakref.ref(w_q, lambda ref: _forget(key, ref)),
                    w_q._version, copy)
    return copy


def _forget(key, ref) -> None:
    """Drop the copy of a weight that died (not one made since for a
    tensor that took its place)."""
    hit = _KMAJOR.get(key)
    if hit is not None and hit[0] is ref:
        del _KMAJOR[key]


def pallas_conv_supported(kernel: Tuple[int, int],
                          strides: Tuple[int, int] = (1, 1),
                          dilation: Tuple[int, int] = (1, 1)) -> bool:
    """Shapes the implicit-GEMM kernels cover: a 1x1 conv at any stride
    and a 3x3 conv at stride 1, undilated."""
    if tuple(dilation) != (1, 1):
        return False
    k = tuple(kernel)
    if k == (1, 1):
        return True
    return k == (3, 3) and tuple(strides) == (1, 1)


def resolve_conv_impl(impl: Optional[str] = None, *,
                      kernel: Tuple[int, int],
                      strides: Tuple[int, int] = (1, 1),
                      dilation: Tuple[int, int] = (1, 1),
                      device=None) -> str:
    """The one conv dispatch rule -> ``"pallas"`` (the implicit-GEMM
    kernel) or ``"reference"``.

    ``impl=None`` reads ``ZOO_CONV_IMPL`` (``auto`` | ``pallas`` |
    ``reference``). ``auto`` picks the kernel on a CUDA ``device``
    (default: the current one, if any) for supported shapes and the
    reference conv everywhere else; an explicit ``pallas`` on an
    unsupported shape raises rather than falling back."""
    impl = impl or knobs.value("ZOO_CONV_IMPL")
    if impl not in ("auto", "pallas", "reference"):
        raise ValueError(f"unknown conv impl {impl!r} "
                         "(expected auto|pallas|reference)")
    supported = pallas_conv_supported(kernel, strides, dilation)
    if impl == "pallas":
        if not supported:
            raise ValueError(
                f"ZOO_CONV_IMPL=pallas but kernel={tuple(kernel)} "
                f"strides={tuple(strides)} dilation={tuple(dilation)} "
                "is outside the implicit-GEMM kernel's envelope "
                "(1x1 any stride, 3x3 stride 1)")
        return "pallas"
    if impl == "reference":
        return "reference"
    return "pallas" if (supported and on_cuda(device)) else "reference"


def _spatial_pads(h: int, w: int, kh: int, kw: int,
                  strides: Tuple[int, int], padding: str):
    """XLA-convention SAME/VALID pads and the output spatial dims:
    ``((top, bottom), (left, right), oh, ow)``. SAME puts the odd pad
    at the end."""
    sh, sw = strides
    padding = padding.upper()
    if padding == "VALID":
        return (0, 0), (0, 0), (h - kh) // sh + 1, (w - kw) // sw + 1
    if padding != "SAME":
        raise ValueError(f"unsupported padding {padding!r}")
    oh = -(-h // sh)
    ow = -(-w // sw)
    th = max((oh - 1) * sh + kh - h, 0)
    tw = max((ow - 1) * sw + kw - w, 0)
    return (th // 2, th - th // 2), (tw // 2, tw - tw // 2), oh, ow


def _pads(x, w, strides, padding: Union[str, Pads],
          dilation: Tuple[int, int] = (1, 1)) -> Pads:
    """Explicit pads for ``padding``; a dilated kernel pads as its
    dilated extent, ``(k - 1) * d + 1``, as XLA pads it."""
    if isinstance(padding, str):
        kh, kw = ((int(w.shape[i]) - 1) * dilation[i] + 1 for i in (0, 1))
        ph, pw, _, _ = _spatial_pads(x.shape[1], x.shape[2], kh, kw,
                                     strides, padding)
        return ph, pw
    return tuple(map(tuple, padding))


def _no_tf32(deterministic=None):
    """Full f32 products: cuDNN would otherwise take TF32 for f32
    convs. ``deterministic=True`` also keeps cuDNN to algorithms that
    give the same bits every run (None: the caller's setting)."""
    cudnn = torch.backends.cudnn
    if deterministic is None:
        deterministic = cudnn.deterministic
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=deterministic, allow_tf32=False)


def _padded_nchw(x, pads: Pads, dtype) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    xn = x.to(dtype).permute(0, 3, 1, 2)
    if pt or pb or pl or pr:
        xn = F.pad(xn, (pl, pr, pt, pb))
    return xn


def _conv_nhwc(x, w, strides, pads: Pads, dtype,
               dilation: Tuple[int, int] = (1, 1),
               groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` of NHWC ``x`` and HWIO ``w``, both cast to
    ``dtype``, with explicit (top, bottom), (left, right) pads, the
    kernel's ``dilation`` (XLA's ``rhs_dilation``) and ``groups`` (XLA's
    ``feature_group_count``: output channel ``o`` reads group ``o //
    (O / groups)``, as in both); NHWC out."""
    xn = _padded_nchw(x, pads, dtype)
    with _no_tf32():
        y = F.conv2d(xn, w.to(dtype).permute(3, 2, 0, 1),
                     stride=tuple(strides), dilation=tuple(dilation),
                     groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_plain_grads(x, w, dy, strides: Tuple[int, int] = (1, 1),
                       padding: Union[str, Pads] = "SAME",
                       needs: Tuple[bool, bool] = (True, True),
                       dilation: Tuple[int, int] = (1, 1), groups: int = 1):
    """``(dx, dw)``, the gradients of the reference conv in ``x``'s
    dtype (f32 sums, TF32 off) at ``x``, ``w`` for the output gradient
    ``dy``: the float kernel's backward (and, with ``dilation``, the
    dilated conv's). A gradient whose ``needs`` flag is False is not
    computed (None).

    cuDNN runs it with deterministic algorithms: its default ones split
    f32 ``dw`` sums (1x1 convs) and ``dx`` sums (7x7 3x3) across blocks
    in an order that changes from run to run, so two ``fit`` runs of one
    seed on the card ended apart; with them, a ``fit`` repeats itself
    bit for bit, as JAX's does."""
    strides, dilation = tuple(strides), tuple(dilation)
    pads = _pads(x, w, strides, padding, dilation)
    (pt, _), (pl, _) = pads
    dt = x.dtype
    xn = _padded_nchw(x, pads, dt)
    wn = w.to(dt).permute(3, 2, 0, 1)
    dyn = dy.to(dt).permute(0, 3, 1, 2)
    dx = dw = None
    with _no_tf32(deterministic=True):
        if needs[0]:
            dx = torch.nn.grad.conv2d_input(xn.shape, wn, dyn,
                                            stride=strides,
                                            dilation=dilation,
                                            groups=groups)
            dx = dx[:, :, pt:pt + x.shape[1], pl:pl + x.shape[2]]
            dx = dx.permute(0, 2, 3, 1).contiguous()
        if needs[1]:
            dw = torch.nn.grad.conv2d_weight(xn, wn.shape, dyn,
                                             stride=strides,
                                             dilation=dilation,
                                             groups=groups)
            dw = dw.permute(2, 3, 1, 0).contiguous().to(w.dtype)
    return dx, dw


class _ConvPlain(torch.autograd.Function):
    """The reference conv: f32 sums with TF32 off in the forward and,
    unlike autograd of ``F.conv2d`` (taken outside :func:`_no_tf32`,
    under cuDNN's TF32 default), in the backward, whose f32 ``dx`` and
    ``dw`` are cast to their inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, w, strides, pads, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conv = (strides, pads)
        ctx.dilation, ctx.groups = dilation, groups
        return _conv_nhwc(x, w, strides, pads, torch.float32,
                          dilation, groups).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_plain_grads(x.float(), w.float(), dy.float(),
                                    *ctx.conv, needs=ctx.needs_input_grad[:2],
                                    dilation=ctx.dilation, groups=ctx.groups)
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype), None, None, None,
                None)


def conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Pads] = "SAME",
                 dilation: Tuple[int, int] = (1, 1),
                 groups: int = 1) -> torch.Tensor:
    """The reference conv and the float kernel's plain version: f32
    arithmetic, output in ``x``'s dtype; differentiable, with f32
    gradients (TF32 off, cuDNN's deterministic algorithms) cast to the
    inputs' dtypes (:class:`_ConvPlain`). ``padding``: ``"SAME"``,
    ``"VALID"`` or explicit ``((top, bottom), (left, right))``;
    ``dilation``: the kernel's (XLA's ``rhs_dilation``), as the TCN's
    dilated causal convs take it; ``groups``: XLA's
    ``feature_group_count`` (``w`` is HWIO with I = C / groups), as the
    depthwise convs take it."""
    strides, dilation = tuple(strides), tuple(int(d) for d in dilation)
    return _ConvPlain.apply(x, w, strides,
                            _pads(x, w, strides, padding, dilation),
                            dilation, int(groups))


def conv2d_int8_plain(x_q, w_q, x_scale, w_scale,
                      strides: Tuple[int, int] = (1, 1),
                      padding: str = "SAME",
                      w_kmajor: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The int8 kernel's plain version and the reference int8 conv: the
    integer sums in float64 (exact), then ``f32(acc) * x_scale[n] *
    w_scale[o]``, f32 out. It takes the kernel wrapper's arguments and
    reads the HWIO ``w_q``; ``w_kmajor``, the kernel's operand, is not
    used."""
    acc = _conv_nhwc(x_q, w_q, strides, _pads(x_q, w_q, strides, padding),
                     torch.float64).float()
    n, o = x_q.shape[0], w_q.shape[3]
    return acc * x_scale.reshape(n, 1, 1, 1).float() * \
        w_scale.reshape(o).float()


def _conv_args(x, w, strides, padding):
    n, h, wd, c = x.shape
    kh, kw, c2, o = w.shape
    if c != c2:
        raise ValueError(f"input has {c} channels, weights {c2}")
    (pt, _), (pl, _), oh, ow = _spatial_pads(h, wd, kh, kw, strides,
                                             padding)
    return (n, h, wd, c, kh, kw, o, strides[0], strides[1], pt, pl, oh,
            ow)


def _check_envelope(w, strides):
    """Raise (naming the envelope) unless the kernel takes ``w``'s shape."""
    resolve_conv_impl("pallas", kernel=tuple(w.shape[:2]), strides=strides)


def implicit_gemm_conv2d(x: torch.Tensor, w: torch.Tensor,
                         strides: Tuple[int, int] = (1, 1),
                         padding: str = "SAME") -> torch.Tensor:
    """NHWC x HWIO float conv through the implicit-GEMM kernel; ``x``
    and ``w`` f32 or bf16 alike, output in their dtype; differentiable
    (:class:`_ConvKernel`).

    CPU tensors take :func:`conv2d_plain`; CUDA tensors launch the
    kernel (or raise)."""
    strides = tuple(strides)
    _check_envelope(w, strides)
    if x.device.type == "cpu":
        return conv2d_plain(x, w, strides, padding)
    return _ConvKernel.apply(x, w, strides, padding)


def _launch_conv2d(x, w, strides, padding) -> torch.Tensor:
    global LAUNCHES
    dev = x.device
    L.require(x, "x", dev, (torch.float32, torch.bfloat16))
    L.require(w, "w", dev, (x.dtype,))
    args = _conv_args(x, w, strides, padding)
    n, c, o, oh, ow = args[0], args[3], args[6], args[11], args[12]
    y = torch.empty((n, oh, ow, o), dtype=x.dtype, device=dev)
    planner = conv_plan if x.dtype == torch.bfloat16 else conv_f32_plan
    p = planner(n * oh * ow, c, o, L.alignment(x, w))
    lib, fl, _ = _entries()
    rc = fl(L.ptr(x), L.ptr(w), L.ptr(y), L.DTYPE_CODES[x.dtype], *args,
            p.bn, p.stages, p.vec, p.smem, L.stream(dev))
    L.check(lib, rc, "conv2d")
    LAUNCHES += 1
    return y


class _ConvKernel(torch.autograd.Function):
    """The float kernel in the forward; the reference conv's gradients
    (:func:`conv2d_plain_grads`) on the saved inputs in the backward."""

    @staticmethod
    def forward(ctx, x, w, strides, padding):
        ctx.save_for_backward(x, w)
        ctx.conv = (strides, padding)
        return _launch_conv2d(x, w, strides, padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_plain_grads(x, w, dy, *ctx.conv)
        return dx, dw, None, None


def implicit_gemm_conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor,
                              x_scale: torch.Tensor, w_scale: torch.Tensor,
                              strides: Tuple[int, int] = (1, 1),
                              padding: str = "SAME",
                              w_kmajor: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Int8 NHWC conv through the implicit-GEMM kernel with the dequant
    epilogue, f32 out. ``x_q`` holds int8-range values (int8, or any
    float dtype, converted here), ``w_q`` the int8 HWIO weights,
    ``x_scale`` the (N, 1, 1, 1) or (N,) per-image scale, ``w_scale`` the
    (O,) per-output-channel scale; ``w_kmajor`` the weights' K-major copy
    (:func:`int8_weights_kmajor`), which the kernel reads: made here, per
    call, when none is passed.

    CPU tensors take :func:`conv2d_int8_plain`; CUDA tensors launch the
    kernel (or raise)."""
    global INT8_LAUNCHES
    strides = tuple(strides)
    _check_envelope(w_q, strides)
    if x_q.device.type == "cpu":
        return conv2d_int8_plain(x_q, w_q, x_scale, w_scale, strides,
                                 padding)
    dev = x_q.device
    if x_q.dtype != torch.int8:
        x_q = x_q.to(torch.int8)
    L.require(x_q, "x_q", dev, (torch.int8,))
    L.require(w_q, "w_q", dev, (torch.int8,))
    args = _conv_args(x_q, w_q, strides, padding)
    n, c, kh, kw, o = args[0], args[3], args[4], args[5], args[6]
    if w_kmajor is None:
        w_kmajor = int8_weights_kmajor(w_q)
    L.require(w_kmajor, "w_kmajor", dev, (torch.int8,), (o, kh * kw * c))
    xs = x_scale.reshape(n).float().contiguous()
    ws = w_scale.reshape(o).float().contiguous()
    L.require(xs, "x_scale", dev, (torch.float32,))
    L.require(ws, "w_scale", dev, (torch.float32,))
    y = torch.empty((n, args[11], args[12], o), dtype=torch.float32,
                    device=dev)
    p = conv_int8_plan(n * args[11] * args[12], c, o,
                       L.alignment(x_q, w_kmajor), L.alignment(y, ws))
    lib, _, q = _entries()
    rc = q(L.ptr(x_q), L.ptr(w_kmajor), L.ptr(xs), L.ptr(ws), L.ptr(y),
           *args, p.bn, p.bk, p.stages, p.vec, p.out_vec, p.smem,
           L.stream(dev))
    L.check(lib, rc, "conv2d_int8")
    INT8_LAUNCHES += 1
    return y


def conv2d(x: torch.Tensor, w: torch.Tensor,
           strides: Tuple[int, int] = (1, 1), padding: str = "SAME",
           impl: Optional[str] = None) -> torch.Tensor:
    """NHWC float conv behind the one dispatch point: the implicit-GEMM
    kernel or the reference conv (:func:`resolve_conv_impl`)."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    strides = tuple(strides)
    if resolve_conv_impl(impl, kernel=(kh, kw), strides=strides,
                         device=x.device) == "reference":
        return conv2d_plain(x, w, strides, padding)
    return implicit_gemm_conv2d(x, w, strides, padding)


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor,
                x_scale: torch.Tensor, w_scale: torch.Tensor,
                strides: Tuple[int, int] = (1, 1), padding: str = "SAME",
                impl: Optional[str] = None,
                w_kmajor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Int8 NHWC conv with the dequant fused, f32 out, behind the one
    dispatch point (``w_kmajor`` as in :func:`implicit_gemm_conv2d_int8`).
    Outside the kernel's envelope it takes the exact float64 reference on
    every device (the JAX package runs a true int8 conv there on its chip
    and an f32 conv on the CPU)."""
    kh, kw = int(w_q.shape[0]), int(w_q.shape[1])
    strides = tuple(strides)
    if resolve_conv_impl(impl, kernel=(kh, kw), strides=strides,
                         device=x_q.device) == "pallas":
        return implicit_gemm_conv2d_int8(x_q, w_q, x_scale, w_scale,
                                         strides, padding, w_kmajor)
    return conv2d_int8_plain(x_q, w_q, x_scale, w_scale, strides, padding)
