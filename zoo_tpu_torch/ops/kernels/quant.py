"""Int8 quantized inference GEMMs (counterpart of
``zoo_tpu/ops/pallas/quant.py``).

Weights are int8 per output channel, symmetric; activations are
quantized per row (Dense) or per image (conv) at run time; the product
runs int8 x int8 -> int32 with the dequant fused into the epilogue. The
kernels are ``zoo_tpu_torch/csrc/quant_matmul.cu``, both on the int8
tensor cores with the K split over a thread-block cluster:
:func:`quantized_matmul` takes quantized activations and their scales
(``wgmma`` s8, plan :func:`qmm_plan`), :func:`fused_quantized_matmul`
quantizes float activations inside the kernel (``mma.sync`` s8, plan
:func:`fqmm_plan`). Both are bound by the bytes of the weights, which
they stream once: the plans split K until the grid fills the card in
one wave, and the two-pass kernel takes 128-row tiles where M > 64, so
at VGG-16's fc6 (M=128, K=25088, the path every Dense past
``_FUSED_MAX_K`` takes) one row tile covers the batch and no weight
byte is fetched twice. Beside each kernel is its plain PyTorch version,
which sums the integer products in float64 (exact) and applies the same
f32 epilogue, so kernel and plain version agree bit for bit.

The per-image activation quantization of :func:`quantized_conv2d` stays
plain PyTorch, as it is XLA in the JAX package; its integer conv goes
through :func:`zoo_tpu_torch.ops.kernels.conv.conv2d_int8`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from zoo_tpu_torch.common import knobs
from zoo_tpu_torch.ops.kernels import _launch as L

# kernel launches since the last reset (see ops.kernels.launch_counts)
QMM_LAUNCHES = 0
FQMM_LAUNCHES = 0
_fns = None

# Past this K the JAX package's fused kernel would crowd its VMEM and the
# two-pass path takes over (quant.py:119); the port keeps the same branch.
# It also keeps the int32 sums exact: 127 * 127 * 8192 << 2**31.
_FUSED_MAX_K = 8192


# the fused kernel's tiles (csrc/quant_matmul.cu, fq::): output rows and
# columns of a tile, K depth of a chunk, ring slots; at most 8 CTAs (the
# portable cluster size) split K, until the grid reaches FQMM_TARGET_CTAS
FQMM_BM, FQMM_BN, FQMM_BK, FQMM_STAGES = 64, 128, 64, 5
FQMM_MAX_CTAS, FQMM_TARGET_CTAS = 8, 128


class FqmmPlan(NamedTuple):
    """Launch plan of the fused int8 GEMM: ``ctas`` CTAs (a cluster)
    split K for each 64 x 128 output tile, each taking ``k_slice``
    columns of x; ``stages`` ring slots; ``x_vec`` and ``w_vec`` bytes a
    copy of x and w (16, 8 or 4 by ``cp.async``; 0: element copies);
    ``smem`` bytes of dynamic shared memory; ``blocks`` CTAs in the
    grid."""
    ctas: int
    k_slice: int
    stages: int
    x_vec: int
    w_vec: int
    smem: int
    blocks: int


@functools.lru_cache(maxsize=256)
def fqmm_plan(m: int, k: int, n: int, x_itemsize: int = 4,
              x_align: int = 16, w_align: int = 16) -> FqmmPlan:
    """The fused kernel's plan for (m, k) x (k, n), x elements of
    ``x_itemsize`` bytes (4 f32, 2 bf16), x and w pointers aligned to
    ``x_align`` and ``w_align`` bytes.

    - K split: CTAs per output tile double (1, 2, 4, 8) while the grid
      is under 128 CTAs and every CTA keeps at least one 64-deep chunk;
      each takes ``k_slice`` columns, a multiple of 64.
    - Copies: the widest of 16, 8 and 4 bytes that divides a row (of x:
      k elements; of w: n bytes) and the pointer, else element copies.
    - Shared memory, as the kernel lays it out: the ring (per slot a
      64 x 64 x chunk and a 64 x 128 w chunk), which the int32 C tile
      (rows padded by 16 bytes) overwrites at the end; the int8 x chunk;
      the rows' partial absmax, scales and reciprocal scales (f32).
    """
    if min(m, k, n) < 1:
        raise ValueError(f"empty int8 GEMM ({m}, {k}) x ({k}, {n})")
    if x_itemsize not in (2, 4):
        raise ValueError(f"x elements of {x_itemsize} bytes: the kernel "
                         "takes f32 or bf16")
    tiles = -(-m // FQMM_BM) * -(-n // FQMM_BN)
    chunks = -(-k // FQMM_BK)
    ctas = 1
    while (ctas < FQMM_MAX_CTAS and tiles * ctas < FQMM_TARGET_CTAS
           and 2 * ctas <= chunks):
        ctas *= 2
    k_slice = -(-chunks // ctas) * FQMM_BK
    ring = FQMM_STAGES * (FQMM_BM * FQMM_BK * x_itemsize
                          + FQMM_BK * FQMM_BN)
    c_tile = FQMM_BM * (FQMM_BN + 4) * 4
    smem = max(ring, c_tile) + FQMM_BM * FQMM_BK + 3 * FQMM_BM * 4
    return FqmmPlan(ctas, k_slice, FQMM_STAGES,
                    L.copy_bytes(k * x_itemsize, x_align),
                    L.copy_bytes(n, w_align), smem, tiles * ctas)


# the two-pass kernel's tiles (csrc/quant_matmul.cu, qm::): 128 output
# rows where M > 64, else 64; 128 columns; 128-deep chunks; ring slots by
# tile rows, beside two K-major w chunks and 1 KB to align the ring
QMM_BN, QMM_BK = 128, 128
QMM_STAGES = {64: 7, 128: 5}


class QmmPlan(NamedTuple):
    """Launch plan of the two-pass int8 GEMM: ``bm`` rows (64 or 128)
    and 128 columns a tile, ``ctas`` CTAs (a cluster) splitting K for
    it, each taking ``k_slice`` columns of x; ``stages`` ring slots;
    ``x_vec`` and ``w_vec`` bytes a copy of x and w (16, 8 or 4 by
    ``cp.async``; 0: element copies); ``smem`` bytes of dynamic shared
    memory; ``blocks`` CTAs in the grid."""
    bm: int
    ctas: int
    k_slice: int
    stages: int
    x_vec: int
    w_vec: int
    smem: int
    blocks: int


def qmm_smem(bm: int) -> int:
    """Shared memory of the two-pass kernel's ``bm``-row tiles: the ring
    (per slot a bm x 128 x chunk and a 128 x 128 w chunk as it lies),
    two w chunks turned K-major, 1 KB to align the ring; the int32 C
    tile goes over the ring at the end."""
    return 1024 + QMM_STAGES[bm] * (bm + QMM_BN) * QMM_BK \
        + 2 * QMM_BN * QMM_BK


def _qmm_split(tiles: int, chunks: int, clusters) -> int:
    """CTAs a cluster (1 .. 8) for ``tiles`` output tiles over ``chunks``
    128-deep chunks: the most CTAs in one wave, every cluster resident
    at once (``clusters[c - 1]`` of c CTAs fit the card) and every CTA
    with at least one chunk."""
    best = 1
    for c in range(2, FQMM_MAX_CTAS + 1):
        slice_ = -(-chunks // c)
        if (tiles * c <= clusters[0] and tiles <= clusters[c - 1]
                and (c - 1) * slice_ < chunks):
            best = c
    return best


@functools.lru_cache(maxsize=256)
def qmm_plan(m: int, k: int, n: int, x_align: int = 16,
             w_align: int = 16, *, clusters: Tuple[int, ...]) -> QmmPlan:
    """The two-pass kernel's plan for (m, k) int8 x (k, n) int8, x and w
    pointers aligned to ``x_align`` and ``w_align`` bytes, on a card
    that runs ``clusters[c - 1]`` clusters of c CTAs at once (the card's
    counts: :func:`cluster_limits`).

    - Tiles: 128 rows where m > 64 (at M = 128 one tile covers the
      batch, so each weight byte is fetched once), else 64; 128 columns.
    - K split: the cluster size that puts the most CTAs in one wave
      (:func:`_qmm_split`); each CTA takes ``k_slice`` columns, a
      multiple of 128. At VGG-16's fc6 (M=128, K=25088, N=4096): 32
      tiles in clusters of 3, 96 CTAs, where 4 would leave 2 of the 32
      clusters to a second wave.
    - Copies: the widest of 16, 8 and 4 bytes that divides a row (of x:
      k bytes; of w: n bytes) and the pointer, else element copies; the
      x copies land straight in the A tile.
    - Shared memory: :func:`qmm_smem` (the kernel derives the ring
      slots and the bytes from ``bm``; the plan keeps them for the fit
      checks).

    K has no limit: the int32 sums are exact for any int8 data while K
    * 128 * 128 < 2**31 (K <= 131071) and, past that, wherever the data
    keep them in range; beyond it they wrap, as the JAX kernel's int32
    sums do.
    """
    if min(m, k, n) < 1:
        raise ValueError(f"empty int8 GEMM ({m}, {k}) x ({k}, {n})")
    bm = 128 if m > 64 else 64
    chunks = -(-k // QMM_BK)
    tiles = -(-m // bm) * -(-n // QMM_BN)
    ctas = _qmm_split(tiles, chunks, clusters)
    return QmmPlan(bm, ctas, -(-chunks // ctas) * QMM_BK, QMM_STAGES[bm],
                   L.copy_bytes(k, x_align), L.copy_bytes(n, w_align),
                   qmm_smem(bm), tiles * ctas)


def _entries():
    global _fns
    if _fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("quant_matmul")
        qmm, fqmm = lib.zt_quantized_matmul, lib.zt_fused_quantized_matmul
        qmm.argtypes = [L.P] * 5 + [L.I] * 9 + [L.P]
        fqmm.argtypes = [L.P, L.I, L.P, L.P, L.P] + [L.I] * 10 + [L.P]
        lib.zt_quantized_matmul_clusters.argtypes = [L.I] * 2
        qmm.restype = fqmm.restype = L.I
        lib.zt_quantized_matmul_clusters.restype = L.I
        _fns = (lib, qmm, fqmm)
    return _fns


def cluster_limits(device: torch.device) -> Tuple[int, ...]:
    """Clusters of 1 .. 8 CTAs of the two-pass kernel that CUDA
    ``device`` runs at once (128-row tiles' shared memory; 64-row ones
    also take one CTA an SM), as the CUDA runtime counts them."""
    index = device.index
    return _cluster_limits(torch.cuda.current_device() if index is None
                           else index)


@functools.lru_cache(maxsize=None)
def _cluster_limits(index: int) -> Tuple[int, ...]:
    lib = _entries()[0]
    with torch.cuda.device(index):
        out = tuple(lib.zt_quantized_matmul_clusters(128, c)
                    for c in range(1, FQMM_MAX_CTAS + 1))
    if min(out) < 1:
        raise RuntimeError(f"cluster occupancy query failed: {out}")
    return out


def absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``1`` where ``amax == 0``, else ``amax / 127`` in ``amax``'s dtype,
    by IEEE division on every device: PyTorch's CUDA kernels multiply by
    the reciprocal of a Python-number divisor, which can differ in the
    last bit, so the divisor is a tensor."""
    return torch.where(amax == 0, 1.0, amax / torch.full_like(amax, 127.0))


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization along ``axis``: ``(values
    int8, scale f32)`` with ``scale`` shaped like ``x`` reduced over
    ``axis`` (keepdim), ``x ~ values * scale``. The absmax and its
    division by 127 run in ``x``'s dtype and widen to f32 after, and
    ``torch.round`` is half-to-even, as the JAX package computes them."""
    scale = absmax_scale(x.abs().amax(dim=axis, keepdim=True)).float()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantized_matmul_plain(x_q, w_q, x_scale, w_scale,
                           out_dtype=torch.float32) -> torch.Tensor:
    """The plain version of :func:`quantized_matmul`: the integer sums in
    float64 (exact), then ``f32(acc) * x_scale[row] * w_scale[col]``.
    ``x_q`` may carry its int8-range values in a float dtype."""
    m, n = x_q.shape[0], w_q.shape[1]
    acc = (x_q.double() @ w_q.double()).float()
    y = acc * x_scale.reshape(m, 1).float() * w_scale.reshape(1, n).float()
    return y.to(out_dtype)


def _scales(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n).float().contiguous()


def quantized_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                     x_scale: torch.Tensor, w_scale: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) ``out_dtype`` (f32 or bf16)
    with the dequant fused: ``x_scale`` (M, 1) or (M,) per row,
    ``w_scale`` (1, N) or (N,) per output channel.

    CPU tensors take :func:`quantized_matmul_plain`; CUDA tensors launch
    the kernel once, with the plan :func:`qmm_plan` counts (or raise)."""
    global QMM_LAUNCHES
    m, k = x_q.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"shapes {tuple(x_q.shape)} @ {tuple(w_q.shape)}")
    if x_q.device.type == "cpu":
        return quantized_matmul_plain(x_q, w_q, x_scale, w_scale, out_dtype)
    dev = x_q.device
    xs, ws = _scales(x_scale, m), _scales(w_scale, n)
    L.require(x_q, "x_q", dev, (torch.int8,), (m, k))
    L.require(w_q, "w_q", dev, (torch.int8,), (k, n))
    L.require(xs, "x_scale", dev, (torch.float32,))
    L.require(ws, "w_scale", dev, (torch.float32,))
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes f32 or "
                        "bf16")
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    p = qmm_plan(m, k, n, L.alignment(x_q), L.alignment(w_q),
                 clusters=cluster_limits(dev))
    lib, qmm, _ = _entries()
    rc = qmm(L.ptr(x_q), L.ptr(w_q), L.ptr(xs), L.ptr(ws), L.ptr(y),
             L.DTYPE_CODES[out_dtype], m, k, n, p.bm, p.ctas, p.k_slice,
             p.x_vec, p.w_vec, L.stream(dev))
    L.check(lib, rc, "quantized_matmul")
    QMM_LAUNCHES += 1
    return y


def fused_quantized_matmul_plain(x, w_q, w_scale, out_dtype=None
                                 ) -> torch.Tensor:
    """The plain version of :func:`fused_quantized_matmul`: ``x`` widened
    to f32, per-row absmax over the full K, ``q = clamp(round(x /
    scale), -127, 127)``, then :func:`quantized_matmul_plain`."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    scale = absmax_scale(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return quantized_matmul_plain(q, w_q, scale, w_scale, out_dtype)


def fused_quantized_matmul(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor, out_dtype=None
                           ) -> torch.Tensor:
    """(M, K) float @ (K, N) int8 -> (M, N) in one kernel: per-row
    activation quantization, the int8 product and the dequant epilogue,
    with no int8 copy of ``x`` in device memory. ``out_dtype`` defaults
    to ``x``'s. Past ``_FUSED_MAX_K`` it takes the two-pass path
    (:func:`quantize_int8` + :func:`quantized_matmul`), as the JAX
    package does.

    CPU tensors take :func:`fused_quantized_matmul_plain`; CUDA tensors
    launch the kernel once, with the plan :func:`fqmm_plan` counts (or
    raise)."""
    global FQMM_LAUNCHES
    m, k = x.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w_q.shape)}")
    out_dtype = out_dtype or x.dtype
    if k > _FUSED_MAX_K:
        x_q, x_scale = quantize_int8(x, axis=-1)
        return quantized_matmul(x_q, w_q, x_scale, w_scale,
                                out_dtype=out_dtype)
    if x.device.type == "cpu":
        return fused_quantized_matmul_plain(x, w_q, w_scale, out_dtype)
    dev = x.device
    ws = _scales(w_scale, n)
    L.require(x, "x", dev, (torch.float32, torch.bfloat16), (m, k))
    L.require(w_q, "w_q", dev, (torch.int8,), (k, n))
    L.require(ws, "w_scale", dev, (torch.float32,))
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes f32 or "
                        "bf16")
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    p = fqmm_plan(m, k, n, x.element_size(), L.alignment(x),
                  L.alignment(w_q))
    lib, _, fqmm = _entries()
    rc = fqmm(L.ptr(x), L.DTYPE_CODES[x.dtype], L.ptr(w_q), L.ptr(ws),
              L.ptr(y), L.DTYPE_CODES[out_dtype], m, k, n, p.ctas,
              p.k_slice, p.stages, p.x_vec, p.w_vec, p.smem, L.stream(dev))
    L.check(lib, rc, "fused_quantized_matmul")
    FQMM_LAUNCHES += 1
    return y


def resolve_int8_matmul(impl: Optional[str] = None) -> str:
    """The one int8-GEMM dispatch rule: ``"fused"`` (one kernel:
    quantize, product, dequant) or ``"unfused"`` (a quantize pass, then
    :func:`quantized_matmul`). ``impl=None`` reads ``ZOO_INT8_MATMUL``
    (``auto`` -> fused)."""
    impl = impl or knobs.value("ZOO_INT8_MATMUL")
    if impl == "auto":
        return "fused"
    if impl not in ("fused", "unfused"):
        raise ValueError(f"unknown int8 matmul impl {impl!r} "
                         "(expected auto|fused|unfused)")
    return impl


def quantized_dense(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """f32/bf16 activations (..., K) x int8 weights (K, N): per-row
    dynamic activation quantization and the int8 product, backend chosen
    by :func:`resolve_int8_matmul`. The output has ``x``'s dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    if resolve_int8_matmul(impl) == "fused":
        y = fused_quantized_matmul(x2, w_q, w_scale, out_dtype=x.dtype)
    else:
        x_q, x_scale = quantize_int8(x2, axis=-1)
        y = quantized_matmul(x_q, w_q, x_scale, w_scale, out_dtype=x.dtype)
    if bias is not None:
        y = y + bias
    return y.reshape(*x.shape[:-1], w_q.shape[1])


def quantize_conv_weights(w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO conv weights -> (int8 HWIO, per-output-channel scale (O,))."""
    kh, kw, ci, o = w.shape
    flat_q, scale = quantize_int8(w.reshape(kh * kw * ci, o), axis=0)
    return flat_q.reshape(w.shape), scale.reshape(o)


def quantized_conv2d(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, strides=(1, 1),
                     padding: str = "SAME",
                     bias: Optional[torch.Tensor] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """f32/bf16 NHWC activations x int8 HWIO weights: per-image dynamic
    activation quantization (plain PyTorch, f32), then the int8 conv of
    :func:`~zoo_tpu_torch.ops.kernels.conv.conv2d_int8` with its dequant
    epilogue, then the bias in f32; the output has ``x``'s dtype. On a
    CUDA device the kernel reads the weights' K-major copy, the one
    ``quantize_model`` attached (made here once if none was)."""
    from zoo_tpu_torch.ops.kernels.conv import (
        attach_kmajor,
        conv2d_int8,
        pallas_conv_supported,
    )

    xf = x.float()
    x_scale = absmax_scale(xf.abs().amax(dim=(1, 2, 3), keepdim=True))
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    w_kmajor = None
    if w_q.device.type == "cuda" and pallas_conv_supported(
            tuple(w_q.shape[:2]), tuple(strides)):
        w_kmajor = attach_kmajor(w_q)
    y = conv2d_int8(x_q, w_q, x_scale, w_scale.float(),
                    strides=tuple(strides), padding=padding, impl=impl,
                    w_kmajor=w_kmajor)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
