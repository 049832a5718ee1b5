"""The fused ResNet identity bottleneck (counterpart of
``zoo_tpu/ops/pallas/fused_block.py``).

``relu(x + expand(relu(conv3x3(relu(reduce(x))))))`` in one kernel,
``zoo_tpu_torch/csrc/fused_block.cu`` (its header gives the plan and
what bounds it): x (B, H, W, Cin) f32 or bf16 is read once and y
written once; t1 and t2 stay in shared memory. The weights are w1
(Cin, Cmid), w2 (3, 3, Cmid, Cmid) HWIO and w3 (Cmid, Cin), cast to
bf16 as the Pallas kernel casts them.

- :func:`bottleneck_reference` is the XLA composition ``_xla_block``:
  three convs in x's dtype, the ReLUs and the residual add.
- :func:`fused_bottleneck_plain` is the kernel's plain version, with its
  rounding points.
- :class:`FusedBottleneck` is the autograd function: the kernel (CUDA
  tensors) or its plain version (CPU tensors) forward; the backward
  recomputes :func:`bottleneck_reference` and takes its gradients, as
  the JAX ``custom_vjp`` does, since the kernel writes only y.
- :func:`fused_bottleneck` is the public op. Its dispatch mirrors the
  JAX op's fallback to the composition on a geometry outside the plan,
  counted as ``fused_bottleneck_reference`` in ``launch_counts()``; it
  never falls back because a build or a launch failed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from zoo_tpu_torch.common.device import resolve_device
from zoo_tpu_torch.ops.kernels import _launch as L
from zoo_tpu_torch.ops.kernels.conv import _conv_nhwc
from zoo_tpu_torch.ops.kernels.conv import _no_tf32 as conv_no_tf32

__all__ = ["bottleneck_reference", "fused_bottleneck",
           "fused_bottleneck_plain", "fused_bottleneck_supported",
           "FusedBottleneck"]

# kernel launches and reference dispatches since the last reset (see
# ops.kernels.launch_counts)
LAUNCHES = 0
REFERENCE_DISPATCHES = 0
_fns = None

# the kernel's fixed shape (csrc/fused_block.cu): 8 warps, each on a
# 32 x 64 output tile of a product; 64 channels of x in a reduce k-slice;
# the shared memory an H100 block may use
WARPS, WARP_ROWS, WARP_COLS, REDUCE_SLICE = 8, 32, 64, 64
MAX_SMEM = 232448
_SIDES = (7, 8, 14, 16)


def _entries():
    global _fns
    if _fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("fused_block")
        fn = lib.zt_fused_bottleneck
        fn.argtypes = [L.P] * 7 + [L.I] * 13 + [L.P]
        fn.restype = L.I
        _fns = (lib, fn)
    return _fns


def padded_cmid(cmid: int) -> int:
    """Cmid as the kernel takes it: 16, 32 or a multiple of 64, so a
    t1/t2 row is 2, 4 or a multiple of 8 swizzled 16-byte units (the
    wrapper pads the weights with zeros)."""
    return 16 if cmid <= 16 else 32 if cmid <= 32 else -(-cmid // 64) * 64


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Launch plan of the fused bottleneck kernel: the output tile
    ``th`` x ``tw`` (``tiles`` of them cover the image), ``warps`` a
    block, ``wn`` the warps across N in the reduce, 3x3 and expand
    products, ``stages`` ring slots, ``smem`` bytes of dynamic shared
    memory, ``cmid`` the padded Cmid, ``items`` the k-slices a block
    runs (its cost)."""
    th: int
    tw: int
    tiles: int
    warps: int
    wn: Tuple[int, int, int]
    stages: int
    smem: int
    cmid: int
    items: int


def _layout(th: int, tw: int, cin: int, cmid: int, wn, stages: int):
    """(items, shared memory) of one tile, as the kernel lays it out: the
    ring (``stages`` slots of the largest item: a band of x rows and a
    w1 slice, or a w2 / w3 slice), t1 on the halo (or the expand's
    staging tile, if larger), t2 on the tile in 32-row steps (or, if
    larger, the reduce's fix-up state that precedes it there: a count,
    the halo rows' norms and room for 256 near ties), then the tile's
    pixel tables (a pixel of x for each halo pixel, of y and a row of t1
    for each output pixel)."""
    p, p1 = th * tw, (th + 2) * (tw + 2)
    kb = min(64, cmid)
    kitems = (-(-cin // REDUCE_SLICE), 9 * (cmid // kb), cmid // kb)
    items, stage, staging = 0, 0, 0
    for ph, (m, n) in enumerate(((p1, cmid), (p, cmid), (p, cin))):
        band = WARP_ROWS * (WARPS // wn[ph])
        chunk = WARP_COLS * wn[ph]
        items += -(-m // band) * -(-n // chunk) * kitems[ph]
        stage = max(stage, band * 128 + REDUCE_SLICE * chunk * 2 if ph == 0
                    else kb * chunk * 2)
        if ph == 2:
            staging = band * (chunk * 2 + 16)
    ties = 16 + -(-4 * p1 // 16) * 16 + 4 * 256
    t1, t2 = p1 * cmid * 2, max(-(-p // 32) * 32 * cmid * 2, ties)
    tables = -(-4 * (p1 + 2 * p) // 16) * 16
    return items, stages * stage + max(t1, staging) + t2 + tables


@functools.lru_cache(maxsize=256)
def _search(h: int, w: int, cin: int, cmid: int) -> Optional[BlockPlan]:
    if min(h, w, cin, cmid) <= 0 or cin % 8:
        return None
    cp = padded_cmid(cmid)
    best, best_key = None, None
    for th in sorted({min(s, h) for s in _SIDES}):
        for tw in sorted({min(s, w) for s in _SIDES}):
            tiles = -(-h // th) * -(-w // tw)
            for wn in itertools.product((1, 2, 4, 8), repeat=3):
                for stages in (3, 2):
                    items, smem = _layout(th, tw, cin, cp, wn, stages)
                    if smem > MAX_SMEM:
                        continue
                    key = (tiles * items, -stages, smem)
                    if best_key is None or key < best_key:
                        best_key = key
                        best = BlockPlan(th, tw, tiles, WARPS, wn, stages,
                                         smem, cp, items)
    return best


def plan(h: int, w: int, cin: int, cmid: int) -> BlockPlan:
    """The kernel's plan for an (h, w) image with ``cin`` -> ``cmid``
    channels: of the tiles with sides 7, 8, 14 or 16 (capped at the
    image), the warps across N of each product and 3 or 2
    ring slots, the one whose shared memory fits a block and whose
    k-slices over the image (tiles x items) are fewest; then more slots,
    then less memory. Larger tiles cut the halo's recompute and re-read
    the weights less; 8 warps of 32 x 64 tiles fill the tensor cores
    best where a product's rows and columns cover them. Raises outside
    the envelope (:func:`fused_bottleneck_supported`)."""
    p = _search(h, w, cin, cmid)
    if p is None:
        raise ValueError(f"fused_bottleneck: {h}x{w} {cin}->{cmid} is "
                         "outside the kernel's envelope (Cin a multiple of "
                         "8, and a plan that fits the "
                         f"{MAX_SMEM} B of shared memory of a block)")
    return p


def fused_bottleneck_supported(h: int, w: int, cin: int, cmid: int) -> bool:
    """True when the kernel takes an (h, w) image with ``cin`` ->
    ``cmid`` channels: ``cin`` a multiple of 8 (x is copied 16 bytes at
    a time) and a plan that fits a block's shared memory."""
    return _search(h, w, cin, cmid) is not None


@contextlib.contextmanager
def _no_tf32():
    """f32 products in full f32 (TF32 off) for matmuls and convs."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with conv_no_tf32():
            yield
    finally:
        matmul.allow_tf32 = prev


def bottleneck_reference(x: torch.Tensor, w1: torch.Tensor,
                         w2: torch.Tensor, w3: torch.Tensor
                         ) -> torch.Tensor:
    """``_xla_block``: 1x1, 3x3 SAME and 1x1 convs in ``x``'s dtype (f32
    sums, TF32 off), the ReLUs and the residual add."""
    cin, cmid = w1.shape
    dt = x.dtype
    none, same = ((0, 0), (0, 0)), ((1, 1), (1, 1))
    t1 = torch.relu(_conv_nhwc(x, w1.reshape(1, 1, cin, cmid), (1, 1),
                               none, dt))
    t2 = torch.relu(_conv_nhwc(t1, w2, (1, 1), same, dt))
    z3 = _conv_nhwc(t2, w3.reshape(1, 1, cmid, cin), (1, 1), none, dt)
    return torch.relu(x + z3)


def fused_bottleneck_plain(x: torch.Tensor, w1: torch.Tensor,
                           w2: torch.Tensor, w3: torch.Tensor
                           ) -> torch.Tensor:
    """The kernel's plain version, rounding where ``_kernel`` rounds:
    f32 products of bf16-rounded operands (TF32 off), t1 and t2 rounded
    to bf16 after their ReLU, the nine taps summed in f32 tap by tap,
    z3 rounded to bf16 and added to bf16 x in bf16; y in x's dtype."""
    b, h, w, cin = x.shape
    cmid = w1.shape[1]
    bf16 = torch.bfloat16

    def f32(t):
        return t.to(bf16).float()
    xb = x.to(bf16).reshape(-1, cin)
    with _no_tf32():
        t1 = torch.relu(xb.float() @ f32(w1)).to(bf16)
        tp = F.pad(t1.reshape(b, h, w, cmid), (0, 0, 1, 1, 1, 1))
        acc = torch.zeros((b * h * w, cmid), dtype=torch.float32,
                          device=x.device)
        for dy in range(3):
            for dx in range(3):
                win = tp[:, dy:dy + h, dx:dx + w, :].reshape(-1, cmid)
                acc = acc + win.float() @ f32(w2[dy, dx])
        t2 = torch.relu(acc).to(bf16)
        z3 = (t2.float() @ f32(w3)).to(bf16)
    y = torch.relu(z3 + xb)
    return y.reshape(b, h, w, cin).to(x.dtype)


def _kernel_weights(w1, w2, w3, cp: int):
    """What the kernel reads of the weights: w1, w2 and w3 in bf16,
    zero-padded to its Cmid ``cp``; w1 transposed (cp, Cin) and the f32
    norms of its rows, w1's columns (the reduce's near-tie fix-up reads
    them); all contiguous and 16-byte aligned."""
    cmid = w1.shape[1]
    ws = [t.to(torch.bfloat16).contiguous() for t in (w1, w2, w3)]
    if cp != cmid:
        pad = cp - cmid
        ws = [F.pad(ws[0], (0, pad)), F.pad(ws[1], (0, pad, 0, pad)),
              F.pad(ws[2], (0, 0, 0, pad))]
    w1t = ws[0].t().contiguous()
    ws += [w1t, torch.linalg.vector_norm(w1t, dim=1, dtype=torch.float32)]
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ws]


def _launch(x, w1, w2, w3) -> torch.Tensor:
    global LAUNCHES
    b, h, w, cin = x.shape
    cmid = w1.shape[1]
    p = plan(h, w, cin, cmid)
    dev = x.device
    L.require(x, "x", dev, (torch.float32, torch.bfloat16))
    for name, t, shape in (("w1", w1, (cin, cmid)),
                           ("w2", w2, (3, 3, cmid, cmid)),
                           ("w3", w3, (cmid, cin))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} has shape {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {dev}")
    ws = _kernel_weights(w1, w2, w3, p.cmid)
    if x.data_ptr() % 16:
        x = x.clone()
    y = torch.empty_like(x)
    lib, fn = _entries()
    rc = fn(L.ptr(x), *(L.ptr(t) for t in ws), L.ptr(y),
            L.DTYPE_CODES[x.dtype], b, h, w, cin, p.cmid, p.th, p.tw,
            *p.wn, p.stages, p.smem, L.stream(dev))
    L.check(lib, rc, "fused_bottleneck")
    LAUNCHES += 1
    return y


class FusedBottleneck(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, its plain version on CPU
    ones. Backward (JAX ``_fused_bottleneck_bwd``): recompute
    :func:`bottleneck_reference` on the saved inputs and return its
    gradients for ``g`` in x's dtype."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3):
        ctx.save_for_backward(x, w1, w2, w3)
        if x.device.type == "cpu":
            return fused_bottleneck_plain(x, w1, w2, w3)
        return _launch(x, w1, w2, w3)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = bottleneck_reference(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g.to(saved[0].dtype)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves)


def _as_tensor(a, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(dev)


def fused_bottleneck(x, w1, w2, w3, impl: Optional[str] = None,
                     device=None) -> torch.Tensor:
    """``relu(x + expand(relu(conv3x3(relu(reduce(x))))))``, fused;
    differentiable (:class:`FusedBottleneck`).

    Tensors run where they lie. Numpy arrays are moved to ``device``
    (default: the current CUDA device; raises without one).

    ``impl``: ``"auto"`` (default) runs the kernel on a CUDA device
    where the geometry lies inside its envelope
    (:func:`fused_bottleneck_supported`) and the composition
    (:func:`bottleneck_reference`) outside it, as the JAX op falls back
    to XLA outside its VMEM plan; on the CPU it runs the kernel's plain
    version at any geometry, as the JAX op interprets its kernel
    off-TPU. ``"kernel"`` raises outside the envelope. Each composition
    taken counts one ``fused_bottleneck_reference`` dispatch; callers
    that want the composition itself call :func:`bottleneck_reference`."""
    global REFERENCE_DISPATCHES
    impl = impl or "auto"
    if impl not in ("auto", "kernel"):
        raise ValueError(f"unknown fused_bottleneck impl {impl!r} "
                         "(expected auto|kernel)")
    args = [x, w1, w2, w3]
    if device is not None or not all(isinstance(a, torch.Tensor)
                                     for a in args):
        dev = resolve_device(device)
        args = [a.to(dev) if isinstance(a, torch.Tensor)
                else _as_tensor(a, dev) for a in args]
    x = args[0]
    _, h, w, cin = x.shape
    cmid = args[1].shape[1]
    supported = fused_bottleneck_supported(h, w, cin, cmid)
    if impl == "kernel" and not supported:
        raise ValueError(f"fused_bottleneck impl='kernel': {h}x{w} "
                         f"{cin}->{cmid} is outside the kernel's envelope")
    if x.device.type != "cpu" and not supported:
        REFERENCE_DISPATCHES += 1
        return bottleneck_reference(*args)
    return FusedBottleneck.apply(*args)
