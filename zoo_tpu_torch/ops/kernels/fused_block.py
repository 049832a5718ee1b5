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

# the plan's shared memory, the one count of the kernel's layout (which
# takes it as an argument): zt_gemm.cuh's FloatTile (f32 a[32][65] and
# b[32][64]) + t1 and t2 in bf16, under the H100's 227 KB a block may use
_STAGING_BYTES = 4 * (32 * 65 + 32 * 64)
MAX_SMEM = 232448


def _entries():
    global _fns
    if _fns is None:
        from zoo_tpu_torch.ops.kernels._build import library
        lib = library("fused_block")
        fn = lib.zt_fused_bottleneck
        fn.argtypes = [L.P] * 5 + [L.I] * 9 + [L.P]
        fn.restype = L.I
        _fns = (lib, fn)
    return _fns


def _side_tile(n: int) -> int:
    """The output tile along a side of ``n`` pixels: 8 where ``n`` is a
    multiple of 8, else 7 where it is one of 7, else min(n, 8)."""
    if n % 8 == 0:
        return 8
    if n % 7 == 0:
        return 7
    return min(n, 8)


def plan(h: int, w: int, cmid: int) -> Tuple[int, int, int]:
    """``(th, tw, shared-memory bytes)`` of the kernel's plan."""
    th, tw = _side_tile(h), _side_tile(w)
    return th, tw, _STAGING_BYTES + ((th + 2) * (tw + 2) + th * tw) * \
        cmid * 2


def fused_bottleneck_supported(h: int, w: int, cin: int, cmid: int) -> bool:
    """True when the kernel's plan for an (h, w) image with ``cin`` ->
    ``cmid`` channels fits a block's shared memory. ``cin`` bounds
    nothing: the kernel walks it in slices."""
    if min(h, w, cin, cmid) <= 0:
        return False
    return plan(h, w, cmid)[2] <= MAX_SMEM


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


def _launch(x, w1, w2, w3) -> torch.Tensor:
    global LAUNCHES
    b, h, w, cin = x.shape
    cmid = w1.shape[1]
    if not fused_bottleneck_supported(h, w, cin, cmid):
        raise ValueError(f"fused_bottleneck: {h}x{w} {cin}->{cmid} is "
                         "outside the kernel's envelope (its plan needs "
                         f"{plan(h, w, cmid)[2]} B of shared memory, a "
                         f"block has {MAX_SMEM})")
    dev = x.device
    L.require(x, "x", dev, (torch.float32, torch.bfloat16))
    ws = [t.to(torch.bfloat16).contiguous() for t in (w1, w2, w3)]
    for name, t, shape in (("w1", ws[0], (cin, cmid)),
                           ("w2", ws[1], (3, 3, cmid, cmid)),
                           ("w3", ws[2], (cmid, cin))):
        L.require(t, name, dev, (torch.bfloat16,), shape)
    th, tw, smem = plan(h, w, cmid)
    y = torch.empty_like(x)
    lib, fn = _entries()
    rc = fn(L.ptr(x), *(L.ptr(t) for t in ws), L.ptr(y),
            L.DTYPE_CODES[x.dtype], b, h, w, cin, cmid, th, tw, smem,
            L.stream(dev))
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
