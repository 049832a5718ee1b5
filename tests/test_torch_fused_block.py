"""The port's fused bottleneck against the JAX package's
(``zoo_tpu/ops/pallas/fused_block.py``).

The JAX op runs its Pallas kernel in interpret mode on the CPU, as its
own tests run it; the port runs the kernel's plain version there.
Inputs are drawn with numpy from a seed and handed to both.

Tolerances: the plain version against the interpreted kernel within one
bf16 step of the largest output, 2**-7 * max|y|, where both round the
same f32 sums of bf16 products and may only land on either side of a
tie (they were bit-equal in every reading); the composition against
``_xla_block`` in f32 within 1e-5 (the same convs summed in another
order); the op's gradients against the JAX ``custom_vjp`` within
``test_pallas.py``'s ``0.01 * max|g| + 0.05``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.ops.pallas import fused_block as jfb

from zoo_tpu_torch.ops.kernels import fused_block as FB
from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

jax.config.update("jax_platforms", "cpu")

# ResNet-50's four identity-bottleneck geometries: (H, W, Cin, Cmid), the
# output tile and the shared memory of the kernel's plan
# (zoo_tpu_torch/csrc/fused_block.cu)
RESNET50 = [((56, 56, 256, 64), (14, 14), 187936),
            ((28, 28, 512, 128), (14, 14), 223776),
            ((14, 14, 1024, 256), (7, 14), 222544),
            ((7, 7, 2048, 512), (7, 7), 214736)]


def _inputs(b, h, w, cin, cmid, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, w, cin).astype(np.float32),
            (rs.randn(cin, cmid) / np.sqrt(cin)).astype(np.float32),
            (rs.randn(3, 3, cmid, cmid) / np.sqrt(9 * cmid))
            .astype(np.float32),
            (rs.randn(cmid, cin) / np.sqrt(cmid)).astype(np.float32))


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 32, 16), (2, 7, 7, 64, 16),
                                   (2, 12, 10, 48, 12)],
                         ids=["test_pallas", "narrow-7x7", "ragged-tiles"])
def test_plain_matches_interpreted_kernel(shape, dtype):
    x, w1, w2, w3 = _inputs(*shape)
    ref = jfb.fused_bottleneck(jnp.asarray(x, getattr(jnp, dtype)),
                               jnp.asarray(w1), jnp.asarray(w2),
                               jnp.asarray(w3), True)
    got = FB.fused_bottleneck_plain(_t(x).to(getattr(torch, dtype)),
                                    _t(w1), _t(w2), _t(w3))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2 ** -7 * np.abs(ref).max())


def test_reference_matches_xla_block():
    x, w1, w2, w3 = _inputs(2, 8, 8, 32, 16, seed=1)
    ref = jfb._xla_block(*(jnp.asarray(a) for a in (x, w1, w2, w3)))
    got = FB.bottleneck_reference(_t(x), _t(w1), _t(w2), _t(w3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_op_gradients_match_jax_custom_vjp():
    """``test_pallas.py``'s gradient case: d/dw of sum(y**2) through the
    op, the port's autograd against the JAX custom_vjp."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, 32).astype(np.float32)
    w1 = (rs.randn(32, 8) * 0.1).astype(np.float32)
    w2 = (rs.randn(3, 3, 8, 8) * 0.1).astype(np.float32)
    w3 = (rs.randn(8, 32) * 0.1).astype(np.float32)

    def loss(a, b, c):
        return jnp.sum(jfb.fused_bottleneck(jnp.asarray(x), a, b, c,
                                            True) ** 2)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(w1),
                                            jnp.asarray(w2),
                                            jnp.asarray(w3))
    leaves = [_t(a).requires_grad_() for a in (w1, w2, w3)]
    y = FB.fused_bottleneck(_t(x), *leaves)
    got = torch.autograd.grad((y ** 2).sum(), leaves)
    for a, b in zip(got, want):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) < 0.01 * scale + 0.05
    # the gradient with respect to x too, against autograd of the
    # composition at the op's own forward output
    xl = _t(x).requires_grad_()
    y = FB.fused_bottleneck(xl, _t(w1), _t(w2), _t(w3))
    (gx,) = torch.autograd.grad((y ** 2).sum(), xl)
    xr = _t(x).requires_grad_()
    (rx,) = torch.autograd.grad(
        FB.bottleneck_reference(xr, _t(w1), _t(w2), _t(w3)), xr,
        2 * y.detach())
    np.testing.assert_allclose(gx.numpy(), rx.numpy(), rtol=0, atol=1e-6)


def test_envelope_holds_resnet50_and_refuses_the_absurd():
    for (h, w, cin, cmid), tile, smem in RESNET50:
        assert FB.fused_bottleneck_supported(h, w, cin, cmid)
        p = FB.plan(h, w, cin, cmid)
        assert ((p.th, p.tw), p.smem) == (tile, smem)
    # the TPU plan's own absurd case is inside the H100 plan (Cmid 512
    # fits at any spatial size); Cmid 1024 is not
    assert jfb._pick_k(128, 112, 112, 2048, 512) == 0
    assert FB.fused_bottleneck_supported(112, 112, 2048, 512)
    assert not FB.fused_bottleneck_supported(112, 112, 4096, 1024)
    assert not FB.fused_bottleneck_supported(0, 8, 32, 16)
    # x is copied 16 bytes at a time: Cin a multiple of 8
    assert not FB.fused_bottleneck_supported(8, 8, 36, 16)
    p = FB.plan(28, 14, 512, 128)
    assert (p.th, p.tw, p.tiles) == (14, 14, 2)
    p = FB.plan(12, 10, 48, 12)
    assert (p.th, p.tw, p.tiles, p.cmid) == (12, 10, 1, 16)


def test_cpu_dispatch_counts_no_launch():
    x, w1, w2, w3 = (_t(a) for a in _inputs(2, 8, 8, 32, 16, seed=2))
    reset_launch_counts()
    y = FB.fused_bottleneck(x, w1, w2, w3)
    counts = launch_counts()
    assert counts["fused_bottleneck"] == 0
    assert counts["fused_bottleneck_reference"] == 0
    assert torch.equal(y, FB.fused_bottleneck_plain(x, w1, w2, w3))
    # on the CPU the plain version runs at any geometry, as the JAX op
    # interprets its kernel whatever its VMEM plan says
    big = [torch.zeros(1, 8, 8, 8), torch.zeros(8, 1024),
           torch.zeros(3, 3, 1024, 1024), torch.zeros(1024, 8)]
    assert not FB.fused_bottleneck_supported(8, 8, 8, 1024)
    assert FB.fused_bottleneck(*big).shape == (1, 8, 8, 8)
    assert launch_counts()["fused_bottleneck_reference"] == 0
    # off the CPU, a geometry outside the envelope takes the composition,
    # counted; tensors on the meta device reach that dispatch without a
    # card (shapes only)
    meta = [t.to("meta") for t in big]
    r = FB.fused_bottleneck(*meta)
    assert r.device.type == "meta" and r.shape == (1, 8, 8, 8)
    assert launch_counts()["fused_bottleneck_reference"] == 1
    with pytest.raises(ValueError, match="envelope"):
        FB.fused_bottleneck(*big, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        FB.fused_bottleneck(x, w1, w2, w3, impl="reference")
    assert launch_counts()["fused_bottleneck"] == 0
    assert launch_counts()["fused_bottleneck_reference"] == 1
    reset_launch_counts()


def test_device_none_raises_without_cuda(monkeypatch):
    arrays = _inputs(1, 8, 8, 32, 16, seed=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FB.fused_bottleneck(*arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        FB.fused_bottleneck(*(_t(a) for a in arrays), device="cuda")
    y = FB.fused_bottleneck(*arrays, device="cpu")
    assert y.device.type == "cpu" and y.shape == (1, 8, 8, 32)
