"""The port's training kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels under the interpreter, as the JAX package's own
tests do. Inputs are drawn with numpy from a seed and handed to both.

Tolerances: 1e-5 absolute on the flash-attention gradients (f32 sums of
at most ~60 O(1) products per element, in another order); 1e-6
absolute on the optimizer updates (the same f32 elementwise math; the
bias corrections are computed in f32 by both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.ops.pallas import fused_optim as jopt
from zoo_tpu.ops.pallas.flash_attention import flash_attention as jflash

from zoo_tpu_torch.ops.attention import dense_attention
from zoo_tpu_torch.ops.kernels import flash_attention as tflash
from zoo_tpu_torch.ops.kernels import fused_optim as topt

jax.config.update("jax_platforms", "cpu")

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fused optimizer takes its elementwise path under an active
    multi-device mesh; an orca context left by another test must not
    switch these comparisons off the kernel."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


# ---------------------------------------------------- flash backward

@pytest.mark.parametrize("causal,h,hkv,tq,tk", [
    (True, 3, 3, 21, 21),     # MHA (rep 1), T not a multiple of the block
    (True, 4, 2, 21, 21),     # GQA rep 2
    (False, 6, 2, 13, 13),    # rep 3, no mask
    (True, 6, 2, 7, 19),      # end-aligned causal, Tq < Tk
    (False, 2, 1, 19, 7),     # Tq > Tk, no mask
])
def test_flash_backward_matches_pallas(causal, h, hkv, tq, tk):
    rs = np.random.RandomState(tq * 31 + tk + h * 7 + hkv)
    B, D = 2, 16
    q = rs.randn(B, h, tq, D).astype(np.float32)
    k = rs.randn(B, hkv, tk, D).astype(np.float32)
    v = rs.randn(B, hkv, tk, D).astype(np.float32)
    do = rs.randn(B, h, tq, D).astype(np.float32)

    # 8-row blocks: several q and k blocks, the last one ragged
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=causal,
                                            block_q=8, block_k=8,
                                            interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    qt, kt, vt = (T(a).requires_grad_() for a in (q, k, v))
    tflash.FlashAttention.apply(qt, kt, vt, causal, None).backward(T(do))
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,h,hkv,tq,tk", [
    (True, 6, 2, 20, 20), (False, 4, 4, 7, 13), (True, 6, 3, 9, 30)])
def test_flash_backward_plain_matches_dense_autograd(causal, h, hkv, tq,
                                                     tk):
    """The explicit recomputation against a third witness, autograd of
    the dense path."""
    rs = np.random.RandomState(h + tq)
    q, do = (T(rs.randn(2, h, tq, 16).astype(np.float32)) for _ in "ab")
    k, v = (T(rs.randn(2, hkv, tk, 16).astype(np.float32)) for _ in "ab")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    dense_attention(*leaves, causal=causal)[0].backward(do)
    o, lse = tflash.flash_attention_fwd(q, k, v, causal=causal)
    got = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for name, a, b in zip("qkv", got, leaves):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), atol=1e-5,
                                   err_msg=f"d{name}")


def test_flash_backward_empty_rows_have_no_gradient():
    """A row whose lse is -inf (no live column) contributes nothing, as
    the Pallas kernels' ``safe_lse`` guard makes it."""
    rs = np.random.RandomState(0)
    q, k, v, do = (T(rs.randn(1, 2, 5, 16).astype(np.float32))
                   for _ in range(4))
    o, lse = tflash.flash_attention_fwd(q, k, v, causal=True)
    lse[:, :, 0] = -float("inf")
    dq, dk, dv = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    assert torch.all(dq[:, :, 0] == 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_flash_attention_is_differentiable_and_counts_no_cpu_launch():
    """CPU tensors take the plain versions: gradients flow, no kernel
    launch is counted."""
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    tflash.flash_attention(q, q, q, causal=True).sum().backward()
    assert q.grad is not None and float(q.grad.abs().sum()) > 0
    assert all(n == 0 for n in launch_counts().values())


# ---------------------------------------------------- fused optimizers

SHAPES = [(37,), (5, 129), (3, 4, 50)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("step", [1, 7])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_matches_pallas(shape, step, wd):
    rs = np.random.RandomState(len(shape) * 10 + step)
    p, g = (rs.randn(*shape).astype(np.float32) for _ in "ab")
    m = (0.1 * rs.randn(*shape)).astype(np.float32)
    v = np.abs(0.01 * rs.randn(*shape)).astype(np.float32)
    ref = jopt.fused_apply_adam(*(jnp.asarray(a) for a in (p, g, m, v)),
                                step, 1e-2, beta1=0.9, beta2=0.999,
                                eps=1e-6, weight_decay=wd, interpret=True)
    tp, tm, tv = T(p.copy()), T(m.copy()), T(v.copy())
    out = topt.fused_apply_adam(tp, T(g), tm, tv, step, 1e-2, beta1=0.9,
                                beta2=0.999, eps=1e-6, weight_decay=wd)
    assert out[0] is tp and out[1] is tm and out[2] is tv   # in place
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.01)])
def test_fused_sgd_matches_pallas(shape, momentum, wd):
    rs = np.random.RandomState(len(shape))
    p, g, b = (rs.randn(*shape).astype(np.float32) for _ in "abc")
    ref = jopt.fused_apply_sgd(jnp.asarray(p), jnp.asarray(g),
                               jnp.asarray(b), 0.05, momentum=momentum,
                               weight_decay=wd, interpret=True)
    tp, tb = T(p.copy()), T(b.copy())
    out = topt.fused_apply_sgd(tp, T(g), tb, 0.05, momentum=momentum,
                               weight_decay=wd)
    assert out[0] is tp and out[1] is tb
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_reference_adam_matches_jax_reference():
    """The plain version against the JAX package's own plain version."""
    rs = np.random.RandomState(4)
    p, g, m = (rs.randn(300).astype(np.float32) for _ in "abc")
    v = np.abs(rs.randn(300)).astype(np.float32)
    ref = jopt.reference_apply_adam(*(jnp.asarray(a) for a in (p, g, m, v)),
                                    3, 2e-3, weight_decay=0.01)
    got = topt.reference_apply_adam(*(T(a) for a in (p, g, m, v)), 3, 2e-3,
                                    weight_decay=0.01)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_bias_corrections_are_f32():
    bc1, bc2 = topt.bias_corrections(10, 0.9, 0.999)
    want1 = np.float32(1) / (np.float32(1) - np.float32(0.9) ** np.float32(10))
    assert bc1 == float(want1)
    assert np.float32(bc2) == bc2
