"""The port's training kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels under the interpreter, as the JAX package's own
tests do. Inputs are drawn with numpy from a seed and handed to both.

Tolerances: 1e-5 absolute on the flash-attention gradients (f32 sums of
at most ~60 O(1) products per element, in another order), one bf16 ulp
of the largest gradient for bf16 inputs (both round p and ds to bf16 at
the same points and the outputs once; an f32 sum in another order may
round either side of a tie); 1e-6
absolute on the optimizer updates (the same f32 elementwise math; the
bias corrections are computed in f32 by both).
"""

import importlib

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
# the module (the package re-exports its function under the same name)
jfa = importlib.import_module("zoo_tpu.ops.pallas.flash_attention")

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


@pytest.mark.parametrize("tq,tk", [
    (21, 21),     # T not a multiple of the 8-row block
    (37, 37),
    (13, 45),     # end-aligned causal, Tq < Tk
    (45, 13),     # Tq > Tk: the first 32 rows see no column (lse -inf)
])
def test_flash_backward_bf16_matches_pallas(tq, tk):
    """bf16 inputs at rep 3 (H=6, Hkv=2), D=64, causal: the plain
    backward against the Pallas kernels in interpret mode, within one
    bf16 ulp of the largest gradient. The plain backward rounds where
    the bf16 tensor-core kernels round on the card (p to bf16 before
    dV, ds before dK and dQ, f32 sums, bf16 outputs); both are fed the
    residuals of the Pallas forward (o and lse), since the port's CPU
    forward is the dense path, whose lse comes from bf16 scores. The
    tolerance alone does not see a missing rounding point (the sums
    average it out), so at least 95 % of each gradient's elements must
    also equal JAX's bit for bit."""
    rs = np.random.RandomState(tq * 31 + tk)
    B, h, hkv, D, blk = 2, 6, 2, 64, 8
    q, do = (rs.randn(B, h, tq, D).astype(np.float32) for _ in "ab")
    k, v = (rs.randn(B, hkv, tk, D).astype(np.float32) for _ in "ab")
    bf = jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(bf) for a in (q, k, v, do))

    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=True,
                                            block_q=blk, block_k=blk,
                                            interpret=True), jq, jk, jv)
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    o, lse = jfa._fwd(*(jfa._pad_to(a.reshape(-1, a.shape[2], D), 1, blk)
                        for a in (jq, jk, jv)), D ** -0.5, True, tk, tq,
                      blk, blk, h, hkv, True)

    def tb(a):
        return T(np.array(jnp.asarray(a).astype(jnp.float32))).to(
            torch.bfloat16)

    got = tflash.flash_attention_bwd_plain(
        tb(jq), tb(jk), tb(jv), tb(o[:, :tq]).reshape(B, h, tq, D),
        T(np.array(lse[:, :tq])).reshape(B, h, tq), tb(jdo), causal=True)
    for name, a, want in zip("qkv", got, ref):
        assert a.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        got_ = a.float().numpy()
        np.testing.assert_allclose(got_, want, rtol=0, atol=ulp,
                                   err_msg=f"d{name}")
        # the rounding points themselves: readings 0.976 to 1.0 here (dq
        # lower: its first rows are f32 cancellation noise in both);
        # without the bf16 rounding of p and ds 0.60 to 0.89
        assert np.mean(got_ == want) >= 0.95, f"d{name}"


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
    out = topt.fused_apply_adam(tp, T(g), tm, tv,
                                torch.tensor(step, dtype=torch.int32), 1e-2,
                                beta1=0.9, beta2=0.999, eps=1e-6,
                                weight_decay=wd)
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
    got = topt.reference_apply_adam(*(T(a) for a in (p, g, m, v)),
                                    torch.tensor(3, dtype=torch.int32), 2e-3,
                                    weight_decay=0.01)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_bias_corrections_are_f32():
    bc1, bc2 = topt.bias_corrections(10, 0.9, 0.999)
    want1 = np.float32(1) / (np.float32(1) - np.float32(0.9) ** np.float32(10))
    assert bc1 == float(want1)
    assert np.float32(bc2) == bc2


@pytest.mark.parametrize("beta", [0.9, 0.999])
def test_bias_corrections_within_an_ulp_of_jax(beta):
    """The port's bias correction (the power in double, rounded once)
    against the JAX kernel's ``1 / (1 - jnp.float32(beta) ** step)`` at
    every step from 1 to 100000: at most one f32 ulp apart (XLA's f32
    power is not correctly rounded at every step). The device version
    of a CPU step tensor equals the host function bit for bit."""
    steps = np.arange(1, 100001)
    host = np.array([topt.bias_corrections(int(t), beta, beta)[0]
                     for t in steps], np.float32)
    dev = topt.device_bias_corrections(
        torch.from_numpy(steps.astype(np.int32)), beta, beta)[0].numpy()
    np.testing.assert_array_equal(dev, host)
    want = np.asarray(1.0 / (1.0 - jnp.float32(beta)
                             ** jnp.asarray(steps, jnp.float32)), np.float32)
    ulps = np.abs(host.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, steps[ulps > 1][:10]
    print(f"beta {beta}: {int((ulps > 0).sum())} of {len(steps)} steps one "
          f"ulp off JAX's, at {steps[ulps > 0][:10].tolist()}")
