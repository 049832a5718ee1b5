"""The port's int8 GEMM module against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX functions
(their Pallas kernels in interpret mode) and the port's, whose kernel
wrappers run the kernels' plain versions on CPU tensors.

Tolerances: ``quantize_int8`` and ``quantized_matmul`` are bit-equal
(the same rounding, exact integer sums, the same f32 epilogue).
``fused_quantized_matmul`` is held within one dequantized step: the JAX
kernel may compute ``x / scale`` as ``x * (1 / scale)`` and flip a
rounding tie by one int8 step, which moves an output by at most
``x_scale[row] * w_scale[col] * 127`` (on these inputs it does not
flip, and the outputs are equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.ops.pallas import quant as jquant

from zoo_tpu_torch.ops.kernels import launch_counts, quant

jax.config.update("jax_platforms", "cpu")

BLOCKS = dict(block_m=32, block_n=32, block_k=32)
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _t(a, dtype=None):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _xw(m=24, k=96, n=40, seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, k).astype(np.float32),
            rs.randn(k, n).astype(np.float32))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_int8_matches_jax(jdt, tdt, axis):
    x, _ = _xw()
    x[3] = 0.0                       # an all-zero row: scale 1
    qj, sj = jquant.quantize_int8(jnp.asarray(x, jdt), axis=axis)
    qt, st = quant.quantize_int8(_t(jnp.asarray(x, jdt)), axis=axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_conv_weights_matches_jax():
    w = np.random.RandomState(0).randn(3, 3, 8, 24).astype(np.float32)
    qj, sj = jquant.quantize_conv_weights(jnp.asarray(w))
    qt, st = quant.quantize_conv_weights(_t(w))
    assert qt.shape == (3, 3, 8, 24) and st.shape == (24,)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(24, 96, 40), (128, 64, 10),
                                   (5, 33, 70)])
def test_quantized_matmul_matches_jax_bit_for_bit(out, m, k, n):
    x, w = _xw(m, k, n)
    x_q, x_s = jquant.quantize_int8(jnp.asarray(x), axis=-1)
    w_q, w_s = jquant.quantize_int8(jnp.asarray(w), axis=0)
    ref = jquant.quantized_matmul(x_q, w_q, x_s, w_s,
                                  out_dtype=getattr(jnp, out),
                                  interpret=True, **BLOCKS)
    got = quant.quantized_matmul(_t(x_q), _t(w_q), _t(x_s), _t(w_s),
                                 out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    np.testing.assert_array_equal(_np(got), _f32(ref))


def _one_step_bound(x, w_s):
    """One int8 step of one activation, dequantized, per output."""
    xf = np.asarray(x, np.float32)
    amax = np.abs(xf).max(axis=-1, keepdims=True)
    x_s = np.where(amax == 0, 1.0, amax / 127.0)
    return x_s * np.asarray(w_s, np.float32).reshape(1, -1) * 127.0


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("m,k,n", [(24, 96, 40), (7, 200, 33)])
def test_fused_quantized_matmul_matches_jax(jdt, tdt, m, k, n):
    x, w = _xw(m, k, n)
    w_q, w_s = jquant.quantize_int8(jnp.asarray(w), axis=0)
    xj = jnp.asarray(x, jdt)
    ref = jquant.fused_quantized_matmul(xj, w_q, w_s, interpret=True,
                                        **BLOCKS)
    got = quant.fused_quantized_matmul(_t(xj), _t(w_q), _t(w_s))
    assert got.dtype == tdt
    diff = np.abs(_np(got) - _f32(ref))
    bound = _one_step_bound(_f32(xj), w_s)
    # one bf16 rounding of the output on top in bf16
    slack = np.abs(_f32(ref)) * 2.0 ** -8 if jdt == jnp.bfloat16 else 0.0
    assert np.all(diff <= bound + slack)


def test_fused_plain_equals_its_two_pass_on_f32():
    """In f32 the fused path quantizes exactly as quantize_int8 does, so
    it equals the two-pass path bit for bit."""
    x, w = _xw()
    w_q, w_s = quant.quantize_int8(_t(w), axis=0)
    x_q, x_s = quant.quantize_int8(_t(x), axis=-1)
    np.testing.assert_array_equal(
        quant.fused_quantized_matmul(_t(x), w_q, w_s).numpy(),
        quant.quantized_matmul(x_q, w_q, x_s, w_s).numpy())


def test_fused_past_max_k_takes_the_two_pass_path():
    m, k, n = 4, quant._FUSED_MAX_K + 8, 16
    x, w = _xw(m, k, n, seed=7)
    w_q, w_s = jquant.quantize_int8(jnp.asarray(w), axis=0)
    ref = jquant.fused_quantized_matmul(jnp.asarray(x), w_q, w_s,
                                        interpret=True, block_m=8,
                                        block_n=128, block_k=1024)
    got = quant.fused_quantized_matmul(_t(x), _t(w_q), _t(w_s))
    x_q, x_s = quant.quantize_int8(_t(x), axis=-1)
    two_pass = quant.quantized_matmul(x_q, _t(w_q), x_s, _t(w_s))
    np.testing.assert_array_equal(got.numpy(), two_pass.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("impl", ["fused", "unfused"])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_quantized_dense_bias_and_batch_dims_match_jax(impl, jdt, tdt):
    rs = np.random.RandomState(4)
    x = jnp.asarray(rs.randn(4, 6, 64), jdt)
    w = rs.randn(64, 32).astype(np.float32)
    b = jnp.asarray(rs.randn(32), jdt)
    w_q, w_s = jquant.quantize_int8(jnp.asarray(w), axis=0)
    ref = jquant.quantized_dense(x, w_q, w_s, bias=b, impl=impl,
                                 interpret=True)
    got = quant.quantized_dense(_t(x), _t(w_q), _t(w_s), bias=_t(b),
                                impl=impl)
    assert got.shape == (4, 6, 32) and got.dtype == tdt
    bound = _one_step_bound(_f32(x).reshape(24, 64), w_s).reshape(4, 6, 32)
    slack = np.abs(_f32(ref)) * 2.0 ** -7 if jdt == jnp.bfloat16 else 0.0
    diff = np.abs(_np(got) - _f32(ref))
    if impl == "unfused":
        bound = 0.0                  # no fused rounding: bit-equal
    assert np.all(diff <= bound + slack)


def test_resolve_int8_matmul_dispatch(monkeypatch):
    monkeypatch.delenv("ZOO_INT8_MATMUL", raising=False)
    assert quant.resolve_int8_matmul() == "fused"
    assert quant.resolve_int8_matmul("unfused") == "unfused"
    monkeypatch.setenv("ZOO_INT8_MATMUL", "unfused")
    assert quant.resolve_int8_matmul() == "unfused"
    assert quant.resolve_int8_matmul("fused") == "fused"
    with pytest.raises(ValueError, match="unknown int8 matmul"):
        quant.resolve_int8_matmul("no-such-impl")


def test_cpu_tensors_launch_no_kernel():
    x, w = _xw()
    w_q, w_s = quant.quantize_int8(_t(w), axis=0)
    x_q, x_s = quant.quantize_int8(_t(x), axis=-1)
    before = launch_counts()
    quant.quantized_matmul(x_q, w_q, x_s, w_s)
    quant.fused_quantized_matmul(_t(x), w_q, w_s)
    after = launch_counts()
    for k in ("quantized_matmul", "fused_quantized_matmul"):
        assert after[k] == before[k]
