"""The port's implicit-GEMM conv module against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX conv
(its Pallas kernel in interpret mode, ``impl="pallas"``, or its
``lax.conv`` reference) and the port's counterpart, whose kernel
wrapper runs the kernel's plain version on CPU tensors.

Tolerances: the int8 conv is bit-equal (the same integers in, exact
integer sums on both sides: int32 in the JAX kernel, float64 in the
plain version; the same f32 epilogue). The float conv in f32 holds
rtol 1e-5, atol 2e-4, the JAX package's own bound between its kernel
and ``lax.conv`` (the sums run in another order; the error grows with
the 9*C reduction, ~5e-5 at C=130). The JAX package's out-of-envelope
int8 reference sums in f32 on the CPU, exact while a partial sum stays
below 2**24; at these sizes the sums stay far below, so it is bit-equal
to the port's float64 reference too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.ops.pallas import conv as jconv
from zoo_tpu.ops.pallas import quant as jquant

from zoo_tpu_torch.ops.kernels import conv, launch_counts, quant

jax.config.update("jax_platforms", "cpu")


def _xw(h=8, w=8, c=8, k=3, o=24, n=2, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, h, w, c).astype(np.float32),
            rs.randn(k, k, c, o).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


ENVELOPE = [
    (8, 8, 8, 1, 1, "SAME"),
    (8, 8, 8, 1, 2, "SAME"),
    (9, 9, 16, 1, 2, "VALID"),
    (8, 8, 8, 3, 1, "SAME"),
    (8, 8, 16, 3, 1, "VALID"),
    (7, 7, 130, 3, 1, "SAME"),     # channels past one 32-deep slice
    (5, 6, 3, 3, 1, "SAME"),       # C below one slice, non-square
]


@pytest.mark.parametrize("h,w,c,k,stride,padding", ENVELOPE)
def test_float_conv_kernel_matches_jax_pallas(h, w, c, k, stride, padding):
    x, wts = _xw(h, w, c, k)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(wts),
                       strides=(stride, stride), padding=padding,
                       impl="pallas", interpret=True)
    got = conv.implicit_gemm_conv2d(_t(x), _t(wts), (stride, stride),
                                    padding)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-4)


@pytest.mark.parametrize("h,w,c,k,stride,padding", ENVELOPE + [
    (8, 8, 8, 3, 2, "SAME"),       # XLA SAME pads (0, 1) here
    (9, 9, 8, 3, 2, "SAME"),
    (8, 8, 4, 5, 1, "SAME"),
    (10, 10, 4, 3, 2, "VALID")])
def test_reference_conv_matches_lax(h, w, c, k, stride, padding):
    x, wts = _xw(h, w, c, k)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(wts),
                       strides=(stride, stride), padding=padding,
                       impl="reference")
    got = conv.conv2d(_t(x), _t(wts), (stride, stride), padding,
                      impl="reference")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-4)


def _quantized(x, wts):
    w_q, w_scale = jquant.quantize_conv_weights(jnp.asarray(wts))
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=(1, 2, 3), keepdims=True)
    x_scale = jnp.where(amax == 0, 1.0, amax / 127.0)
    x_q = jnp.clip(jnp.round(jnp.asarray(x) / x_scale), -127, 127)
    return x_q, w_q, x_scale, w_scale.astype(jnp.float32)


@pytest.mark.parametrize("h,w,c,k,stride,padding", ENVELOPE)
def test_int8_conv_kernel_matches_jax_pallas_bit_for_bit(h, w, c, k, stride,
                                                         padding):
    x, wts = _xw(h, w, c, k)
    x_q, w_q, x_scale, w_scale = _quantized(x, wts)
    ref = jconv.conv2d_int8(x_q, w_q, x_scale, w_scale,
                            strides=(stride, stride), padding=padding,
                            impl="pallas", interpret=True)
    for xq in (_t(x_q).to(torch.int8), _t(x_q)):   # int8 or int-valued f32
        got = conv.implicit_gemm_conv2d_int8(
            xq, _t(w_q), _t(x_scale), _t(w_scale), (stride, stride),
            padding)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k,stride,padding", [
    (3, 2, "SAME"), (3, 2, "VALID"), (5, 1, "SAME")])
def test_int8_conv_outside_the_envelope_matches_jax_reference(k, stride,
                                                              padding):
    x, wts = _xw(9, 9, 8, k)
    x_q, w_q, x_scale, w_scale = _quantized(x, wts)
    ref = jconv.conv2d_int8(x_q, w_q, x_scale, w_scale,
                            strides=(stride, stride), padding=padding)
    got = conv.conv2d_int8(_t(x_q), _t(w_q), _t(x_scale), _t(w_scale),
                           (stride, stride), padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("impl", ["pallas", "reference"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantized_conv2d_matches_jax(impl, dtype):
    """The layer's int8 path: per-image quantization, the int8 conv, the
    bias; bit-equal in f32 and in bf16."""
    x, wts = _xw(k=3)
    xj = jnp.asarray(x, dtype)
    b = np.random.RandomState(5).randn(24).astype(np.float32)
    w_q, w_scale = jquant.quantize_conv_weights(jnp.asarray(wts))
    ref = jquant.quantized_conv2d(xj, w_q, w_scale.astype(dtype),
                                  bias=jnp.asarray(b, dtype), impl=impl,
                                  interpret=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = quant.quantized_conv2d(
        _t(np.asarray(xj.astype(jnp.float32))).to(tdt), _t(w_q),
        _t(np.asarray(w_scale.astype(dtype).astype(jnp.float32))).to(tdt),
        bias=_t(b).to(tdt), impl=impl)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_pallas_conv_supported_matrix():
    for args in [((1, 1), (1, 1), (1, 1)), ((1, 1), (2, 2), (1, 1)),
                 ((3, 3), (1, 1), (1, 1)), ((3, 3), (2, 2), (1, 1)),
                 ((5, 5), (1, 1), (1, 1)), ((3, 3), (1, 1), (2, 2)),
                 ((1, 3), (1, 1), (1, 1))]:
        assert conv.pallas_conv_supported(*args) == \
            jconv.pallas_conv_supported(*args), args


@pytest.mark.parametrize("h,w,k,s,padding", [
    (56, 56, 3, 2, "SAME"), (112, 112, 3, 2, "SAME"), (7, 7, 3, 1, "SAME"),
    (9, 8, 1, 2, "SAME"), (9, 9, 3, 2, "VALID"), (16, 16, 4, 1, "SAME"),
    (5, 5, 7, 2, "SAME")])
def test_spatial_pads_match_jax(h, w, k, s, padding):
    assert conv._spatial_pads(h, w, k, k, (s, s), padding) == \
        jconv._spatial_pads(h, w, k, k, (s, s), padding)


def test_resolve_conv_impl_dispatch(monkeypatch):
    monkeypatch.delenv("ZOO_CONV_IMPL", raising=False)
    r = conv.resolve_conv_impl
    # auto: the kernel on a CUDA device inside the envelope, else the
    # reference conv
    assert r(kernel=(3, 3), device="cpu") == "reference"
    assert r(kernel=(3, 3), device="cuda") == "pallas"
    assert r(kernel=(1, 1), strides=(2, 2), device="cuda") == "pallas"
    assert r(kernel=(3, 3), strides=(2, 2), device="cuda") == "reference"
    assert r(kernel=(7, 7), device="cuda") == "reference"
    # the knob overrides auto; an argument beats the knob
    monkeypatch.setenv("ZOO_CONV_IMPL", "pallas")
    assert r(kernel=(1, 1), device="cpu") == "pallas"
    assert r("reference", kernel=(1, 1), device="cuda") == "reference"
    with pytest.raises(ValueError, match="envelope"):
        r(kernel=(3, 3), strides=(2, 2))
    monkeypatch.setenv("ZOO_CONV_IMPL", "reference")
    assert r(kernel=(3, 3), device="cuda") == "reference"
    with pytest.raises(ValueError, match="unknown conv impl"):
        r("cudnn", kernel=(3, 3))


def test_forced_kernel_outside_the_envelope_raises():
    x, wts = _xw(k=3)
    with pytest.raises(ValueError, match="envelope"):
        conv.conv2d(_t(x), _t(wts), (2, 2), impl="pallas")
    with pytest.raises(ValueError, match="envelope"):
        conv.implicit_gemm_conv2d(_t(x), _t(wts), (2, 2))
    x_q, w_q, x_scale, w_scale = _quantized(x, wts)
    with pytest.raises(ValueError, match="envelope"):
        conv.conv2d_int8(_t(x_q), _t(w_q), _t(x_scale), _t(w_scale), (2, 2),
                         impl="pallas")


def test_cpu_tensors_launch_no_kernel():
    x, wts = _xw(k=1)
    x_q, w_q, x_scale, w_scale = _quantized(x, wts)
    before = launch_counts()
    conv.implicit_gemm_conv2d(_t(x), _t(wts))
    conv.implicit_gemm_conv2d_int8(_t(x_q), _t(w_q), _t(x_scale),
                                   _t(w_scale))
    after = launch_counts()
    assert after["conv2d"] == before["conv2d"]
    assert after["conv2d_int8"] == before["conv2d_int8"]
