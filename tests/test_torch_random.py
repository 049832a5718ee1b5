"""The port's threefry PRNG (``zoo_tpu_torch/ops/random.py``) and the
key derivations of the dropout kernel's module on the CPU against
``jax.random`` in its ``jax_threefry_partitionable`` mode: keys,
splits, fold-ins, bits, uniforms and Bernoulli masks bit-equal for
several keys, shapes (0-d, empty, odd sizes, 4-D) and rates. Every
comparison is exact: the functions are integer work, and the uniform's
float is built from its bits.
"""

import zlib

import jax
import numpy as np
import pytest
import torch

from zoo_tpu_torch.ops import random as R
from zoo_tpu_torch.ops.kernels import dropout as D

jax.config.update("jax_platforms", "cpu")

SEEDS = (0, 1, 7, 42, 2 ** 31 - 1, -1, -123456)
SHAPES = ((), (0,), (1,), (7,), (3, 5), (2, 0, 3), (2, 3, 4, 5), (129,))


def _np(key):
    return np.asarray(key).astype(np.int64)


def test_partitionable_mode_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(_np(jax.random.PRNGKey(seed)),
                          R.PRNGKey(seed).numpy())
    assert R.PRNGKey(seed).dtype == torch.int64


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 5])
def test_split(seed, num):
    want = _np(jax.random.split(jax.random.PRNGKey(seed), num))
    assert np.array_equal(want, R.split(R.PRNGKey(seed), num).numpy())
    assert np.array_equal(want, D.split(R.PRNGKey(seed), num).numpy())


def test_split_is_threefry_of_the_counter():
    """key i of a split is both words of threefry(key, (0, i))."""
    from jax._src.prng import threefry_2x32
    k = jax.random.PRNGKey(7)
    assert np.array_equal(_np(jax.random.split(k)[1]),
                          _np(threefry_2x32(k, np.array([0, 1], np.uint32))))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("data", [0, 1, 99, 2 ** 31, 2 ** 32 - 1,
                                  zlib.crc32(b"dropout_1"),
                                  zlib.crc32(b"bert")])
def test_fold_in(seed, data):
    want = _np(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    assert np.array_equal(want, R.fold_in(R.PRNGKey(seed), data).numpy())
    assert np.array_equal(want, D.fold_in(R.PRNGKey(seed), data).numpy())


@pytest.mark.parametrize("seed", (0, 7, -1))
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    got = R.random_bits(tk, shape)
    assert tuple(got.shape) == shape
    assert np.array_equal(_np(jax.random.bits(jk, shape)), got.numpy())
    u = R.uniform(tk, shape)
    assert u.dtype == torch.float32
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                          u.numpy())


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.8, 0.9, 1.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_bernoulli(p, shape):
    jk, tk = jax.random.PRNGKey(3), R.PRNGKey(3)
    assert np.array_equal(np.asarray(jax.random.bernoulli(jk, p, shape)),
                          R.bernoulli(tk, p, shape).numpy())


def test_derived_keys_chain_as_jax():
    """A chain of splits and fold-ins, as the fit loop and BERT take
    them, stays on JAX's keys."""
    jk, tk = jax.random.PRNGKey(1), R.PRNGKey(1)
    for step in range(4):
        js, jk = jax.random.split(jk)
        ts, tk = D.split(tk)
        jl = jax.random.fold_in(js, zlib.crc32(b"bert"))
        tl = D.fold_in(ts, zlib.crc32(b"bert"))
        assert np.array_equal(_np(jl), tl.numpy()), step
        assert np.array_equal(_np(jk), tk.numpy()), step


def test_bits_past_the_low_word_carry_the_high_word():
    """Counters with a high word above 0 (more than 2**32 elements):
    threefry of (hi, lo), as JAX's ``iota_2x32_shape`` gives them."""
    from jax._src.prng import threefry2x32_p
    k = jax.random.PRNGKey(5)
    hi = np.array([1, 2, 3], np.uint32)
    lo = np.array([0, 7, 2 ** 32 - 1], np.uint32)
    want = threefry2x32_p.bind(k[0], k[1], hi, lo)
    x0, x1 = R.threefry2x32(5 >> 32, 5, torch.from_numpy(hi.astype(
        np.int64)), torch.from_numpy(lo.astype(np.int64)))
    assert np.array_equal(_np(want[0]), x0.numpy())
    assert np.array_equal(_np(want[1]), x1.numpy())


def test_dropout_wrapper_checks():
    k = R.PRNGKey(0)
    x = torch.randn(4, 5)
    assert D.dropout(x, k, 0.0) is x
    with pytest.raises(ValueError, match="rate"):
        D.dropout(x, k, 1.0)
    assert D.resolve_dropout_impl("cpu") == "plain"
    assert D.resolve_dropout_impl("cuda") == "cuda"
    assert D._spans((4, 5), None) == (1, 20)
    assert D._spans((2, 3, 4, 5), (2, 3, 1, 1)) == (20, 1)
    assert D._spans((2, 3, 4, 5), (2, 1, 1, 5)) == (12, 5)
    with pytest.raises(ValueError, match="broadcast"):
        D._spans((2, 3, 4), (2, 2, 4))
    with pytest.raises(ValueError, match="run"):
        D._spans((2, 3, 4, 5), (2, 1, 4, 1))


@pytest.mark.parametrize("lo,hi", [(1 / 8, 1 / 3), (-2.5, 0.75),
                                   (0.0, 1.0)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_range_is_bit_equal(lo, hi, seed):
    """``minval``/``maxval``: ``u * (hi - lo) + lo`` rounded once (XLA
    contracts it into a fused multiply-add), floored at ``lo``."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4099,),
                                         minval=lo, maxval=hi))
    got = R.uniform(R.PRNGKey(seed), (4099,), lo, hi).numpy()
    assert np.array_equal(got, want)


def _ulps(a, b):
    """|a - b| in f32 ulps (the two's-complement distance of the bits)."""
    def ordered(v):
        i = v.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


# the measured gap to jax.random.normal on the CPU (2**20 draws): share
# of bit-equal draws and the largest distance in ulps
NORMAL_EQUAL_SHARE, NORMAL_MAX_ULPS = 0.9999, 3


@pytest.mark.parametrize("seed", [1234, 0])
def test_normal_within_its_pinned_ulps(seed):
    """``normal`` against ``jax.random.normal`` over 2**20 draws: at
    least 99.99 % bit-equal and none more than 3 ulp away (the ``log``
    inside XLA's ``log1p`` rounds an ulp apart on 0.03 % of its inputs;
    ``torch.erfinv`` alone would match 41 %, up to 90 ulp)."""
    shape = (1 << 20,)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = R.normal(R.PRNGKey(seed), shape).numpy()
    d = _ulps(got, want)
    assert (d == 0).mean() >= NORMAL_EQUAL_SHARE, (d == 0).mean()
    assert d.max() <= NORMAL_MAX_ULPS, d.max()


@pytest.mark.parametrize("shape", [(), (0,), (7,), (3, 5, 2)])
def test_normal_small_shapes_equal(shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(5), shape))
    got = R.normal(R.PRNGKey(5), shape).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _ulps(got, want).max(initial=0) <= NORMAL_MAX_ULPS


def test_erf_inv_edges():
    """erf_inv(+-1) is +-inf, as XLA's edge case; erf_inv(0) is 0."""
    x = torch.tensor([-1.0, 0.0, 1.0])
    got = R.erf_inv(x).numpy()
    assert np.isneginf(got[0]) and got[1] == 0.0 and np.isposinf(got[2])
