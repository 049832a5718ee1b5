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
