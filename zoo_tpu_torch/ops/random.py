"""JAX's threefry PRNG in the ``jax_threefry_partitionable`` mode, on
torch tensors (counterpart of ``jax.random``'s default implementation).

A key is a ``(2,)`` int64 tensor holding two uint32 words, as
``jax.random.PRNGKey`` gives them; every function here is a pure
function of its key and returns JAX's bits bit for bit:

- :func:`PRNGKey` ``(seed)`` -> ``[seed >> 32, seed & 0xffffffff]``
  (the high word 0 for a negative 32-bit seed, as JAX without x64);
- :func:`fold_in` ``(key, d)`` -> both words of threefry(key, (0, d));
- :func:`split` ``(key, n)`` -> key ``i`` is both words of
  threefry(key, (0, i));
- :func:`random_bits` ``(key, shape)`` -> ``x0 ^ x1`` of threefry(key,
  (hi, lo)), (hi, lo) the 64-bit row-major flat index;
- :func:`uniform` -> ``(bits >> 9) | 0x3F800000`` viewed as f32, minus
  1, floored at 0;
- :func:`bernoulli` ``(key, p, shape)`` -> ``uniform < float32(p)``
  (JAX's ``mode='low'``);
- :func:`uniform` with ``minval``/``maxval`` -> ``max(minval, u *
  (maxval - minval) + minval)``, the product and sum rounded once (XLA
  contracts them into a fused multiply-add);
- :func:`normal` -> ``sqrt(2) * erf_inv(u)``, ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, ``erf_inv`` XLA's (Giles' single-precision
  polynomial, each Horner step a fused multiply-add) over XLA CPU's
  ``log1p`` (a Cephes rational below ``sqrt(2) - 1``, Eigen's
  polynomial ``log`` of ``1 + x`` above it). Not bit for bit: over
  2**20 draws 99.997 % are equal and the rest within 3 ulp (the
  ``log`` lands an ulp off XLA's on 0.03 % of its inputs;
  ``tests/test_torch_random.py`` pins the gap).

These are the plain versions, composed from int64 tensor ops (every sum
taken mod 2**32 by a mask): what every caller runs on the CPU, and what
the dropout kernel (:mod:`zoo_tpu_torch.ops.kernels.dropout`) is held
to on the card, bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher, 20 rounds, on int64 tensors (or
    ints) holding uint32 values, broadcast together: key ``(k1, k2)``,
    counter ``(x0, x1)``; the rounds of ``jax._src.prng``'s threefry
    lowering. Every sum is taken mod 2**32 by a mask, so nothing leaves
    int64; the two counter words update in place after the first add."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = torch.broadcast_tensors(torch.as_tensor((x0 + ks[0]) & M32),
                                     torch.as_tensor((x1 + ks[1]) & M32))
    x0, x1 = x0.clone(), x1.clone()
    hi = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            torch.bitwise_left_shift(x1, r, out=hi).bitwise_and_(M32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(M32)
    return x0, x1


def threefry_bits(seeds: torch.Tensor, token_index: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(N, n) uint32 values (in int64) of JAX's
    ``random_bits(fold_in(key, token_index), 32, (n,))`` for the raw
    threefry key ``key = [0, seed]`` of each row: ``fold_in`` enciphers
    the counter ``(0, index)`` under the key, and bit ``j`` is the xor
    of the two words of counter ``(0, j)`` under the folded key."""
    s = seeds.long() & M32
    zero = torch.zeros_like(s)
    k1, k2 = threefry2x32(zero, s, zero, token_index.long() & M32)
    col = torch.arange(n, device=seeds.device, dtype=torch.int64)
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], 0, col[None, :])
    return b1.bitwise_xor_(b2)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``[seed >> 32, seed &
    0xffffffff]``; a negative seed of 32 bits (an int32 to JAX without
    x64) has the high word 0."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 0 else (seed >> 32) & M32
    # two fills, not a copy from the host (item assignment copies a
    # host scalar): on the card no sync
    key = torch.full((2,), seed & M32, dtype=torch.int64, device=device)
    key[0].fill_(hi)
    return key


def derive(key: torch.Tensor, n: int, first: int = 0) -> torch.Tensor:
    """(n, 2) keys: key ``i`` is both words of threefry(key, (0, first +
    i)), the counter words of :func:`split` and :func:`fold_in`."""
    lo = torch.arange(first, first + n, dtype=torch.int64,
                      device=key.device) & M32
    x0, x1 = threefry2x32(key[0], key[1], 0, lo)
    return torch.stack([x0, x1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: a (num, 2) tensor of keys."""
    return derive(key, num)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for an int ``data`` (taken as
    uint32, as JAX takes it)."""
    return derive(key, 1, int(data) & M32)[0]


def flat_counters(shape: Sequence[int], device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``iota_2x32_shape``: the row-major flat index of every
    element of ``shape`` as its high and low 32-bit words (int64)."""
    n = math.prod(shape)
    if n > 2 ** 63 - 1:
        raise ValueError(f"random bits of {n} elements: above the "
                         "64-bit flat index this module counts in")
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))
    return i >> 32, i & M32


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, held in int64)."""
    hi, lo = flat_counters(shape, key.device)
    x0, x1 = threefry2x32(key[0], key[1], hi, lo)
    return x0.bitwise_xor_(x1)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) -> f32 in [0, 1): the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, floored at 0 (JAX's
    ``_uniform`` with ``minval=0, maxval=1``)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 rounded once, as a fused multiply-add: the
    product is exact in float64 and the sum is rounded to f32 from
    float64 (a second rounding can differ from one only on a float64
    tie, about once in 2**29 draws)."""
    return (a.double() * b.double() + c.double()).float()


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in f32: the
    bits' float in [0, 1) scaled by ``maxval - minval`` (in f32) and
    shifted by ``minval`` in one fused multiply-add, floored at
    ``minval``."""
    u = bits_to_uniform(random_bits(key, shape))
    if minval == 0.0 and maxval == 1.0:
        return u
    lo, hi = _f32(minval, key.device), _f32(maxval, key.device)
    return torch.maximum(lo, fma(u, hi - lo, lo))


# XLA's ErfInv32 (Giles' polynomial): the w < 5 branch in w - 2.5, the
# other in sqrt(w) - 3, the highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p below sqrt(2) - 1: x - x**2 / 2 + x**3 * P(x) / Q(x)
# (Cephes), the polynomials in f32 with fused Horner steps
_LOG1P_P = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
            6.5787325942061044846969E0, 2.9911919328553073277375E1,
            6.0949667980987787057556E1, 5.7112963590585538103336E1,
            2.0039553499201281259648E1)
_LOG1P_Q = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
            2.2176239823732856465394E2, 3.0909872225312059774938E2,
            2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Eigen's (Cephes') single-precision log, which XLA CPU emits for log
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, _f32(c, x.device).expand_as(x))
    return p


def _log(x: torch.Tensor) -> torch.Tensor:
    """Eigen's ``plog`` for f32 ``x > 0``: ``x = m * 2**e`` with m in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in ``m - 1``, then
    ``e * ln 2`` added in two parts."""
    dev = x.device
    t = torch.clamp_min(x, 1.1754943508222875e-38)
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = t < _f32(0.707106781186547524, dev)
    t = (t - 1.0) + torch.where(small, t, torch.zeros_like(t))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    p = [_f32(c, dev) for c in _LOG_P]
    y = fma(fma(t, p[0], p[1]), t, p[2])
    y1 = fma(fma(t, p[3], p[4]), t, p[5])
    y2 = fma(fma(t, p[6], p[7]), t, p[8])
    y = fma(fma(y, x3, y1), x3, y2) * x3
    y = y + _f32(-2.12194440e-4, dev) * e
    t = t - _f32(0.5, dev) * x2
    return (t + y) + _f32(0.693359375, dev) * e


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's ``log1p`` of f32 ``x > -1``."""
    x2 = x * x
    r = (x * x2) * (_horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q))
    near = x + fma(_f32(-0.5, x.device).expand_as(x), x2, r)
    return torch.where(x.abs() < 0.41421356237309504880, near,
                       _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` on (-1, 1) (module docstring)."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    dev = x.device
    p = torch.where(lt, _f32(_ERFINV_LT5[0], dev), _f32(_ERFINV_GE5[0], dev))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, _f32(a, dev), _f32(b, dev)))
    return torch.where(x.abs() == 1.0, x * float("inf"),
                       p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32, within 3 ulp (module
    docstring)."""
    u = uniform(key, shape, -(1.0 - 2.0 ** -24), 1.0)  # f32 nextafter(-1, 0)
    return _f32(math.sqrt(2), key.device) * erf_inv(u)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``
    (f32, as JAX takes a weak float): ``uniform < float32(p)``."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)
