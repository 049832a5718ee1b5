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
  (JAX's ``mode='low'``).

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


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32."""
    return bits_to_uniform(random_bits(key, shape))


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``
    (f32, as JAX takes a weak float): ``uniform < float32(p)``."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)
