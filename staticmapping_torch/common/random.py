"""The JAX package's random bits, drawn with plain torch ops.

``jax.random.uniform(jax.random.key(seed), shape)`` under JAX's defaults
(the ``threefry2x32`` PRNG, partitionable counters, ``jax_enable_x64``
off) is a pure function of ``(seed, shape)``.  This module computes it bit
for bit on any device, so the port's random samplers keep the same points
as the JAX package's.  The algorithm is a copy of JAX's own:

* ``jax/_src/prng.py::threefry_seed``: the key is ``(0, seed mod 2**32)``;
  without 64-bit mode the seed is a 32-bit integer, so only its low 32
  bits count;
* ``jax/_src/prng.py::iota_2x32_shape``: the counters are the row-major
  flat index of each element, split into its high and low 32-bit words;
* ``jax/_src/prng.py::threefry_2x32`` (``_threefry2x32_lowering``): 20
  rounds of Threefry-2x32 in five groups of four, a key injection after
  each group;
* ``jax/_src/prng.py::_threefry_random_bits_partitionable``: 32-bit draws
  are the two output words XOR-ed;
* ``jax/_src/random.py::_uniform``: the top 23 bits become the mantissa of
  a float in [1, 2), minus 1.

The uint32 words are held in int64 tensors and masked after every add and
shift.  Nothing here keeps state between calls.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key
    ``(k1, k2)``: uint32 values in int64 tensors (the key words may be
    Python ints).  Returns the two output words, same shape and dtype."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def random_bits(seed: int, shape: Sequence[int],
                device) -> torch.Tensor:
    """``jax.random.bits(jax.random.key(seed), shape)`` (uint32) as an int64
    tensor of ``shape`` on ``device``."""
    shape = tuple(int(s) for s in shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(0, int(seed) & _MASK, count >> 32, count & _MASK)
    return (x0 ^ x1).reshape(shape)


def uniform(seed: int, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.uniform(jax.random.key(seed), shape)``: float32 in
    [0, 1) on ``device``, equal to JAX's bit for bit."""
    bits = (random_bits(seed, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0

