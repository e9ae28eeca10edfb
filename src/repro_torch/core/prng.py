"""JAX's threefry2x32 random numbers, bit for bit, as plain torch ops.

The reference draws a ``random`` op's values as
``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), salt),
shape, dtype)`` (``repro.core.executor.make_block_fn``).  This module
reproduces that draw exactly, so the port's random ops give the same bits
as the JAX package:

* ``PRNGKey(seed)`` — the key words ``(seed >> 32, seed & 0xFFFFFFFF)``
  (``jax._src.prng.threefry_seed``);
* ``fold_in(key, data)`` — ``threefry_2x32(key, [0, data])``
  (``jax._src.prng._threefry_fold_in``);
* ``uniform`` — the partitionable bit layout (``jax_threefry_partitionable``
  is on from jax 0.5): element ``i`` of the flattened shape hashes the
  counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and keeps both output words
  (``_threefry_random_bits_partitionable``), whose top mantissa bits become
  a float in ``[1, 2)`` minus one (``jax._src.random._uniform``).

The key schedule runs on Python integers; the per-element hash runs as
int64 tensor ops masked to 32 bits on the caller's device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher with 20 rounds
    (``jax._src.prng._threefry2x32_lowering``).  Keys and counters are
    Python ints or int64 tensors holding 32-bit values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two key words."""
    s = int(seed) % 2 ** 64
    return s >> 32, s & MASK


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


# float dtype -> (integer view dtype, mantissa bits, exponent-zero bits)
_LAYOUT = {
    np.dtype(np.float64): (torch.int64, 52, 0x3FF0000000000000),
    np.dtype(np.float32): (torch.int32, 23, 0x3F800000),
    np.dtype(np.float16): (torch.int16, 10, 0x3C00),
}


def uniform(seed: int, salt: int, shape, dtype,
            device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(fold_in(PRNGKey(seed), salt), shape, dtype)``
    on ``device``, bitwise."""
    dt = np.dtype(dtype)
    if dt not in _LAYOUT:
        raise TypeError(f"uniform draws float16/32/64, not {dt}")
    view, nmant, one = _LAYOUT[dt]
    k1, k2 = fold_in(prng_key(seed), salt)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & MASK)
    if dt.itemsize == 8:
        # the 64-bit word is b1:b2; keep its top 52 bits without forming it
        frac = (b1 << (nmant - 32)) | (b2 >> (64 - nmant))
    else:
        frac = (b1 ^ b2) >> (32 - nmant) if dt.itemsize == 4 \
            else ((b1 ^ b2) & 0xFFFF) >> (16 - nmant)
    floats = (frac | one).to(view).view(torch.float64 if dt.itemsize == 8
                                        else torch.float32 if dt.itemsize == 4
                                        else torch.float16)
    return (floats - 1.0).reshape(tuple(shape))
