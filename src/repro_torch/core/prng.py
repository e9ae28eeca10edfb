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

The key schedule runs on Python integers (:func:`key_words`); the
per-element hash (:func:`uniform_at`) runs as int64 tensor ops masked to
32 bits on the caller's device.  The fused-block kernel takes the same
steps per element in-kernel, on ``uint32``, with the key words as launch
arguments.

A fused loop (``core/loop.py``) runs many iterations of one flush without
the host between them, so its draws cannot take key words from the host
at each call: a drain writes every iteration's key words into a device
:class:`KeyTable` in one copy, and each draw reads its own from there at
the iteration a device counter names (:func:`uniform_from`, and the
kernel's loop form).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

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


# float dtype -> (torch dtype, mantissa bits)
_LAYOUT = {
    np.dtype(np.float64): (torch.float64, 52),
    np.dtype(np.float32): (torch.float32, 23),
    np.dtype(np.float16): (torch.float16, 10),
}


#: calls of :func:`uniform` (the whole-array draw of the torch floor); the
#: fused-block kernel draws in-kernel and never calls it, which a run can
#: check by setting this to 0 first
CALLS = {"uniform": 0}


def key_words(seed: int, salt: int) -> Tuple[int, int]:
    """The two key words of one draw, ``fold_in(PRNGKey(seed), salt)``,
    computed on the host: a kernel takes them as launch arguments, so one
    compiled kernel serves every salt."""
    return fold_in(prng_key(seed), salt)


def uniform_at(seed: int, salt: int, index: torch.Tensor,
               dtype) -> torch.Tensor:
    """The value of flat element ``index`` (an int64 tensor, any shape) of
    ``uniform(seed, salt, shape, dtype)`` for every ``shape`` that holds
    it, in the steps the fused-block kernel takes per element:
    :func:`uniform_bits` under the draw's key words."""
    return uniform_bits(*key_words(seed, salt), index, dtype)


Word = Union[int, torch.Tensor]


def uniform_bits(k1: Word, k2: Word, index: torch.Tensor,
                 dtype) -> torch.Tensor:
    """:func:`uniform_at` from the draw's two key words, Python ints or
    0-dim int64 tensors holding 32-bit values (:meth:`KeyTable.words`):
    the counter pair ``(i >> 32, i & MASK)``, threefry2x32 under the key
    words, then the top mantissa bits of the output words as a float in
    ``[1, 2)`` minus one.  That float minus one is ``frac * 2**-nmant``
    exactly (``frac`` < 2**nmant converts exactly and the scale is a power
    of two), which is how it is computed here: a dtype view of the bits
    would have no batching rule under ``torch.func.vmap`` (PyTorch 2.11),
    and a batched serving dispatch draws through this function."""
    dt = np.dtype(dtype)
    if dt not in _LAYOUT:
        raise TypeError(f"uniform draws float16/32/64, not {dt}")
    torch_dt, nmant = _LAYOUT[dt]
    b1, b2 = threefry2x32(k1, k2, index >> 32, index & MASK)
    if dt.itemsize == 8:
        # the 64-bit word is b1:b2; keep its top 52 bits without forming it
        frac = (b1 << (nmant - 32)) | (b2 >> (64 - nmant))
    else:
        frac = (b1 ^ b2) >> (32 - nmant) if dt.itemsize == 4 \
            else ((b1 ^ b2) & 0xFFFF) >> (16 - nmant)
    return frac.to(torch_dt) * 2.0 ** -nmant


def uniform(seed: int, salt: int, shape, dtype,
            device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(fold_in(PRNGKey(seed), salt), shape, dtype)``
    on ``device``, bitwise: :func:`uniform_at` over every flat index."""
    return uniform_from(*key_words(seed, salt), shape, dtype, device)


def uniform_from(k1: Word, k2: Word, shape, dtype,
                 device: torch.device) -> torch.Tensor:
    """:func:`uniform` from the draw's key words; 0-dim int64 tensors from
    a :class:`KeyTable` keep the draw on the device, with nothing read
    back to the host, so a CUDA graph can hold it."""
    CALLS["uniform"] += 1
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return uniform_bits(k1, k2, i, dtype).reshape(tuple(shape))


@dataclass(frozen=True)
class KeyTable:
    """The key words of a fused loop's draws, on the device.

    ``table`` is ``(unroll, n_rand, 2)`` ``uint32``: row ``i`` holds
    iteration ``i``'s key words, draw by draw in the order the loop body
    runs them (:func:`key_words` of each draw's salt).  ``ctr`` is a
    one-element int32 tensor beside it: the iteration being run, which the
    loop resets once per drain and advances after each iteration.  ``off``
    is the first draw of the block this view is handed to, so a block's
    draw ``j`` reads ``table[ctr, off + j]``.  Nothing here reads a device
    value on the host."""

    table: torch.Tensor
    ctr: torch.Tensor
    off: int = 0

    @property
    def stride(self) -> int:
        """``uint32`` words from one iteration's row to the next."""
        return 2 * self.table.shape[1]

    def at(self, off: int) -> "KeyTable":
        """The view a block whose first draw is ``off`` of a row reads."""
        return KeyTable(self.table, self.ctr, self.off + off)

    def words(self, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Draw ``j``'s two key words at the current iteration, as 0-dim
        int64 tensors on the table's device."""
        flat = self.table.view(torch.int32).reshape(-1)
        at = self.ctr.to(torch.int64) * self.stride + 2 * (self.off + j)
        pair = flat.take(torch.cat([at, at + 1])).to(torch.int64) & MASK
        return pair[0], pair[1]
