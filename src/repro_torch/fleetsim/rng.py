"""JAX's threefry PRNG, bit for bit, for the fleet simulator's stochastic
forwarding policies (``random``, ``power_of_two``).

The reference draws each forward from ``jax.random``:
``PRNGKey(seed)``, ``fold_in`` by the request's row and by its hop, then
``uniform`` (and, for ``power_of_two``, a ``split`` first).  This module
computes the same words on the host with Python ints masked to 32 bits,
in the mode the reference runs (``jax_threefry_partitionable``, the
default since JAX 0.5):

* ``prng_key(seed)``    — ``(0, seed mod 2**32)`` (a 32-bit seed);
* ``fold_in(key, d)``   — ``threefry2x32(key, (0, d mod 2**32))``;
* ``split(key)``        — key ``i`` of two is ``threefry2x32(key, (0, i))``
  (the 64-bit counter ``i`` as hi / lo words);
* ``uniform(key)``      — the 32 random bits ``x0 ^ x1`` of
  ``threefry2x32(key, (0, 0))``; their top 23 under the exponent of 1.0,
  minus 1.0, scaled to ``[minval, maxval)`` by one fused multiply-add
  (as XLA's CPU compiler contracts the reference) and clamped to
  ``minval``, in f32.

``csrc/threefry.cuh`` is the same arithmetic as device code, for the
``event_scan`` kernel; this module is its plain version.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import fma32

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: int, x1: int) -> Tuple[int, int]:
    """Threefry-2x32 with 20 rounds (five groups of four, a key injection
    after each), as ``jax._src.prng._threefry2x32_lowering``."""
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return 0, seed & _MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``; ``data`` is taken mod 2**32, as
    JAX converts an int32 to uint32."""
    return threefry2x32(key, 0, data & _MASK)


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)`` (two keys), partitionable mode."""
    return threefry2x32(key, 0, 0), threefry2x32(key, 0, 1)


def random_bits(key: Key) -> int:
    """``jax.random.bits(key)``: one uint32 word, partitionable mode."""
    x0, x1 = threefry2x32(key, 0, 0)
    return x0 ^ x1


def uniform(key: Key, minval: float = 0.0, maxval: float = 1.0
            ) -> np.float32:
    """``jax.random.uniform(key, (), float32, minval, maxval)``."""
    f32 = np.float32
    one = np.uint32((random_bits(key) >> 9) | 0x3F800000).view(f32)
    lo, hi = f32(minval), f32(maxval)
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    scaled = f32(fma32(t(one - f32(1.0)), t(hi - lo), t(lo)).item())
    return max(lo, scaled)


def scaled_index(u: np.float32, n: int) -> int:
    """``min(int32(u * n), max(n - 1, 0))`` with ``u * n`` one f32 product,
    as the reference picks among ``n`` neighbours."""
    return min(int(np.float32(u) * np.float32(n)), max(n - 1, 0))
