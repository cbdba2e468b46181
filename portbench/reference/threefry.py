"""Counter-based random draws as ``jax.random`` defines them, written from
the published definitions: Threefry-2x32 with 20 rounds (Salmon, Moraes,
Dror and Shaw, "Parallel random numbers: as easy as 1, 2, 3", SC 2011),
and JAX's key conventions with ``jax_threefry_partitionable`` on.

- a key is two 32-bit words ``(k1, k2)``;
- ``split(key, n)``: key i is the hash of the counter pair ``(0, i)``;
- ``uniform(key, n, lo, hi)`` in float32: draw i takes the hash of ``(0,
  i)``, ``w = bits1 ^ bits2``; the top 23 bits of ``w`` are the mantissa of
  a float ``f`` in [1, 2); the draw is ``max(lo, (f - 1) (hi - lo) + lo)``
  with ``hi - lo`` taken in float32 and the product and the sum rounded
  once to float32, as a fused multiply-add rounds them. Here the product
  is exact in float64 and the sum is rounded to float64 first, which can
  differ from one rounding only where that sum lies half-way between two
  float32 values.

Words are int64 tensors masked to 32 bits, so the arithmetic runs on any
device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "split", "uniform"]

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """The 20-round hash of the counters ``(x0, x1)`` under the key ``(k1,
    k2)``: five groups of four rounds, a key injection after each."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x0, x1 = (x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK
    for group in range(5):
        for r in ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def _hash_of_counters(key, n: int):
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(i), i)


def split(key, n: int) -> torch.Tensor:
    """``(n, 2)`` int64 keys from the ``(2,)`` int64 ``key``."""
    return torch.stack(_hash_of_counters(key, n), dim=1)


def uniform(key, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``(n,)`` float32 draws in [lo, hi) from the ``(2,)`` int64 ``key``."""
    b1, b2 = _hash_of_counters(key, n)
    word = ((b1 ^ b2) >> 9) | 0x3F800000
    f = word.to(torch.int32).view(torch.float32) - 1.0
    lo32 = np.float32(lo)
    scale = np.float32(hi) - lo32
    out = (f.double() * float(scale) + float(lo32)).float()
    return torch.clamp(out, min=float(lo32))
