"""Threefry-2x32 counter-based random numbers, bit for bit those of the
JAX package's ``jax.random`` (default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on).

A key is the reference's raw key: two uint32 words, ``(2,)`` of
``torch.uint32``. The arithmetic runs on int64 tensors masked to 32 bits
(torch has no shifts or adds for uint32 on the CPU), on whatever device
the key lies on, so one function is the draw on both devices and the
plain twin of the birth/death kernel's inlined hash
(``csrc/birth_death.cu``).

- ``threefry2x32(k1, k2, x0, x1)``: the 20-round hash of the counter pair
  ``(x0, x1)`` under the key ``(k1, k2)``;
- ``prng_key(seed)``: ``jax.random.PRNGKey(seed)`` = ``[seed >> 32,
  seed & 0xFFFFFFFF]``;
- ``split(key, n)``: ``jax.random.split`` = the hash of the counters
  ``(0, i)``, ``(n, 2)``;
- ``uniform(key, n, dtype, minval, maxval)``: ``jax.random.uniform``. In
  float32 the word is ``bits1 ^ bits2`` of the hash of ``(0, i)``, its top
  23 bits the mantissa of a float in [1, 2); in float64 (the reference
  under ``jax_enable_x64``) the word is ``bits1 << 32 | bits2``, its top 52
  bits the mantissa. Then ``max(minval, (f - 1) * (maxval - minval) +
  minval)`` in the dtype. In float32 the product and the sum are rounded
  once, as the reference's fused multiply-add gives them; in float64 each
  is rounded, so where ``maxval - minval`` is not a power of two a draw
  may lie an ulp from the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "split", "uniform", "fma_rounded"]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counters ``(x0, x1)`` under the key
    ``(k1, k2)``; every word an int64 tensor (or int) in [0, 2^32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]`` as
    uint32 words (``[0, seed]`` for 0 <= seed < 2^32)."""
    seed = int(seed) % (1 << 64)
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=device).to(torch.uint32)


def _words(key: torch.Tensor, n: int):
    """The hash of the counters ``(0, i)``, i < n, under ``key``: two int64
    tensors of 32-bit words."""
    kw = key.to(torch.int64)
    x1 = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(kw[0], kw[1], torch.zeros_like(x1), x1)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)``: ``(n, 2)`` uint32 keys."""
    return torch.stack(_words(key, n), dim=1).to(torch.uint32)


def uniform(key: torch.Tensor, n: int, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype, minval, maxval)``: ``(n,)``
    floats of ``dtype`` (float32 or float64) on the key's device."""
    b1, b2 = _words(key, n)
    if dtype == torch.float32:
        word = ((b1 ^ b2) >> 9) | 0x3F800000
        floats = word.to(torch.int32).view(torch.float32) - 1.0
        np_dtype = np.float32
    elif dtype == torch.float64:
        word = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        floats = word.view(torch.float64) - 1.0
        np_dtype = np.float64
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    lo, hi = np_dtype(minval), np_dtype(maxval)
    return torch.clamp(fma_rounded(floats, float(hi - lo), float(lo)), min=float(lo))


def fma_rounded(u: torch.Tensor, scale: float, offset: float) -> torch.Tensor:
    """``u * scale + offset`` in ``u``'s dtype, ``scale`` and ``offset``
    taken in that dtype. In float32 it is rounded once, as XLA's fused
    multiply-add gives it (the float64 product of two 24-bit mantissas is
    exact); in float64 after each operation."""
    if u.dtype == torch.float32:
        return (u.double() * float(np.float32(scale)) + float(np.float32(offset))).float()
    return u * scale + offset
