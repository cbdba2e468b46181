"""Packet ensemble maintenance (port of ``rays/resample.py``).

- ``k_cutoff_reset``: packets whose wavenumber magnitude reaches a cutoff
  are reset to the injection wavenumber (k0, 0).
- ``weibull_birth_death``: Weibull-age birth/death resampling. Packets
  carry an age and a sampled lifetime; dead packets (age >= lifetime) are
  reborn at uniform random positions with the injection wavenumber, a
  random branch and a fresh lifetime. The ensemble keeps its size. One
  flow step is one launch of ``csrc/birth_death.cu`` on the card
  (``ops/birth_death``), its plain twin on the CPU.

The random stream is the reference's: ``BirthDeathState.key`` is its
``jax.random`` key (two uint32 words) and ``rays/prng`` reproduces its
Threefry draws bit for bit, so a checkpoint of either package continues
the same stream in the other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.birth_death import birth_death, weibull
from .packets import Packets
from .prng import split, uniform

__all__ = ["k_cutoff_reset", "BirthDeathState", "init_birth_death", "weibull_birth_death"]


def k_cutoff_reset(p: Packets, k_cutoff: float, k0: float) -> Packets:
    """Reset packets with |k| >= k_cutoff to (k0, 0)."""
    mag2 = p.k * p.k + p.l * p.l
    reset = mag2 >= (k_cutoff * k_cutoff)
    return Packets(
        p.x,
        p.y,
        torch.where(reset, torch.full_like(p.k, k0), p.k),
        torch.where(reset, torch.zeros_like(p.l), p.l),
        p.sign,
    )


class BirthDeathState(NamedTuple):
    age: torch.Tensor       # (N,) current packet age
    lifetime: torch.Tensor  # (N,) sampled Weibull lifetime
    key: torch.Tensor       # (2,) uint32: the reference's PRNG key, checkpointed
                            # so a resumed run continues the same stream
    births: torch.Tensor    # () int32 cumulative rebirth count


def init_birth_death(key: torch.Tensor, n: int, k_shape: float = 1.5, lam: float = 10.0,
                     stagger: bool = True, dtype: torch.dtype = torch.float32
                     ) -> BirthDeathState:
    """Sample initial lifetimes on the key's device; with ``stagger`` the
    initial ages are uniform in [0, lifetime), so deaths de-synchronise.
    ``dtype`` is the reference's default float dtype (float64 under
    ``jax_enable_x64``)."""
    k1, k2, k3 = split(key, 3)
    lifetime = weibull(k1, n, k_shape, lam, dtype)
    age = uniform(k2, n, dtype) * lifetime if stagger else torch.zeros_like(lifetime)
    return BirthDeathState(age=age, lifetime=lifetime, key=k3.clone(),
                           births=torch.zeros((), dtype=torch.int32, device=key.device))


def weibull_birth_death(p: Packets, state: BirthDeathState, dt, Lx: float, Ly: float,
                        k0: float, k_shape: float = 1.5, lam: float = 10.0,
                        x0: float | None = None, y0: float | None = None):
    """Age the ensemble by ``dt`` (a float or a 0-d tensor); dead packets
    are reborn. Returns ``(packets', state', dead)``; the inputs are not
    modified."""
    x0 = -Lx / 2.0 if x0 is None else x0
    y0 = -Ly / 2.0 if y0 is None else y0
    x, y, k, l, sign, age, lifetime, key, births, dead = birth_death(
        p.x, p.y, p.k, p.l, p.sign, state.age, state.lifetime, state.key, state.births, dt,
        Lx=Lx, Ly=Ly, k0=k0, k_shape=k_shape, lam=lam, x0=x0, y0=y0)
    return Packets(x, y, k, l, sign), BirthDeathState(age, lifetime, key, births), dead
