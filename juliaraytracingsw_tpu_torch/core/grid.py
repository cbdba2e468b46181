"""Doubly-periodic 2-D spectral grid (port of ``core/grid.py``).

Layouts are the reference's: physical fields ``(..., ny, nx)`` indexed
``[y, x]``; spectral fields ``(..., nl, nkr)`` with ``nkr = nx//2 + 1``
non-negative x-wavenumbers on the last axis. The FFT normalisation is
numpy's (forward unnormalised, inverse carries 1/(nx*ny)).

All arrays are built in float64 numpy and rounded once to float32, so they
are bit-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Grid", "make_grid"]


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of a doubly-periodic rectangular grid."""

    nx: int
    ny: int
    Lx: float
    Ly: float
    aliased_fraction: float
    x: torch.Tensor        # (nx,) cell-centred coords starting at -Lx/2
    y: torch.Tensor        # (ny,)
    kr: torch.Tensor       # (nkr,) non-negative x wavenumbers
    l: torch.Tensor        # (nl,)  y wavenumbers in FFT order
    Krsq: torch.Tensor     # (nl, nkr) = kr^2 + l^2
    invKrsq: torch.Tensor  # (nl, nkr), zero at the (0,0) mode
    dealias_mask: torch.Tensor  # (nl, nkr) float mask, 1 keep / 0 zero
    ik: torch.Tensor       # (1, nkr) complex64 i*kr
    il: torch.Tensor       # (nl, 1) complex64 i*l

    @property
    def device(self) -> torch.device:
        return self.kr.device

    @property
    def nkr(self) -> int:
        return self.nx // 2 + 1

    @property
    def nl(self) -> int:
        return self.ny

    @property
    def dx(self) -> float:
        return self.Lx / self.nx

    @property
    def dy(self) -> float:
        return self.Ly / self.ny

    @property
    def spectral_shape(self) -> tuple[int, int]:
        return (self.nl, self.nkr)

    @property
    def physical_shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    def dealias(self, solh: torch.Tensor) -> torch.Tensor:
        """Zero the aliased (highest) wavenumbers: square per-axis 2/3 rule
        for the default aliased fraction 1/3."""
        return solh * self.dealias_mask


def make_grid(
    nx: int,
    Lx: float = 2.0 * np.pi,
    ny: int | None = None,
    Ly: float | None = None,
    aliased_fraction: float = 1.0 / 3.0,
    *,
    device: torch.device | str = "cuda",
) -> Grid:
    """Build a float32 Grid with every array on ``device``."""
    ny = nx if ny is None else ny
    Ly = Lx if Ly is None else Ly
    nkr = nx // 2 + 1

    dx, dy = Lx / nx, Ly / ny
    x = np.arange(nx) * dx - Lx / 2.0
    y = np.arange(ny) * dy - Ly / 2.0

    kr = 2.0 * np.pi / Lx * np.arange(nkr)
    ell = 2.0 * np.pi / Ly * np.fft.fftfreq(ny, d=1.0 / ny)

    Krsq = ell[:, None] ** 2 + kr[None, :] ** 2
    invKrsq = np.where(Krsq > 0, 1.0 / np.where(Krsq > 0, Krsq, 1.0), 0.0)

    if aliased_fraction and aliased_fraction > 0:
        kcut_x = (1.0 - aliased_fraction) * (nx // 2)
        kcut_y = (1.0 - aliased_fraction) * (ny // 2)
        ix = np.arange(nkr)
        iy = np.abs(np.fft.fftfreq(ny, d=1.0 / ny))
        mask = (ix[None, :] <= kcut_x) & (iy[:, None] <= kcut_y)
    else:
        mask = np.ones((ny, nkr), bool)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    kr_t, l_t = f32(kr), f32(ell)
    zr, zl = torch.zeros_like(kr_t), torch.zeros_like(l_t)
    return Grid(
        nx=nx,
        ny=ny,
        Lx=float(Lx),
        Ly=float(Ly),
        aliased_fraction=float(aliased_fraction),
        x=f32(x),
        y=f32(y),
        kr=kr_t,
        l=l_t,
        Krsq=f32(Krsq),
        invKrsq=f32(invKrsq),
        dealias_mask=f32(mask),
        ik=torch.complex(zr, kr_t)[None, :],
        il=torch.complex(zl, l_t)[:, None],
    )
