"""f-plane rotating shallow water in velocity/height variables (port of
``models/rsw.py``).

State ``(3, nl, nkr)`` complex64 = [uh, vh, etah] with

    u_t   =  f v - Cg^2 eta_x - (u u_x + v u_y) - nu (-del^2)^{n} u
    v_t   = -f u - Cg^2 eta_y - (u v_x + v v_y) - nu (-del^2)^{n} v
    eta_t = -(u_x + v_y) - ((eta u)_x + (eta v)_y) - nu (-del^2)^{n} eta

The linear part is a per-mode 3x3 block, exponentiated once on the host by
the IF-AB3 stepper. The nonlinear term is one batched inverse transform of
7 fields and one batched forward transform of 4 products.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.grid import Grid
from ..core.spectral import (irfft2, irfft2_dealiased, parseval_sum2,
                             rfft2_dealiased)
from .base import Model

__all__ = [
    "RSWParams", "make_model", "build_L", "updatevars", "set_solution",
    "kinetic_energy", "potential_energy", "total_energy",
]


@dataclass(frozen=True)
class RSWParams:
    nu: float
    nnu: int
    f: float
    Cg2: float

    @property
    def Cg(self) -> float:
        return float(np.sqrt(self.Cg2))


def build_L(grid: Grid, params: RSWParams) -> torch.Tensor:
    """Blockwise linear operator ``(3, 3, nl, nkr)`` complex64 on the grid's
    device, rows/cols ordered (u, v, eta)::

        [ D    f    -ik Cg^2 ]
        [-f    D    -il Cg^2 ]
        [-ik  -il    D       ]

    with D = -nu K^{2 nnu}, built in float64 numpy."""
    kr = grid.kr.cpu().numpy().astype(np.float64)[None, :]
    ell = grid.l.cpu().numpy().astype(np.float64)[:, None]
    Krsq = grid.Krsq.cpu().numpy().astype(np.float64)
    D = -params.nu * Krsq ** params.nnu
    nl, nkr = D.shape
    L = np.zeros((3, 3, nl, nkr), np.complex128)
    L[0, 0] = D
    L[0, 1] = params.f
    L[0, 2] = -1j * kr * params.Cg2
    L[1, 0] = -params.f
    L[1, 1] = D
    L[1, 2] = -1j * ell * params.Cg2
    L[2, 0] = -1j * kr * np.ones_like(ell)
    L[2, 1] = -1j * ell * np.ones_like(kr)
    L[2, 2] = D
    return torch.as_tensor(L.astype(np.complex64), device=grid.device)


def _advection_N(solh: torch.Tensor, grid: Grid, rotational_only: bool = False) -> torch.Tensor:
    """N = [-(u u_x + v u_y), -(u v_x + v v_y), -div(eta u)] spectrally,
    with the 2/3 truncation on both transforms. With ``rotational_only``
    the advecting velocity of the momentum equations is the rotational
    (divergence-free) part of (u, v) (the Linborg variant)."""
    uh, vh, etah = solh[0], solh[1], solh[2]
    ik, il = grid.ik, grid.il

    fields = [uh, vh, etah, ik * uh, il * uh, ik * vh, il * vh]
    if rotational_only:
        # zeta = v_x - u_y; psi_rot = -zeta/K^2; (ur, vr) = (-psi_y, psi_x)
        psirh = -(ik * vh - il * uh) * grid.invKrsq
        fields += [-il * psirh, ik * psirh]
    phys = irfft2_dealiased(torch.stack(fields), grid)
    u, v, eta, ux, uy, vx, vy = phys[:7].unbind(0)
    ua, va = (phys[7], phys[8]) if rotational_only else (u, v)

    prods = torch.stack([ua * ux + va * uy, ua * vx + va * vy, eta * u, eta * v])
    prodh = rfft2_dealiased(prods, grid)
    Nu = -prodh[0]
    Nv = -prodh[1]
    Neta = -(ik * prodh[2] + il * prodh[3])
    return torch.stack([Nu, Nv, Neta])


def make_model(
    grid: Grid,
    nu: float = 1e-16,
    nnu: int = 4,
    f: float = 1.0,
    Cg: float = 1.0,
    forcing=None,
) -> Model:
    """``forcing(sol, t) -> Fh`` is an optional additive spectral forcing."""
    params = RSWParams(nu=float(nu), nnu=int(nnu), f=float(f), Cg2=float(Cg) ** 2)
    L = build_L(grid, params)

    def calcN(solh, t):
        N = _advection_N(solh, grid)
        if forcing is not None:
            N = N + forcing(solh, t)
        return N

    return Model(name="rsw", grid=grid, params=params, L=L, calcN=calcN, nfields=3)


def updatevars(solh: torch.Tensor, grid: Grid, params: RSWParams):
    """Physical (u, v, eta, zeta_lin) with zeta_lin = v_x - u_y - f eta."""
    solh = grid.dealias(solh)
    uh, vh, etah = solh[0], solh[1], solh[2]
    zetah = grid.ik * vh - grid.il * uh - params.f * etah
    phys = irfft2(torch.stack([uh, vh, etah, zetah]), grid.nx)
    return phys[0], phys[1], phys[2], phys[3]


def set_solution(u0h: torch.Tensor, v0h: torch.Tensor, eta0h: torch.Tensor) -> torch.Tensor:
    """The spectral state ``(3, nl, nkr)`` of (uh, vh, etah)."""
    return torch.stack([u0h, v0h, eta0h])


def kinetic_energy(solh: torch.Tensor, grid: Grid) -> torch.Tensor:
    """(1/2) <u^2 + v^2> / area."""
    return (
        parseval_sum2(solh[0], grid) + parseval_sum2(solh[1], grid)
    ) / (2.0 * grid.Lx * grid.Ly)


def potential_energy(solh: torch.Tensor, grid: Grid, params: RSWParams) -> torch.Tensor:
    """(Cg^2/2) <eta^2> / area."""
    return 0.5 * params.Cg2 * parseval_sum2(solh[2], grid) / (grid.Lx * grid.Ly)


def total_energy(solh: torch.Tensor, grid: Grid, params: RSWParams) -> torch.Tensor:
    return kinetic_energy(solh, grid) + potential_energy(solh, grid, params)
