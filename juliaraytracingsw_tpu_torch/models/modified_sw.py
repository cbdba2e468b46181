"""Modified shallow water (port of ``models/modified_sw.py``): nonlinear
pressure Cg^2 F(eta) with F = 3/2 - 1/(2 (1 + eta)^2).

The pressure leaves the linear operator (its column in the momentum rows
is zero) and enters the nonlinear term as -i k Cg^2 F_hat; the height
flux keeps its linear part -div(u) in L.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.spectral import irfft2_dealiased, rfft2_dealiased
from .base import Model
from .rsw import RSWParams

__all__ = ["make_model", "build_L_modified"]


def build_L_modified(grid, params: RSWParams, decouple_eta: bool = False) -> torch.Tensor:
    """RSW's ``(3, 3, nl, nkr)`` L without the pressure column, complex64 on
    the grid's device, built in float64 numpy; ``decouple_eta`` also zeroes
    the divergence row (the quadratic-height variant)."""
    kr = grid.kr.cpu().numpy().astype(np.float64)[None, :]
    ell = grid.l.cpu().numpy().astype(np.float64)[:, None]
    D = -params.nu * grid.Krsq.cpu().numpy().astype(np.float64) ** params.nnu
    nl, nkr = D.shape
    L = np.zeros((3, 3, nl, nkr), np.complex128)
    L[0, 0] = D
    L[0, 1] = params.f
    L[1, 0] = -params.f
    L[1, 1] = D
    if not decouple_eta:
        L[2, 0] = -1j * kr * np.ones_like(ell)
        L[2, 1] = -1j * ell * np.ones_like(kr)
    L[2, 2] = D
    return torch.as_tensor(L.astype(np.complex64), device=grid.device)


def _modified_N(solh, grid, pressure_of_h):
    """Advection, nonlinear pressure and height flux, shared by the
    modified (prognostic eta) and quadratic-height (prognostic m)
    variants."""
    uh, vh, hh = solh[0], solh[1], solh[2]
    ik, il = grid.ik, grid.il
    stack = torch.stack([uh, vh, hh, ik * uh, il * uh, ik * vh, il * vh])
    u, v, h, ux, uy, vx, vy = irfft2_dealiased(stack, grid).unbind(0)

    F = pressure_of_h(h)
    prods = torch.stack([u * ux + v * uy, u * vx + v * vy, F, h * u, h * v])
    prodh = rfft2_dealiased(prods, grid)
    Nu = -prodh[0] - ik * prodh[2]
    Nv = -prodh[1] - il * prodh[2]
    Nh = -(ik * prodh[3] + il * prodh[4])
    return torch.stack([Nu, Nv, Nh])


def make_model(grid, nu=1e-16, nnu=4, f=1.0, Cg=1.0, forcing=None) -> Model:
    """``forcing(sol, t) -> Fh``: an optional additive spectral forcing."""
    params = RSWParams(nu=float(nu), nnu=int(nnu), f=float(f), Cg2=float(Cg) ** 2)
    L = build_L_modified(grid, params)
    Cg2 = params.Cg2

    def pressure(eta):
        return Cg2 * (1.5 - 0.5 / (1.0 + eta) ** 2)

    def calcN(solh, t):
        N = _modified_N(solh, grid, pressure)
        if forcing is not None:
            N = N + forcing(solh, t)
        return N

    return Model(name="modified_sw", grid=grid, params=params, L=L, calcN=calcN, nfields=3)
