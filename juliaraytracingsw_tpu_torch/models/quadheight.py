"""Quadratic-height modified shallow water in m = 1/(1 + eta) (port of
``models/quadheight.py``): pressure Cg^2 (3/2 - m^2/2), flux
m_t = -div(m u), and an L whose third row and column are decoupled (only
Coriolis in the momentum block).

``set_solution`` turns an eta_0 spectrum into m_0 = 1/(1 + eta_0);
``updatevars`` recovers eta = 1/m - 1; the potential energy is read from
the spatial mean of m (the physical mean, as the JAX package does).
"""
from __future__ import annotations

import torch

from ..core.spectral import irfft2, parseval_sum2, rfft2
from .base import Model
from .modified_sw import _modified_N, build_L_modified
from .rsw import RSWParams

__all__ = ["make_model", "set_solution", "updatevars", "kinetic_energy",
           "potential_energy"]


def make_model(grid, nu=1e-16, nnu=4, f=1.0, Cg=1.0, forcing=None) -> Model:
    """``forcing(sol, t) -> Fh``: an optional additive spectral forcing."""
    params = RSWParams(nu=float(nu), nnu=int(nnu), f=float(f), Cg2=float(Cg) ** 2)
    L = build_L_modified(grid, params, decouple_eta=True)
    Cg2 = params.Cg2

    def pressure(m):
        return Cg2 * (1.5 - 0.5 * m * m)

    def calcN(solh, t):
        N = _modified_N(solh, grid, pressure)
        if forcing is not None:
            N = N + forcing(solh, t)
        return N

    return Model(name="quadheight_sw", grid=grid, params=params, L=L, calcN=calcN, nfields=3)


def set_solution(u0h, v0h, eta0h, grid):
    """State [uh, vh, mh] from an eta_0 spectrum: m_0 = 1/(1 + eta_0)."""
    eta0 = irfft2(eta0h, grid.nx)
    m0h = rfft2(1.0 / (1.0 + eta0))
    return torch.stack([u0h, v0h, m0h])


def updatevars(solh, grid):
    """(u, v, m, eta, zeta) physical fields; eta = 1/m - 1, zeta = v_x - u_y."""
    solh = grid.dealias(solh)
    uh, vh, mh = solh[0], solh[1], solh[2]
    zetah = grid.ik * vh - grid.il * uh
    u, v, m, zeta = irfft2(torch.stack([uh, vh, mh, zetah]), grid.nx).unbind(0)
    return u, v, m, 1.0 / m - 1.0, zeta


def kinetic_energy(solh, grid):
    return (
        parseval_sum2(solh[0], grid) + parseval_sum2(solh[1], grid)
    ) / (2.0 * grid.Lx * grid.Ly)


def potential_energy(solh, grid, params: RSWParams):
    """0.5 Cg^2 <m>, read from the mean mode."""
    mean_m = solh[2][0, 0].real / (grid.nx * grid.ny)
    return 0.5 * params.Cg2 * mean_m
