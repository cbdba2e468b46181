"""One-layer equivalent-barotropic shallow-water QG model (port of
``models/swqg.py``).

Prognostic PV q = (del^2 - Kd^2) psi,

    q_t = -J(psi, q) - nu (-del^2)^{n_nu} q

with the Jacobian in conservative form J(f, g) = (f_x g)_y - (f_y g)_x and a
diagonal hyperviscous linear operator, so the IF-AB3 stepper reduces to
scalar integrating factors.

State: one complex spectral field ``qh`` of shape ``(nl, nkr)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.grid import Grid
from ..core.spectral import irfft2_dealiased, parseval_sum, parseval_sum2, rfft2_dealiased
from .base import Model

__all__ = ["SWQGParams", "make_model", "streamfunction_from_pv",
           "pv_from_streamfunction", "kinetic_energy", "potential_energy",
           "enstrophy", "energy", "energy_dissipation", "enstrophy_dissipation"]


@dataclass(frozen=True)
class SWQGParams:
    nu: float        # hyperviscosity coefficient
    nnu: int         # hyperviscosity order
    Kd2: float       # squared deformation wavenumber (= f^2/Cg^2)


def pv_from_streamfunction(psih, grid: Grid, params: SWQGParams):
    """qh = -(K^2 + Kd^2) psih."""
    return -(grid.Krsq + params.Kd2) * psih


def streamfunction_from_pv(qh, grid: Grid, params: SWQGParams):
    """psih = -qh / (K^2 + Kd^2)."""
    return -qh / (grid.Krsq + params.Kd2)


def make_model(
    grid: Grid,
    nu: float = 1e-16,
    nnu: int = 4,
    f: float = 1.0,
    Cg: float = 1.0,
) -> Model:
    params = SWQGParams(nu=float(nu), nnu=int(nnu), Kd2=float(f) ** 2 / float(Cg) ** 2)
    D = -params.nu * grid.Krsq ** params.nnu  # (nl, nkr) real diagonal

    def calcN(solh, t):
        """q_t nonlinear term: -J(psi, q) = -(psi_x q)_y + (psi_y q)_x,
        truncated by the 2/3 rule on both transforms."""
        psih = streamfunction_from_pv(solh, grid, params)
        ik, il = grid.ik, grid.il
        # one batched inverse transform: q, psi_x, psi_y
        q, psix, psiy = irfft2_dealiased(torch.stack([solh, ik * psih, il * psih]),
                                         grid).unbind(0)
        prodh = rfft2_dealiased(torch.stack([psix * q, psiy * q]), grid)
        return -il * prodh[0] + ik * prodh[1]

    return Model(name="swqg", grid=grid, params=params, L=D, calcN=calcN, nfields=1)


# --- energetics ---------------------------------------------------------------

def kinetic_energy(qh, grid: Grid, params: SWQGParams):
    psih = streamfunction_from_pv(qh, grid, params)
    return parseval_sum2(torch.sqrt(grid.Krsq) * psih, grid) / (2.0 * grid.Lx * grid.Ly)


def potential_energy(qh, grid: Grid, params: SWQGParams):
    psih = streamfunction_from_pv(qh, grid, params)
    return params.Kd2 * parseval_sum2(psih, grid) / (2.0 * grid.Lx * grid.Ly)


def energy(qh, grid: Grid, params: SWQGParams):
    return kinetic_energy(qh, grid, params) + potential_energy(qh, grid, params)


def enstrophy(qh, grid: Grid, params: SWQGParams):
    return parseval_sum2(qh, grid) / (2.0 * grid.Lx * grid.Ly)


def energy_dissipation(qh, grid: Grid, params: SWQGParams):
    # the reference sums a complex64 integrand whatever the state's dtype
    integrand = params.nu * grid.Krsq ** (params.nnu - 1) * qh.abs() ** 2
    return parseval_sum(integrand.to(torch.complex64), grid) / (grid.Lx * grid.Ly)


def enstrophy_dissipation(qh, grid: Grid, params: SWQGParams):
    integrand = params.nu * grid.Krsq ** params.nnu * qh.abs() ** 2
    return parseval_sum(integrand.to(torch.complex64), grid) / (grid.Lx * grid.Ly)
