"""Equal-depth two-layer quasi-geostrophic model with background shear
(port of ``models/twolayerqg.py``).

Layers move with background velocities +U and -U, bottom drag mu acts on
layer 2, and F = 2 f0^2 / (Cg^2 drho/rho0). State qh ``(2, nl, nkr)``.
Per mode, q = S psi with

    S      = [[-K^2 - F,  F], [F, -K^2 - F]]
    S^{-1} = [[-K^2 - F, -F], [-F, -K^2 - F]] / (K^2 (K^2 + 2F))

The block linear operator (mean-flow advection -+ i k U q_j, PV-gradient
terms -+ 2 i k F U psi_j, drag mu K^2 psi_2, hyperviscosity) is built on
the host in float64 and consumed by the matrix-exponential steppers.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.spectral import irfft2_dealiased, parseval_sum, rfft2_dealiased
from .base import Model

__all__ = [
    "TwoLayerParams", "make_model", "build_L",
    "streamfunction_from_pv", "pv_from_streamfunction",
    "kinetic_energy", "potential_energy",
]


@dataclass(frozen=True)
class TwoLayerParams:
    U: float      # background shear: layer 1 +U, layer 2 -U
    mu: float     # bottom drag on layer 2
    nu: float
    nnu: int
    F: float      # 2 f0^2 / (Cg^2 drho/rho0)


def pv_from_streamfunction(psih, grid, params: TwoLayerParams):
    """(2, nl, nkr): q_j = -K^2 psi_j + F (psi_other - psi_j)."""
    F = params.F
    q1 = -grid.Krsq * psih[0] + F * (psih[1] - psih[0])
    q2 = -grid.Krsq * psih[1] + F * (psih[0] - psih[1])
    return torch.stack([q1, q2])


def streamfunction_from_pv(qh, grid, params: TwoLayerParams):
    """Inverse stretching; zero at the mean mode."""
    F = params.F
    qsum = qh[0] + qh[1]
    p1 = -(grid.Krsq * qh[0] + F * qsum)
    p2 = -(grid.Krsq * qh[1] + F * qsum)
    scale = grid.invKrsq / (grid.Krsq + 2.0 * F)
    return torch.stack([p1, p2]) * scale


def build_L(grid, params: TwoLayerParams) -> torch.Tensor:
    """(2, 2, nl, nkr) block operator, built in complex128 on the host and
    rounded once to complex64 on the grid's device."""
    kr = grid.kr.cpu().numpy().astype(np.float64)[None, :]
    K2 = grid.Krsq.cpu().numpy().astype(np.float64)
    K2inv = np.where(K2 > 0, 1.0 / np.where(K2 > 0, K2, 1.0), 0.0)
    F, U, mu = params.F, params.U, params.mu
    D = -params.nu * K2 ** params.nnu

    # S^{-1} rows scaled by the per-layer psi coefficients:
    # layer 1: -2ikFU psi1 ; layer 2: (+2ikFU + mu K^2) psi2
    denom = K2inv / (K2 + 2.0 * F)
    Sinv00 = (-K2 - F) * denom
    Sinv01 = -F * denom
    c1 = -2j * kr * F * U * np.ones_like(K2)
    c2 = 2j * kr * F * U + mu * K2

    L = np.zeros((2, 2) + K2.shape, np.complex128)
    L[0, 0] = c1 * Sinv00 + (-1j * kr * U) + D
    L[0, 1] = c1 * Sinv01
    L[1, 0] = c2 * Sinv01
    L[1, 1] = c2 * Sinv00 + (1j * kr * U) + D
    return torch.as_tensor(L.astype(np.complex64), device=grid.device)


def make_model(
    grid,
    U: float = 0.5,
    mu: float = 1e-2,
    nu: float = 1e-6,
    nnu: int = 4,
    f0: float = 3.0,
    Cg: float = 1.0,
    drho_rho0: float = 0.2,
) -> Model:
    params = TwoLayerParams(
        U=float(U), mu=float(mu), nu=float(nu), nnu=int(nnu),
        F=float(2.0 * f0**2 / Cg**2 / drho_rho0),
    )
    L = build_L(grid, params)

    def calcN(solh, t):
        """Per layer q_t = -J(psi_j, q_j) in conservative form: one
        inverse transform of 6 fields, one forward of 4 products."""
        psih = streamfunction_from_pv(solh, grid, params)
        ik, il = grid.ik, grid.il
        phys = irfft2_dealiased(torch.cat([solh, ik * psih, il * psih]), grid)
        q, psix, psiy = phys[0:2], phys[2:4], phys[4:6]
        prodh = rfft2_dealiased(torch.cat([psix * q, psiy * q]), grid)
        return -il * prodh[0:2] + ik * prodh[2:4]

    return Model(name="twolayerqg", grid=grid, params=params, L=L, calcN=calcN, nfields=2)


def kinetic_energy(qh, grid, params: TwoLayerParams):
    """(KE_1, KE_2): <K^2 |psi_j|^2> / area per layer."""
    psih = streamfunction_from_pv(qh, grid, params)
    ke = parseval_sum(grid.Krsq * psih.abs() ** 2, grid) / (grid.Lx * grid.Ly)
    return ke[0], ke[1]


def potential_energy(qh, grid, params: TwoLayerParams):
    """F <|psi_1 - psi_2|^2> / (2 area)."""
    psih = streamfunction_from_pv(qh, grid, params)
    diff = (psih[0] - psih[1]).abs() ** 2
    return params.F * parseval_sum(diff, grid) / (2.0 * grid.Lx * grid.Ly)
