"""Thomas-Yamada coupled barotropic / baroclinic model (port of
``models/thomasyamada.py``).

Nondimensional state (zeta_t, u_c, v_c, p_c), shape ``(4, nl, nkr)``:
barotropic vorticity, baroclinic velocity and pressure. The linear wave
terms stay in N, not in L:

    d zeta_t /dt = -Ro [ div(u_t zeta_t) + (l^2-k^2)(uc vc)^ + k l ((uc^2)^-(vc^2)^) ]
    d u_c /dt    =  v_c - i k p_c - Ro [ i k (ut uc)^ + (vt uc_y)^ + (vc ut_y)^ ]
    d v_c /dt    = -u_c - i l p_c - Ro [ i l (vt vc)^ + (ut vc_x)^ + (uc vt_x)^ ]
    d p_c /dt    = -i k u_c - i l v_c - Ro [ (ut pc_x)^ + (vt pc_y)^ ]

L is the diagonal hyperviscosity ``(4, nl, nkr)``; the default stepper is
ETDRK4. The linear eigenbasis (omega = sqrt(1 + K^2)) splits the
baroclinic components into wave and geostrophic parts.

L is computed in float64 and rounded once to float32. The JAX package
raises K^2 to the power ``nnu`` in float32, which overflows for K^2 above
~6.5e4 at the default ``nnu = 8`` (grids from 362^2 up); its ETDRK4
tables are then NaN at those modes. Below that the two agree to float32
rounding.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.spectral import irfft2_dealiased, parseval_sum2, rfft2_dealiased
from .base import Model

__all__ = [
    "TYParams", "make_model", "ty_bases", "decompose_balanced_wave",
    "barotropic_energy", "baroclinic_energy", "wave_geostrophic_energy",
]


@dataclass(frozen=True)
class TYParams:
    nu: float
    nnu: int
    Ro: float


def make_model(grid, nu=3.5e-25, nnu=8, Ro=0.2) -> Model:
    params = TYParams(nu=float(nu), nnu=int(nnu), Ro=float(Ro))
    D = -params.nu * grid.Krsq.cpu().numpy().astype(np.float64) ** params.nnu
    D = torch.as_tensor(D.astype(np.float32), device=grid.device)
    Ro = params.Ro
    k = grid.kr[None, :]
    l = grid.l[:, None]

    def calcN(solh, t):
        # N has linear terms that bypass the transforms: dealias the input
        solh = grid.dealias(solh)
        zth, uch, vch, pch = solh.unbind(0)
        ik, il = grid.ik, grid.il
        psith = -zth * grid.invKrsq
        uth = -il * psith
        vth = ik * psith

        stack = torch.stack([
            zth, uth, vth, uch, vch,
            il * uch,   # uc_y
            ik * vch,   # vc_x
            il * uth,   # ut_y
            ik * vth,   # vt_x
            ik * pch,   # pc_x
            il * pch,   # pc_y
        ])
        zt, ut, vt, uc, vc, ucy, vcx, uty, vtx, pcx, pcy = (
            irfft2_dealiased(stack, grid).unbind(0))

        prods = torch.stack([
            ut * zt, vt * zt,        # vorticity advection
            uc * vc,                 # baroclinic stress
            uc * uc, vc * vc,
            ut * uc, vt * vc,        # baroclinic advection, diagonal
            vt * ucy + vc * uty,     # uc cross terms
            ut * vcx + uc * vtx,     # vc cross terms
            ut * pcx + vt * pcy,     # pressure advection
        ])
        (utzt, vtzt, ucvc, uc2, vc2, utuc, vtvc, uc_cross, vc_cross,
         pc_adv) = rfft2_dealiased(prods, grid).unbind(0)

        Nzt = -Ro * (
            1j * k * utzt + 1j * l * vtzt
            + (-(k**2) + l**2) * ucvc
            + k * l * (uc2 - vc2)
        )
        Nuc = vch - 1j * k * pch - Ro * (1j * k * utuc + uc_cross)
        Nvc = -uch - 1j * l * pch - Ro * (1j * l * vtvc + vc_cross)
        Npc = -1j * k * uch - 1j * l * vch - Ro * pc_adv
        return torch.stack([Nzt, Nuc, Nvc, Npc])

    return Model(name="thomasyamada", grid=grid, params=params,
                 L=D.expand((4,) + D.shape), calcN=calcN, nfields=4)


def ty_bases(grid):
    """(Phi0, Phip, Phim), each ``(3, nl, nkr)`` complex64 on the grid's
    device, for the baroclinic components (uc, vc, pc); omega =
    sqrt(1 + K^2). Built in float64 numpy."""
    kr = grid.kr.cpu().numpy().astype(np.float64)[None, :]
    ell = grid.l.cpu().numpy().astype(np.float64)[:, None]
    Krsq = grid.Krsq.cpu().numpy().astype(np.float64)
    invK = grid.invKrsq.cpu().numpy().astype(np.float64)
    om = np.sqrt(1.0 + Krsq)
    s = np.sqrt(invK / 2.0)

    Phi0 = np.empty((3,) + Krsq.shape, np.complex128)
    Phi0[0] = 1j * ell / om
    Phi0[1] = -1j * kr / om
    Phi0[2] = -1.0 / om
    Phi0[:, 0, 0] = [0.0, 0.0, 1.0]

    Phip = np.empty_like(Phi0)
    Phip[0] = (om * kr + 1j * ell) * s / om
    Phip[1] = (om * ell - 1j * kr) * s / om
    Phip[2] = (om**2 - 1.0) * s / om
    Phip[:, 0, 0] = np.asarray([1j, 1.0, 0.0]) / np.sqrt(2.0)

    Phim = np.empty_like(Phi0)
    Phim[0] = (-om * kr + 1j * ell) * s / om
    Phim[1] = (-om * ell - 1j * kr) * s / om
    Phim[2] = (om**2 - 1.0) * s / om
    Phim[:, 0, 0] = np.asarray([1j, -1.0, 0.0]) / np.sqrt(2.0)

    def cast(a):
        return torch.as_tensor(a.astype(np.complex64), device=grid.device)

    return cast(Phi0), cast(Phip), cast(Phim)


def decompose_balanced_wave(solh, grid, bases=None):
    """(Gh, Wh): the geostrophic and wave parts ``(3, nl, nkr)`` of the
    baroclinic components of a full state ``(4, nl, nkr)``."""
    if bases is None:
        bases = ty_bases(grid)
    Phi0, Phip, Phim = bases
    bc = solh[1:4]

    def proj(Phi):
        return torch.sum(bc * torch.conj(Phi), dim=0)

    Gh = proj(Phi0) * Phi0
    Wh = proj(Phip) * Phip + proj(Phim) * Phim
    return Gh, Wh


def barotropic_energy(solh, grid):
    return parseval_sum2(torch.sqrt(grid.invKrsq) * solh[0], grid)


def baroclinic_energy(solh, grid):
    ke = parseval_sum2(solh[1], grid) + parseval_sum2(solh[2], grid)
    pe = parseval_sum2(solh[3], grid)
    return ke, pe


def wave_geostrophic_energy(solh, grid, bases=None):
    """((wave KE, wave PE), (geo KE, geo PE))."""
    Gh, Wh = decompose_balanced_wave(solh, grid, bases)
    wave = (
        parseval_sum2(Wh[0], grid) + parseval_sum2(Wh[1], grid),
        parseval_sum2(Wh[2], grid),
    )
    geo = (
        parseval_sum2(Gh[0], grid) + parseval_sum2(Gh[1], grid),
        parseval_sum2(Gh[2], grid),
    )
    return wave, geo
