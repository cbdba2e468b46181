"""Wave/vortex (wave/balanced) decomposition of RSW states (port of
``models/wave_vortex.py``).

Two equivalent views:

1. PV-inversion split: linear PV q = v_x - u_y - f eta, balanced
   streamfunction psi = -q/(K^2 + Kd^2), geostrophic fields
   (u_g, v_g, eta_g) = (-psi_y, psi_x, f psi / Cg^2); wave part = residual.
2. Linear eigenbasis: orthonormal vortical/+wave/-wave modes Phi_0, Phi_+,
   Phi_- of the linear RSW operator with omega = sqrt(f^2 + Cg^2 K^2) in
   the energy inner product <a,b> = u_a u_b* + v_a v_b* + Cg^2 eta_a eta_b*;
   projection weights c_0, c_+, c_- and reconstruction.

All tensors are (nl, nkr) spectral; a basis is (3, nl, nkr) per mode
ordered (u, v, Cg*eta) so the inner product is a plain channel contraction.
"""
from __future__ import annotations

import numpy as np
import torch

from .rsw import RSWParams

__all__ = [
    "wave_balanced_decomposition",
    "balanced_wave_bases",
    "project_balanced_wave",
    "reconstruct",
]


def wave_balanced_decomposition(solh: torch.Tensor, grid, params: RSWParams):
    """((ugh, vgh, etagh), (uwh, vwh, etawh)) from state [uh, vh, etah]."""
    uh, vh, etah = solh[0], solh[1], solh[2]
    Kd2 = params.f**2 / params.Cg2
    qh = grid.ik * vh - grid.il * uh - params.f * etah
    psih = -qh / (grid.Krsq + Kd2)
    ugh = -grid.il * psih
    vgh = grid.ik * psih
    etagh = params.f / params.Cg2 * psih
    geo = torch.stack([ugh, vgh, etagh])
    return geo, solh - geo


def _np64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def balanced_wave_bases(grid, params: RSWParams):
    """(Phi0, Phip, Phim), each (3, nl, nkr) complex64 on the grid's
    device, rows (u, v, Cg eta), built on the host in float64."""
    f, Cg2 = params.f, params.Cg2
    Cg = np.sqrt(Cg2)
    kr = _np64(grid.kr)[None, :]
    ell = _np64(grid.l)[:, None]
    Krsq = _np64(grid.Krsq)
    invK = _np64(grid.invKrsq)
    om = np.sqrt(f**2 + Cg2 * Krsq)
    s = np.sqrt(invK / 2.0)

    # NOTE: the reference writes the eta component as -f/omega
    # (rsw/RSWUtils.jl:32), which makes Phi0 non-orthogonal to Phi+/Phi-
    # (<Phi0, Phi+> = -2 f K^2 sqrt(invK/2) Cg / omega^2 != 0) and
    # inconsistent with its own geostrophic split eta_g = +f psi / Cg^2
    # (rsw/RSWUtils.jl:15). +f/omega yields an exactly orthonormal basis,
    # a deliberate defect fix the JAX package makes too.
    Phi0 = np.empty((3,) + Krsq.shape, np.complex128)
    Phi0[0] = -1j * ell * Cg / om
    Phi0[1] = 1j * kr * Cg / om
    Phi0[2] = f / om
    Phi0[:, 0, 0] = [0.0, 0.0, 1.0]

    Phip = np.empty_like(Phi0)
    Phip[0] = (om * kr + 1j * f * ell) * s / om
    Phip[1] = (om * ell - 1j * f * kr) * s / om
    Phip[2] = Cg * Krsq * s / om
    Phip[:, 0, 0] = np.asarray([1j, 1.0, 0.0]) / np.sqrt(2.0)

    Phim = np.empty_like(Phi0)
    Phim[0] = (-om * kr + 1j * f * ell) * s / om
    Phim[1] = (-om * ell - 1j * f * kr) * s / om
    Phim[2] = Cg * Krsq * s / om
    Phim[:, 0, 0] = np.asarray([-1j, 1.0, 0.0]) / np.sqrt(2.0)

    def cast(a):
        return torch.as_tensor(a.astype(np.complex64), device=grid.device)

    return cast(Phi0), cast(Phip), cast(Phim)


def project_balanced_wave(solh: torch.Tensor, bases, params: RSWParams):
    """(c0, cp, cm) projection weights: (uh, vh, Cg*etah) contracted
    against conj(Phi)."""
    Cg = float(np.sqrt(params.Cg2))
    state = torch.stack([solh[0], solh[1], Cg * solh[2]])
    return tuple(torch.sum(state * torch.conj(Phi), dim=0) for Phi in bases)


def reconstruct(c0, cp, cm, bases, params: RSWParams):
    """(uh, vh, etah) from eigen-weights."""
    Phi0, Phip, Phim = bases
    out = c0 * Phi0 + cp * Phip + cm * Phim
    Cg = float(np.sqrt(params.Cg2))
    return torch.stack([out[0], out[1], out[2] / Cg])
