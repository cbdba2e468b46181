"""Spectrally exact ray tracing through NUFFT field evaluation (port of
``rays/nufft_rays.py``).

The velocity and gradient spectra are evaluated at the packets exactly
(``analysis/nufft.nufft2d2``: two complex products a stage), blended
linearly in time between two spectral snapshots, with fixed RK4 substeps.
Use it where interpolation error must be zero, as an oracle for the
gridded interpolation paths: a stage costs O(modes x packets).
"""
from __future__ import annotations

import torch

from ..analysis.nufft import nufft2d2
from ..core.spectral import spectral_gradients
from .dispersion import group_velocity
from .packets import Packets
from .raytrace import RayParams

__all__ = ["spectra_from_psih", "nufft_raytrace"]


def spectra_from_psih(psih: torch.Tensor, grid) -> torch.Tensor:
    """``(5, nl, nkr)`` [uh, vh, uxh, uyh, vxh] spectral stack."""
    return torch.stack(spectral_gradients(psih, grid))


def _rhs(p: Packets, spec, grid, rp: RayParams) -> Packets:
    u, v, ux, uy, vx = nufft2d2(spec, p.x, p.y, grid)   # (5, N)
    cgx, cgy = group_velocity(p.k, p.l, rp.f, rp.Cg, p.sign)
    return Packets(u + cgx, v + cgy, -(ux * p.k + vx * p.l), -(uy * p.k - ux * p.l),
                   torch.zeros_like(p.sign))


def _axpy(p: Packets, d: Packets, s) -> Packets:
    return Packets(p.x + s * d.x, p.y + s * d.y, p.k + s * d.k, p.l + s * d.l, p.sign)


def nufft_raytrace(packets: Packets, spec_old: torch.Tensor, spec_new: torch.Tensor, t0, t1,
                   grid, rp: RayParams, nsubsteps: int = 1) -> Packets:
    """``nsubsteps`` RK4 substeps from ``t0`` to ``t1`` with the spectra
    blended at each stage's time (exact interpolation)."""
    h = (t1 - t0) / nsubsteps
    da = 1.0 / nsubsteps

    def blend(a):
        return (1.0 - a) * spec_old + a * spec_new

    p = packets
    for i in range(nsubsteps):
        a0 = i * da
        F0, Fh, F1 = blend(a0), blend(a0 + 0.5 * da), blend(a0 + da)
        k1 = _rhs(p, F0, grid, rp)
        k2 = _rhs(_axpy(p, k1, 0.5 * h), Fh, grid, rp)
        k3 = _rhs(_axpy(p, k2, 0.5 * h), Fh, grid, rp)
        k4 = _rhs(_axpy(p, k3, h), F1, grid, rp)
        p = Packets(*(getattr(p, n) + h / 6 * (getattr(k1, n) + 2 * getattr(k2, n)
                                               + 2 * getattr(k3, n) + getattr(k4, n))
                      for n in ("x", "y", "k", "l")), p.sign)
    return p
