"""Slab-sharded rotating shallow water (port of ``parallel/sharded_rsw.py``).

``ShardedRSW`` instantiates the model-generic sharded core
(``parallel/sharded.ShardedSpectralModel``: column-block state, slab FFTs,
all-gathered interpolation fields, each rank's packets) for the 3-field
RSW system: the full 3x3 L by the matrix-exponential IF-AB3, advection
and height-flux nonlinearity, and the PV-inversion streamfunction for the
rays. The reference's file-swap variants follow: ``ShardedLinborg``,
``ShardedModifiedSW`` and ``ShardedQuadHeight``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import modified_sw, rsw
from .fft import local_irfft2, local_rfft2
from .sharded import ShardedSpectralModel, _host

__all__ = ["ShardedRSW", "ShardedLinborg", "ShardedModifiedSW", "ShardedQuadHeight"]


@dataclass
class ShardedRSW(ShardedSpectralModel):
    """Slab-sharded RSW stepping + coupled rays (``params``: ``RSWParams``)."""

    nfields = 3

    def _build_L(self):
        return _host(rsw.build_L(self.grid, self.params))

    def _extra_consts(self):
        K2 = _host(self.grid.Krsq).astype(np.float64)
        Kd2 = self.params.f ** 2 / self.params.Cg2
        return {"pvfac": (-1.0 / (K2 + Kd2)).astype(np.float32)}

    def _calcN_local(self, solh, c):
        """``models/rsw._advection_N`` on one column block."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        uh, vh, etah = (solh * deal).unbind(0)
        stack = torch.stack([uh, vh, etah, ik * uh, il * uh, ik * vh, il * vh])
        u, v, eta, ux, uy, vx, vy = local_irfft2(stack, self.grid.nx, self.mesh).unbind(0)
        prods = torch.stack([u * ux + v * uy, u * vx + v * vy, eta * u, eta * v])
        prodh = local_rfft2(prods, self.nkr_pad, self.mesh)
        Neta = -(ik * prodh[2] + il * prodh[3])
        return torch.stack([-prodh[0], -prodh[1], Neta]) * deal

    def _psih_local(self, sol, c):
        """PV-inversion streamfunction psih = -q/(K^2 + Kd^2) on one block."""
        qh = c["ik"] * sol[1] - c["il"] * sol[0] - self.params.f * sol[2]
        return qh * c["pvfac"]


@dataclass
class ShardedLinborg(ShardedRSW):
    """Linborg variant: the momentum equations advected by the rotational
    (divergence-free) part of the flow only. Same L and ray
    streamfunction as RSW."""

    def _extra_consts(self):
        d = super()._extra_consts()
        d["invK"] = _host(self.grid.invKrsq).astype(np.float32)
        return d

    def _calcN_local(self, solh, c):
        ik, il, deal, invK = c["ik"], c["il"], c["deal"], c["invK"]
        uh, vh, etah = (solh * deal).unbind(0)
        psirh = -(ik * vh - il * uh) * invK
        stack = torch.stack([uh, vh, etah, ik * uh, il * uh, ik * vh, il * vh,
                             -il * psirh, ik * psirh])
        u, v, eta, ux, uy, vx, vy, ur, vr = (
            local_irfft2(stack, self.grid.nx, self.mesh).unbind(0))
        prods = torch.stack([ur * ux + vr * uy, ur * vx + vr * vy, eta * u, eta * v])
        prodh = local_rfft2(prods, self.nkr_pad, self.mesh)
        Neta = -(ik * prodh[2] + il * prodh[3])
        return torch.stack([-prodh[0], -prodh[1], Neta]) * deal


@dataclass
class ShardedModifiedSW(ShardedRSW):
    """Modified SW variant: the nonlinear pressure Cg^2 F(eta) in N, its
    column removed from L."""

    _decouple_eta = False

    def _build_L(self):
        return _host(modified_sw.build_L_modified(self.grid, self.params,
                                                  decouple_eta=self._decouple_eta))

    def _pressure_local(self, h):
        # Cg^2 F with F = 3/2 - 1/(2 (1+eta)^2)
        return self.params.Cg2 * (1.5 - 0.5 / (1.0 + h) ** 2)

    def _calcN_local(self, solh, c):
        ik, il, deal = c["ik"], c["il"], c["deal"]
        uh, vh, hh = (solh * deal).unbind(0)
        stack = torch.stack([uh, vh, hh, ik * uh, il * uh, ik * vh, il * vh])
        u, v, h, ux, uy, vx, vy = local_irfft2(stack, self.grid.nx, self.mesh).unbind(0)
        prods = torch.stack([u * ux + v * uy, u * vx + v * vy, self._pressure_local(h),
                             h * u, h * v])
        prodh = local_rfft2(prods, self.nkr_pad, self.mesh)
        Nu = -prodh[0] - ik * prodh[2]
        Nv = -prodh[1] - il * prodh[2]
        Nh = -(ik * prodh[3] + il * prodh[4])
        return torch.stack([Nu, Nv, Nh]) * deal


@dataclass
class ShardedQuadHeight(ShardedModifiedSW):
    """QuadHeight variant: prognostic m = 1/(1+eta), pressure Cg^2 (3/2 -
    m^2/2), the third row and column of L decoupled. The ray
    streamfunction recovers eta = 1/m - 1 through one more slab FFT round
    trip before the PV inversion."""

    _decouple_eta = True

    def _pressure_local(self, m):
        return self.params.Cg2 * (1.5 - 0.5 * m * m)

    def _psih_local(self, sol, c):
        m = local_irfft2(sol[2:3], self.grid.nx, self.mesh)
        etah = local_rfft2(1.0 / m - 1.0, self.nkr_pad, self.mesh)[0]
        qh = c["ik"] * sol[1] - c["il"] * sol[0] - self.params.f * etah
        return qh * c["pvfac"]
