"""Per-snapshot energetics rollups and time-mean spectra (port of
``analysis/spectra.py``), on tensors on the snapshot's device.

Per-snapshot KE/APE for {total, geo, wave}, eigen-coefficient energies
Eg/Ew, enstrophy, max speeds, cubic (exact) energetics, plus time-mean 2-D
spectra and derived Rossby/Froude/eddy-scale numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.spectral import irfft2, parseval_sum2
from ..models.rsw import RSWParams
from ..models.wave_vortex import (
    balanced_wave_bases,
    project_balanced_wave,
    wave_balanced_decomposition,
)

__all__ = ["snapshot_energetics", "derived_scales", "TimeMeanSpectra"]


def snapshot_energetics(solh: torch.Tensor, grid, params: RSWParams, bases=None) -> dict:
    """Full per-snapshot energy decomposition, as Python floats."""
    area = grid.Lx * grid.Ly
    geo, wave = wave_balanced_decomposition(solh, grid, params)

    def ke(s):
        return float((parseval_sum2(s[0], grid) + parseval_sum2(s[1], grid)) / (2 * area))

    def pe(s):
        return float(0.5 * params.Cg2 * parseval_sum2(s[2], grid) / area)

    out = {
        "KE": ke(solh), "PE": pe(solh),
        "KE_geo": ke(geo), "PE_geo": pe(geo),
        "KE_wave": ke(wave), "PE_wave": pe(wave),
    }

    # eigen-coefficient energies (projection weights)
    if bases is None:
        bases = balanced_wave_bases(grid, params)
    c0, cp, cm = project_balanced_wave(solh, bases, params)
    out["E_geo_eig"] = float(parseval_sum2(c0, grid) / (2 * area))
    out["E_wave_eig"] = float((parseval_sum2(cp, grid) + parseval_sum2(cm, grid)) / (2 * area))

    # enstrophy of linearised PV, max speeds
    qh = grid.ik * solh[1] - grid.il * solh[0] - params.f * solh[2]
    out["enstrophy"] = float(parseval_sum2(qh, grid) / (2 * area))
    u, v, eta = (irfft2(solh[i], grid.nx) for i in range(3))
    out["umax"] = float(torch.max(torch.sqrt(u**2 + v**2)))
    out["eta_min"] = float(torch.min(eta))

    # cubic (exact) energetics: KE3 = <(1+eta)|u|^2>/2
    dA = grid.dx * grid.dy / area
    out["KE_cubic"] = float(torch.sum((1 + eta) * (u**2 + v**2) / 2) * dA)
    return out


def derived_scales(energetics: dict, grid, params: RSWParams):
    """Derived Rossby / Froude / eddy-turnover metrics from an energetics
    record."""
    U = np.sqrt(2.0 * energetics["KE_geo"])
    Z = energetics["enstrophy"]
    eddy_k = np.sqrt(Z / max(energetics["KE_geo"], 1e-30))
    Cg = np.sqrt(params.Cg2)
    return {
        "Ro": U * eddy_k / params.f,
        "Fr": U / Cg,
        "eddy_wavenumber": eddy_k,
        "eddy_turnover": 1.0 / max(U * eddy_k, 1e-30),
    }


class TimeMeanSpectra:
    """Accumulate time-mean 2-D modal energy spectra for {total, geo, wave},
    on the host in float32 as the reference does."""

    def __init__(self, grid, params: RSWParams):
        self.grid, self.params = grid, params
        self.count = 0
        self.acc = {}

    def add(self, solh: torch.Tensor):
        grid, params = self.grid, self.params
        geo, wave = wave_balanced_decomposition(solh, grid, params)
        for name, s in (("total", solh), ("geo", geo), ("wave", wave)):
            mag = s.abs().cpu().numpy()
            ke2d = 0.5 * (mag[0] ** 2 + mag[1] ** 2)
            pe2d = 0.5 * params.Cg2 * mag[2] ** 2
            for kind, val in (("KE", ke2d), ("PE", pe2d)):
                key = f"{name}_{kind}"
                self.acc[key] = self.acc.get(key, 0.0) + val
        self.count += 1

    def mean(self):
        return {k: v / max(self.count, 1) for k, v in self.acc.items()}
