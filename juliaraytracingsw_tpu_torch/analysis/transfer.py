"""Spectral energy/enstrophy transfer (flux) functions with triad
wave-vortex decomposition (port of ``analysis/transfer.py``).

Per-mode flux densities E(k,l) = Re[(conj(uh) du/dt_N + conj(vh) dv/dt_N)/2
+ Cg^2/2 conj(etah) deta/dt_N] and the linearised-PV enstrophy analog, with
the quadratic RHS B(a, b) evaluated with advecting field a and advected
field b, decomposed into triad classes by the number of wave factors:
ggg / ggw / gww / www.

Batched FFTs on the snapshot's device, run eagerly (the reference jits
them per snapshot); one call per snapshot, accumulated over time on the
host in float64 (``time_mean_transfer``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.spectral import irfft2, rfft2
from ..models.wave_vortex import wave_balanced_decomposition

__all__ = ["quadratic_rhs", "flux_fields", "triad_transfer", "time_mean_transfer"]


def _phys_fields(solh, grid):
    """(u, v, eta, ux, vx, etax, uy, vy, etay) physical."""
    uh, vh, etah = solh[0], solh[1], solh[2]
    ik, il = grid.ik, grid.il
    stack = torch.stack([
        uh, vh, etah,
        ik * uh, ik * vh, ik * etah,
        il * uh, il * vh, il * etah,
    ])
    return irfft2(stack, grid.nx)


def quadratic_rhs(phys1, phys2, grid):
    """B(a, b): quadratic RSW tendency with advecting a, advected b ->
    (du, dv, deta) spectral."""
    u1, v1, eta1 = phys1[0], phys1[1], phys1[2]
    ux2, vx2 = phys2[3], phys2[4]
    uy2, vy2 = phys2[6], phys2[7]
    u2, v2 = phys2[0], phys2[1]
    prods = torch.stack([
        u1 * ux2 + v1 * uy2,
        u1 * vx2 + v1 * vy2,
        eta1 * u2,
        eta1 * v2,
    ])
    prodh = rfft2(prods)
    du = -prodh[0]
    dv = -prodh[1]
    deta = -(grid.ik * prodh[2] + grid.il * prodh[3])
    return torch.stack([du, dv, deta])


def flux_fields(solh, dsol, grid, params):
    """(E(k,l), Z(k,l)) per-mode flux densities."""
    uh, vh, etah = solh[0], solh[1], solh[2]
    du, dv, deta = dsol[0], dsol[1], dsol[2]
    E = torch.real(
        0.5 * (torch.conj(uh) * du + torch.conj(vh) * dv)
        + 0.5 * params.Cg2 * torch.conj(etah) * deta
    )
    qh = grid.ik * vh - grid.il * uh - params.f * etah
    dq = grid.ik * dv - grid.il * du - params.f * deta
    Z = torch.real(torch.conj(qh) * dq)
    return E, Z


def triad_transfer(solh, grid, params):
    """Per-snapshot triad-decomposed flux densities: dict of (E, Z) pairs
    keyed 'total', 'ggg', 'ggw', 'gww', 'www'."""
    solh = grid.dealias(solh)
    geo, wave = wave_balanced_decomposition(solh, grid, params)
    pt = _phys_fields(solh, grid)
    pg = _phys_fields(geo, grid)
    pw = _phys_fields(wave, grid)

    Bgg = quadratic_rhs(pg, pg, grid)
    Bgw = quadratic_rhs(pg, pw, grid) + quadratic_rhs(pw, pg, grid)
    Bww = quadratic_rhs(pw, pw, grid)
    Btot = quadratic_rhs(pt, pt, grid)

    out = {}
    out["total"] = flux_fields(solh, Btot, grid, params)
    out["ggg"] = flux_fields(geo, Bgg, grid, params)
    Eggw1, Zggw1 = flux_fields(geo, Bgw, grid, params)
    Eggw2, Zggw2 = flux_fields(wave, Bgg, grid, params)
    out["ggw"] = (Eggw1 + Eggw2, Zggw1 + Zggw2)
    Egww1, Zgww1 = flux_fields(geo, Bww, grid, params)
    Egww2, Zgww2 = flux_fields(wave, Bgw, grid, params)
    out["gww"] = (Egww1 + Egww2, Zgww1 + Zgww2)
    out["www"] = flux_fields(wave, Bww, grid, params)
    return out


def time_mean_transfer(snapshots, grid, params):
    """Average triad transfers over an iterable of (3, nl, nkr) snapshots
    (tensors, or arrays moved to the grid's device)."""
    acc = None
    count = 0
    for sol in snapshots:
        if not isinstance(sol, torch.Tensor):
            sol = torch.as_tensor(np.asarray(sol), device=grid.device)
        cur = {k: (e.cpu().numpy().astype(np.float64), z.cpu().numpy().astype(np.float64))
               for k, (e, z) in triad_transfer(sol, grid, params).items()}
        if acc is None:
            acc = cur
        else:
            acc = {k: (acc[k][0] + e, acc[k][1] + z) for k, (e, z) in cur.items()}
        count += 1
    return {k: (e / count, z / count) for k, (e, z) in acc.items()}
