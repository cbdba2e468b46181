"""Initial-condition generators (port of ``coupled/initial_conditions.py``).

The random spectra are built in numpy from an explicit ``Generator``, with
the reference's code, so the same seed gives the same spectrum bit for bit
before the final conversion to the grid's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.spectral import enforce_reality, rfft2

__all__ = ["random_band_psih", "band_geo_wave_ic", "front_ic", "ty_initial_condition",
           "upsample_snapshot"]


def _grid_np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def random_band_psih(grid, rng, kband=(2, 6), amp=0.1, dtype=torch.float32):
    """Band-limited random streamfunction spectrum, normalised so the max
    physical |psi| equals amp; ``dtype`` is the physical field's."""
    K = np.sqrt(grid.Krsq.cpu().numpy())
    mask = (K >= kband[0]) & (K <= kband[1])
    psih = mask * np.exp(1j * rng.uniform(0, 2 * np.pi, K.shape))
    psi = np.fft.irfft2(psih, s=(grid.ny, grid.nx))
    psi *= amp / max(np.abs(psi).max(), 1e-30)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return rfft2(torch.as_tensor(psi.astype(np_dtype), device=grid.device))


def band_geo_wave_ic(grid, rng, Kg=(10, 13), Kw=(0, 5), ag=1.5, aw=0.1,
                     f=3.0, Cg=1.0):
    """Geostrophic + wave random RSW state ``(3, nl, nkr)`` complex64.

    Geo part: balanced fields from band-limited random phases with 1/omega
    amplitude, normalised so the max geostrophic speed is ``ag``. Wave part:
    linear-wave eigenstructure with random per-mode +/- branch signs,
    normalised so the max wave speed is ``aw``."""
    Cg2 = Cg * Cg
    kr = _grid_np(grid.kr)[None, :]
    ell = _grid_np(grid.l)[:, None]
    Krsq = _grid_np(grid.Krsq)
    invK = _grid_np(grid.invKrsq)
    om = np.sqrt(f * f + Cg2 * Krsq)

    geo_mask = (Krsq >= Kg[0] ** 2) & (Krsq <= Kg[1] ** 2) & (Krsq > 0)
    wave_mask = (Krsq >= Kw[0] ** 2) & (Krsq <= Kw[1] ** 2) & (Krsq > 0)
    shift = np.exp(2j * np.pi * rng.random(Krsq.shape))
    sgn = np.sign(rng.random(Krsq.shape) - 0.5)

    def normalise(uh, vh, hh, target):
        u = np.fft.irfft2(uh, s=(grid.ny, grid.nx))
        v = np.fft.irfft2(vh, s=(grid.ny, grid.nx))
        umax = np.sqrt(u**2 + v**2).max()
        s = target / max(umax, 1e-30)
        return uh * s, vh * s, hh * s

    geo_amp = 1.0 / om
    etagh = np.where(geo_mask, geo_amp * f * shift, 0.0)
    ugh = np.where(geo_mask, -geo_amp * 1j * Cg2 * ell * shift, 0.0)
    vgh = np.where(geo_mask, geo_amp * 1j * Cg2 * kr * shift, 0.0)
    ugh, vgh, etagh = normalise(ugh, vgh, etagh, ag)

    wave_amp = np.sqrt(invK) / (2.0 * om)
    etawh = np.where(wave_mask, wave_amp * Krsq * shift, 0.0)
    uwh = np.where(wave_mask, wave_amp * (sgn * kr * om * shift + 1j * f * ell * shift), 0.0)
    vwh = np.where(wave_mask, wave_amp * (sgn * ell * om * shift - 1j * f * kr * shift), 0.0)
    uwh, vwh, etawh = normalise(uwh, vwh, etawh, aw)

    sol = np.stack([ugh + uwh, vgh + vwh, etagh + etawh]).astype(np.complex64)
    # purge conjugate-symmetry violations of the random phases
    return enforce_reality(torch.as_tensor(sol, device=grid.device), grid)


def front_ic(grid, rng, n_waves=10, aw=0.1, f=3.0, Cg=1.0):
    """Random rotated Gaussian line fronts of waves ``(3, nl, nkr)``
    complex64: ``n_waves`` fronts, each a grid-scale Gaussian across and a
    deformation-radius Gaussian along the front, rotated and placed at
    random, projected onto the linear wave structure and normalised to max
    speed ``aw``."""
    Cg2 = Cg * Cg
    xs, ys = _grid_np(grid.x), _grid_np(grid.y)
    X, Y = np.meshgrid(xs, ys)
    delta = grid.Lx / grid.nx
    Ld = Cg / f
    F = np.zeros_like(X)
    for _ in range(n_waves):
        th = 2 * np.pi * rng.random()
        x0 = grid.Lx * rng.random() + float(xs[0])
        y0 = grid.Ly * rng.random() + float(ys[0])
        # rotate into front coordinates, wrap periodically, rotate back
        nx_ = (X - x0) * np.cos(th) - (Y - y0) * np.sin(th)
        ny_ = (X - x0) * np.sin(th) + (Y - y0) * np.cos(th)
        ox = nx_ * np.cos(th) + ny_ * np.sin(th)
        oy = -nx_ * np.sin(th) + ny_ * np.cos(th)
        xd = np.mod(ox - float(xs[0]), grid.Lx) + float(xs[0])
        yd = np.mod(oy - float(ys[0]), grid.Ly) + float(ys[0])
        nxd = xd * np.cos(th) - yd * np.sin(th)
        nyd = xd * np.sin(th) + yd * np.cos(th)
        expo = -(nxd**2) / (2 * delta**2) - nyd**2 / (2 * Ld**2)
        F += -1.0 / (delta * Ld) * np.exp(expo / 2)
    F -= F.mean()

    Fh = np.fft.rfft2(F)
    kr = _grid_np(grid.kr)[None, :]
    ell = _grid_np(grid.l)[:, None]
    om = np.sqrt(f * f + Cg2 * _grid_np(grid.Krsq))
    invK = _grid_np(grid.invKrsq)
    etawh = 1j * Cg / om * Fh
    uwh = 1j * Cg * (om * kr + 1j * f * ell) * invK / om * Fh
    vwh = 1j * Cg * (om * ell - 1j * f * kr) * invK / om * Fh
    uw = np.fft.irfft2(uwh, s=(grid.ny, grid.nx))
    vw = np.fft.irfft2(vwh, s=(grid.ny, grid.nx))
    s = aw / max(np.sqrt(uw**2 + vw**2).max(), 1e-30)
    sol = np.stack([uwh * s, vwh * s, etawh * s]).astype(np.complex64)
    return enforce_reality(torch.as_tensor(sol, device=grid.device), grid)


def ty_initial_condition(grid, rng, k0g_range=(0, 1), k0w_range=(0, 1),
                         at=0.0, ag=0.0, aw=0.0):
    """Eigenbasis-projected random Thomas-Yamada state ``(4, nl, nkr)``
    complex64: independent random phases for the barotropic
    streamfunction, the geostrophic baroclinic mode (on Phi0) and the two
    wave modes (Phi+, Phi-), band-limited on |K| by ``k0g_range`` and
    ``k0w_range`` and normalised so the largest physical amplitude of each
    family is (at, ag, aw); the barotropic variable is zeta = -K^2 psi."""
    from ..models.thomasyamada import ty_bases

    Krsq = _grid_np(grid.Krsq)
    geo_f = (Krsq >= k0g_range[0] ** 2) & (Krsq <= k0g_range[1] ** 2)
    wave_f = (Krsq >= k0w_range[0] ** 2) & (Krsq <= k0w_range[1] ** 2)

    def phases():
        return np.exp(2j * np.pi * rng.random(Krsq.shape))

    Phi0, Phip, Phim = (b.cpu().numpy().astype(np.complex128) for b in ty_bases(grid))

    psith = phases() * geo_f
    gh = Phi0 * (phases() * geo_f)[None]          # (3, nl, nkr) (uc, vc, pc)
    wh = (Phip * phases()[None] + Phim * phases()[None]) * wave_f[None]

    def norm_to(fieldh, target):
        phys = np.fft.irfft2(fieldh, s=(grid.ny, grid.nx))
        return target / max(np.abs(phys).max(), 1e-30)

    psith = psith * norm_to(psith, at)
    gh = gh * norm_to(gh[0], ag)
    wh = wh * norm_to(wh[0], aw)

    zth = -Krsq * psith
    sol = np.stack([zth, gh[0] + wh[0], gh[1] + wh[1], gh[2] + wh[2]]).astype(np.complex64)
    return enforce_reality(torch.as_tensor(sol, device=grid.device), grid)


def upsample_snapshot(snapshot, new_grid) -> torch.Tensor:
    """Zero-pad a ``(C, nl_s, nkr_s)`` spectral snapshot (a tensor or an
    array) onto a finer grid: the low-|l| rows go to the start, the high
    (negative l) rows to the end, scaled by (nl_new / nl_old)^2 for the
    FFT normalisation; on ``new_grid``'s device."""
    snap = (snapshot.detach().cpu().numpy() if isinstance(snapshot, torch.Tensor)
            else np.asarray(snapshot))
    C, nl_s, nkr_s = snap.shape
    half = nkr_s - 1
    scale = new_grid.nl ** 2 / nl_s ** 2
    out = np.zeros((C, new_grid.nl, new_grid.nkr), snap.dtype)
    out[:, :half, :nkr_s] = scale * snap[:, :half, :]
    out[:, -(nl_s - half):, :nkr_s] = scale * snap[:, half:, :]
    return torch.as_tensor(out, device=new_grid.device)
