"""Single wave packet in a Gaussian envelope (port of
``coupled/single_wave.py``): a plane wave with the linear RSW wave
polarisation times a periodic Gaussian envelope, injected into the
geostrophic part of a spun-up flow, so one resolved wave packet and
ray-traced packets evolve together.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.spectral import enforce_reality, rfft2
from ..models.wave_vortex import wave_balanced_decomposition

__all__ = ["gaussian_envelope", "single_wave_state", "inject_single_wave"]


def gaussian_envelope(grid, x0: float, y0: float, env_size: float) -> np.ndarray:
    """(ny, nx) float64 periodic Gaussian envelope centred at (x0, y0)."""
    x = grid.x.cpu().numpy().astype(np.float64)
    y = grid.y.cpu().numpy().astype(np.float64)
    mx = np.mod(x - x0 - x[0], grid.Lx) + x[0]
    my = np.mod(y - y0 - y[0], grid.Ly) + y[0]
    return np.exp(-((mx[None, :] / env_size) ** 2)
                  - (my[:, None] / env_size) ** 2)


def single_wave_state(grid, params, x0, y0, k0_idx, l0_idx, phase=0.0,
                      env_size=0.5, aw=0.1) -> torch.Tensor:
    """(3, nl, nkr) spectral wave state on the grid's device: an enveloped
    plane wave with the linear RSW polarisation, max |u_w| = aw."""
    k0 = float(grid.kr[k0_idx])
    l0 = float(grid.l[l0_idx])
    Ksq = k0 * k0 + l0 * l0
    invKsq = 1.0 / Ksq
    f = params.f
    omK = np.sqrt(f * f + params.Cg2 * Ksq)

    env = gaussian_envelope(grid, x0, y0, env_size)
    X = grid.x.cpu().numpy().astype(np.float64)[None, :]
    Y = grid.y.cpu().numpy().astype(np.float64)[:, None]
    waveform = env * np.exp(1j * (k0 * X + l0 * Y + phase))

    etaw = np.real(0.5 * waveform)
    uw = np.real(invKsq * (0.5 * k0 * omK + 0.5j * f * l0) * waveform)
    vw = np.real(invKsq * (0.5 * l0 * omK - 0.5j * f * k0) * waveform)
    s = aw / max(np.abs(uw).max(), 1e-30)
    stack = np.stack([uw * s, vw * s, etaw * s]).astype(np.float32)
    return rfft2(torch.as_tensor(stack, device=grid.device))


def inject_single_wave(solh, grid, params, **wave_kwargs) -> torch.Tensor:
    """Keep the geostrophic (PV) part of a spun-up state and add the fresh
    enveloped wave in place of its wave part."""
    geo, _ = wave_balanced_decomposition(solh, grid, params)
    wave = single_wave_state(grid, params, **wave_kwargs)
    return enforce_reality(geo + wave, grid)
