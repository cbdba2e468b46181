"""Spectral transforms and Parseval sums (port of ``core/spectral.py``).

The transforms are ``torch.fft`` (cuFFT on the card, pocketfft or MKL on
the CPU). The dealiased pair applies the grid's 2/3 mask as an explicit
multiply; the reference's TPU dense-DFT backend has no counterpart here.
"""
from __future__ import annotations

import torch

__all__ = [
    "rfft2", "irfft2", "rfft2_dealiased", "irfft2_dealiased",
    "parseval_sum2", "parseval_sum", "enforce_reality", "spectral_gradients",
]


def rfft2(field: torch.Tensor) -> torch.Tensor:
    """Real -> half-complex transform over the last two axes."""
    return torch.fft.rfft2(field, dim=(-2, -1))


def irfft2(fieldh: torch.Tensor, nx: int) -> torch.Tensor:
    """Half-complex -> real inverse transform over the last two axes;
    ``nx`` fixes the physical size of the last axis."""
    return torch.fft.irfft2(fieldh, s=(fieldh.shape[-2], nx), dim=(-2, -1))


def rfft2_dealiased(field: torch.Tensor, grid) -> torch.Tensor:
    """``grid.dealias(rfft2(field))``."""
    return grid.dealias(rfft2(field))


def irfft2_dealiased(fieldh: torch.Tensor, grid) -> torch.Tensor:
    """``irfft2(grid.dealias(fieldh), grid.nx)``."""
    return irfft2(grid.dealias(fieldh), grid.nx)


def _doubling_weights(grid) -> torch.Tensor:
    """Conjugate-symmetry weights of rfft storage: the kr=0 column once,
    every kr>0 column twice, an even-nx Nyquist column once."""
    w = torch.full((grid.nkr,), 2.0, dtype=torch.float32, device=grid.device)
    # ``fill_`` passes its value to the kernel, where ``w[0] = 1.0`` copies
    # it from a host tensor, which a CUDA graph (the driver's frame tail,
    # whose diagnostics sum by Parseval) cannot hold
    w[0].fill_(1.0)
    if grid.nx % 2 == 0:
        w[-1].fill_(1.0)
    return w[None, :]


def parseval_sum2(fieldh: torch.Tensor, grid) -> torch.Tensor:
    """sum |f|^2 over physical space from the half spectrum."""
    w = _doubling_weights(grid)
    norm = grid.Lx * grid.Ly / (grid.nx**2 * grid.ny**2)
    return norm * torch.sum(w * fieldh.abs() ** 2, dim=(-2, -1))


def parseval_sum(fieldh: torch.Tensor, grid) -> torch.Tensor:
    """Integral of a real quantity stored spectrally (real part of the mode
    sum with conjugate doubling)."""
    w = _doubling_weights(grid)
    norm = grid.Lx * grid.Ly / (grid.nx**2 * grid.ny**2)
    return norm * torch.sum(w * fieldh.real, dim=(-2, -1))


def enforce_reality(solh: torch.Tensor, grid) -> torch.Tensor:
    """Project onto the exactly conjugate-symmetric subspace by a
    physical-space round trip."""
    return rfft2(irfft2(grid.dealias(solh), grid.nx))


def spectral_gradients(psih: torch.Tensor, grid):
    """(uh, vh, uxh, uyh, vxh) from a streamfunction: u = -psi_y,
    v = psi_x (v_y = -u_x by incompressibility)."""
    ik, il = grid.ik, grid.il
    uh = -il * psih
    vh = ik * psih
    uxh = ik * uh
    uyh = il * uh
    vxh = ik * vh
    return uh, vh, uxh, uyh, vxh
