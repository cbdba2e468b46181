"""High-wavenumber exponential spectral filter (port of ``core/filters.py``).

filter(K') = 1 for K' <= innerK, exp(-decay (K' - innerK)^order) above,
in the normalised wavenumber K' = sqrt((kr dx/pi)^2 + (l dy/pi)^2), with
decay chosen so the filter reaches ``tol`` at K' = outerK.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_filter"]


def make_filter(
    grid,
    order: float = 4.0,
    innerK: float = 0.65,
    outerK: float = 1.0,
    tol: float = 1e-15,
) -> torch.Tensor:
    """(nl, nkr) float32 multiplicative filter on the grid's device."""
    # float32 numpy arithmetic, as the reference does it
    Kx = grid.kr.cpu().numpy() * grid.dx / np.pi
    Ky = grid.l.cpu().numpy() * grid.dy / np.pi
    K = np.sqrt(Kx[None, :] ** 2 + Ky[:, None] ** 2)
    decay = -np.log(tol) / (outerK - innerK) ** order
    filt = np.exp(-decay * np.maximum(K - innerK, 0.0) ** order)
    filt[K < innerK] = 1.0
    return torch.as_tensor(filt.astype(np.float32), device=grid.device)
