"""Periodic interpolation helpers (port of part of ``rays/interp.py``).

Only the spectral B-spline prefilter is ported; the taps path waits
(ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bspline_prefilter_mask"]


def bspline_prefilter_mask(grid) -> torch.Tensor:
    """(nl, nkr) spectral prefilter turning samples into periodic cubic
    B-spline coefficients: the sampled spline has DFT (4 + 2 cos theta)/6
    per axis, so dividing by b(kx dx) b(ky dy) interpolates exactly."""
    # float32 numpy arithmetic, as the reference does it
    tx = grid.kr.cpu().numpy() * grid.dx
    ty = grid.l.cpu().numpy() * grid.dy
    bx = (4.0 + 2.0 * np.cos(tx)) / 6.0
    by = (4.0 + 2.0 * np.cos(ty)) / 6.0
    mask = 1.0 / (by[:, None] * bx[None, :])
    return torch.as_tensor(mask.astype(np.float32), device=grid.device)
