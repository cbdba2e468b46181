"""Periodic field interpolation at scattered packet positions (port of
``rays/interp.py``).

The taps path: every call gathers each tap of every field from the full
field stack, so it needs no patch table. It is the reference semantics the
patch path is held against, and the sampler of ``rays/raytrace``'s
``gather='taps'`` branches.

- ``bilinear``: 4-point stencil;
- ``bspline``: periodic cubic B-spline, 16 points, on fields prefiltered in
  spectral space (``bspline_prefilter_mask``);
- ``bicubic_hermite``: bicubic from corner values and exact corner
  derivatives.

All take field stacks ``(F, ny, nx)`` and query points ``(N,)`` and return
``(F, N)``. Each call gathers its taps in one ``index_select``
(``_gather_taps``), counted by interp in ``taps_gathers``: host calls,
a CUDA graph's capture included; a replay runs the gathers it holds with
no host call and counts nothing.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bicubic_hermite", "bilinear", "bspline", "bspline_prefilter_mask",
           "interpolate", "taps_gathers"]

# host calls of ``_gather_taps`` by interp
taps_gathers = {"bilinear": 0, "bspline": 0, "bicubic": 0}


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


def _frac_index(q, origin, d):
    """Continuous index into a periodic axis: integer cell + fraction."""
    fi = (q - origin) / d
    i0 = torch.floor(fi)
    return i0.to(torch.int32), fi - i0


def _wrap(i, n):
    return torch.remainder(i, n)


def _gather_taps(fields, tap_flat_idx, interp: str):
    """One flat gather for all fields x taps: fields (F, ny, nx),
    tap_flat_idx (T, N) flattened yx indices -> (F, T, N); counted in
    ``taps_gathers[interp]``."""
    taps_gathers[interp] += 1
    F, ny, nx = fields.shape
    T, N = tap_flat_idx.shape
    offs = (torch.arange(F, dtype=tap_flat_idx.dtype, device=fields.device)
            * (ny * nx))[:, None, None]
    idx = (tap_flat_idx[None] + offs).reshape(-1)
    return fields.reshape(F * ny * nx).index_select(0, idx).reshape(F, T, N)


def bilinear(fields, xq, yq, x0, y0, dx, dy):
    """Periodic bilinear interpolation; fields (F, ny, nx) -> (F, N)."""
    _, ny, nx = fields.shape
    ix0, ax = _frac_index(xq, x0, dx)
    iy0, ay = _frac_index(yq, y0, dy)
    ix0, ix1 = _wrap(ix0, nx), _wrap(ix0 + 1, nx)
    iy0w, iy1 = _wrap(iy0, ny), _wrap(iy0 + 1, ny)
    taps = torch.stack([
        iy0w * nx + ix0, iy0w * nx + ix1, iy1 * nx + ix0, iy1 * nx + ix1,
    ])
    g = _gather_taps(fields, taps, "bilinear")   # (F, 4, N)
    b = g[:, 0] + ax * (g[:, 1] - g[:, 0])
    t = g[:, 2] + ax * (g[:, 3] - g[:, 2])
    return b + ay * (t - b)


def _bspline_w(a):
    """Cubic B-spline weights of the 4 taps at offsets (-1, 0, 1, 2)."""
    a2, a3 = a * a, a * a * a
    return ((1.0 - 3.0 * a + 3.0 * a2 - a3) / 6.0,
            (4.0 - 6.0 * a2 + 3.0 * a3) / 6.0,
            (1.0 + 3.0 * a + 3.0 * a2 - 3.0 * a3) / 6.0,
            a3 / 6.0)


def bspline(coeff_fields, xq, yq, x0, y0, dx, dy):
    """Periodic cubic B-spline evaluation on prefiltered coefficient fields
    (F, ny, nx); all 16 taps in one gather."""
    _, ny, nx = coeff_fields.shape
    ix0, ax = _frac_index(xq, x0, dx)
    iy0, ay = _frac_index(yq, y0, dy)
    wx, wy = _bspline_w(ax), _bspline_w(ay)
    taps = []
    for jy in range(4):
        iy = _wrap(iy0 + (jy - 1), ny)
        for jx in range(4):
            taps.append(iy * nx + _wrap(ix0 + (jx - 1), nx))
    g = _gather_taps(coeff_fields, torch.stack(taps), "bspline")   # (F, 16, N)
    out = None
    for jy in range(4):
        row = None
        for jx in range(4):
            term = g[:, jy * 4 + jx] * wx[jx]
            row = term if row is None else row + term
        term = row * wy[jy]
        out = term if out is None else out + term
    return out


def _cubic_hermite(a, f0, f1, m0, m1):
    """Hermite cubic on [0, 1] from end values and end slopes."""
    a2 = a * a
    a3 = a2 * a
    return (f0 + m0 * a + (-3.0 * f0 + 3.0 * f1 - 2.0 * m0 - m1) * a2
            + (2.0 * f0 - 2.0 * f1 + m0 + m1) * a3)


def bicubic_hermite(f, fx, fy, fxy, xq, yq, x0, y0, dx, dy):
    """Bicubic with exact corner derivatives. The four stacks are
    (F, ny, nx); derivatives are in physical units (scaled by dx, dy
    here)."""
    F, ny, nx = f.shape
    ix0, ax = _frac_index(xq, x0, dx)
    iy0, ay = _frac_index(yq, y0, dy)
    ix0w, ix1 = _wrap(ix0, nx), _wrap(ix0 + 1, nx)
    iy0w, iy1 = _wrap(iy0, ny), _wrap(iy0 + 1, ny)
    taps = torch.stack([
        iy0w * nx + ix0w, iy0w * nx + ix1, iy1 * nx + ix0w, iy1 * nx + ix1,
    ])
    g = _gather_taps(torch.cat([f, fx, fy, fxy]), taps, "bicubic")   # (4F, 4, N)

    def corners(block, scale):
        c = g[block * F:(block + 1) * F] * scale
        return c[:, 0], c[:, 1], c[:, 2], c[:, 3]

    f00, f10, f01, f11 = corners(0, 1.0)
    fx00, fx10, fx01, fx11 = corners(1, dx)
    fy00, fy10, fy01, fy11 = corners(2, dy)
    fxy00, fxy10, fxy01, fxy11 = corners(3, dx * dy)
    b0 = _cubic_hermite(ax, f00, f10, fx00, fx10)
    b1 = _cubic_hermite(ax, f01, f11, fx01, fx11)
    d0 = _cubic_hermite(ax, fy00, fy10, fxy00, fxy10)
    d1 = _cubic_hermite(ax, fy01, fy11, fxy01, fxy11)
    return _cubic_hermite(ay, b0, b1, d0, d1)


def interpolate(fields, xq, yq, x0, y0, dx, dy, method: str = "bilinear"):
    """Dispatch on method. For ``'bicubic'`` ``fields`` is the stacked
    (4F, ny, nx) [f | fx | fy | fxy] layout of ``fields_from_psih(...,
    interp='bicubic')`` and the result has F rows."""
    if method == "bilinear":
        return bilinear(fields, xq, yq, x0, y0, dx, dy)
    if method == "bspline":
        return bspline(fields, xq, yq, x0, y0, dx, dy)
    if method == "bicubic":
        F4 = fields.shape[0]
        if F4 % 4:
            raise ValueError(
                "bicubic expects a stacked (4F, ny, nx) [f|fx|fy|fxy] layout")
        F = F4 // 4
        return bicubic_hermite(fields[:F], fields[F:2 * F], fields[2 * F:3 * F],
                               fields[3 * F:], xq, yq, x0, y0, dx, dy)
    raise ValueError(f"unknown interpolation method {method!r}")
