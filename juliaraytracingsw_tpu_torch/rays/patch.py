"""Per-cell patch tables and the per-stage patch sampler (port of
``rays/patch.py``).

Once per flow snapshot the fields are packed into a table whose row ``c``
holds the full ``ph x pw`` neighbourhood of cell ``c`` for every field, so a
substep needs one row gather per packet and every RK stage interpolates
locally from that row. ``patch_interpolate_pair_shared`` is that local
interpolation over the gathered (old|new) pair rows, the reference's
default ``pairsplit`` form; ``patch_interpolate`` evaluates one time level
(the reference's ``split`` form, kept as the oracle the pair form is held
against). The ``mxu`` and ``conv`` TPU variants are not ported.
"""
from __future__ import annotations

import torch

from .interp import _bspline_w

__all__ = ["PATCH_SHAPES", "build_patch_table", "patch_interpolate",
           "patch_interpolate_pair_shared"]

# interp method -> (patch height, patch width, lo offset of the tap grid);
# the windows cover local offsets in [-1, 2) exactly
PATCH_SHAPES = {
    "bilinear": (4, 4, 1),
    "bspline": (6, 6, 2),
    "bicubic": (4, 4, 1),
}


def build_patch_table(fields: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """(F, ny, nx) -> (ny*nx, F*ph*pw) packed per-cell neighbourhoods.

    Row c = cell (iy, ix) holds fields[f, iy + dy - lo, ix + dx - lo]
    (periodic) for all f, dy in [0, ph), dx in [0, pw), in (f, dy, dx)
    order."""
    ph, pw, lo = PATCH_SHAPES[method]
    F, ny, nx = fields.shape
    shifted = [torch.roll(fields, shifts=(lo - dy, lo - dx), dims=(1, 2))
               for dy in range(ph) for dx in range(pw)]
    # (ph*pw, F, ny, nx) -> (ny, nx, F, ph*pw) -> (ny*nx, F*ph*pw)
    T = torch.stack(shifted).permute(2, 3, 1, 0)
    return T.reshape(ny * nx, F * ph * pw)


def _axis_weights_bilinear(local, size, lo):
    """(N,) local offsets from the patch's base cell -> (N, size) bilinear
    tap weights; tap j sits at j - lo."""
    j0 = torch.clip(torch.floor(local), -lo, size - lo - 2)
    a = local - j0
    t = (j0 + lo)[:, None].to(torch.int32)
    iota = torch.arange(size, dtype=torch.int32, device=local.device)
    zero = torch.zeros((), dtype=local.dtype, device=local.device)
    w = torch.where(iota == t, (1.0 - a)[:, None], zero)
    return w + torch.where(iota == t + 1, a[:, None], zero)


def _axis_weights_bspline(local, size, lo):
    """Cubic B-spline weights over the 4 taps floor(local)-1 .. +2, over the
    full patch axis ``(N, size)``; the base is clipped so the window stays
    in the patch, and the local cubic extends polynomially beyond."""
    j0 = torch.clip(torch.floor(local), -(lo - 1), size - lo - 3)
    a = local - j0
    base = (j0 + lo - 1)[:, None].to(torch.int32)
    iota = torch.arange(size, dtype=torch.int32, device=local.device)
    zero = torch.zeros((), dtype=local.dtype, device=local.device)
    w = torch.zeros((local.shape[0], size), dtype=local.dtype, device=local.device)
    for j, wj in enumerate(_bspline_w(a)):
        w = w + torch.where(iota == base + j, wj[:, None], zero)
    return w


def _axis_weights_hermite(local, size, lo, scale):
    """Hermite cubic weights over the 2 nodes of the containing cell:
    ``(wv, wd)``, the value basis (h00, h01) and the derivative basis (h10,
    h11) scaled by the physical cell size, each ``(N, size)``."""
    j0 = torch.clip(torch.floor(local), -lo, size - lo - 2)
    a = local - j0
    a2, a3 = a * a, a * a * a
    h00, h01 = 1.0 - 3.0 * a2 + 2.0 * a3, 3.0 * a2 - 2.0 * a3
    h10, h11 = (a - 2.0 * a2 + a3) * scale, (a3 - a2) * scale
    t = (j0 + lo)[:, None].to(torch.int32)
    iota = torch.arange(size, dtype=torch.int32, device=local.device)
    zero = torch.zeros((), dtype=local.dtype, device=local.device)
    wv = (torch.where(iota == t, h00[:, None], zero)
          + torch.where(iota == t + 1, h01[:, None], zero))
    wd = (torch.where(iota == t, h10[:, None], zero)
          + torch.where(iota == t + 1, h11[:, None], zero))
    return wv, wd


def _hermite_block_weights(local_x, local_y, deriv_scale):
    """The 4 separable (wy, wx) weight pairs of the [f, fx, fy, fxy] channel
    blocks of the bicubic corner-data layout."""
    ph, pw, lo = PATCH_SHAPES["bicubic"]
    sx, sy = deriv_scale
    wxv, wxd = _axis_weights_hermite(local_x, pw, lo, sx)
    wyv, wyd = _axis_weights_hermite(local_y, ph, lo, sy)
    return ((wyv, wxv), (wyv, wxd), (wyd, wxv), (wyd, wxd))


def _separable_weights(local_x, local_y, method: str):
    """(wx, wy) per-axis tap weights, ``(N, pw)`` and ``(N, ph)``."""
    ph, pw, lo = PATCH_SHAPES[method]
    if method == "bilinear":
        return _axis_weights_bilinear(local_x, pw, lo), _axis_weights_bilinear(local_y, ph, lo)
    if method == "bspline":
        return _axis_weights_bspline(local_x, pw, lo), _axis_weights_bspline(local_y, ph, lo)
    raise ValueError(f"unknown patch interp {method!r}")


def patch_interpolate(patches, local_x, local_y, method: str = "bilinear",
                      deriv_scale=(1.0, 1.0)):
    """Evaluate all fields of one time level from gathered patch rows.

    patches (N, F*ph*pw) rows of ``build_patch_table``; local_x/y (N,)
    offsets from each packet's base cell. Returns (F, N), F//4 rows for the
    bicubic [f|fx|fy|fxy] layout, whose derivative channels need
    ``deriv_scale=(dx, dy)``."""
    ph, pw, _ = PATCH_SHAPES[method]
    N = patches.shape[0]
    F = patches.shape[1] // (ph * pw)
    P = patches.reshape(N, F, ph, pw)
    if method == "bicubic":
        Pb = P.reshape(N, 4, F // 4, ph, pw)
        out = None
        for b, (wy, wx) in enumerate(
                _hermite_block_weights(local_x, local_y, deriv_scale)):
            v = torch.sum(Pb[:, b] * wx[:, None, None, :], dim=3)
            v = torch.sum(v * wy[:, None, :], dim=2)
            out = v if out is None else out + v
        return out.t()                                        # (F/4, N)
    wx, wy = _separable_weights(local_x, local_y, method)
    v = torch.sum(P * wx[:, None, None, :], dim=3)
    v = torch.sum(v * wy[:, None, :], dim=2)
    return v.t()                                              # (F, N)


def patch_interpolate_pair_shared(rows_pair, local_x, local_y, a,
                                  method: str = "bilinear",
                                  deriv_scale=(1.0, 1.0)):
    """Time-blended evaluation of all fields from gathered pair rows, the
    separable weights built once and shared by both time levels.

    rows_pair (N, 2*F*ph*pw); local_x/y (N,) offsets from each packet's
    base cell; a the blend (0 -> old, 1 -> new). Returns (F, N), F//4 rows
    for the bicubic [f|fx|fy|fxy] layout, whose derivative channels need
    ``deriv_scale=(dx, dy)``."""
    ph, pw, _ = PATCH_SHAPES[method]
    N = rows_pair.shape[0]
    F = rows_pair.shape[1] // (2 * ph * pw)
    P = rows_pair.reshape(N, 2, F, ph, pw)
    if method == "bicubic":
        Pb = P.reshape(N, 2, 4, F // 4, ph, pw)
        out = None
        for b, (wy, wx) in enumerate(
                _hermite_block_weights(local_x, local_y, deriv_scale)):
            v = torch.sum(Pb[:, :, b] * wx[:, None, None, None, :], dim=4)
            v = torch.sum(v * wy[:, None, None, :], dim=3)    # (N, 2, F/4)
            out = v if out is None else out + v
    else:
        wx, wy = _separable_weights(local_x, local_y, method)
        out = torch.sum(P * wx[:, None, None, None, :], dim=4)
        out = torch.sum(out * wy[:, None, None, :], dim=3)    # (N, 2, F)
    v = (1.0 - a) * out[:, 0] + a * out[:, 1]
    return v.t()                                              # (F, N)
