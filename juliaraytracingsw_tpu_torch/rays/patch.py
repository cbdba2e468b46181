"""Per-cell patch tables (port of the table build of ``rays/patch.py``).

Once per flow snapshot the fields are packed into a table whose row ``c``
holds the full ``ph x pw`` neighbourhood of cell ``c`` for every field, so a
substep needs one row gather per packet and every RK stage interpolates
locally from that row.
"""
from __future__ import annotations

import torch

__all__ = ["PATCH_SHAPES", "build_patch_table"]

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
