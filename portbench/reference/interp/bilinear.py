"""The bilinear interpolant: fields stored at the configuration's table
precision and interpolated bilinearly on the periodic grid; each stage
blends the two time levels' interpolated values linearly in time."""
from __future__ import annotations

import torch


def table(fields, g, p):
    """The ``(5, ny, nx)`` field stack as the configuration's table stores
    it."""
    return p.t(fields)


def sampler(Fo, Fn, bx, by, g, p):
    """``sample(lx, ly, a) -> (5, N)``: lx, ly in physical units from the
    base cell's corner ``(bx, by)``, a the time blend of the old and new
    tables."""
    n, dx = g.n, g.dx
    Fo, Fn = Fo.reshape(5, -1), Fn.reshape(5, -1)
    bxi, byi = bx.to(torch.int64), by.to(torch.int64)

    def sample(lx, ly, a):
        axes = []
        for loc, base in ((lx / dx, bxi), (ly / dx, byi)):
            j0 = torch.clip(torch.floor(loc), -1.0, 1.0)
            axes.append((loc - j0, base + j0.to(torch.int64)))
        (ax, ix), (ay, iy) = axes
        ix0, ix1 = torch.remainder(ix, n), torch.remainder(ix + 1, n)
        iy0, iy1 = torch.remainder(iy, n) * n, torch.remainder(iy + 1, n) * n
        w = ((1.0 - ay) * (1.0 - ax), (1.0 - ay) * ax, ay * (1.0 - ax), ay * ax)
        idx = (iy0 + ix0, iy0 + ix1, iy1 + ix0, iy1 + ix1)
        vo = sum(Fo[:, i] * wi for i, wi in zip(idx, w))
        vn = sum(Fn[:, i] * wi for i, wi in zip(idx, w))
        return p.r((1.0 - a) * vo + a * vn)

    return sample
