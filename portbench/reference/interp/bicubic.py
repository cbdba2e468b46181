"""The bicubic Hermite interpolant from corner data: each field and its
derivatives f_x, f_y and f_xy at the four corners of the cell that holds
the point (JuliaRaytracingSW, ``utils/CUDAInterpolations.jl:71-108``).

With a, b the point's fractions of the cell along x and y, and dx = dy the
square grid's cell size::

    p(a, b) = sum_{i,j in {0,1}} [ h_i(a) h_j(b) f_ij
                                   + dx g_i(a) h_j(b) f_x,ij
                                   + dy h_i(a) g_j(b) f_y,ij
                                   + dx dy g_i(a) g_j(b) f_xy,ij ]

    h_0 = 1 - 3a^2 + 2a^3,  h_1 = 3a^2 - 2a^3,  g_0 = a - 2a^2 + a^3,  g_1 = a^3 - a^2

Each time level is evaluated so, then the two are blended linearly in
time. The stored table is ``(20, ny, nx)`` [f | f_x | f_y | f_xy] of the
five fields [u, v, u_x, u_y, v_x], rounded to the table's precision.

Departures from the reference's CUDA interpolation:

- the derivative blocks are the exact spectral derivatives of the sampled
  fields on the doubly periodic grid (one ``rfft2``, times i k_x, i k_y and
  -k_x k_y, each inverse-transformed), not finite differences; the Nyquist
  wavenumber of each axis is taken as 0, so every derivative is real;
- the corner values are read from the cell that holds the stage position,
  with the cell index clipped to [-1, 1] from the packet's base cell, as
  ``interp/bilinear.py`` clips it; outside that reach the end cell's cubic
  is extended;
- every quantity is float32, the table rounded once to its stated dtype.

No matrix product is taken here, so TF32 cannot enter.
"""
from __future__ import annotations

import torch


def _wavenumbers(n: int, L: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(k_x over the rfft's half axis, k_y over the full axis), float32, the
    Nyquist wavenumber of each set to 0."""
    k = torch.fft.fftfreq(n, d=1.0 / n, dtype=torch.float64, device=device)
    k[n // 2] = 0.0
    k = (2.0 * torch.pi / L) * k
    return k[: n // 2 + 1].abs().float(), k.float()


def table(fields, g, p):
    """``(5, ny, nx)`` fields -> ``(20, ny, nx)`` [f | f_x | f_y | f_xy] at
    the table's precision."""
    n = fields.shape[-1]
    kx, ky = _wavenumbers(n, g.L, fields.device)
    fh = torch.fft.rfft2(fields.float(), dim=(-2, -1))
    ikx = torch.complex(torch.zeros_like(kx), kx)[None, None, :]
    iky = torch.complex(torch.zeros_like(ky), ky)[None, :, None]
    spectra = torch.cat([ikx * fh, iky * fh, ikx * iky * fh])
    derivs = torch.fft.irfft2(spectra, s=(n, n), dim=(-2, -1))
    return p.t(torch.cat([fields.float(), derivs]))


def _hermite(a):
    """(h_0, h_1, g_0, g_1) at the fraction ``a``."""
    a2 = a * a
    a3 = a2 * a
    return 1.0 - 3.0 * a2 + 2.0 * a3, 3.0 * a2 - 2.0 * a3, a - 2.0 * a2 + a3, a3 - a2


def sampler(Fo, Fn, bx, by, g, p):
    """``sample(lx, ly, a) -> (5, N)``: lx, ly in physical units from the
    base cell's corner ``(bx, by)``, a the time blend of the old and new
    tables."""
    n, dx = g.n, g.dx
    Fo, Fn = Fo.reshape(4, 5, -1), Fn.reshape(4, 5, -1)
    bxi, byi = bx.to(torch.int64), by.to(torch.int64)

    def sample(lx, ly, a):
        axes = []
        for loc, base in ((lx / dx, bxi), (ly / dx, byi)):
            j0 = torch.clip(torch.floor(loc), -1.0, 1.0)
            i = base + j0.to(torch.int64)
            axes.append((loc - j0, (torch.remainder(i, n), torch.remainder(i + 1, n))))
        (ax, (ix0, ix1)), (ay, (iy0, iy1)) = axes
        hx0, hx1, gx0, gx1 = _hermite(ax)
        hy0, hy1, gy0, gy1 = _hermite(ay)
        # corner (i, j): x node i, y node j
        corners = (((ix0, iy0), hx0, gx0, hy0, gy0), ((ix1, iy0), hx1, gx1, hy0, gy0),
                   ((ix0, iy1), hx0, gx0, hy1, gy1), ((ix1, iy1), hx1, gx1, hy1, gy1))

        def level(F):
            out = 0.0
            for (ix, iy), hx, gx, hy, gy in corners:
                c = F[:, :, iy * n + ix]
                out = out + (hx * hy * c[0] + dx * gx * hy * c[1]
                             + dx * hx * gy * c[2] + dx * dx * gx * gy * c[3])
            return out

        return p.r((1.0 - a) * level(Fo) + a * level(Fn))

    return sample
