"""Exact-area isotropic (radial) spectra (port of ``analysis/radial.py``,
numpy as there; the grid's wavenumbers are read from its tensors).

Equivalent of the reference's utils/ExactRadialSpectrum.jl: each spectral
cell [k +/- dk/2] x [l +/- dk/2] contributes to radial bin r_i with weight =
(area of cell inside the disk of radius r_i) - (inside r_{i-1}), divided by
the cell area — an exactly-partitioned annulus decomposition (weights over
all radii sum to 1 per cell).

Instead of the reference's three clip-case constructions
(ExactRadialSpectrum.jl:65-128) we use the closed-form disk/rectangle
intersection area in the first quadrant,

    A = int_W^E max(0, min(sqrt(r^2-x^2), N) - S) dx,

with the antiderivative I(x) = (x sqrt(r^2-x^2) + r^2 asin(x/r))/2 —
identical results, fully vectorised. Mirror symmetry in l and conjugate
doubling in kr match the rfft storage (kr = 0 and Nyquist counted once).
"""
from __future__ import annotations

import numpy as np

__all__ = ["radial_weights", "radial_spectrum", "radial_bins"]


def _I(x, r):
    """Antiderivative of sqrt(r^2 - x^2) on [0, r]."""
    x = np.clip(x, 0.0, r)
    return 0.5 * (x * np.sqrt(np.maximum(r * r - x * x, 0.0))
                  + r * r * np.arcsin(np.clip(x / r, -1.0, 1.0)))


def _quadrant_area(W, E, S, N, r):
    """Area of the disk of radius r intersected with [W,E]x[S,N] (all >= 0)."""
    W = np.minimum(W, r)
    E = np.minimum(E, r)
    # x-range where circle height sqrt(r^2-x^2) >= N  -> full height (N - S)
    xN = np.sqrt(np.maximum(r * r - N * N, 0.0))
    xa = np.clip(xN, W, E)       # [W, xa]: full cell height
    # [xa, xb]: circle between S and N
    xS = np.sqrt(np.maximum(r * r - S * S, 0.0))
    xb = np.clip(xS, W, E)
    full = (N - S) * np.maximum(xa - W, 0.0)
    partial = (_I(xb, r) - _I(xa, r)) - S * np.maximum(xb - xa, 0.0)
    return full + np.maximum(partial, 0.0)


def _np64(t) -> np.ndarray:
    """A grid tensor (on any device) as float64 numpy."""
    return t.detach().cpu().numpy().astype(np.float64)


def _disk_weights(grid, radius):
    """(nl, nkr) fraction of each cell inside the disk |K| <= radius."""
    kr = _np64(grid.kr)
    ell = np.abs(_np64(grid.l))
    dk = kr[1] - kr[0]
    h = dk / 2.0

    W = np.maximum(kr - h, 0.0)
    E = kr + h
    W[0], E[0] = 0.0, h
    S = np.maximum(ell - h, 0.0)
    N = ell + h
    S[ell == 0], N[ell == 0] = 0.0, h

    area = _quadrant_area(W[None, :], E[None, :], S[:, None], N[:, None],
                          radius)
    cell = (E - W)[None, :] * (N - S)[:, None]
    return area / cell


def radial_bins(grid, resolution_factor: int = 2):
    kr = _np64(grid.kr)
    dk = kr[1] - kr[0]
    num = resolution_factor * (grid.nkr - 2)
    return np.arange(1, num + 1) / resolution_factor * dk


def _doubling(grid):
    dbl = np.ones(grid.nkr)
    dbl[1:] = 2.0
    if grid.nx % 2 == 0:
        dbl[-1] = 1.0
    return dbl


def _native_lib():
    import ctypes
    import os

    path = os.path.join(
        os.path.dirname(__file__), "..", "..", "native", "lib",
        "libradial_weights.so",
    )
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.radial_weights_sparse.restype = ctypes.c_int64
    return lib


def radial_weights(grid, resolution_factor: int = 2):
    """(radii, W) with W a scipy.sparse CSR matrix of shape (R, nl*nkr)
    including conjugate doubling (ExactRadialSpectrum.jl:13-14).

    Uses the native C++ builder (native/radial_weights.cpp) when built —
    required for 1024^2+ where a dense (R, nl, nkr) tensor would be GBs —
    with a vectorised numpy fallback producing identical weights.
    """
    import scipy.sparse as sp

    radii = radial_bins(grid, resolution_factor)
    dbl = _doubling(grid)
    ncell = grid.nl * grid.nkr

    lib = _native_lib()
    if lib is not None:
        import ctypes

        kr = np.ascontiguousarray(_np64(grid.kr))
        labs = np.ascontiguousarray(np.abs(_np64(grid.l)))
        rads = np.ascontiguousarray(radii.astype(np.float64))
        cap = ncell * 8
        obin = np.empty(cap, np.int32)
        ocell = np.empty(cap, np.int64)
        ow = np.empty(cap, np.float64)
        ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        dblc = np.ascontiguousarray(dbl)
        n = lib.radial_weights_sparse(
            ctypes.c_int32(grid.nl), ctypes.c_int32(grid.nkr),
            ptr(kr, ctypes.c_double), ptr(labs, ctypes.c_double),
            ptr(dblc, ctypes.c_double),
            ctypes.c_int32(len(rads)), ptr(rads, ctypes.c_double),
            ctypes.c_int64(cap),
            ptr(obin, ctypes.c_int32), ptr(ocell, ctypes.c_int64),
            ptr(ow, ctypes.c_double),
        )
        if n >= 0:
            W = sp.coo_matrix(
                (ow[:n], (obin[:n], ocell[:n])),
                shape=(len(radii), ncell),
            ).tocsr()
            return radii, W

    # numpy fallback: stream per-radius dense masks into sparse rows
    prev = np.zeros((grid.nl, grid.nkr))
    rows, cols, vals = [], [], []
    for i, r in enumerate(radii):
        w = _disk_weights(grid, r) * dbl[None, :]
        diff = w - prev
        iy, ix = np.nonzero(diff > 1e-14)
        rows.append(np.full(len(iy), i))
        cols.append(iy * grid.nkr + ix)
        vals.append(diff[iy, ix])
        prev = w
    W = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(len(radii), ncell),
    ).tocsr()
    return radii, W


def radial_spectrum(data, weights):
    """data (nl, nkr) real (e.g. |uh|^2) -> (R,) binned spectrum."""
    return np.asarray(weights @ np.asarray(data, np.float64).ravel())
