"""Exact type-2 evaluation of spectral fields at scattered points (port of
``analysis/nufft.py``).

    f(x_j) = sum_{k,l} fh[l,k] e^{i(k x_j + l y_j)}  (conjugate-even in k)

factored through the separable phase into two complex contractions,

    g[l, j] = sum_k w_k fh[l, k] e^{i k x_j}      (nl x nkr) @ (nkr x N)
    f[j]    = sum_l g[l, j] e^{i l y_j}           a product summed over nl

O(nl nkr N) work in two batched products (``torch.einsum``, cuBLAS's
complex GEMM on the card) instead of O(nl nkr N) scattered exponentials.
The products run in full float32 precision: the port never turns on TF32
(the reference asks for ``Precision.HIGHEST`` here).
"""
from __future__ import annotations

import torch

__all__ = ["nufft2d2"]


def nufft2d2(fh: torch.Tensor, xq: torch.Tensor, yq: torch.Tensor, grid) -> torch.Tensor:
    """Evaluate rfft2-layout spectra at scattered points, exactly.

    ``fh``: ``(..., nl, nkr)`` spectra with the FFT normalisation
    (unnormalised forward); ``xq``, ``yq``: ``(N,)`` physical coordinates.
    Returns ``(..., N)`` real."""
    # conjugate-even doubling: the kr > 0 columns stand for +/- pairs
    w = torch.full((grid.nkr,), 2.0, dtype=fh.dtype, device=fh.device)
    w[0] = 1.0
    if grid.nx % 2 == 0:
        w[-1] = 1.0
    # the rfft2 coefficients carry the DFT index phases: evaluate relative
    # to the first grid node (x0, y0)
    phase_x = torch.exp(1j * torch.outer(grid.kr, xq - grid.x[0])).to(fh.dtype)  # (nkr, N)
    phase_y = torch.exp(1j * torch.outer(grid.l, yq - grid.y[0])).to(fh.dtype)   # (nl, N)
    g = torch.einsum("...lk,kn->...ln", fh * w, phase_x)
    f = (g * phase_y).sum(-2)
    return f.real / (grid.nx * grid.ny)
