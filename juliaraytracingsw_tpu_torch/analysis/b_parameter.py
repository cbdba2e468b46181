"""Ray-diffusivity b-parameter from omega-k streamfunction spectra (the
port's own copy of ``analysis/b_parameter.py``: numpy and scipy, run on
the host).

Builds the isotropised streamfunction correlation spectrum C(omega, q)
from per-k frequency analysis output, evaluates the WKB resonance integral

    D_11(k) = k^2 int dq int deta q^5 cos^2(eta) sin^2(eta)
                       C(-c_g(k) q cos(eta), q)

and fits D_11(k) ~ b * (k/Kd)^2. Grid arrays may be CPU tensors or arrays.
"""
from __future__ import annotations

import numpy as np

__all__ = ["psi_correlation", "compute_D11", "fit_b"]


def psi_correlation(psit_by_k, t, grid):
    """C(omega, K-bin) from per-k time-FFT'd streamfunction rows.

    ``psit_by_k``: mapping k_index (0-based) -> (Nomega, nl) complex array of
    time-FFT'd psi_hat rows. Bins modes by integer |K| = floor(sqrt(k^2+l^2))
    (compute_b_parameter.jl:33-54). Returns (omegas (fftshifted), C).
    """
    n_omega = len(t)
    dt = t[1] - t[0]
    omegas = np.fft.fftshift(2 * np.pi * np.fft.fftfreq(n_omega, d=dt))
    ell = np.asarray(grid.l, np.float64)
    C = np.zeros((n_omega, 2 * grid.nkr))
    norm = 1.0 / n_omega**2 / grid.nx**2 / grid.ny**2 / 2.0
    for k_idx, psit in psit_by_k.items():
        k = float(grid.kr[k_idx])
        q = np.sqrt(k * k + ell * ell)
        K_bin = np.floor(q).astype(int)
        power = (np.abs(np.asarray(psit)) ** 2) * norm  # (Nomega, nl)
        np.add.at(C.T, K_bin, power.T)
    return omegas, C


def compute_D11(omegas, C, grid, f0: float, Kd: float, n_points: int = 176,
                dq: float = 0.1, deta: float = 0.01):
    """Resonance integral D_11(k) (compute_b_parameter.jl:57-80)."""
    from scipy.interpolate import RegularGridInterpolator

    c = f0 / Kd
    k = np.arange(1, n_points + 1) / n_points * n_points
    om = np.sqrt(f0**2 + c**2 * k**2)
    cg = c**2 * k / om

    # C rows are raw-FFT omega order; shift to ascending to match omegas
    Csub = np.fft.fftshift(C[:, :grid.nkr], axes=0)
    interp = RegularGridInterpolator(
        (omegas, np.arange(grid.nkr, dtype=float)), Csub,
        bounds_error=False, fill_value=0.0,
    )
    q = np.arange(0.0, float(grid.kr[-1]) + dq, dq)
    eta = np.arange(0.0, 2 * np.pi, deta)
    Q, ETA = np.meshgrid(q, eta, indexing="ij")
    D11 = np.zeros(n_points)
    for i in range(n_points):
        sigma = -cg[i] * Q * np.cos(ETA)
        vals = interp(np.stack([sigma.ravel(), Q.ravel()], axis=1)).reshape(Q.shape)
        D11[i] = k[i] ** 2 * np.sum(
            Q**5 * np.cos(ETA) ** 2 * np.sin(ETA) ** 2 * vals
        ) * dq * deta
    return k, D11


def fit_b(k, D11, Kd: float):
    """Least-squares fit D11 = b (k/Kd)^2 (compute_b_parameter.jl:81-86)."""
    x = (k / Kd) ** 2
    return float((x * D11).sum() / (x * x).sum())
