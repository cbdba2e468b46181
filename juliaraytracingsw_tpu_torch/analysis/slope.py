"""Spectral-slope and Matern model estimation for packet frequency spectra
(a copy of ``analysis/slope.py``, numpy only).

Equivalent of the reference utils/SlopeEstimation.jl: power-law and Matern
spectrum models, log-likelihoods, Gaussian-KDE density estimation and
maximum-likelihood fitting.

Model conventions (SlopeEstimation.jl:3-19):
    power law : S(omega) = A * omega^(-slope)
    Matern    : S(omega) = A / (lambda^2 + omega^2)^(nu/2)   ("nu" = decay)
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "power_law", "matern", "estimate_pdf", "fit_power_law", "fit_matern",
    "log_likelihood",
]


def power_law(omega, A, slope):
    return A * np.power(np.abs(omega), -slope)


def matern(omega, A, lam, nu):
    return A / np.power(lam * lam + omega * omega, nu / 2.0)


def estimate_pdf(samples, grid_points=None, bandwidth=None):
    """Gaussian-KDE density estimate (SlopeEstimation.jl:27-35)."""
    samples = np.asarray(samples, np.float64)
    n = len(samples)
    if bandwidth is None:
        sigma = samples.std()
        bandwidth = 1.06 * sigma * n ** (-1 / 5)  # Silverman
    if grid_points is None:
        lo, hi = samples.min(), samples.max()
        pad = 3 * bandwidth
        grid_points = np.linspace(lo - pad, hi + pad, 512)
    diffs = (grid_points[:, None] - samples[None, :]) / bandwidth
    pdf = np.exp(-0.5 * diffs**2).sum(axis=1) / (
        n * bandwidth * np.sqrt(2 * np.pi)
    )
    return grid_points, pdf


def log_likelihood(spectrum_model, omega, observed, params):
    """Whittle-type log-likelihood of an observed (periodogram) spectrum
    under a model: sum over frequencies of -(log S + I/S)."""
    S = spectrum_model(omega, *params)
    S = np.maximum(S, 1e-300)
    return float(-(np.log(S) + observed / S).sum())


def _fit(model, omega, observed, x0, bounds):
    from scipy.optimize import minimize

    omega = np.asarray(omega, np.float64)
    observed = np.asarray(observed, np.float64)
    mask = (np.abs(omega) > 0) & np.isfinite(observed) & (observed > 0)
    om, obs = np.abs(omega[mask]), observed[mask]

    def neg_ll(x):
        return -log_likelihood(model, om, obs, x)

    res = minimize(neg_ll, x0, bounds=bounds, method="L-BFGS-B")
    return res.x, -res.fun


def fit_power_law(omega, observed, slope0: float = 2.0):
    """ML fit of (A, slope); returns ((A, slope), loglik)."""
    A0 = float(np.median(np.abs(observed)) or 1.0)
    return _fit(power_law, omega, observed, np.asarray([A0, slope0]),
                [(1e-12, None), (0.1, 10.0)])


def fit_matern(omega, observed, lam0: float = 1.0, nu0: float = 2.0):
    """ML fit of (A, lambda, nu); returns ((A, lambda, nu), loglik)."""
    A0 = float(np.median(np.abs(observed)) or 1.0)
    return _fit(matern, omega, observed, np.asarray([A0, lam0, nu0]),
                [(1e-12, None), (1e-6, None), (0.1, 10.0)])
