"""Canonical figure set for simulation runs (matplotlib backend; a copy of
``analysis/figures.py``, matplotlib imported inside the functions).

Equivalent of the reference's CairoMakie figure layer
(analysis/Notebooks/rsw_suite/RSWAnalysisSuite.jl): energy time series,
exact-radial KE/APE spectra with power-law guides, spectral flux integrals
Pi(k), PV / divergence snapshot heatmaps, omega-k heatmaps
(analysis/Notebooks/MakeOmegaKPlots.jl), packet KDE evolution.

All functions take data, return the saved figure path.

THREAD SAFETY: figures are built with the matplotlib object-oriented API
(Figure + FigureCanvasAgg), NOT pyplot — the global pyplot/Gcf state machine
is not thread-safe, and analysis.suite.analyze_runs renders runs from a
thread pool.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = [
    "plot_energy_series", "plot_radial_spectra", "plot_flux_integrals",
    "plot_snapshot_heatmaps", "plot_omega_k_heatmap", "plot_packet_pdfs",
]


def _figure(nrows=1, ncols=1, figsize=(7, 4)):
    """Thread-safe figure construction: pure OO API, no pyplot/Gcf."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=figsize)
    FigureCanvasAgg(fig)
    axes = fig.subplots(nrows, ncols)
    return fig, axes


def _save(fig, out_dir, name):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    return path


def plot_energy_series(t, series: dict, out_dir, name="energy_series.png",
                       title="Energy diagnostics"):
    """series: name -> (T,) array (RSWAnalysisSuite.jl:249-264)."""
    fig, ax = _figure(figsize=(7, 4))
    for label, vals in series.items():
        ax.plot(t, np.asarray(vals), label=label)
    ax.set_xlabel("t")
    ax.set_ylabel("energy")
    ax.set_title(title)
    ax.legend()
    return _save(fig, out_dir, name)


def plot_radial_spectra(radii, spectra: dict, out_dir,
                        name="radial_spectra.png", guides=(-2.0, -3.0)):
    """Log-log isotropic spectra with k^slope guide lines
    (RSWAnalysisSuite.jl:355-364)."""
    fig, ax = _figure(figsize=(6, 5))
    for label, spec in spectra.items():
        ax.loglog(radii, np.maximum(np.asarray(spec), 1e-30), label=label)
    kref = radii[len(radii) // 4: len(radii) // 2]
    base = max(np.max(list(spectra.values())[0]), 1e-30)
    for s in guides:
        ax.loglog(kref, base * (kref / kref[0]) ** s, "k--", lw=0.8,
                  label=f"k^{s:g}")
    ax.set_xlabel("|K|")
    ax.set_ylabel("E(|K|)")
    ax.legend(fontsize=8)
    return _save(fig, out_dir, name)


def plot_flux_integrals(radii, flux_spectra: dict, out_dir,
                        name="flux_integrals.png"):
    """Pi(k) = -int_0^k T(k') dk' from binned transfer densities
    (RSWAnalysisSuite.jl:180-220)."""
    fig, ax = _figure(figsize=(7, 4))
    for label, T in flux_spectra.items():
        Pi = -np.cumsum(np.asarray(T))
        ax.semilogx(radii, Pi, label=label)
    ax.axhline(0, color="k", lw=0.5)
    ax.set_xlabel("|K|")
    ax.set_ylabel("Pi(|K|)")
    ax.legend(fontsize=8)
    return _save(fig, out_dir, name)


def plot_snapshot_heatmaps(fields: dict, grid, out_dir,
                           name="snapshots.png"):
    """Physical-space heatmaps (PV, divergence, ... —
    RSWAnalysisSuite.jl:304-353)."""
    n = len(fields)
    fig, axes = _figure(1, n, figsize=(4.5 * n, 4))
    if n == 1:
        axes = [axes]
    ext = [float(grid.x[0]), float(grid.x[0]) + grid.Lx,
           float(grid.y[0]), float(grid.y[0]) + grid.Ly]
    for ax, (label, f) in zip(axes, fields.items()):
        f = np.asarray(f)
        vmax = np.abs(f).max() or 1.0
        im = ax.imshow(f, origin="lower", extent=ext, cmap="RdBu_r",
                       vmin=-vmax, vmax=vmax)
        ax.set_title(label)
        fig.colorbar(im, ax=ax, shrink=0.8)
    return _save(fig, out_dir, name)


def plot_omega_k_heatmap(omega, kbins, power, out_dir,
                         name="omega_k.png", dispersion=None,
                         title="omega-k spectrum"):
    """(omega, K) heatmap with optional dispersion-curve overlay
    (MakeOmegaKPlots.jl:22-71)."""
    fig, ax = _figure(figsize=(6, 5))
    P = np.log10(np.maximum(np.asarray(power), 1e-30))
    im = ax.pcolormesh(kbins, omega, P, shading="auto", cmap="magma")
    if dispersion is not None:
        ax.plot(kbins, dispersion(np.asarray(kbins)), "w--", lw=1)
        ax.plot(kbins, -dispersion(np.asarray(kbins)), "w--", lw=1)
    ax.set_xlabel("|K|")
    ax.set_ylabel("omega")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label="log10 power")
    return _save(fig, out_dir, name)


def plot_packet_pdfs(times, grid_points, pdfs, out_dir,
                     name="packet_frequency_pdfs.png", f0=None):
    """KDE frequency-spectrum evolution (MakeRaytracingPlots.jl:14-65)."""
    from matplotlib import colormaps

    fig, ax = _figure(figsize=(7, 4))
    cmap = colormaps["viridis"]
    for i, (t, pdf) in enumerate(zip(times, pdfs)):
        ax.plot(grid_points, pdf, color=cmap(i / max(len(times) - 1, 1)),
                label=f"t={t:.1f}" if i in (0, len(times) - 1) else None)
    if f0 is not None:
        ax.axvline(f0, color="k", ls=":", lw=1, label="f")
    ax.set_xlabel("omega")
    ax.set_ylabel("pdf")
    ax.legend(fontsize=8)
    return _save(fig, out_dir, name)
