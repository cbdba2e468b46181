"""Packet trajectory loading and ensemble statistics (port of
``analysis/packet_stats.py``).

- a loader over the rolling packet files, stitched across files;
- per-packet intrinsic and absolute (Doppler) frequencies;
- KDE frequency-spectrum evolution and wavenumber-spread series.

Series are numpy arrays; the frequencies are computed in their float32 by
``rays/dispersion`` on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..rays.dispersion import doppler_frequency, omega
from .slope import estimate_pdf

__all__ = [
    "load_packet_series", "intrinsic_frequencies", "absolute_frequencies",
    "wavenumber_spread", "frequency_pdf_evolution",
]


def load_packet_series(reader):
    """Gather the full packet telemetry across a rolling file sequence.

    Returns dict with t (T,), x (T, N, 2), k (T, N, 2), and u/g when present.
    """
    import h5py

    frames = {}
    for path in reader.paths:
        with h5py.File(path, "r") as f:
            if "p" not in f:
                continue
            for step in f["p/t"].keys():
                rec = {"t": float(np.asarray(f[f"p/t/{step}"]))}
                for name in ("x", "k", "u", "g"):
                    if f"p/{name}/{step}" in f:
                        rec[name] = f[f"p/{name}/{step}"][()]
                frames[int(step)] = rec
    steps = sorted(frames)
    out = {"step": np.asarray(steps),
           "t": np.asarray([frames[s]["t"] for s in steps])}
    for name in ("x", "k", "u", "g"):
        if all(name in frames[s] for s in steps):
            out[name] = np.stack([frames[s][name] for s in steps])
    return out


def _sign(sign):
    return 1.0 if sign is None else torch.as_tensor(np.asarray(sign)[None, :])


def intrinsic_frequencies(series, f, Cg, sign=None):
    """omega(k) along trajectories: (T, N)."""
    k = torch.as_tensor(series["k"])
    return omega(k[..., 0], k[..., 1], f, Cg, _sign(sign)).numpy()


def absolute_frequencies(series, f, Cg, sign=None):
    """Doppler-shifted Omega = omega + k.u (needs sampled velocities)."""
    k, u = torch.as_tensor(series["k"]), torch.as_tensor(series["u"])
    return doppler_frequency(k[..., 0], k[..., 1], u[..., 0], u[..., 1], f, Cg,
                             _sign(sign)).numpy()


def wavenumber_spread(series):
    """Time series of ensemble |k| statistics: mean, std, rms, max."""
    k = series["k"]
    mag = np.hypot(k[..., 0], k[..., 1])
    return {
        "t": series["t"],
        "mean": mag.mean(axis=1),
        "std": mag.std(axis=1),
        "rms": np.sqrt((mag**2).mean(axis=1)),
        "max": mag.max(axis=1),
    }


def frequency_pdf_evolution(series, f, Cg, sign=None, times=None,
                            grid_points=None):
    """KDE of the intrinsic-frequency distribution at selected times.
    Returns (times, grid, pdfs (T, G))."""
    om = np.abs(intrinsic_frequencies(series, f, Cg, sign))
    t = series["t"]
    if times is None:
        idx = np.linspace(0, len(t) - 1, min(len(t), 16)).astype(int)
    else:
        idx = [int(np.argmin(np.abs(t - tt))) for tt in times]
    if grid_points is None:
        grid_points = np.linspace(om.min() * 0.9, om.max() * 1.1, 256)
    pdfs = np.stack([
        estimate_pdf(om[i], grid_points=grid_points)[1] for i in idx
    ])
    return t[idx], grid_points, pdfs
