"""Frequency-wavenumber (omega-k) spectral analysis (the port's own copy of
``analysis/omega_k.py``: numpy and h5py, run on the host).

Time series of (decomposed) spectral fields at fixed k are gathered from a
run's snapshot files, demeaned, linearly detrended, Hann-windowed and
Fourier transformed in time. One pass over the snapshot sequence collects
a whole block of k columns at once (bounded by memory), so one process
covers the full analysis; blocks can be farmed out across processes
(``omega-k --fanout``). ``detrend`` removes the mean as well as the trend
(the reference's detrend leaves the mean in, polluting only omega = 0).
Grid arrays may be CPU tensors or arrays.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = [
    "hann", "demean", "detrend", "clean_fft", "collect_time_series",
    "count_snapshots", "snapshot_shape", "assemble_radial_omega_k",
    "omega_k_spectrum", "stft_omega_k", "cubic_velocity_spectra",
]


def count_snapshots(reader, group: str = "snapshots/sol",
                    skip_first: bool = True) -> int:
    """Number of frames a collect_time_series pass will yield — metadata
    only (reader.steps key counts), no snapshot data is read. Used to size
    bounded-memory k sub-blocks before streaming."""
    return max(len(reader.steps(group)) - int(skip_first), 0)


def snapshot_shape(reader, group: str = "snapshots/sol"):
    """Shape of one stored snapshot (metadata only)."""
    import h5py

    for path in reader.paths:
        with h5py.File(path, "r") as f:
            if group in f:
                for s in f[group]:
                    return f[group][s].shape
    return ()


def hann(n: int) -> np.ndarray:
    """Periodic Hann window (reference hann(), FourierRSW.jl:9-15)."""
    m = np.arange(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * m / n))


def demean(data: np.ndarray) -> np.ndarray:
    return data - data.mean(axis=0, keepdims=True)


def detrend(t: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Remove mean AND least-squares linear trend along axis 0.

    The reference's detrend (FourierRSW.jl:22-35) fits the slope on demeaned
    data but subtracts the trend from the ORIGINAL series, leaving the time
    mean in (it only pollutes the omega=0 bin). We demean as well — a
    deliberate cleanup, pinned by tests.
    """
    t = np.asarray(t, np.float64)
    d = demean(data)
    tsum = t.sum()
    t2sum = (t * t).sum()
    n = len(t)
    txsum = np.tensordot(t, d, axes=(0, 0))
    slope = n * txsum / (n * t2sum - tsum**2)
    intercept = -slope * tsum / n
    shape = (len(t),) + (1,) * (data.ndim - 1)
    return d - slope[None] * t.reshape(shape) - intercept[None]


def clean_fft(t: np.ndarray, data: np.ndarray, window: np.ndarray | None = None):
    """detrend -> window -> FFT along the time axis (FourierRSW.jl:37-40)."""
    if window is None:
        window = hann(len(t))
    shape = (len(t),) + (1,) * (data.ndim - 1)
    return np.fft.fft(window.reshape(shape) * detrend(t, data), axis=0)


def collect_time_series(
    reader,
    extract: Callable[[np.ndarray], dict[str, np.ndarray]],
    group: str = "snapshots/sol",
    time_group: str = "snapshots/t",
    skip_first: bool = True,
):
    """One pass over a SequencedReader: for each frame call
    ``extract(snapshot) -> {name: array}`` and stack results along time.

    Returns (t, {name: (T, ...)}). ``extract`` typically slices a k-block of
    wave/geo-decomposed fields.
    """
    import h5py

    times, rows = [], []
    first = True
    for path in reader.paths:
        with h5py.File(path, "r") as f:
            if group not in f:
                continue
            for s in sorted(f[group].keys(), key=int):
                if first and skip_first:
                    first = False
                    continue
                first = False
                times.append(float(np.asarray(f[f"{time_group}/{s}"])))
                snap = f[f"{group}/{s}"][()]
                rows.append(extract(snap))
    if not rows:
        return np.zeros(0), {}
    names = rows[0].keys()
    out = {n: np.stack([r[n] for r in rows], axis=0) for n in names}
    return np.asarray(times), out


def omega_k_spectrum(t, series: dict[str, np.ndarray]):
    """Windowed time-FFT of each collected series; returns
    (omega, {name: spectrum}) with omega in fftfreq order * 2 pi / T-span."""
    w = hann(len(t))
    dt = np.median(np.diff(t))
    omega = 2.0 * np.pi * np.fft.fftfreq(len(t), d=dt)
    return omega, {n: clean_fft(t, d, w) for n, d in series.items()}


def stft_omega_k(t, data, window_length: int, overlap: float = 0.5):
    """Short-time (sliding-window) omega-k analysis
    (swqg/fourier-analysis/ShortTimeFourierSWQG.jl:74-117): returns
    (window_centers, omega, spectra (W, window_length, ...))."""
    step = max(int(window_length * (1.0 - overlap)), 1)
    w = hann(window_length)
    dt = np.median(np.diff(t))
    omega = 2.0 * np.pi * np.fft.fftfreq(window_length, d=dt)
    centers, specs = [], []
    for start in range(0, len(t) - window_length + 1, step):
        seg_t = t[start:start + window_length]
        seg = data[start:start + window_length]
        centers.append(seg_t.mean())
        specs.append(clean_fft(seg_t, seg, w))
    return np.asarray(centers), omega, np.stack(specs, axis=0)


def assemble_radial_omega_k(omega_dir: str, grid, names=("c0", "cp", "cm"),
                            resolution_factor: int = 2):
    """Assemble per-k ``radial_data_k=*.h5`` files (cmd_omega_k output)
    into radially-binned frequency-wavenumber power spectra — the
    reference's MakeOmegaKPlots assembly
    (analysis/Notebooks/MakeOmegaKPlots.jl:22-71: per-k |c|^2 slices
    weighted into exact-area radius bins and summed over k).

    Returns (omega_shifted, radii, {name: (n_omega, R) power}).
    """
    import glob
    import os
    import re

    import h5py

    from .radial import radial_weights

    radii, W = radial_weights(grid, resolution_factor)   # CSR (R, nl*nkr)
    files = sorted(glob.glob(os.path.join(omega_dir, "radial_data_k=*.h5")))
    if not files:
        raise FileNotFoundError(f"no radial_data_k files in {omega_dir}")
    acc = {}
    omega = None
    nkr, nl = grid.nkr, grid.nl
    for path in files:
        ki = int(re.search(r"k=(\d+)", os.path.basename(path)).group(1))
        with h5py.File(path, "r") as f:
            if omega is None:
                t = f["t"][()]
                dt = float(np.median(np.diff(t)))
                omega = 2.0 * np.pi * np.fft.fftfreq(len(t), d=dt)
            # column block of the sparse weights for this k_x row:
            # flattened cell index = l * nkr + ki (analysis/radial.py)
            cols = np.arange(nl) * nkr + ki
            Wk = np.asarray(W[:, cols].todense())        # (R, nl)
            for name in names:
                if name not in f:
                    continue
                power = np.abs(f[name][()]) ** 2          # (T, nl)
                acc.setdefault(name, 0.0)
                acc[name] = acc[name] + power @ Wk.T      # (T, R)
    shift = np.fft.fftshift
    return shift(omega), radii, {n: shift(v, axes=0) for n, v in acc.items()}


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a)


def cubic_velocity_spectra(uh, vh, etah, grid):
    """"Cubic variables" m_u = sqrt(1+eta) u for exactly quadratic energy.
    Host numpy implementation (analysis side); tensors are copied to the
    host."""
    u = np.fft.irfft2(_host(uh), s=(grid.ny, grid.nx))
    v = np.fft.irfft2(_host(vh), s=(grid.ny, grid.nx))
    eta = np.fft.irfft2(_host(etah), s=(grid.ny, grid.nx))
    root = np.sqrt(np.maximum(1.0 + eta, 0.0))
    return np.fft.rfft2(root * u), np.fft.rfft2(root * v)
