"""Readers for the reference's JLD2 files, which are HDF5 (port of
``io/jld2.py``; numpy and h5py only, the same code).

Handles the two JLD2-specific wrinkles:
- complex numbers stored as an (re, im) compound dtype;
- Julia column-major arrays: a Julia (nkr, nl) spectral field appears
  transposed relative to our (nl, nkr) layout, so ``to_spectral_layout``
  transposes the trailing two axes.
"""
from __future__ import annotations

import h5py
import numpy as np

__all__ = ["load_array", "load_scalar", "load_struct", "load_twolayer_ic",
           "list_keys", "to_spectral_layout"]


def _convert(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.names and set(arr.dtype.names) >= {"re", "im"}:
        return arr["re"] + 1j * arr["im"]
    return arr


def load_array(path: str, key: str) -> np.ndarray:
    with h5py.File(path, "r") as f:
        obj = f[key]
        if isinstance(obj, h5py.Dataset):
            return _convert(obj[()])
        raise TypeError(f"{key} is a group, not a dataset")


def load_scalar(path: str, key: str):
    val = load_array(path, key)
    return val.item() if np.ndim(val) == 0 else val


def list_keys(path: str, group: str = "/"):
    with h5py.File(path, "r") as f:
        out = []
        f[group].visit(out.append)
        return out


def load_struct(path: str, key: str) -> dict:
    """Unpack a Julia struct stored as a compound dataset into a dict —
    the reader-side equivalent of the reference's
    ``@unpack f₀, β, b, H, U, μ = ic_file["params"]``
    (raytracing/TwoLayerRaytracing.jl:167). Nested {re, im} compound
    fields convert to complex; unicode fieldnames (f₀, β, μ) pass through.
    """
    with h5py.File(path, "r") as f:
        rec = f[key][()]
    if rec.dtype.names is None:
        raise TypeError(f"{key} is not a compound (struct) dataset")
    out = {}
    for name in rec.dtype.names:
        val = np.asarray(rec[name])
        out[name] = _convert(val) if val.dtype.names else val
        if out[name].ndim == 0:
            out[name] = out[name].item()
    return out


def load_twolayer_ic(path: str):
    """Load a reference two-layer IC file the way the production drivers do
    (raytracing/TwoLayerRaytracing.jl:162-182): first snapshot index from
    ``snapshots/t``, ψh from ``snapshots/ψh/<index>``, the params struct,
    and ``clock/dt``. Returns (psih (2, nl, nkr) complex, t, params dict,
    dt)."""
    with h5py.File(path, "r") as f:
        index = sorted(f["snapshots/t"].keys(), key=int)[0]
        t = float(np.asarray(f[f"snapshots/t/{index}"]))
    psih = load_array(path, f"snapshots/ψh/{index}")
    params = load_struct(path, "params")
    dt = float(load_scalar(path, "clock/dt"))
    return to_spectral_layout(psih), t, params, dt


def to_spectral_layout(julia_array: np.ndarray) -> np.ndarray:
    """Julia (nkr, nl[, C]) column-major -> our (C,) (nl, nkr) layout.

    h5py reads the raw buffer row-major, which already reverses Julia's axis
    order: a Julia array stored as (nkr, nl, C) arrives as (C, nl, nkr) —
    exactly our layout. For 2-D fields it arrives as (nl, nkr). This helper
    is therefore the identity for matching ranks, but kept as a documented
    seam in case of version differences.
    """
    return julia_array
